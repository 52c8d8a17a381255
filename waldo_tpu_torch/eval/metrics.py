"""Video quality metrics, SSIM / PSNR / MS-SSIM (+ LPIPS when its weights
exist): the port's counterpart of waldo_tpu/eval/metrics.py, with the same
protocol: per-timestep metrics over the dumped ``real_vid`` and
``inp_pred_vid`` videos, reported per t and cumulatively past the context.
SSIM follows tf.image.ssim (11x11 gaussian, sigma 1.5, k1 0.01, k2 0.03,
max_val 1); MS-SSIM the standard 5-scale power weights.

The gaussian filter runs as two separable passes of explicit float32
multiply-adds, so it is full float32 on the card whatever the global TF32
settings say (the JAX package pins ``Precision.HIGHEST`` for the same).

CLI, on the card unless ``--device cpu`` is given:
  python -m waldo_tpu_torch.eval.metrics VID_TAG VID_LENGTH VID_CONTEXT \\
      [--results_root results] [--metrics ssim psnr msssim] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np
import torch

from ..utils import resolve_device

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss_1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2(img: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    """img (B,H,W,C) float32, valid depthwise filter by outer(g, g)."""
    k = len(g)
    oh, ow = img.shape[1] - k + 1, img.shape[2] - k + 1
    rows = sum(float(g[i]) * img[:, i: i + oh] for i in range(k))
    return sum(float(g[j]) * rows[:, :, j: j + ow] for j in range(k))


def _ssim_per_channel(a, b, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    g = _gauss_1d(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _filter2(a, g)
    mu_b = _filter2(b, g)
    sigma_aa = _filter2(a * a, g) - mu_a ** 2
    sigma_bb = _filter2(b * b, g) - mu_b ** 2
    sigma_ab = _filter2(a * b, g) - mu_a * mu_b
    luminance = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return (luminance * cs).mean(dim=(1, 2)), cs.mean(dim=(1, 2))


def ssim(a, b, max_val=1.0):
    """a, b (B,H,W,C) in [0, max_val] -> (B,) (tf.image.ssim semantics)."""
    s, _ = _ssim_per_channel(a.float(), b.float(), max_val)
    return s.mean(-1)


def psnr(a, b, max_val=1.0):
    mse = ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _pool2(x):
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) / 4


def ms_ssim(a, b, max_val=1.0, weights=_MSSSIM_WEIGHTS):
    """Multi-scale SSIM (B,H,W,C) -> (B,).

    tf.image.ssim_multiscale for inputs of 176 px or more (11 px filter x
    2^4); smaller inputs take fewer scales, with the weights renormalized,
    as in the JAX package (tf refuses such inputs)."""
    a, b = a.float(), b.float()
    max_levels = 1
    size = min(a.shape[1], a.shape[2])
    while max_levels < len(weights) and (size >> max_levels) >= 11:
        max_levels += 1
    weights = weights[:max_levels]
    levels = len(weights)
    w = torch.tensor(weights, dtype=torch.float32, device=a.device)
    w = w / w.sum() if levels < len(_MSSSIM_WEIGHTS) else w
    mcs = []
    for i in range(levels):
        s, cs = _ssim_per_channel(a, b, max_val)
        if i < levels - 1:
            mcs.append(cs.mean(-1).clamp(min=0.0))
            h2, w2 = a.shape[1] - a.shape[1] % 2, a.shape[2] - a.shape[2] % 2
            a, b = _pool2(a[:, :h2, :w2]), _pool2(b[:, :h2, :w2])
    vals = torch.stack(mcs + [s.mean(-1).clamp(min=0.0)], dim=-1)  # (B, levels)
    return torch.prod(vals ** w, dim=-1)


def load_video(path):
    """A dumped video (.avi, a folder of PNG frames, or what imageio reads)
    -> (T, H, W, 3) float64 in [0, 1]."""
    if os.path.isdir(path):
        import PIL.Image

        frames = [np.asarray(PIL.Image.open(p).convert("RGB"))
                  for p in sorted(glob(os.path.join(path, "*.png")))]
        return np.stack(frames) / 255.0
    if path.lower().endswith(".avi"):
        from ..data.video import open_video

        r = open_video(path)
        return r.read(0, r.num_frames) / 255.0
    import imageio.v2 as imageio

    return np.stack(imageio.mimread(path, memtest=False)) / 255.0


METRICS = {"ssim": ssim, "psnr": psnr, "msssim": ms_ssim}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("vid_tag", type=str)
    parser.add_argument("vid_length", type=int)
    parser.add_argument("vid_context", type=int)
    parser.add_argument("--results_root", type=str, default="results")
    parser.add_argument("--real_folder", type=str, default="real_vid")
    parser.add_argument("--fake_folder", type=str, default="inp_pred_vid")
    parser.add_argument("--metrics", type=str, nargs="+", default=["lpips", "msssim"])
    parser.add_argument("--batch_size", type=int, default=16,
                        help="accepted as the JAX CLI accepts it; frames are scored one by one")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    dist = sorted({"fid", "fvd"} & set(args.metrics))
    if dist:
        raise NotImplementedError(f"the distribution metrics {dist} are not ported yet "
                                  f"(ROADMAP.md queue 1 item 9)")

    lpips_fn = None
    if "lpips" in args.metrics:
        from .lpips import LPIPS

        lpips_fn = LPIPS.maybe_load("alex", device=dev)
        if lpips_fn is None:
            print("WARNING: LPIPS requested (the reference's default metric) but no "
                  f"converted weights at {LPIPS.weights_path()} - falling back to ssim. "
                  "Convert with waldo_tpu_torch.eval.lpips.convert_lpips_state_dict "
                  "(and numpy.savez).", file=sys.stderr, flush=True)
            args.metrics = [m for m in args.metrics if m != "lpips"]
            if not args.metrics:
                args.metrics = ["ssim", "msssim"]
            elif "ssim" not in args.metrics:
                args.metrics.insert(0, "ssim")

    folders = glob(os.path.join(args.results_root, f"*{args.vid_tag}"))
    if len(folders) != 1:
        raise ValueError(f"tag {args.vid_tag!r} names {len(folders)} result folders: {folders}")
    root = folders[0]

    def vid_files(folder):
        files = sorted(glob(os.path.join(root, folder, "*.mp4"))
                       + glob(os.path.join(root, folder, "*.avi")))
        return files or sorted(
            p for p in glob(os.path.join(root, folder, "*")) if os.path.isdir(p))

    real_files, fake_files = vid_files(args.real_folder), vid_files(args.fake_folder)
    if not real_files or len(real_files) != len(fake_files):
        raise ValueError(f"{root}: {len(real_files)} real and {len(fake_files)} fake videos")

    fns = {m: METRICS[m] for m in args.metrics if m != "lpips"}
    if "lpips" in args.metrics:
        # LPIPS takes [-1, 1]; the videos load in [0, 1]
        fns["lpips"] = lambda a, b: lpips_fn(a * 2 - 1, b * 2 - 1)
    per_t = {m: [[] for _ in range(args.vid_length)] for m in args.metrics}
    with torch.no_grad():
        for rf, ff in zip(real_files, fake_files):
            real, fake = load_video(rf), load_video(ff)
            t_max = min(args.vid_length, real.shape[0], fake.shape[0])
            for t in range(t_max):
                a = torch.from_numpy(real[None, t].astype(np.float32)).to(dev)
                bb = torch.from_numpy(fake[None, t].astype(np.float32)).to(dev)
                for m in args.metrics:
                    per_t[m][t].append(float(fns[m](bb, a)[0]))

    results = {}
    for m in args.metrics:
        for t in range(args.vid_length):
            vals = per_t[m][t]
            if vals:
                print(f"[{m}:{t}] : {np.mean(vals):.4f} +- {np.std(vals):.4f}")
            if t >= args.vid_context:
                cum = [v for tt in range(args.vid_context, t + 1) for v in per_t[m][tt]]
                print(f"[cum {m}:{t}] : {np.mean(cum):.4f} +- {np.std(cum):.4f}")
                results[f"cum_{m}"] = float(np.mean(cum))
    return results


if __name__ == "__main__":
    main()

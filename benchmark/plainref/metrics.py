"""The evaluator's frame metrics (the port's eval/metrics.py SSIM and
PSNR, copied): tf.image.ssim semantics, an 11x11 gaussian of sigma 1.5 as
two separable passes of explicit float32 multiply-adds."""
from __future__ import annotations

import numpy as np
import torch


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
    """a, b (B,H,W,C) in [0, max_val] -> (B,)."""
    s, _ = _ssim_per_channel(a.float(), b.float(), max_val)
    return s.mean(-1)


def psnr(a, b, max_val=1.0):
    mse = ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / mse)


def clip_metrics(out: dict, ctx_len: int) -> dict:
    """The evaluator's L1, PSNR and SSIM of one batch's predicted and
    reconstructed frames past the context, and of the fused ones (``inp_*``),
    as floats (the port's ``Evaluator._accumulate_metrics``)."""
    real = out["real_vid"].float()
    res = {}
    for name, key in [("pred", "pred_vid"), ("rec", "rec_vid"),
                      ("inp_pred", "inp_pred_vid"), ("inp_rec", "inp_rec_vid")]:
        if key not in out:
            continue
        v = out[key].float()
        t0 = ctx_len if v.shape[1] == real.shape[1] else 0
        a = ((v[:, t0:].clamp(-1, 1) + 1) / 2).reshape((-1,) + tuple(v.shape[2:]))
        b = ((real[:, t0:].clamp(-1, 1) + 1) / 2).reshape((-1,) + tuple(real.shape[2:]))
        res[f"l1_{name}"] = float((v[:, t0:] - real[:, t0:]).abs().mean())
        res[f"psnr_{name}"] = float(psnr(a, b).mean())
        res[f"ssim_{name}"] = float(ssim(a, b).mean())
    return res

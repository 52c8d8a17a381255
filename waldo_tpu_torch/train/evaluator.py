"""Inference and evaluation loop (counterpart of waldo_tpu/train/evaluator.py).

``Evaluator(cfg).run()`` runs ``vid_prediction`` (``Synthesizer.predict``,
then ``inpaint_with_mat`` when ``use_inpainter`` and ``use_mat_inpainter``
are set) over the eval split, dumps the real, reconstructed and predicted
videos under ``cfg.result_path/<name>/vid_<id>`` for the metrics CLI
(``python -m waldo_tpu_torch.eval.metrics``), and returns the means of L1,
PSNR and SSIM over the predicted and reconstructed frames. The nets restore
from the port's ``.npz`` checkpoint slots (``--s_load_path``,
``--s_pg_load_path``, ``--s_ii_load_path``).

Under torchrun (cli/test.py) it runs data-parallel, one process per card
(parallel/mesh.py): rank r of W predicts rows [r B/W, (r+1) B/W) of each
global batch of B clips and dumps them as ``(i W + r) B/W + b`` for its row
b of batch i, which is world 1's id ``i B + r B/W + b`` of the same clip;
``run`` returns the metric means over the ranks, the same dict on every
rank as at world 1. ``iteration_times`` stays the rank's own. On a
(data, seq) grid r and W are the data coordinate and the data axis's size
D: the S ranks of a data coordinate predict its rows alike, on whole token
streams (the JAX evaluator registers no active mesh, so nothing is
sharded), the first of them dumps them, and the means are world D's.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..convert import from_jax, to_jax
from ..data import DataLoader, create_dataset
from ..eval.metrics import psnr, ssim
from ..models import Synthesizer
from ..parallel import mesh
from ..utils.heartbeat import beat
from ..utils.profiling import annotate
from .checkpoint import CheckpointManager, normalize_which

DUMPS = ("real_vid", "rec_vid", "pred_vid", "inp_rec_vid", "inp_pred_vid")
# the prediction's intermediate maps, which are neither dumped nor scored
_INTERMEDIATE = ("pred_grids", "pred_raw_output", "pred_alpha", "pred_alpha_ctx", "pred_flow")


def save_video_frames(vid: np.ndarray, path: str, fps: int = 4) -> str:
    """vid (T, H, W, 3) in [-1, 1] -> ``path`` (.mp4) through imageio where it
    can write one, else an MJPG .avi beside it (data/video.py's writer),
    else a folder of PNG frames; returns the format written: "mp4", "avi"
    or "png"."""
    arr = ((np.clip(vid, -1, 1) + 1) / 2 * 255).astype(np.uint8)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, list(arr), fps=fps, macro_block_size=1)
        return "mp4"
    except (ImportError, ValueError, OSError, RuntimeError):
        pass  # no imageio, or no backend that writes mp4
    try:
        from ..data.video import write_mjpeg_avi

        write_mjpeg_avi(path[:-4] + ".avi", arr, fps=fps)
        return "avi"
    except (ImportError, OSError):
        import PIL.Image

        folder = path[:-4]
        os.makedirs(folder, exist_ok=True)
        for t, frame in enumerate(arr):
            PIL.Image.fromarray(frame).save(os.path.join(folder, f"{t:03d}.png"))
        return "png"


class Evaluator:
    def __init__(self, cfg: Config, device="cuda"):
        device = mesh.setup(cfg, device)
        self.cfg = cfg
        self.syn = Synthesizer(cfg, device=device, seed=cfg.seed)
        self.device = self.syn.device
        self.ckpt = CheckpointManager(cfg.checkpoint_path)
        m = cfg.model
        trees = to_jax(self.syn)
        restored = False
        for label, load_path, which in [("pe", m.load_path, m.which_iter),
                                        ("pg", m.pg_load_path, m.pg_iter),
                                        ("ii", m.ii_load_path, m.ii_iter)]:
            if label in trees and load_path is not None:
                trees[label] = self.ckpt.restore(label, trees[label],
                                                 which=normalize_which(which),
                                                 load_path=load_path)
                restored = True
        if restored:
            from_jax(trees, self.syn)
        self.inpainter = None
        if m.use_inpainter and m.use_mat_inpainter:
            from ..models.mat import MatInpainter

            self.inpainter = MatInpainter(m.inpainter_path, device=self.device, seed=cfg.seed)
        self.dump_format: Optional[str] = None
        # host seconds of each iteration of the last run: waiting on the
        # loader, the copy + predict + metrics + copy back (``step``), the
        # dumps
        self.iteration_times: List[Dict[str, float]] = []

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The videos of one batch of device tensors: predict, then the MAT
        post-processing when it is on."""
        cfg = self.cfg
        out = self.syn.predict(batch)
        if self.inpainter is not None and "pred_grids" in out:
            from ..models.mat_pipeline import inpaint_with_mat

            out["inp_pred_vid"] = inpaint_with_mat(
                cfg, self.syn.warper, self.syn.wif, self.inpainter, out["pred_raw_output"],
                out["pred_alpha"], out["pred_alpha_ctx"], batch["vid"], out["pred_flow"],
                cfg.model.ctx_len, out["pred_grids"])
        for k in _INTERMEDIATE:
            out.pop(k, None)
        return out

    def run(self, dump: bool = True, max_batches: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        if max_batches is None:
            max_batches = cfg.max_batch_eval_vid
        ds = create_dataset(cfg, phase=cfg.data.eval_phase)
        loader = iter(DataLoader(ds, cfg.batch_size_vid, shuffle=False,
                                 num_workers=cfg.data.num_workers))
        os.makedirs(cfg.result_path, exist_ok=True)
        metrics: Dict[str, list] = {}
        self.iteration_times = []
        try:
            i = 0
            while max_batches is None or i < max_batches:
                if mesh.is_main():
                    beat(i)  # liveness signal for a supervisor's stall watchdog
                t0 = time.perf_counter()
                with annotate("eval/batch"):
                    batch = next(loader, None)
                if batch is None:
                    break
                loader_s = time.perf_counter() - t0
                predict_s, dump_s = self.step(i, batch, metrics, dump)
                self.iteration_times.append({"loader_s": loader_s, "predict_s": predict_s,
                                             "dump_s": dump_s})
                i += 1
        finally:
            loader.close()  # stops the loader's producer
        means = {k: float(np.mean(v)) for k, v in metrics.items()}
        return {k: float(v) for k, v in mesh.mean_over_ranks(means, self.device).items()}

    def step(self, i: int, batch, metrics: Dict[str, list], dump: bool = True):
        """One iteration on loader batch ``i`` (numpy arrays): its copy to the
        device, the predict, the metrics (appended to ``metrics``), the copy
        back and, with ``dump``, the dumps. Returns the host seconds of the
        copy + predict + metrics + copy back and of the dumps."""
        t0 = time.perf_counter()
        with annotate("eval/predict"):
            arrays = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                      for k, v in batch.items() if isinstance(v, np.ndarray)}
            out_dev = self.predict(arrays)
            self._accumulate_metrics(out_dev, metrics)
            out = {k: v.float().cpu().numpy() for k, v in out_dev.items()}
        del out_dev, arrays
        t1 = time.perf_counter()
        if dump:
            with annotate("eval/dump"):
                self._dump(out, i)
        return t1 - t0, time.perf_counter() - t1

    def _dump(self, out: Dict[str, np.ndarray], i: int) -> None:
        if not mesh.rows_writer():  # one rank of a data coordinate writes its rows
            return
        for name in DUMPS:
            if name not in out:
                continue
            folder = os.path.join(self.cfg.result_path, name)
            os.makedirs(folder, exist_ok=True)
            vids = out[name]
            for b in range(vids.shape[0]):
                # the JAX package's rank-aware id: world 1's for the same clip
                vid_id = (i * mesh.data_world() + mesh.data_rank()) * vids.shape[0] + b
                fmt = save_video_frames(vids[b], os.path.join(folder, f"vid_{vid_id:05d}.mp4"),
                                        fps=4)
                if self.dump_format is None:
                    self.dump_format = fmt
                    if mesh.is_main():
                        print(f"[eval] videos are dumped as {fmt} under "
                              f"{self.cfg.result_path}", flush=True)

    def _accumulate_metrics(self, out: Dict[str, torch.Tensor], metrics: Dict[str, list]):
        """L1, PSNR and SSIM of the predicted and reconstructed frames past
        the context, and of the fused ones (``inp_*``) when WIF is on."""
        real = out["real_vid"].float()
        tc = self.cfg.model.ctx_len
        for name, key in [("pred", "pred_vid"), ("rec", "rec_vid"),
                          ("inp_pred", "inp_pred_vid"), ("inp_rec", "inp_rec_vid")]:
            if key not in out:
                continue
            v = out[key].float()
            t0 = tc if v.shape[1] == real.shape[1] else 0
            a = ((v[:, t0:].clamp(-1, 1) + 1) / 2).reshape((-1,) + tuple(v.shape[2:]))
            b = ((real[:, t0:].clamp(-1, 1) + 1) / 2).reshape((-1,) + tuple(real.shape[2:]))
            metrics.setdefault(f"l1_{name}", []).append(
                float((v[:, t0:] - real[:, t0:]).abs().mean()))
            metrics.setdefault(f"psnr_{name}", []).append(float(psnr(a, b).mean()))
            metrics.setdefault(f"ssim_{name}", []).append(float(ssim(a, b).mean()))

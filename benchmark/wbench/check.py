"""What decides ``correct``: the plain reference (``plainref``) on the same
inputs and weights as the program, after the window, and the numbers that
compare the two.

Evaluation: for each clip the recorder kept, the reference predicts the
same clip and scores it; compared are the videos that reach ``rec_vid``,
``pred_vid``, ``inp_rec_vid`` and ``inp_pred_vid`` (LVD, FLP, the warper
with what K1 and K2 compute, WIF) and the evaluator's metrics.

Training: the reference follows the program's first steps from the same
weights on the same batches: the first step's loss, the norm of each
leaf's first gradient as Adam got it, and each leaf's first change against
the reference's (the norm of their difference, so that its direction
counts), by the worst leaf, against the reference's norm of that leaf or of
the median leaf, whichever is larger. Leaves whose first gradient in the
reference is under a thousandth of the median leaf's move by round-off
alone and are left out of the change.

The same functions give the readings the limits were set from (each
loop's ``readings``, run by ``calibrate.py``): the reference in a lower
precision, or with a fault, in the program's place.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from .flops import ModelFlops

VIDEO_KEYS = ("real_vid", "rec_vid", "pred_vid", "inp_rec_vid", "inp_pred_vid")


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and cuDNN in TF32 (``tf32``) or in full float32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def reference(cfg, weights, device):
    """The reference's nets on ``device`` with a copy of ``weights``; their
    parameters ask for gradients, as the program's do (some products take
    another kernel for such parameters, and round otherwise)."""
    from plainref.synthesizer import Reference

    ref = Reference(cfg, device)
    ref.load({k: {n: v.detach().clone().requires_grad_(True) for n, v in w.items()}
              for k, w in weights.items() if k in ref.nets()})
    return ref


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


# -- evaluation --


def reference_clip(ref, batch, device, observer=None, count_flops=False):
    """The reference's videos (host float32) and metrics of one batch, and
    the predict's model FLOPs when asked."""
    from plainref.metrics import clip_metrics
    from plainref.ops.grid_sample import observe

    flops = None
    with contextlib.ExitStack() as stack:
        if observer is not None:
            stack.enter_context(observe(observer))
        if count_flops:
            counter = stack.enter_context(ModelFlops())
        out = ref.predict(to_device(batch, device))
    if count_flops:
        flops = counter.total
    metrics = clip_metrics(out, ref.cfg.model.ctx_len)
    videos = {k: out[k].float() for k in VIDEO_KEYS if k in out}
    return videos, metrics, flops


def eval_numbers(got: Dict[str, np.ndarray], got_metrics: Dict[str, float],
                 want: Dict[str, torch.Tensor], want_metrics: Dict[str, float]) -> Dict[str, float]:
    """How far one clip's videos and metrics lie from the reference's:
    the largest and the mean absolute gap over the videos' elements, the
    share of elements more than 1e-3 apart, and the largest gap of a metric
    (PSNR relative to the reference's)."""
    res = {"vid_gap_max": 0.0, "vid_gap_mean": 0.0, "vid_share_1e-3": 0.0}
    for k, w in want.items():
        g = torch.as_tensor(got[k]).to(w.device)
        if g.shape != w.shape:
            raise ValueError(f"{k}: the program gave {tuple(g.shape)}, the reference "
                             f"{tuple(w.shape)}")
        d = (g.float() - w).abs()
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
        res["vid_gap_max"] = max(res["vid_gap_max"], float(d.max()))
        res["vid_gap_mean"] = max(res["vid_gap_mean"], float(d.mean()))
        res["vid_share_1e-3"] = max(res["vid_share_1e-3"], float((d > 1e-3).float().mean()))
    gaps = []
    for k, w in want_metrics.items():
        g = got_metrics[k]
        gap = abs(g - w) / (abs(w) if k.startswith("psnr") else 1.0)
        gaps.append(gap if np.isfinite(gap) else float("inf"))
    res["metric_gap"] = max(gaps) if gaps else 0.0
    return res


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


# -- training --


def reference_steps(cfg, weights, pool, n: int, device, net: str, loss: str,
                    tf32: bool = False, half_batch: bool = False, observer=None,
                    count_flops: bool = False) -> dict:
    """The reference's first ``n`` steps of the net ``net`` from ``weights``
    on the pool's batches (``it`` = 0, 1, ...), its loss the reference's
    method ``loss``, as the program's trainer takes them: each step's loss,
    the first gradient, the parameters after step 1 and after the last, and
    the first step's model FLOPs (forward and backward) when asked. With
    ``half_batch`` the loss is the mean over the first half of each batch
    (a fault, for the readings); ``observer`` sees the first step's
    samples."""
    from plainref.adam import Adam
    from plainref.ops.grid_sample import observe

    ref = reference(cfg, weights, device)
    module = ref.nets()[net]
    names = [name for name, _ in module.named_parameters()]
    params = [p for _, p in module.named_parameters()]
    loss_of = getattr(ref, loss)
    opt = Adam(params, cfg.model)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    losses, grad1, params1, flops = [], None, None, None
    with precision(tf32):
        for k in range(n):
            batch = pool[k % len(pool)]
            if half_batch:
                batch = {key: v[: v.shape[0] // 2] for key, v in batch.items()}
            with contextlib.ExitStack() as stack:
                if observer is not None and k == 0:
                    stack.enter_context(observe(observer))
                if count_flops and k == 0:
                    counter = stack.enter_context(ModelFlops())
                loss_k, _ = loss_of(batch, k, generator=gen)
                grads = torch.autograd.grad(loss_k, params)
            if count_flops and k == 0:
                flops = counter.total
            if k == 0:
                grad1 = [g.detach().clone() for g in grads]
            opt.step([g.detach() for g in grads])
            if k == 0:
                params1 = [p.detach().clone() for p in params]
            losses.append(float(loss_k.detach()))
            del loss_k, grads
    return {"losses": losses, "grad1": grad1, "params1": params1,
            "params": [p.detach() for p in params], "names": names, "flops": flops}


def train_numbers(got: dict, want: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """How far the program's first steps lie from the reference's: the
    relative gap of the first step's loss (and the largest over the steps),
    and by the worst leaf the gap of the first gradient's norm and the
    first step's change against the reference's (the norm of their
    difference), and the gap of the norm of the change after all the
    followed steps (with the median leaf's); ``start`` holds the weights
    both began from. The later steps are read, not compared: with Adam's
    first update a gradient element's sign, an element near 0 that two
    roundings of the backward sign otherwise moves by 2 lr, and steps 2 and
    3 carry that through the inversions' hard decisions."""
    if got["names"] != want["names"]:
        raise ValueError("the program's trained leaves differ from the reference's")
    loss = [abs(g - w) / abs(w) if np.isfinite(g) else float("inf")
            for g, w in zip(got["losses"], want["losses"])]
    res = {"loss1_gap": loss[0], "loss_gap": max(loss)}
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))
    gn_w = np.array([norm(g) for g in want["grad1"]])
    gn_g = np.array([norm(g) for g in got["grad1"]])
    med = float(np.median(gn_w))
    res["grad_gap"] = float(np.nanmax(np.where(np.isfinite(gn_g),
                                               np.abs(gn_g - gn_w) / np.maximum(gn_w, med),
                                               np.inf)))
    moved = gn_w >= 1e-3 * med

    def change_gaps(key):
        dn_w = np.array([norm(p - start[n]) for n, p in zip(want["names"], want[key])])
        dn_g = np.array([norm(p - start[n]) for n, p in zip(got["names"], got[key])])
        med_d = float(np.median(dn_w[moved]))
        gap = np.where(np.isfinite(dn_g), np.abs(dn_g - dn_w) / np.maximum(dn_w, med_d), np.inf)
        return gap[moved]

    d1_w = [p - start[n] for n, p in zip(want["names"], want["params1"])]
    med_1 = float(np.median(np.array([norm(d) for d in d1_w])[moved]))
    step1 = np.array([norm(g - w) / max(norm(d), med_1) if torch.isfinite(g).all() else np.inf
                      for g, w, d in zip(got["params1"], want["params1"], d1_w)])
    res["step1_gap"] = float(np.max(step1[moved]))
    gap = change_gaps("params")
    res["change_gap"] = float(np.max(gap))
    res["change_gap_median"] = float(np.median(gap))
    res["leaves_left_out"] = int((~moved).sum())
    return res

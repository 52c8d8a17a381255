#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (waldo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--iters N] [--out results.json] [--profile DIR]
    python3 chip_smoke.py --k1-stress REPS [--k1-cases N]
    python3 chip_smoke.py --k2-fwd
    python3 chip_smoke.py --gan [--out results.json]
    python3 chip_smoke.py --seq

Phases, in order; any failure exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit and the
     TF32 settings (both set off: the checks below are float32);
  2. build: compiles every CUDA kernel of the port from its sources, and
     the yardsticks (the earlier designs of the two backwards and of K2's
     shared-grid forward); prints each kernel's registers and spills and
     the atomics in the backwards' SASS;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at ragged small shapes (bias_act: all nine
     activations, with and without bias, gain and clamp); the samplers'
     pre-pass (planes and nonzero boxes) for equality; the fused warp and the
     per-channel sampler on dense and object-sparse inputs and on the skip's
     edge cases (an all-zero plane, a layer grid wholly out of range, boxes
     touching each border, a texel reached by one tap only, C=32); K2's
     shared-grid forward on its edge cases (k2_edge_checks: few and many
     channels, tp_sz 1 and 3, ragged tiles, both window copies, holes,
     shrinks past the window cap, bf16, outputs filled with NaN first) and
     its autograd route;
  4. main path: the flagship predict (Cityscapes 256x512, 14 frames with 4
     of context, bf16 nets, "fast" sampling, iterative inversion) with
     seeded random weights; checks the kernel launch counts and the
     outputs, times predicted frames/s with CUDA events, and runs a small
     float32 predict on the card against the same predict on the CPU;
  5. MAT path (scripts/cityscapes/test_mat.sh): the flagship predict with
     the test_mat flags, then inpaint_with_mat with a 512 MatInpainter
     (seeded random weights; MAT at its published widths on 512x512
     crops); checks the launch counts (the warp with its ghost mask, the
     sampler, bias_act once per MAT layer) and the output, times ms per clip
     over MAT_CLIPS clips and predicted frames/s, and runs a small float32
     chain (MAT at 128) on the card against the same chain on the CPU;
  6. kernel timings at the main paths' shapes beside their bounds (the warp
     with and without its ghost mask, as the two paths launch it, on dense
     and object-sparse inputs and on the inputs the flagship predict hands
     it, with their share of zero samples; the pre-pass alone);
  7. training path (scripts/cityscapes/train_lvd.sh, LVD): its flags parsed
     by the port's parse_cli, on synthetic clips, at full width (B=8, 14
     frames of 128x256, embed 512, 16 objects, the scatter inversion);
     Trainer.run for a few iterations (launch counts: each sample's forward
     and backward kernel and the pre-pass once a step; finite loss, no
     skipped step, parameters moved, the latest checkpoint restores equal),
     ms per step and clips/s on one fixed batch, peak memory; the two
     samples' forward and backward kernels against their plain versions at
     the path's shapes (dense and object-sparse inputs, an all-zero plane,
     grids on the pixel lattice and wholly out of range, a zoom; for the
     K2' backward also planes over its shared-memory cap; for the K2
     backward also a shrink whose texture windows exceed its cap, ragged
     shapes, tp_sz > 1 and a grad_out off 16-byte alignment) and timed
     beside their bounds and ATen's backward; the K2' backward also split
     into its wrapper, kernel, kernel without grad_img and the wrapper's
     other passes; each backward timed in turns against its earlier design
     (csrc/yardstick/), on those inputs and on the inputs a training step
     hands it (K2's from a step with pxl_vid; with their layout and share of
     zero output gradient); a small float32 step, card vs CPU;
  8. FLP training (scripts/cityscapes/train_flp.sh): its flags parsed, on
     synthetic clips, at full width (B=4, 14 frames of 128x256, embed 512,
     16 objects), its frozen LVD teacher restored from phase 7's run;
     Trainer.run (no kernel launch: the path has none; finite loss, no
     skipped step, every FLP parameter moved and no LVD one, the latest
     slots restore equal), ms per step, clips/s and peak memory on a fixed
     batch, a small float32 step card vs CPU;
  9. WIF training (scripts/cityscapes/train_wif.sh): the same at its full
     width (B=8, 5 frames loaded at 512x1024, UNet depth 6, embed 512), (a)
     without LPIPS weights (the warning; L1 only) and (b) with seeded random
     VGG16 LPIPS weights; launch counts (the decode's K2' and K2 batch-mode
     sample and the pre-pass once a step, no backward: the decode runs
     under no_grad); the two samples against their plain versions on the
     inputs one step hands them, timed beside their bounds and
     F.grid_sample;
 10. test.sh and test_mat.sh (scripts/cityscapes/) through the test CLI,
     waldo_tpu_torch.cli.test.main, on a Cityscapes-format tree written at
     the scripts' geometry (3 sequences of 30 frames at 512x1024, labels,
     flows at 128x256; Cityscapes itself is not in the repo), the three nets
     restored from phases 7-9's runs: the slots restore equal, strict
     launch counts (per predict K1 with its ghost mask and K2 at N=56 and
     N=40, the pre-pass twice; test_mat.sh also bias_act once per MAT layer
     per forward), every dump written (each real_vid dump equal to the
     loader's frames through the dump format) and finite, the metrics
     finite; ms per predict at B=1, per evaluator iteration (with its waits
     on the loader and the dumps) and per MAT clip, peak memory; the
     metrics CLI (waldo_tpu_torch.eval.metrics TAG 14 4) on the dumps, with
     its LPIPS fallback; K1 with its mask, K2 and the pre-pass at 512x1024
     on the inputs one predict hands them and on dense inputs, against
     their plain versions and timed beside their bounds (K2 beside
     F.grid_sample), with their inputs' share of zero samples; a small
     float32 evaluator card vs CPU; K2's batch mode on the first of each
     shape of the MAT warps test_mat.sh handed it, against its plain
     version and timed beside its bound and F.grid_sample.
 11. converters: reference-format {pe,pg,ii}_net_0.pth files written from the
     flagship's seeded weights (the port's rules run backwards) and loaded
     by load_reference_checkpoints: every parameter bitwise equal, one
     flagship predict equal to the source's; a MAT persistence pickle at 512
     written from a MatInpainter's weights, converted by
     convert_mat_weights and loaded by MatInpainter(weights_path=...): one
     forward equal to the source's, bias_act once per MAT layer; each
     conversion timed.
 12. data parallelism over processes (phase_dist, also alone with --dist).
 13. WIF adversarial training: train_wif.sh's flags with the GAN losses
     ("sharp_vid lpips_vid adv dis") and the adaptive lambda, at the
     script's width (B=8, 5 frames loaded at 512x1024, UNet depth 6, embed
     512, float32 nets, "fast" sampling), phase 7's teacher and phase 9's
     seeded random LPIPS weights: Trainer.run (strict launch counts: K2',
     K2's batch mode and the pre-pass once in each G and each D step), the G
     step (adv with lambda) and the D step timed on one batch, phase 9b's
     plain WIF step timed in turns with the G step, a GAN iteration (two
     loader batches) with the script's 8 workers, peak memory; K2', K2 and
     the pre-pass against their plain versions on the D step's decode,
     timed beside their bounds; the training CLI under torchrun (NCCL, world
     1); Synthesizer.decode_layer on phase 7's batch against its plain
     samples; small float32 G and D steps card vs CPU, lambda included.
 14. sequence sharding (phase_seq, also alone with --seq): two gloo ranks
     of a 1 x 2 ("data", "seq") grid on card 0 (torchrun, seq_worker) step
     (a) LVD at train_lvd.sh's width and (b) FLP at train_flp.sh's from
     (a)'s saved LVD, both at B = 4 (both ranks hold the whole batch on
     one card), SEQ_STEPS steps through Trainer.step, the seq ranks
     splitting the tokens of LVD's pose estimator and layer estimator
     (FLP's encoder, 255 tokens, stays whole): strict launch counts per
     step, the ranks' parameters bitwise equal after each step, the loss
     and parameters against world 1 at B = 4 in this process, ms a step
     against world 1's, the gloo bytes a step, each rank's peak memory;
     (c) where there are two cards or more, (a) with NCCL, a card a rank,
     on a W/2 x 2 grid at train_lvd.sh's B = 8; (d) the VGG19 loss card vs
     CPU and timed on 8 frame pairs of 512x1024; (e) a MAT Generator at
     128 with truncation_cutoff, update_w_avg, return_stg1 and a bias-free
     layer card vs CPU, bias_act once per layer call.
Phases 7-9 also time the training loop's iterations (a batch from the
prefetching loader, its copy, one step) with the script's loader workers
and (phases 7, 8) with one, beside the host's time to make one batch's
clips; they run
Trainer.run and those iterations with the trainer's logger off, and then
check the logging on a fixed batch (logging_check): Synthesizer.visuals
alone (ms, launches, peak memory), logged against unlogged iterations in
turns with the logging's host time split (visuals, copy, rendering,
writing), the event files read back with every visual tag. Phase 7 also
traces a step by profiling.trace, holds memory_stats() against the
allocator's peak and a small float32 visuals of each mode, card against
CPU. Phase
10 also runs the metrics CLI with fid and fvd on test.sh's dumps, without
weights (rfid, rfvd_proxy) and with seeded random Inception and I3D weight
files (fid, fvd), and times both extractors on the dumps.
With --profile DIR, phases 4, 5, 7, 8, 9 and 10 also trace one predict, one
MAT clip, one training step of each net, one loop iteration of each and one
evaluator iteration with torch.profiler and write the device time per span
and per kernel, and the device's idle share, to
DIR/profile{,_mat,_train,_flp,_wif_*,*_iteration}.json and .txt.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
Every K2 forward row (the shared-grid sample, tp_sz > 1 and batch mode)
gives ms a call of its wrapper (back-to-back calls: the host's time where
that is the larger) and ms on the device (launches captured in a CUDA graph
and replayed), beside its first design (csrc/yardstick/grid_sample_fwd_pr1.cu)
timed in turns on the device and F.grid_sample a call and on the device;
the MAT warps' rows also split a call's host time (k2_host_split).
With --k1-stress REPS only phase 1 runs, then phase 3's flagship cases of
the fused warp REPS times each into outputs that start as NaN (k1_stress);
the last line is its JSON summary.
With --gan only phases 1, 2 and 13 run, the teacher a seeded LVD slot at
train_lvd.sh's flags (gan_teacher); the last line is its JSON summary.
With --seq only phases 1, 2 and 14 run; the last line is its JSON summary.
With --k2-fwd only phases 1 and 2 run, then K2's forward on its edge cases
and at every row's shapes on dense inputs (k2_fwd_study, with the L2 test:
a texture shared by tp_sz 14 grid rows against its 56 copies); the last
line is its JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np

# (memory bytes/s, float32 CUDA-core flop/s), dense, published for each card
# the port is run on, by the name torch.cuda.get_device_name gives it
_CARDS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),  # H100 SXM
}

K1_SOURCE = "waldo_tpu_torch/csrc/warp_alpha_ctx.cu"
K2_SOURCE = "waldo_tpu_torch/csrc/grid_sample.cu"
K3_SOURCE = "waldo_tpu_torch/csrc/bias_act.cu"
PRE_SOURCE = "waldo_tpu_torch/csrc/planes.cu"
K1_REPLACES = "waldo_tpu/ops/pallas/grid_sample.py:842"
K2_REPLACES = "waldo_tpu/ops/pallas/grid_sample.py:470"
K3_REPLACES = "waldo_tpu/ops/pallas/bias_act.py:71"
BWD_SOURCE = "waldo_tpu_torch/csrc/grid_sample_bwd.cu"
# the backwards replace the VJPs the JAX package attaches to grid_sample_pallas
# in its two modes (_pallas_bwd and _pallas_mg_bwd, XLA code on the TPU)
K2_BWD_REPLACES = "waldo_tpu/ops/grid_sample.py:166"
K2PC_BWD_REPLACES = "waldo_tpu/ops/grid_sample.py:219"
# the first designs of the two backwards, kept as yardsticks under
# waldo_tpu_torch/csrc/: the per-channel backward's row strips and the shared
# backward's block-wide walk
ROWS_BWD_SOURCE = "yardstick/grid_sample_bwd_rows.cu"
SHARED_BWD_FIRST_SOURCE = "yardstick/grid_sample_shared_bwd_pr4.cu"
# K2's shared-grid forward in its first design, the yardstick of its tile kernel
FWD_FIRST_SOURCE = "yardstick/grid_sample_fwd_pr1.cu"
TRAIN_SCRIPT = "scripts/cityscapes/train_lvd.sh"
FLP_SCRIPT = "scripts/cityscapes/train_flp.sh"
WIF_SCRIPT = "scripts/cityscapes/train_wif.sh"
TEST_SCRIPT = "scripts/cityscapes/test.sh"
TEST_MAT_SCRIPT = "scripts/cityscapes/test_mat.sh"
EVAL_CLIPS = 3  # test.sh clips of phase 10, one a Cityscapes-format sequence
EVAL_MAT_CLIPS = 2  # test_mat.sh clips of phase 10
TRAIN_ITERS = 3  # Trainer.run iterations of each training phase
TRAIN_TIMED = 5  # timed steps on one fixed batch
LOADER_ITERS = 3  # timed loader iterations (batch, copy, step) per worker count
LOG_TURNS = 2  # logged and unlogged iterations timed in turns, of each
# the pre-pass computes on the card what _skip_flags computes for the TPU
# kernels (and the permute copy K1's wrapper made before)
PRE_REPLACES = "waldo_tpu/ops/pallas/grid_sample.py:555"
# MAT's largest bias_act call: FirstStage conv_first and the last
# DecStyleBlock at 512x512, 180 channels
K3_SHAPE = (1, 512, 512, 180)
# timed test_mat clips (one clip takes ~2 s on an H100)
MAT_CLIPS = 3
# float32 kernel vs float32 plain version: the same arithmetic summed in
# another order (and, for the fused warp, a C-term product), ~1e-6 apart
TOL_F32 = 1e-4
# bf16 textures: both sides round one float32 result to bf16, which may
# land one bf16 step (2^-8 relative) apart
TOL_BF16 = 2 ** -7


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_rates(name):
    if name not in _CARDS:
        raise RuntimeError(f"no memory and float32 rates for the card {name!r}: "
                           f"add its published rates to _CARDS")
    return _CARDS[name]


def bound(card_name, nbytes, nops):
    """The least time (ms) the card could take: bytes over its memory rate or
    float32 operations over its peak, whichever is larger, and which."""
    bw, fp32 = card_rates(card_name)
    tb, to = nbytes / bw * 1e3, nops / fp32 * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def cuda_time(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def smooth_grids(rng, rows, layers, gh, gw, dev, hole_frac=0.05):
    """Per-(row, layer) random affine warps of the pixel-center grid (the
    smooth TPS-like motion the predict path feeds its samplers), with a
    share of pixels set to the inverse warp's far-out hole value 4.0.
    Built on the device; (rows, layers, gh, gw, 2) float32."""
    import torch
    from waldo_tpu_torch.ops import get_grid

    base = torch.as_tensor(get_grid(gh, gw).reshape(-1, 2), device=dev)
    a = np.eye(2, dtype=np.float32) + rng.uniform(-0.1, 0.1, (rows, layers, 2, 2))
    t = rng.uniform(-0.3, 0.3, (rows, layers, 1, 2))
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    g = torch.einsum("pc,rlcd->rlpd", base, a) + t
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))
    g[torch.rand(g.shape[:3], generator=gen, device=dev) < hole_frac] = 4.0
    return g.reshape(rows, layers, gh, gw, 2).contiguous()


def sparse_alpha(rng, f, h, w, c, dev):
    """Object-sparse layer alphas (F, H, W, C), as the predict path's are:
    layer 0 (the background) dense, each object layer nonzero only inside
    one random rotated rectangle covering 3-8 % of the plane. Built on the
    device."""
    import torch

    alpha = torch.zeros(f, h, w, c, device=dev)
    alpha[..., 0] = torch.from_numpy(rng.rand(f, h, w).astype(np.float32)).to(dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + 0.5
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] + 0.5
    for i in range(f):
        for k in range(1, c):
            area = rng.uniform(0.03, 0.08) * h * w
            aspect, ang = rng.uniform(0.5, 2), rng.uniform(0, np.pi)
            a, b = np.sqrt(area * aspect) / 2, np.sqrt(area / aspect) / 2
            r = max(a, b)
            cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
            u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
            v = (yy - cy) * np.cos(ang) - (xx - cx) * np.sin(ang)
            inside = (u.abs() <= a) & (v.abs() <= b)
            vals = torch.from_numpy(rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)).to(dev)
            alpha[i, :, :, k] = vals * inside
    return alpha


def k1_inputs(rng, f, h, w, c, tp, tc, with_io, dev, sparse=False):
    import torch

    n = f * tp
    alpha = (sparse_alpha(rng, f, h, w, c, dev) if sparse
             else torch.from_numpy(rng.rand(f, h, w, c).astype(np.float32)).to(dev))
    occ = rng.rand(n, c, c).astype(np.float32)
    io = (rng.rand((n // (tc * tp)) * tp, c, h, w) > 0.3).astype(np.float32) if with_io else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return alpha, smooth_grids(rng, n, c, h, w, dev), to(occ), to(io)


def skip_edge_inputs(rng, f, h, w, rows, dev):
    """Texture (F, H, W, 8) and per-layer grids (F*rows, 8, H, W, 2) for the
    sparsity skip's edge cases, one per layer: 0 dense; 1 all zero; 2 dense
    with its grid wholly out of range; 3-6 a nonzero block touching the top,
    bottom, left and right border; 7 one nonzero texel, sampled half a texel
    off the pixel centers, so that each of its four neighbouring samples
    reaches it with one tap only."""
    import torch
    from waldo_tpu_torch.ops import get_grid

    tex = torch.zeros(f, h, w, 8, device=dev)
    tex[..., 0] = torch.from_numpy(rng.rand(f, h, w).astype(np.float32)).to(dev)
    tex[..., 2] = torch.from_numpy(rng.rand(f, h, w).astype(np.float32) + 0.1).to(dev)
    blk = lambda *shape: torch.from_numpy(rng.rand(*shape).astype(np.float32) + 0.1).to(dev)
    tex[:, :3, w // 4: w // 2, 3] = blk(f, 3, w // 2 - w // 4)
    tex[:, -2:, w // 3: w // 2, 4] = blk(f, 2, w // 2 - w // 3)
    tex[:, h // 4: h // 2, :2, 5] = blk(f, h // 2 - h // 4, 2)
    tex[:, h // 3: h // 2, -3:, 6] = blk(f, h // 2 - h // 3, 3)
    tex[:, h // 2, w // 2, 7] = 0.9
    n = f * rows
    grids = smooth_grids(rng, n, 8, h, w, dev)
    grids[:, 2] += 3.0
    base = torch.as_tensor(get_grid(h, w), device=dev)
    grids[:, 7] = base + torch.tensor([1.0 / w, 1.0 / h], device=dev)
    return tex, grids.contiguous()


def k2_inputs(rng, f, h, w, c, tp, ho, wo, dev, dtype=None):
    import torch

    img = torch.from_numpy(rng.rand(f, h, w, c).astype(np.float32) * 2 - 1).to(dev)
    if dtype is not None:
        img = img.to(dtype)
    grid = smooth_grids(rng, f * tp, 1, ho, wo, dev)[:, 0].contiguous()
    return img, grid


def write_cityscapes_tree(root, true_dim, flow_dim, n_seqs, n_frames=30, split="val",
                          lyt_model="deeplabv3", flow_model="raft", num_cls=20, seed=0):
    """A Cityscapes-format tree under ``root`` at true_dim x 2*true_dim, the
    layout and flow trees beside it: ``n_seqs`` sequences of ``n_frames``
    frames of smooth moving content (a drifting sinusoid texture over a
    two-class ground, and 2-3 moving rectangles of other classes), labels as
    8-bit PNGs of class ids below ``num_cls`` and .flo files at flow_dim x
    2*flow_dim holding each frame's displacement from the frame before, in
    the flow file's pixels (0 at the first frame). Returns the frame
    folder."""
    import PIL.Image
    from waldo_tpu_torch.data import write_flo

    h, w = true_dim, 2 * true_dim
    fh, fw = flow_dim, 2 * flow_dim
    sfx = "" if true_dim == 1024 else f"_{true_dim}"
    dirs = {"rgb": f"leftImg8bit_sequence{sfx}", "lyt": f"leftImg8bit_sequence_{lyt_model}{sfx}",
            "flow": f"leftImg8bit_sequence_{flow_model}_{flow_dim}"}
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fy, fx = np.mgrid[0:fh, 0:fw].astype(np.float32)
    for s in range(n_seqs):
        rng = np.random.RandomState(seed + s)
        freq = (rng.rand(4) * 0.05 + 0.01) * 512 / h
        phase, slope, amp = rng.rand(4) * 6.28, rng.rand(4) * 2 - 1, rng.rand(4, 3) * 0.2
        vel = rng.randn(2).astype(np.float32) * 0.004 * w  # background, px per frame
        objs = [dict(c=rng.rand(2) * (w, h), v=rng.randn(2) * 0.006 * w,
                     half=(rng.rand(2) * 0.08 + 0.04) * (w, h), rgb=rng.rand(3) * 255,
                     cls=int(rng.randint(2, num_cls))) for _ in range(rng.randint(2, 4))]
        name = f"smoke_{s:06d}"
        for k in range(n_frames):
            ox, oy = vel * k
            tex = sum(amp[i] * np.sin(freq[i] * ((xx + ox) + slope[i] * (yy + oy))
                                      + phase[i])[..., None] for i in range(4))
            img = np.clip((0.5 + tex) * 255, 0, 255)
            lab = np.where(yy > h * 0.55, 0, 1).astype(np.uint8)
            fl = np.broadcast_to(-vel * fw / w, (fh, fw, 2)).copy()
            for o in objs:
                cx, cy = o["c"] + o["v"] * k
                m = (np.abs(xx - cx) < o["half"][0]) & (np.abs(yy - cy) < o["half"][1])
                img[m] = o["rgb"]
                lab[m] = o["cls"]
                mf = ((np.abs(fx * w / fw - cx) < o["half"][0])
                      & (np.abs(fy * h / fh - cy) < o["half"][1]))
                fl[mf] = -o["v"] * fw / w
            stem = f"{name}_{k:06d}_leftImg8bit"
            paths = {key: os.path.join(root, d, split, "smoke") for key, d in dirs.items()}
            for p in paths.values():
                os.makedirs(p, exist_ok=True)
            PIL.Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(paths["rgb"], stem + ".png"), compress_level=1)
            PIL.Image.fromarray(lab).save(os.path.join(paths["lyt"], stem + ".png"),
                                          compress_level=1)
            write_flo(os.path.join(paths["flow"], stem + ".flo"),
                      fl if k > 0 else np.zeros_like(fl))
    return os.path.join(root, dirs["rgb"])


def reference_state_dict(syn, net):
    """The reference's state dict of ``net`` ('pe', 'pg' or 'ii') holding
    the port synthesizer's weights: each parameter under the rules' torch
    name and the reference's layout (the port's own layout: both are
    torch's), and the buffers the nets recompute (``expected_buffers``)."""
    import torch
    from waldo_tpu_torch.convert import _convert_leaf, _flatten, to_jax
    from waldo_tpu_torch.models.convert import _RULES, expected_buffers

    leaves = _flatten(to_jax(syn)[net]["params"])
    sd = {tkey: torch.from_numpy(np.ascontiguousarray(_convert_leaf(leaves[fpath], kind)))
          for tkey, fpath, kind in _RULES[net](syn.cfg)}
    sd.update({k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in expected_buffers(syn.cfg, net).items()})
    return sd


# the port's MAT names (the flax tree's) -> the reference's torch names: the
# inverse of waldo_tpu_torch.models.mat.convert's _RULES, applied in order
_MAT_TORCH_NAMES = [
    (r"enc\.b(\d+)\.", lambda m: f"enc.EncConv_Block_{2 ** int(m.group(1))}x"
                                 f"{2 ** int(m.group(1))}."),
    (r"first_stage\.tran([34])\.upsample\.", r"first_stage.tran\1.downsample."),
    (r"first_stage\.tran(\d+)\.", r"first_stage.tran.\1."),
    (r"\.block(\d+)\.", r".blocks.\1."),
    (r"\.mlp_fc(\d)", r".mlp.fc\1"),
    (r"first_stage\.(enc_conv|down_conv|dec_conv)(\d+)\.", r"first_stage.\1.\2."),
    (r"to_style\.conv(\d+)\.", r"to_style.conv.\1."),
]


def mat_torch_key(port_key):
    """The reference's torch state-dict key of a port MAT Generator key."""
    import re

    for pat, rep in _MAT_TORCH_NAMES:
        port_key = re.sub(pat, rep, port_key)
    return port_key


def mat_reference_state_dict(net):
    """The reference's state dict of the port MAT Generator ``net``: torch
    names, modulated convolutions' weights as (1,O,I,kh,kw), every other
    tensor in the port's (torch's) layout, the resampling filters too."""
    from waldo_tpu_torch.models.mat.basic import ModulatedConv2d

    modulated = {f"{name}.weight" for name, m in net.named_modules()
                 if isinstance(m, ModulatedConv2d)}
    return {mat_torch_key(k): (v[None] if k in modulated else v).detach().cpu().clone()
            for k, v in net.state_dict().items()}


class _FakePersistent:
    """Pickles as a persistent-class module of the reference pickles does: a
    reduce-call to torch_utils.persistence._reconstruct_persistent_obj(meta)
    whose meta.state is the module's __dict__."""

    def __init__(self, state):
        self.state = state

    def __reduce__(self):
        meta = dict(type="class", version=6, module_src="<src>", class_name="Generator",
                    state=self.state)
        return sys.modules["torch_utils.persistence"]._reconstruct_persistent_obj, (meta,)


def write_mat_pickle(sd, path):
    """A persistence pickle of the reference's format ({"G", "G_ema"}, each a
    tree of persistent modules with _parameters, _buffers and _modules)
    holding the state dict ``sd``; buffers are the "noise_const",
    "resample_filter" and "w_avg" tensors."""
    import pickle
    import types
    from collections import OrderedDict

    root = {}
    for key, t in sd.items():
        node = root
        *mods, leaf = key.split(".")
        for m in mods:
            node = node.setdefault("_modules", OrderedDict()).setdefault(m, {})
        kind = "_buffers" if leaf in ("noise_const", "resample_filter", "w_avg") else "_parameters"
        node.setdefault(kind, OrderedDict())[leaf] = t

    def wrap(node):
        state = {"training": False, "_parameters": node.get("_parameters", OrderedDict()),
                 "_buffers": node.get("_buffers", OrderedDict()),
                 "_modules": OrderedDict((k, wrap(v)) for k, v in
                                         node.get("_modules", OrderedDict()).items())}
        return _FakePersistent(state)

    tu, pers = types.ModuleType("torch_utils"), types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):  # never called while writing
        raise RuntimeError

    _reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    pers._reconstruct_persistent_obj = _reconstruct_persistent_obj
    tu.persistence = pers
    sys.modules["torch_utils"], sys.modules["torch_utils.persistence"] = tu, pers
    try:
        with open(path, "wb") as f:
            pickle.dump({"G": wrap(root), "G_ema": wrap(root)}, f)
    finally:
        del sys.modules["torch_utils"], sys.modules["torch_utils.persistence"]


def jsonable(obj):
    """``obj`` with every dict key made a string (launch keys are tuples)."""
    if isinstance(obj, dict):
        return {k if isinstance(k, str) else str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj


def max_err(got, want):
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    log("== 1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    log(f"card: {card_line}")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    card_rates(name)  # the bounds of phase 6 need the card's rates
    log(f"tf32 defaults: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32 set: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, card_line


def phase_build():
    from waldo_tpu_torch.ops.kernels import KERNELS, build

    log("== 2. build")
    t0 = time.perf_counter()
    # every kernel of the port, and the yardsticks (earlier designs)
    report = build(sorted({k.source for k in KERNELS.values()}
                          | {ROWS_BWD_SOURCE, SHARED_BWD_FIRST_SOURCE, FWD_FIRST_SOURCE}))
    resources = {}
    for src, r in report.items():
        log(f"built {src} in {r['seconds']:.1f} s")
        for fn, res in ptxas_resources(r["log"]).items():
            log(f"  {fn}: {res}")
            resources[f"{src}:{fn}"] = res
    total = time.perf_counter() - t0
    log(f"build wall time {total:.1f} s")
    sass = sass_atomics("grid_sample_bwd.cu")
    log(f"atomics in the SASS of grid_sample_bwd.cu: {sass}")
    return total, sass, resources


def ptxas_resources(build_log):
    """Each kernel's registers and spills from ptxas' -v report, by its
    name (the bool template argument, where there is one, in brackets)."""
    import re

    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = ""
        elif name is not None and ("spill" in line or "registers" in line):
            what = line.split(":", 1)[-1].strip() if line.startswith("ptxas") else line.strip()
            out[name] = (out[name] + "; " if out[name] else "") + what
    return out


def kernel_name(mangled):
    """The kernel's own name in an Itanium-mangled symbol (its nested names
    are length-prefixed), with a leading bool template argument."""
    import re

    pos = 3 if mangled.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if m is None:
            return mangled
        start = pos + m.end()
        ident = mangled[start:start + int(m.group())]
        pos = start + len(ident)
        if ident.endswith("_kernel"):
            t = re.match(r"ILb([01])E", mangled[pos:])
            return ident + (f"<{t.group(1)}>" if t else "")


def sass_atomics(source):
    """Counts of the atomic instructions in the SASS of a built kernel
    library (cuobjdump beside nvcc; a float atomicAdd on shared memory shows
    as ATOMS.CAST.SPIN, a compare-and-swap loop, where sm_90 has no native
    shared float add), or why there are none."""
    import re

    from waldo_tpu_torch.ops.kernels.build import _nvcc, library_path

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "not read (no cuobjdump beside nvcc)"
    sass = subprocess.run([tool, "-sass", str(library_path(source))], capture_output=True,
                          text=True, timeout=120).stdout
    found = re.findall(r"\b(?:ATOMS|ATOMG|ATOM|REDG|RED)\.[.A-Z0-9_]*", sass)
    return {k: found.count(k) for k in sorted(set(found))}


def phase_kernels(dev):
    import torch
    from waldo_tpu_torch.ops.grid_sample import (grid_sample_ctx_plain, plane_boxes_plain,
                                                 warp_alpha_ctx_plain)
    from waldo_tpu_torch.ops.kernels import (grid_sample_cuda, plane_boxes_cuda,
                                             warp_alpha_ctx_cuda)

    log("== 3. kernels against their plain versions "
        f"(tolerance {TOL_F32} float32, {TOL_BF16:.4g} bf16 output; the pre-pass exactly)")
    rng = np.random.RandomState(0)
    errs = {}

    def pre_case(label, tex):
        planes, boxes = plane_boxes_cuda(tex)
        want_planes, want_boxes = plane_boxes_plain(tex)
        torch.cuda.synchronize()
        check(torch.equal(boxes, want_boxes), f"plane_boxes {label}: boxes differ from the plain "
              f"version at {(boxes != want_boxes).nonzero()[:4].tolist()}")
        check(torch.equal(planes, want_planes), f"plane_boxes {label}: planes differ")
        area = ((want_boxes[..., 1] - want_boxes[..., 0] + 1).clamp(min=0)
                * (want_boxes[..., 3] - want_boxes[..., 2] + 1).clamp(min=0))
        log(f"plane_boxes {label} {tex.dtype}: planes and boxes equal to the plain version; "
            f"{int((want_boxes[..., 1] < 0).sum())} of {boxes.shape[0] * boxes.shape[1]} planes "
            f"empty, boxes cover {float(area.sum()) / planes.numel():.3f} of the texels")

    def k1_check(label, a, g, o, io, tp, tcp):
        got = warp_alpha_ctx_cuda(a, g, o, io, tp, tcp)
        want = warp_alpha_ctx_plain(a, g, o, io, tp_sz=tp, tcp=tcp)
        torch.cuda.synchronize()
        e = max_err(got, want)
        log(f"warp_alpha_ctx {label}: max|err| {e:.3g} (tol {TOL_F32})")
        ok = e <= TOL_F32 and all(torch.isfinite(x).all() for x in got)
        if not ok:  # where it disagrees, and whether a second launch does too
            for name, x, y in zip(("alpha_occ", "disocc", "flow"), got, want):
                bad = ((x - y).abs() > TOL_F32) | ~torch.isfinite(x)
                rows = bad.flatten(1).any(1).nonzero().flatten()
                log(f"  {name}: {int(bad.sum())} elements over the tolerance in rows "
                    f"{rows[:16].tolist()} of {x.shape[0]}; first at "
                    f"{bad.nonzero()[:4].tolist()}")
            log(f"  a second launch: max|err| "
                f"{max_err(warp_alpha_ctx_cuda(a, g, o, io, tp, tcp), want):.3g}")
        check(ok, f"warp_alpha_ctx {label} disagrees: {e}")
        return e

    def k1_case(label, f, h, w, c, tp, tc, with_io, sparse=False):
        a, g, o, io = k1_inputs(rng, f, h, w, c, tp, tc, with_io, dev, sparse)
        if sparse and not with_io:
            pre_case(label, a)
            pre_case(label, a.to(torch.bfloat16))
        return k1_check(label, a, g, o, io, tp, tc * tp)

    for sparse in (False, True):
        for tp in (14, 10):
            for with_io in (False, True):
                errs["warp_alpha_ctx", 4 * tp, with_io, sparse] = k1_case(
                    f"N={4 * tp} flagship" + (", object-sparse" if sparse else ", dense")
                    + (", is_obj" if with_io else ""), 4, 256, 512, 17, tp, 4, with_io, sparse)
    # one case for each of the kernel's compile-time layer counts (8, 16, 20, 32)
    k1_case("ragged 37x53 C=5, is_obj", 2, 37, 53, 5, 3, 2, True)
    k1_case("ragged 23x41 C=12, is_obj", 2, 23, 41, 12, 2, 2, True)
    k1_case("ragged 31x19 C=19", 1, 31, 19, 19, 3, 1, False)
    k1_case("ragged 29x61 C=32", 2, 29, 61, 32, 2, 1, False)
    k1_case("ragged 29x61 C=32, object-sparse", 2, 29, 61, 32, 2, 1, False, sparse=True)
    # the skip's edge cases, one per layer (skip_edge_inputs), 2 frames x 3 rows
    tex, grids = skip_edge_inputs(rng, 2, 37, 53, 3, dev)
    pre_case("skip edge cases 37x53 C=8", tex)
    pre_case("skip edge cases 37x53 C=8", tex.to(torch.bfloat16))
    occ = torch.from_numpy(rng.rand(6, 8, 8).astype(np.float32)).to(dev)
    io = torch.from_numpy((rng.rand(3, 8, 37, 53) > 0.3).astype(np.float32)).to(dev)
    for mask in (None, io):
        k1_check("skip edge cases 37x53 C=8" + (", is_obj" if mask is not None else ""),
                 tex, grids, occ, mask, 3, 6)

    def k2_case(label, f, h, w, c, tp, ho, wo, dtype=None):
        img, grid = k2_inputs(rng, f, h, w, c, tp, ho, wo, dev, dtype)
        got = grid_sample_cuda(img, grid, tp)
        want = grid_sample_ctx_plain(img.float(), grid, tp).to(img.dtype)
        torch.cuda.synchronize()
        tol = TOL_F32 if img.dtype == torch.float32 else TOL_BF16
        e = float((got.float() - want.float()).abs().max())
        log(f"grid_sample {label}: max|err| {e:.3g} (tol {tol:.3g})")
        check(got.dtype == img.dtype and e <= tol and torch.isfinite(got).all(),
              f"grid_sample {label} disagrees: {e}")
        return e

    errs["grid_sample", 56] = k2_case("N=56 C=23 flagship", 4, 256, 512, 23, 14, 256, 512)
    errs["grid_sample", 40] = k2_case("N=40 C=23 flagship", 4, 256, 512, 23, 10, 256, 512)
    k2_case("ragged 31x45 C=7 -> 19x70", 3, 31, 45, 7, 2, 19, 70)
    k2_case("ragged bf16 31x45 C=7 -> 19x70", 3, 31, 45, 7, 2, 19, 70, torch.bfloat16)
    errs["grid_sample", "edge"] = k2_edge_checks(dev, np.random.RandomState(10))

    per_channel = phase_kernels_per_channel(dev, rng, tex, grids[::3].contiguous())
    errs["bias_act"] = phase_kernels_bias_act(dev, rng)
    return errs, per_channel


def phase_kernels_per_channel(dev, rng, edge_tex, edge_grids):
    """K2', the per-channel grid sample (the training-path alpha warp): dense
    and object-sparse at 4x256x512, C=17, timed beside one F.grid_sample call
    on the channel-folded texture, then the skip's edge cases, bf16 and C=32."""
    import torch
    import torch.nn.functional as F
    from waldo_tpu_torch.ops.grid_sample import grid_sample_multigrid_plain
    from waldo_tpu_torch.ops.kernels import grid_sample_per_channel_cuda

    def case(label, img, grids):
        got = grid_sample_per_channel_cuda(img, grids)[0]
        want = grid_sample_multigrid_plain(img.float(), grids).to(img.dtype)
        torch.cuda.synchronize()
        tol = TOL_F32 if img.dtype == torch.float32 else TOL_BF16
        e = float((got.float() - want.float()).abs().max())
        log(f"grid_sample per-channel {label} {img.dtype}: max|err| {e:.3g} (tol {tol:.3g})")
        check(got.dtype == img.dtype and e <= tol and bool(torch.isfinite(got).all()),
              f"per-channel grid_sample {label} disagrees: {e}")
        return e

    res = {}
    f, h, w, c = 4, 256, 512, 17
    for kind in ("dense", "sparse"):
        img = (sparse_alpha(rng, f, h, w, c, dev) if kind == "sparse"
               else torch.from_numpy(rng.rand(f, h, w, c).astype(np.float32)).to(dev))
        grids = smooth_grids(rng, f, c, h, w, dev)
        e = case(f"4x256x512 C=17 {kind}", img, grids)
        ms = cuda_time(lambda: grid_sample_per_channel_cuda(img, grids), 20)
        plain = cuda_time(lambda: grid_sample_multigrid_plain(img, grids), 3)
        # one library call for the same function: the channels folded into
        # the batch, one single-channel texture per grid
        img_fold = img.permute(0, 3, 1, 2).reshape(f * c, 1, h, w).contiguous()
        grids_fold = grids.reshape(f * c, h, w, 2)
        lib = cuda_time(lambda: F.grid_sample(img_fold, grids_fold, mode="bilinear",
                                              padding_mode="zeros", align_corners=False), 20)
        b_ms, b_by = bound(torch.cuda.get_device_name(0),
                           4 * (2 * f * h * w * c + f * c * h * w * 2), f * c * h * w * 24)
        log(f"grid_sample per-channel 4x256x512 C=17 {kind}: {ms:.4f} ms (bound {b_ms:.4f} ms "
            f"by {b_by}, {b_ms / ms:.0%} of it), plain {plain:.4f} ms, library (F.grid_sample, "
            f"channels folded into the batch) {lib:.4f} ms")
        res[kind] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": e}
        del img, grids, img_fold, grids_fold
    case("skip edge cases 37x53 C=8", edge_tex, edge_grids)
    case("skip edge cases 37x53 C=8", edge_tex.to(torch.bfloat16), edge_grids)
    case("ragged 29x61 C=32 object-sparse", sparse_alpha(rng, 2, 29, 61, 32, dev),
         smooth_grids(rng, 2, 32, 29, 61, dev))
    return res


def phase_kernels_bias_act(dev, rng):
    """bias_act against its plain version: every activation with and without
    bias, gain and clamp, on a ragged width (one element a thread) and a
    width of a multiple of 4 (float4 a thread) and on an unaligned view;
    then the MAT shapes. Also checks that a CUDA tensor of another dtype or
    another bias axis raises. Returns max|err| at K3_SHAPE."""
    import torch
    from waldo_tpu_torch.ops.bias_act import _ACTS, bias_act, bias_act_plain
    from waldo_tpu_torch.ops.kernels import bias_act_cuda

    def case(label, x, b, act, gain, clamp):
        got = bias_act_cuda(x, b, act, gain, clamp)
        want = bias_act_plain(x, b, -1, act, gain, clamp)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(e <= TOL_F32 and bool(torch.isfinite(got).all()),
              f"bias_act {label} disagrees: max|err| {e}")
        return e

    worst = 0.0
    for shape in ((3, 37, 21), (5, 33, 20)):
        x = torch.from_numpy((rng.randn(*shape) * 3).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.randn(shape[-1]).astype(np.float32)).to(dev)
        for act in sorted(_ACTS):
            for bias, gain, clamp in ((b, _ACTS[act][1], None), (b, 0.7, 1.5), (None, 2.0, 0.5)):
                worst = max(worst, case(f"{act} {shape}", x, bias, act, gain, clamp))
    base = torch.from_numpy(rng.randn(1 + 6 * 40).astype(np.float32)).to(dev)
    unaligned = base[1:].view(6, 40)
    worst = max(worst, case("unaligned view", unaligned, torch.ones(40, device=dev), "lrelu", 1.4, 0.9))
    log(f"bias_act, 9 activations x (bias, gain, clamp) on (3,37,21), (5,33,20) and an "
        f"unaligned view: max|err| {worst:.3g} (tol {TOL_F32})")

    x = torch.from_numpy((rng.randn(*K3_SHAPE) * 2).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(K3_SHAPE[-1]).astype(np.float32)).to(dev)
    e_big = case(f"{K3_SHAPE} lrelu", x, b, "lrelu", _ACTS["lrelu"][1], None)
    del x
    tok = torch.from_numpy(rng.randn(1, 4096, 180).astype(np.float32)).to(dev)
    e_tok = case("(1,4096,180) linear", tok, b, "linear", 1.0, None)
    log(f"bias_act {K3_SHAPE} lrelu gain sqrt2: max|err| {e_big:.3g}; (1,4096,180) linear: "
        f"max|err| {e_tok:.3g} (tol {TOL_F32})")

    for bad, kw, err in ((tok.to(torch.bfloat16), {}, TypeError), (tok, {"dim": 1}, ValueError)):
        try:
            bias_act(bad, **kw)
        except err:
            continue
        raise RuntimeError(f"bias_act on a CUDA tensor with {bad.dtype} {kw} did not raise")
    log("bias_act on CUDA raises on bfloat16 and on a bias along another axis")
    return e_big


def flagship_batch(cfg, dev, seed=0):
    import torch

    rng = np.random.RandomState(seed)
    t, nl = cfg.data.vid_len, cfg.data.num_lyt
    hd, wd = cfg.load_dim, int(cfg.load_dim * cfg.aspect_ratio)
    h, w = cfg.dim, int(cfg.dim * cfg.aspect_ratio)
    lyt = 5.0 * (2 * np.eye(nl, dtype=np.float32)[rng.randint(0, nl, (1, t, hd, wd))] - 1)
    batch = {"vid": rng.rand(1, t, hd, wd, 3).astype(np.float32) * 2 - 1,
             "lyt": lyt,
             "flow": rng.randn(1, t, h, w, 2).astype(np.float32) * 0.02}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def k1_stress(dev, reps, n_cases=8):
    """Phase 3's first n_cases flagship cases of the fused warp (its
    RandomState(0) inputs, made in its order), each run reps times, to tell
    an output element the kernels never write from one they write wrong.
    Each repetition: the pre-pass against its plain version (exactly); the
    warp launched on those planes into outputs filled with NaN; and the
    warp through its wrapper, after the cache is emptied and handed back
    blocks of the outputs' sizes filled with NaN, so that the wrapper's
    torch.empty outputs land in them (counted) and an unwritten element
    reads NaN. Both warps are held to the plain version (1e-4). The first
    repetition's first case is the process's first launch of both kernels.
    Returns the counts, and the (repetition, case) of each failure."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import plane_boxes_plain, warp_alpha_ctx_plain
    from waldo_tpu_torch.ops.kernels import WARP_ALPHA_CTX, plane_boxes_cuda, warp_alpha_ctx_cuda

    rng = np.random.RandomState(0)
    cases = []
    for sparse in (False, True):
        for tp in (14, 10):
            for with_io in (False, True):
                if len(cases) < n_cases:
                    a, g, o, io = k1_inputs(rng, 4, 256, 512, 17, tp, 4, with_io, dev, sparse)
                    cases.append((f"N={4 * tp}" + (" object-sparse" if sparse else " dense")
                                  + (" is_obj" if with_io else ""), a, g, o, io, tp, 4 * tp,
                                  warp_alpha_ctx_plain(a, g, o, io, tp_sz=tp, tcp=4 * tp),
                                  plane_boxes_plain(a)))
    nan = float("nan")

    def poison(*tensors):  # free blocks of these sizes, filled with NaN; their addresses
        blocks = [torch.full(t.shape, nan if t.is_floating_point() else -7, dtype=t.dtype,
                             device=dev) for t in tensors]
        return {b.data_ptr() for b in blocks}

    def counts(got, want):  # (elements left unwritten, elements written wrong)
        left = sum(torch.isnan(x).sum() for x in got)
        wrong = sum((((x - y).abs() > TOL_F32) & ~torch.isnan(x)).sum() for x, y in zip(got, want))
        return left, wrong

    stats = torch.zeros(reps, len(cases), 5, dtype=torch.int64, device=dev)
    reused = 0  # wrapper calls whose three outputs all landed in NaN blocks
    t0 = time.perf_counter()
    for r in range(reps):
        for i, (_, a, g, o, io, tp, tcp, want, want_pre) in enumerate(cases):
            poison(*want_pre)
            planes, boxes = plane_boxes_cuda(a)
            stats[r, i, 0] = (planes != want_pre[0]).sum() + (boxes != want_pre[1]).sum()
            outs = [torch.full(x.shape, nan, device=dev) for x in want]
            n, c, gh, gw = g.shape[:4]
            stream = torch.cuda.current_stream(dev).cuda_stream
            WARP_ALPHA_CTX.launch(None, planes.data_ptr(), boxes.data_ptr(), g.data_ptr(),
                                  o.data_ptr(), io.data_ptr() if io is not None else None,
                                  *(x.data_ptr() for x in outs), a.shape[1], a.shape[2], c, n,
                                  gh, gw, tp, tcp, stream)
            stats[r, i, 1], stats[r, i, 2] = counts(outs, want)
            del planes, boxes, outs
            torch.cuda.empty_cache()  # so that the wrapper's allocations find the NaN blocks
            nan_blocks = poison(*want, *want_pre)
            got = warp_alpha_ctx_cuda(a, g, o, io, tp, tcp)
            stats[r, i, 3], stats[r, i, 4] = counts(got, want)
            reused += all(x.data_ptr() in nan_blocks for x in got)
            del got
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = stats.cpu().numpy()
    what = ["pre-pass elements differing", "warp into NaN: elements left unwritten",
            "warp into NaN: elements written wrong", "warp's wrapper: NaN elements",
            "warp's wrapper: elements wrong"]
    res = {"reps": reps, "cases": [c[0] for c in cases], "seconds": secs,
           "first_launch": dict(zip(what, stats[0, 0].tolist())),
           "wrapper_outputs_in_nan_blocks": reused,
           "failures": {w: [[int(r), cases[i][0], int(stats[r, i, k])]
                            for r, i in zip(*np.nonzero(stats[..., k]))][:20]
                        for k, w in enumerate(what)},
           "calls_failing": {w: int((stats[..., k] > 0).sum()) for k, w in enumerate(what)}}
    log(f"K1 stress: {reps} repetitions of {len(cases)} cases in {secs:.1f} s, "
        f"{reps * len(cases)} calls of each kind ({reused} wrapper calls with all three "
        f"outputs in NaN blocks); calls failing {res['calls_failing']}; the process's first "
        f"launch {res['first_launch']}")
    return res


def small_cfg():
    from waldo_tpu_torch.config import Config, DataConfig, ModelConfig

    return Config(
        dim=32, load_dim=64, aspect_ratio=2.0, compute_dtype="float32",
        data=DataConfig(num_lyt=6, fg_idx=[0, 1], bg_idx=[2, 3], other_idx=[4], vid_len=5),
        model=ModelConfig(
            patch_size=8, latent_shape=(4, 8), obj_shape=(2, 2), embed_dim=64, num_heads=4,
            num_obj=4, oe_depth=1, pe_depth=1, pg_com_depth=1, pg_enc_depth=1,
            pg_dec_depth=1, pg_num_timesteps=5, oe_num_timesteps=5, ii_depth=2,
            ii_embed_dim=32, ctx_len=2, use_pe=True, use_pg=True, use_ii=True,
            fast_inverse_warp=True, sample_precision="float32"),
    )


def spans_and_kernels(prof, wall_ms):
    """Device time per ``annotate`` span and per kernel, and the device's idle
    share, from one profiled window of ``wall_ms`` (host clock, synced). A
    span's device time runs from its first kernel's start to its last one's
    end; busy time is the union of the kernels' own intervals."""
    from torch.autograd import DeviceType

    spans, kernels = {}, []
    for e in prof.key_averages():
        if e.is_user_annotation:
            # a span has a host row and a device row under the same name
            sp = spans.setdefault(e.key, {"count": 0, "device_ms": 0.0, "cpu_ms": 0.0})
            sp["count"] = max(sp["count"], e.count)
            sp["device_ms"] = max(sp["device_ms"], e.device_time_total / 1e3)
            sp["cpu_ms"] = max(sp["cpu_ms"], e.cpu_time_total / 1e3)
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    ivals = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    busy_us, end = 0.0, -float("inf")
    for s0, s1 in ivals:
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "kernel_ms": sum(k[0] for k in kernels),
            "spans": dict(sorted(spans.items())),
            "top_kernels": [{"ms": t, "count": c, "name": k[:120]} for t, c, k in kernels[:25]],
            "all_kernels": [{"ms": t, "count": c, "name": k[:120]} for t, c, k in kernels]}


def phase_profile(fn, out_dir, label):
    """Trace one call of ``fn`` into out_dir/profile{label}.json and .txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    res = spans_and_kernels(prof, wall_ms)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile{label}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    with open(os.path.join(out_dir, f"profile{label}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))
    log(f"profiled{label or ' predict'}: {wall_ms:.2f} ms wall (profiler on), device busy "
        f"{res['device_busy_ms']:.2f} ms, idle share {res['idle_share']:.3f}, "
        f"kernel time {res['kernel_ms']:.2f} ms")
    for name, sp in res["spans"].items():
        log(f"  span {name}: device {sp['device_ms']:.3f} ms, host {sp['cpu_ms']:.3f} ms "
            f"({sp['count']} calls)")
    for k in res["top_kernels"][:12]:
        log(f"  kernel {k['ms']:.3f} ms x{k['count']}: {k['name'][:90]}")
    return res


def read_launches():
    from waldo_tpu_torch.ops.kernels import KERNELS

    return ({k: v.launches for k, v in KERNELS.items()},
            {k: dict(v.launches_by_key) for k, v in KERNELS.items()})


def phase_main(dev, iters, profile_dir=None):
    import torch
    from waldo_tpu_torch.config import flagship_cfg
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.ops.kernels import reset_launches

    log("== 4. main path: flagship predict")
    cfg = flagship_cfg()
    t0 = time.perf_counter()
    syn = Synthesizer(cfg, device=dev, seed=0)
    batch = flagship_batch(cfg, dev)
    torch.cuda.synchronize()
    log(f"synthesizer + batch ready in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for n in syn.nets().values() for p in n.parameters())} parameters)")
    for _ in range(2):
        syn.predict(batch)
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = syn.predict(batch)
    torch.cuda.synchronize()
    launches, by_key = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"launches in one predict: {launches} by key {by_key}")
    check(launches == {"warp_alpha_ctx": 2, "grid_sample": 2, "grid_sample_per_channel": 0,
                       "grid_sample_bwd": 0, "grid_sample_per_channel_bwd": 0, "bias_act": 0,
                       "plane_boxes": 2},
          f"expected 2 launches of the warp, its pre-pass and the sampler per predict, "
          f"got {launches}")
    check(by_key["warp_alpha_ctx"] == {(56, False): 1, (40, False): 1}
          and by_key["grid_sample"] == {56: 1, 40: 1} and by_key["plane_boxes"] == {4: 2},
          f"unexpected launch shapes {by_key}")

    t, ctx = cfg.data.vid_len, cfg.model.ctx_len
    shapes = {"rec_vid": (1, t, 256, 512, 3), "inp_rec_vid": (1, t, 256, 512, 3),
              "pred_vid": (1, t, 256, 512, 3), "inp_pred_vid": (1, t, 256, 512, 3),
              "pred_flow": (1, ctx, t - ctx, 256, 512, 2)}
    for k, shape in shapes.items():
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)} != {shape}")
        check(bool(torch.isfinite(out[k]).all()), f"{k} has non-finite values")
    check(torch.equal(out["pred_vid"][:, :ctx], batch["vid"][:, :ctx]),
          "pred_vid does not start with the context frames")
    check(torch.equal(out["inp_pred_vid"][:, :ctx].float(), batch["vid"][:, :ctx]),
          "inp_pred_vid does not start with the context frames")
    log("outputs finite, of the expected shapes; pred_vid[:, :4] == input frames")

    ms = cuda_time(lambda: syn.predict(batch), iters, warmup=1)
    fps = (t - ctx) / (ms / 1e3)
    log(f"predict: {ms:.2f} ms per call over {iters} calls -> {fps:.3f} predicted frames/s; "
        f"peak memory {peak_gb:.2f} GB")
    prof = phase_profile(lambda: syn.predict(batch), profile_dir, "") if profile_dir else None
    k1_inputs_seen = capture_sample_inputs(lambda: syn.predict(batch))[0]
    del out, syn
    torch.cuda.empty_cache()

    # small float32 predict on the card against the same predict on the CPU
    cfg_s = small_cfg()
    gpu = Synthesizer(cfg_s, device=dev, seed=1)
    cpu = Synthesizer(cfg_s, device="cpu", seed=1)
    b_cpu = {k: v.cpu() for k, v in flagship_batch(cfg_s, "cpu", seed=1).items()}
    want = cpu.predict(b_cpu)
    got = gpu.predict({k: v.to(dev) for k, v in b_cpu.items()})
    err = max(float((got[k].cpu() - want[k]).abs().max()) for k in shapes)
    log(f"small float32 predict, card vs CPU: max|err| {err:.3g} (tol 1e-3)")
    check(err <= 1e-3, f"small predict on the card disagrees with the CPU: {err}")
    return {"ms_per_predict": ms, "fps": fps, "peak_gb": peak_gb, "launches": launches,
            "launches_by_key": by_key, "small_predict_err": err, "profile": prof}, k1_inputs_seen


def capture_sample_inputs(predict):
    """The inputs of every fused warp call (alpha, grid, occ, is_obj, tp_sz,
    tcp) and every shared-grid sample (img, grid, tp_sz) in one
    ``predict()``, copied, for the kernels to be timed on them."""
    from waldo_tpu_torch.models import warper

    k1, k2 = [], []
    fused, ctx = warper.warp_alpha_ctx, warper.grid_sample_ctx

    def capture_k1(alpha, grids, occ, is_obj, *, tp_sz, tcp):
        k1.append(tuple(None if t is None else t.float().contiguous().clone()
                        for t in (alpha, grids, occ, is_obj)) + (tp_sz, tcp))
        return fused(alpha, grids, occ, is_obj, tp_sz=tp_sz, tcp=tcp)

    def capture_k2(img, grid, *, tp_sz):
        k2.append((img.contiguous().clone(), grid.contiguous().clone(), tp_sz))
        return ctx(img, grid, tp_sz=tp_sz)

    warper.warp_alpha_ctx, warper.grid_sample_ctx = capture_k1, capture_k2
    try:
        predict()
    finally:
        warper.warp_alpha_ctx, warper.grid_sample_ctx = fused, ctx
    return k1, k2


def mat_clip(cfg, syn, inpainter, batch):
    """One test_mat clip: predict, then the MAT post-processing."""
    from waldo_tpu_torch.models.mat_pipeline import inpaint_with_mat

    out = syn.predict(batch)
    return inpaint_with_mat(cfg, syn.warper, syn.wif, inpainter, out["pred_raw_output"],
                            out["pred_alpha"], out["pred_alpha_ctx"], batch["vid"],
                            out["pred_flow"], cfg.model.ctx_len, out["pred_grids"])


def mat_chain_with_holes(cfg, syn, inpainter, batch):
    """A test_mat clip whose alpha maps get a region no layer covers (a hole
    that MAT fills) and an object on the left and on the right border in
    every frame, with a zero last flow, so that the border completion
    runs."""
    import torch
    from waldo_tpu_torch.models.mat_pipeline import inpaint_with_mat

    out = syn.predict(batch)
    ac = out["pred_alpha_ctx"].clone()
    h, w = ac.shape[-3:-1]
    ac[..., h // 4: h // 2, w // 3: w // 2, :] = -1.0
    ac[..., h // 8: h // 4, :6, 1] = 1.0
    ac[..., h // 2: 3 * h // 4, -6:, 2] = 1.0
    return inpaint_with_mat(cfg, syn.warper, syn.wif, inpainter, out["pred_raw_output"],
                            out["pred_alpha"], ac, batch["vid"],
                            torch.zeros_like(out["pred_flow"]), cfg.model.ctx_len,
                            out["pred_grids"])


def same_z(inpainters, seed):
    """Hand every inpainter the same z sequence, made with numpy."""
    import torch

    zs = np.random.RandomState(seed).randn(256, 1, 512).astype(np.float32)
    for inp in inpainters:
        it = iter(zs)
        inp._next_z = lambda b, it=it, dev=inp.device: torch.from_numpy(next(it)).to(dev)


def phase_mat(dev, profile_dir=None):
    import torch
    from waldo_tpu_torch.config import flagship_mat_cfg
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.models.mat import MatInpainter
    from waldo_tpu_torch.models.mat import basic as mat_basic
    from waldo_tpu_torch.ops.bias_act import bias_act
    from waldo_tpu_torch.ops.kernels import BIAS_ACT, reset_launches

    log("== 5. MAT path: flagship predict + inpaint_with_mat (test_mat)")
    cfg = flagship_mat_cfg()
    t0 = time.perf_counter()
    syn = Synthesizer(cfg, device=dev, seed=0)
    inp = MatInpainter(resolution=512, device=dev, seed=0)
    batch = flagship_batch(cfg, dev)
    torch.cuda.synchronize()
    log(f"synthesizer + MAT inpainter + batch ready in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in inp.net.parameters())} MAT parameters)")

    # bias_act launches of one Generator forward (a calibration run, not the
    # path's), and how many of its inputs arrive strided, i.e. need a
    # layout copy before the kernel (every MAT layer calls bias_act through
    # models/mat/basic.py)
    x0 = torch.zeros(1, 512, 512, 3, device=dev)
    m0 = torch.ones(1, 512, 512, 1, device=dev)
    strided, k3_bytes = [], [0]

    def counting_bias_act(x, b=None, *args, **kwargs):
        """bias_act, noting strided inputs and the bytes each call must move
        (x read and y written once, the bias read once)."""
        if not x.is_contiguous():
            strided.append(tuple(x.shape))
        k3_bytes[0] += x.element_size() * 2 * x.numel() + (0 if b is None else 4 * b.numel())
        return bias_act(x, b, *args, **kwargs)

    with torch.inference_mode():
        reset_launches()
        mat_basic.bias_act = counting_bias_act
        try:
            inp._apply(x0, m0, inp._next_z(1))
        finally:
            mat_basic.bias_act = bias_act
        per_forward = BIAS_ACT.launches
        gen_ms = cuda_time(lambda: inp._apply(x0, m0, inp._next_z(1)), 5)
    log(f"one MAT Generator forward at 512x512: {per_forward} bias_act launches "
        f"({len(strided)} of them on a strided input, copied first: {strided[:8]}), "
        f"{gen_ms:.2f} ms")
    strided_per_forward = len(strided)
    mat_clip(cfg, syn, inp, batch)  # warm-up
    torch.cuda.synchronize()

    inp.calls = 0
    k3_bytes[0] = 0
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mat_basic.bias_act = counting_bias_act
    try:
        out = mat_clip(cfg, syn, inp, batch)
    finally:
        mat_basic.bias_act = bias_act
    torch.cuda.synchronize()
    launches, by_key = read_launches()
    forwards = inp.calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"launches in one clip: {launches} by key {by_key}; {forwards} MAT forwards "
        f"({forwards // 3} inpainter calls of 3 crops)")
    check(by_key["warp_alpha_ctx"] == {(56, True): 1, (40, True): 1},
          f"the warp did not run with its ghost mask at N=56 and N=40: {by_key}")
    check(by_key["grid_sample"] == {56: 1, 40: 1}, f"unexpected sampler launches {by_key}")
    check(by_key["plane_boxes"] == {4: 2}, f"the warp's pre-pass did not run twice: {by_key}")
    check(all(launches[k] == 0 for k in ("grid_sample_per_channel", "grid_sample_bwd",
                                         "grid_sample_per_channel_bwd")),
          f"a training-path kernel ran in the MAT clip: {launches}")
    check(forwards % 3 == 0 and 11 <= forwards // 3 <= 13,
          f"expected 11-13 inpainter calls of 3 crops, got {forwards} forwards")
    check(launches["bias_act"] > 0 and launches["bias_act"] == per_forward * forwards,
          f"bias_act launched {launches['bias_act']} times, not {per_forward} x {forwards}")
    k3_bound_ms, _ = bound(torch.cuda.get_device_name(0), k3_bytes[0], 0)
    log(f"bias_act in one clip: {launches['bias_act']} launches moving {k3_bytes[0] / 1e9:.4f} GB: "
        f"bound {k3_bound_ms:.4f} ms per clip")

    t, ctx = cfg.data.vid_len, cfg.model.ctx_len
    check(tuple(out.shape) == (1, t, 256, 512, 3), f"inp_pred_vid shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "inp_pred_vid has non-finite values")
    check(torch.equal(out[:, :ctx], batch["vid"][:, :ctx]),
          "inp_pred_vid does not start with the context frames")
    log(f"output (1, {t}, 256, 512, 3) finite; its first {ctx} frames == input frames")

    ms = cuda_time(lambda: mat_clip(cfg, syn, inp, batch), MAT_CLIPS, warmup=0)
    fps = (t - ctx) / (ms / 1e3)
    log(f"MAT clip: {ms:.2f} ms per clip over {MAT_CLIPS} clips -> {fps:.4f} predicted frames/s; "
        f"peak memory {peak_gb:.2f} GB")
    prof = None
    if profile_dir:
        prof = phase_profile(lambda: mat_clip(cfg, syn, inp, batch), profile_dir, "_mat")
        k3 = sum(k["ms"] for k in prof["all_kernels"] if "bias_act" in k["name"])
        prof["bias_act_share"] = k3 / prof["kernel_ms"]
        log(f"bias_act: {k3:.2f} ms of {prof['kernel_ms']:.2f} ms kernel time "
            f"({prof['bias_act_share']:.3f}), against its bound of {k3_bound_ms:.4f} ms per clip")
    del out, syn, inp
    torch.cuda.empty_cache()

    # small float32 chain (MAT at 128) on the card against the CPU, with a
    # hole and two border objects put into its alpha maps, so that MAT's
    # fill reaches the output and the border completion runs
    cfg_s = small_cfg()
    for f in ("loop_ii", "inpaint_obj", "propagate_unique", "use_shadows", "use_expansion",
              "soft_shadow", "propagate_obj", "use_inpainter", "use_mat_inpainter",
              "restrict_to_ctx"):
        setattr(cfg_s.model, f, True)
    b_cpu = {k: v.cpu() for k, v in flagship_batch(cfg_s, "cpu", seed=2).items()}
    outs, calls = [], []
    for d in (dev, "cpu"):
        syn_s = Synthesizer(cfg_s, device=d, seed=2)
        inp_s = MatInpainter(resolution=128, device=d, seed=2)
        same_z([inp_s], seed=3)
        outs.append(mat_chain_with_holes(cfg_s, syn_s, inp_s,
                                         {k: v.to(d) for k, v in b_cpu.items()}).cpu())
        calls.append(inp_s.calls)
    got, want = outs
    tp_s = cfg_s.data.vid_len - cfg_s.model.ctx_len
    check(calls == [3 * (tp_s + 3)] * 2,
          f"expected {tp_s + 3} inpainter calls (reference, {tp_s} frames, 2 border objects) "
          f"of 3 crops on each side, got {calls} forwards")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    log(f"small float32 MAT chain (with a hole and two border objects; {calls[0]} MAT "
        f"forwards), card vs CPU: max|err| {err:.3g} (tol 1e-3 x max|CPU output| = "
        f"{1e-3 * scale:.3g})")
    check(bool(torch.isfinite(got).all()) and err <= 1e-3 * scale,
          f"small MAT chain on the card disagrees with the CPU: {err}")
    return {"ms_per_clip": ms, "fps": fps, "peak_gb": peak_gb, "launches": launches,
            "launches_by_key": by_key, "mat_forwards": forwards,
            "bias_act_per_forward": per_forward, "bias_act_strided_inputs": strided_per_forward,
            "bias_act_bytes_per_clip": k3_bytes[0], "bias_act_bound_ms_per_clip": k3_bound_ms,
            "generator_ms": gen_ms,
            "small_chain_err": err, "small_chain_scale": scale, "profile": prof}


def k1_row(card_name, label, a, g, o, mask, tp, tcp, n_launches, err):
    """The fused warp timed beside its bound and its plain version."""
    from waldo_tpu_torch.ops.grid_sample import warp_alpha_ctx_plain
    from waldo_tpu_torch.ops.kernels import warp_alpha_ctx_cuda

    f, h, w, c = a.shape
    n, _, gh, gw, _ = g.shape
    ms = cuda_time(lambda: warp_alpha_ctx_cuda(a, g, o, mask, tp, tcp), 20)
    plain = cuda_time(lambda: warp_alpha_ctx_plain(a, g, o, mask, tp_sz=tp, tcp=tcp), 3)
    p = gh * gw
    nbytes = 4 * (f * h * w * c + n * c * p * 2 + n * c * c + n * p * (c + 3))
    nops = n * p * (3 * c * c + 32 * c)
    if mask is not None:  # the mask rows the launch reads, and a multiply per sample
        nbytes += 4 * (n // tcp) * tp * c * p
        nops += n * p * c
    b_ms, b_by = bound(card_name, nbytes, nops)
    return {"name": label, "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
            "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def k1_check(a, g, o, io, tp, tcp, whose):
    """The fused warp against its plain version on these inputs; max|err|."""
    from waldo_tpu_torch.ops.grid_sample import warp_alpha_ctx_plain
    from waldo_tpu_torch.ops.kernels import warp_alpha_ctx_cuda

    err = max_err(warp_alpha_ctx_cuda(a, g, o, io, tp, tcp),
                  warp_alpha_ctx_plain(a, g, o, io, tp_sz=tp, tcp=tcp))
    check(err <= TOL_F32, f"warp_alpha_ctx on {whose} inputs disagrees: {err}")
    return err


def k1_input_shares(a, g, io, tp, label):
    """The share of zero (pixel, layer) samples of the fused warp's inputs
    (the ghost mask not applied), and of samples the box test skips."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import (grid_sample_multigrid_plain, plane_boxes_plain,
                                                 tap_footprint_skips)

    n = g.shape[0]
    _, boxes = plane_boxes_plain(a)
    frame = torch.arange(n, device=a.device) // tp
    skip = float(tap_footprint_skips(g, boxes[frame], a.shape[1], a.shape[2]).float().mean())
    sam = grid_sample_multigrid_plain(a.repeat_interleave(tp, dim=0), g)
    zero = float((sam == 0).float().mean())
    zero_obj = float((sam[..., 1:] == 0).float().mean())
    del sam
    box_area = ((boxes[..., 1] - boxes[..., 0] + 1).clamp(min=0)
                * (boxes[..., 3] - boxes[..., 2] + 1).clamp(min=0)).float()
    box_share = float(box_area.mean()) / (a.shape[1] * a.shape[2])
    log(f"{label}: zero samples {zero:.4f} of all (pixel, layer), {zero_obj:.4f} of the object "
        f"layers'; the box test skips {skip:.4f}; boxes cover {box_share:.4f} of a plane on "
        f"average")
    return {"n": n, "zero_share": zero, "zero_share_objects": zero_obj, "skip_share": skip,
            "box_share": box_share}


def graph_ms(fn, reps=20, replays=5):
    """fn's device time: reps calls captured in one CUDA graph, so no host
    time lies between the launches (a back-to-back loop of a call shorter
    than its host work times the host); ms per call, the median over
    replays timed one by one. The graph and its memory pool are freed
    before it returns."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    times = []
    for _ in range(replays):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del g
    torch.cuda.empty_cache()
    return float(np.median(times))


def fwd_first(img, grid, tp):
    """K2's shared-grid forward in its first design (the tile kernel's
    yardstick, csrc/yardstick/grid_sample_fwd_pr1.cu): img (F, H, W, C),
    grid (F*tp, Ho, Wo, 2), both contiguous -> (F*tp, Ho, Wo, C)."""
    import ctypes

    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    k = yardstick(FWD_FIRST_SOURCE, "waldo_grid_sample_fwd_first", [p] * 3 + [i] * 8 + [p])
    f, h, w, c = img.shape
    rows, ho, wo = grid.shape[:3]
    out = torch.empty((rows, ho, wo, c), dtype=img.dtype, device=img.device)
    k.launch(None, img.data_ptr(), grid.data_ptr(), out.data_ptr(), h, w, c, rows, ho, wo, tp,
             int(img.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    return out


def k2_fwd_times(img, grid, tp, reps=20):
    """K2's shared-grid forward on these inputs, timed: ``ms`` per call of
    its wrapper (back-to-back calls, CUDA events: the host's time per call
    where that exceeds the kernel's), ``device_ms`` in a CUDA graph, and
    its first-design yardstick's device time in turns with it (new, first,
    first, new) and per call; F.grid_sample on the texture repeated tp
    times, channel-first and float32 (``library_ms`` per call, and in a
    graph)."""
    import torch
    import torch.nn.functional as F
    from waldo_tpu_torch.ops.kernels import grid_sample_cuda

    new = lambda: grid_sample_cuda(img, grid, tp)
    first = lambda: fwd_first(img, grid, tp)
    nchw = img.repeat_interleave(tp, dim=0) if tp > 1 else img
    nchw = nchw.permute(0, 3, 1, 2).float().contiguous()
    lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)
    turns = {"new": [], "first": []}
    for who in ("new", "first", "first", "new"):
        turns[who].append(graph_ms(new if who == "new" else first, reps))
    res = {"ms": cuda_time(new, reps), "device_ms": sum(turns["new"]) / 2,
           "yardstick_ms": sum(turns["first"]) / 2, "yardstick_call_ms": cuda_time(first, reps),
           "library_ms": cuda_time(lib, reps), "library_device_ms": graph_ms(lib, reps),
           "turns": turns}
    del nchw
    torch.cuda.empty_cache()
    return res


def k2_fwd_bound(card_name, img, grid, texels=None):
    """K2's forward bound: the texture read once (or only the texels the
    grid's taps reach, every channel of each, where ``texels`` counts
    them), the grid read and the output written once, at the texture's
    type; 16 + 8 C float32 operations a pixel."""
    f, h, w, c = img.shape
    n, ho, wo, _ = grid.shape
    es, p = img.element_size(), ho * wo
    read = f * h * w * c if texels is None else texels * c
    return bound(card_name, es * (read + n * p * c) + 8 * n * p, n * p * (16 + 8 * c))


def k2_row(card_name, label, img, grid, tp, n_launches, err, texels=None, **extra):
    """A K2 forward row: the kernel timed (k2_fwd_times) beside its bound,
    its plain version, F.grid_sample and its first-design yardstick; for the tile
    kernel (C > FWD_FEW_C) also its windows on these inputs
    (shared_fwd_windows): bands a tile, and the share of warps whose band's
    window passes the cap, which read their texels from device memory."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import (FWD_FEW_C, grid_sample_ctx_plain,
                                                 shared_fwd_windows)

    t = k2_fwd_times(img, grid, tp)
    plain = cuda_time(lambda: grid_sample_ctx_plain(img, grid, tp), 3)
    b_ms, b_by = k2_fwd_bound(card_name, img, grid, texels)
    f, h, w, c = img.shape
    if c > FWD_FEW_C:
        win = shared_fwd_windows(grid, h, w, c, img.element_size())
        live = win[..., 4] >= 0
        first = win[..., 4] == torch.arange(win.shape[3], device=win.device)
        t["bands_per_tile"] = float(first.sum()) / (win.shape[0] * win.shape[1] * win.shape[2])
        t["unstaged_warp_share"] = float((live & (win[..., 6] == 0)).sum()) / float(live.sum())
        del win, live, first
    return {"name": label, "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "launches": n_launches, "max_abs_err": err, "ms": t.pop("ms"), "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t.pop("library_ms"), **t,
            **extra}


def log_rows(rows):
    """One line a kernel row: ms a call and, for K2's forward, on the device
    and its first-design yardstick's; the bound and its share; the library
    call's and the plain version's ms."""
    for r in rows:
        dev_ms = r.get("device_ms", r["ms"])
        line = f"{r['name']}: {r['ms']:.4f} ms a call"
        if "device_ms" in r:
            line += f", {dev_ms:.4f} ms on the device"
        line += (f" (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                 f"{r['bound_ms'] / dev_ms:.0%} of it)")
        if "yardstick_ms" in r:
            line += (f"; first-design yardstick {r['yardstick_ms']:.4f} ms on the device, "
                     f"{r['yardstick_call_ms']:.4f} a call (turns {r['turns']})")
        if "bands_per_tile" in r:
            line += (f"; {r['bands_per_tile']:.3f} bands a tile, "
                     f"{r['unstaged_warp_share']:.4f} of the warps past the window cap")
        lib = r["library_ms"]
        line += "; library " + ("none" if lib is None else f"{lib:.4f} ms a call")
        if "library_device_ms" in r:
            line += f", {r['library_device_ms']:.4f} on the device"
        log(line + f"; plain {r['plain_ms']:.3f} ms")


def k2_host_split(img, grid, reps=50):
    """Where a short K2 call's time goes (ms a call, back-to-back): the
    bare launch into an output made once, the wrapper (checks, output,
    stream, launch), the path's own entry (grid_sample under
    inference_mode, as the MAT post-processing calls it), and the host's
    time alone (host clock over calls that are not waited for) for the
    bare launch, the output's allocation, the wrapper, the path's entry
    and F.grid_sample."""
    import torch
    import torch.nn.functional as F
    from waldo_tpu_torch.ops.grid_sample import grid_sample
    from waldo_tpu_torch.ops.kernels import GRID_SAMPLE, grid_sample_cuda

    f, h, w, c = img.shape
    rows, ho, wo = grid.shape[:3]
    out = torch.empty((rows, ho, wo, c), dtype=img.dtype, device=img.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (img.data_ptr(), None, grid.data_ptr(), out.data_ptr(), h, w, c, rows, ho, wo, 1, 0,
            int(img.dtype == torch.bfloat16), stream)
    nchw = img.permute(0, 3, 1, 2).float().contiguous()
    lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return t

    res = {"launch_ms": cuda_time(lambda: GRID_SAMPLE.launch(None, *args), reps),
           "launch_host_ms": host_ms(lambda: GRID_SAMPLE.launch(None, *args)),
           "empty_host_ms": host_ms(lambda: torch.empty((rows, ho, wo, c), dtype=img.dtype,
                                                        device=img.device)),
           "wrapper_ms": cuda_time(lambda: grid_sample_cuda(img, grid, 1), reps),
           "wrapper_host_ms": host_ms(lambda: grid_sample_cuda(img, grid, 1)),
           "library_host_ms": host_ms(lib)}
    with torch.inference_mode():
        res["path_ms"] = cuda_time(lambda: grid_sample(img, grid), reps)
        res["path_host_ms"] = host_ms(lambda: grid_sample(img, grid))
    return res


def k2_edge_checks(dev, rng):
    """K2's shared-grid forward against its plain version on its edge
    cases, each launched into an output filled with NaN (an element the
    kernel never writes then fails): C = 1, 3 (the few-channel kernel), 23,
    32 (the tile kernel); tp_sz 1 and 3; output sizes that are not whole
    tiles; texture rows of a whole number of 16-byte vectors and not (the
    window's two copy paths); smooth warps with the inverse warp's holes at
    4.0; 1.5- and 3-fold shrinks (tile windows over the cap, staged in bands
    of warps) and a 6-fold one (bands of one warp over the cap: texels read
    from device memory); a grid wholly out of range; bf16 textures. Then the
    autograd route: a sample whose inputs want a gradient records the
    kernel's backward, one under no_grad does not. Returns the largest
    float32 error."""
    import torch
    from waldo_tpu_torch.ops import get_grid
    from waldo_tpu_torch.ops.grid_sample import (FWD_FEW_C, _grid_sample_kernel,
                                                 grid_sample_ctx_plain, shared_fwd_windows)
    from waldo_tpu_torch.ops.kernels import GRID_SAMPLE

    worst = 0.0
    for f, h, w, c, tp, ho, wo, kind, dtype in (
            (2, 37, 52, 1, 3, 29, 45, "smooth", torch.float32),
            (2, 37, 53, 3, 1, 40, 37, "smooth", torch.float32),
            (2, 37, 52, 3, 3, 16, 48, "smooth", torch.float32),
            (3, 40, 48, 23, 1, 45, 61, "smooth", torch.float32),
            (2, 31, 45, 23, 3, 19, 70, "smooth", torch.float32),
            (2, 33, 64, 32, 3, 37, 29, "smooth", torch.float32),
            (2, 64, 96, 23, 3, 64, 96, "shrink1.5", torch.float32),
            (2, 64, 96, 23, 1, 64, 96, "shrink3", torch.float32),
            (2, 200, 256, 23, 1, 33, 40, "shrink6", torch.float32),
            (2, 37, 52, 23, 3, 20, 30, "out_of_range", torch.float32),
            (2, 37, 52, 23, 3, 29, 45, "smooth", torch.bfloat16),
            (2, 37, 53, 3, 1, 29, 45, "smooth", torch.bfloat16),
            (2, 64, 96, 23, 1, 64, 96, "shrink3", torch.bfloat16)):
        img, grid = k2_inputs(rng, f, h, w, c, tp, ho, wo, dev, dtype)
        if kind != "smooth":
            base = torch.as_tensor(get_grid(ho, wo), device=dev)
            grid = (grid + 3.0 if kind == "out_of_range" else base * float(kind[6:]))
            grid = grid.expand(f * tp, ho, wo, 2).contiguous()
        tiles = bands = unstaged = 0
        if c > FWD_FEW_C:  # the tile kernel's windows (fewer channels: a thread a pixel)
            win = shared_fwd_windows(grid, h, w, c, img.element_size())
            tiles = win.shape[0] * win.shape[1] * win.shape[2]
            bands = int((win[..., 4] == torch.arange(win.shape[3], device=dev)).sum())
            unstaged = int(((win[..., 4] >= 0) & (win[..., 6] == 0)).sum())
        out = torch.full((f * tp, ho, wo, c), float("nan"), device=dev).to(dtype)
        GRID_SAMPLE.launch(None, img.data_ptr(), None, grid.data_ptr(), out.data_ptr(), h, w, c,
                           f * tp, ho, wo, tp, 0, int(dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
        want = grid_sample_ctx_plain(img, grid, tp)
        torch.cuda.synchronize()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        e = float((out.float() - want.float()).abs().max())
        label = (f"{f}x{h}x{w} C={c} tp_sz {tp} -> {ho}x{wo} {kind} "
                 f"{str(dtype).replace('torch.', '')}")
        log(f"grid_sample edge case {label}: max|err| {e:.3g} (tol {tol:.3g}); "
            f"{bands} bands in {tiles} tiles, {unstaged} warps reading device memory")
        check(e <= tol and bool(torch.isfinite(out).all()),
              f"grid_sample edge case {label} disagrees: {e}")
        check(kind in ("smooth", "out_of_range", "shrink6") or bands > tiles,
              f"{label}: no tile was split into bands")
        check(kind != "shrink6" or unstaged > 0, f"{label}: every band was staged")
        if dtype == torch.float32:
            worst = max(worst, e)
    img, grid = k2_inputs(rng, 2, 37, 52, 23, 3, 29, 45, dev)
    grid.requires_grad_()
    out = _grid_sample_kernel(img, grid, 3)
    check(out.grad_fn is not None, "a sample whose grid wants a gradient recorded no backward")
    (g,) = torch.autograd.grad(out, grid, torch.ones_like(out))
    check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
          "the sample's grid gradient is not finite or all 0")
    with torch.no_grad():
        check(_grid_sample_kernel(img, grid, 3).grad_fn is None,
              "a sample under no_grad recorded a backward")
    log("grid_sample autograd route: a grid that wants a gradient records the kernel's "
        "backward; under no_grad the kernel runs alone")
    return worst


def k2_fwd_study(dev, card_name):
    """--k2-fwd: K2's shared-grid forward at every row's shapes on dense
    inputs (smooth random warps with 5 % holes), each against its plain
    version and timed (k2_row); where the test.sh shapes' time goes in L2
    (the first-design yardstick with tp_sz 14 on 4 textures against tp_sz 1 on
    the 56 copies: equal times mean that every grid row reads its texture
    from device memory); and the host's share of the one-row MAT warps'
    calls (k2_host_split)."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import grid_sample_ctx_plain
    from waldo_tpu_torch.ops.kernels import grid_sample_cuda

    log("== K2 forward on its edge cases")
    k2_edge_checks(dev, np.random.RandomState(10))
    rng = np.random.RandomState(4)
    log("== K2 forward at every row's shapes, dense inputs")
    rows, extra = [], {}
    for label, f, h, w, c, tp in (("flagship N=56", 4, 256, 512, 23, 14),
                                  ("flagship N=40", 4, 256, 512, 23, 10),
                                  ("LVD batch mode", 112, 128, 256, 23, 1),
                                  ("WIF decode batch mode", 32, 512, 1024, 23, 1),
                                  ("test.sh N=56", 4, 512, 1024, 23, 14),
                                  ("test.sh N=40", 4, 512, 1024, 23, 10),
                                  ("MAT warp masks", 1, 512, 1024, 1, 1),
                                  ("MAT warp RGB", 1, 512, 1024, 3, 1)):
        img, grid = k2_inputs(rng, f, h, w, c, tp, h, w, dev)
        want = grid_sample_ctx_plain(img, grid, tp)
        err = max_err(grid_sample_cuda(img, grid, tp), want)
        err_first = max_err(fwd_first(img, grid, tp), want)
        del want
        check(err <= TOL_F32 and err_first <= TOL_F32,
              f"K2 {label}: max|err| {err} (first-design yardstick {err_first})")
        row = k2_row(card_name, f"grid_sample {label} {f}x{h}x{w} C={c} tp_sz {tp}", img, grid,
                     tp, 0, err)
        if c <= 3:
            row["host_split"] = k2_host_split(img, grid)
            log(f"{label}: {row['host_split']}")
        if label == "test.sh N=56":
            rep = img.repeat_interleave(tp, dim=0)
            extra["l2"] = {"first_tp14_ms": row["yardstick_ms"],
                           "first_tp1_copies_ms": graph_ms(lambda: fwd_first(rep, grid, 1)),
                           "new_tp14_ms": row["device_ms"],
                           "new_tp1_copies_ms": graph_ms(lambda: grid_sample_cuda(rep, grid, 1))}
            log(f"{label}, one texture for 14 rows against 56 copies: {extra['l2']}")
            del rep
        rows.append(row)
        log_rows(rows[-1:])
        del img, grid
        torch.cuda.empty_cache()
    return rows, extra


def plane_boxes_row(card_name, label, tex, n_launches):
    """The pre-pass checked for equality and timed. Its ~0.03 ms at 256x512
    is close to the host's cost of one wrapper call (checks, two
    allocations, the launch), so the kernel is timed launched into outputs
    made once, and the wrapper's time is logged beside it. One permute copy
    (what the warp's wrapper did before) is logged as a yardstick: it
    computes the planes but not the boxes."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import plane_boxes_plain
    from waldo_tpu_torch.ops.kernels import PLANE_BOXES, plane_boxes_cuda

    got = plane_boxes_cuda(tex)
    want = plane_boxes_plain(tex)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, want)), f"{label} disagrees")
    stream = torch.cuda.current_stream(tex.device).cuda_stream
    ms = cuda_time(lambda: PLANE_BOXES.launch(None, tex.data_ptr(), got[0].data_ptr(),
                                              got[1].data_ptr(), *tex.shape, 0, stream), 100)
    wrapper_ms = cuda_time(lambda: plane_boxes_cuda(tex), 100)
    plain = cuda_time(lambda: plane_boxes_plain(tex), 5)
    copy_ms = cuda_time(lambda: tex.permute(0, 3, 1, 2).contiguous(), 100)
    b_ms, b_by = bound(card_name, 2 * tex.numel() * 4 + want[1].numel() * 4, tex.numel())
    log(f"{label}: through its wrapper {wrapper_ms:.4f} ms; permute copy alone {copy_ms:.4f} ms")
    return {"name": label, "route": "cuda", "source": PRE_SOURCE, "replaces": PRE_REPLACES,
            "launches": n_launches, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_timings(dev, card_name, errs, by_key, mat_by_key, launches, k3_launches, k1_seen):
    import torch
    from waldo_tpu_torch.ops.bias_act import _ACTS, bias_act_plain
    from waldo_tpu_torch.ops.kernels import bias_act_cuda

    log("== 6. kernel timings at the main paths' shapes")
    bw, fp32 = card_rates(card_name)
    log(f"bounds at {bw / 1e12:.2f} TB/s and {fp32 / 1e12:.0f} TFLOP/s float32 ({card_name})")
    rng = np.random.RandomState(1)
    rows = []

    for tp in (14, 10):
        f, h, w, c, tc = 4, 256, 512, 17, 4
        n, p = f * tp, h * w
        # dense random alphas, and object-sparse ones (layer 0 dense, each
        # object one quad); without the ghost mask as the predict launches
        # the warp, with it as the MAT path (restrict_to_ctx) does
        for sparse in (False, True):
            a, g, o, io = k1_inputs(rng, f, h, w, c, tp, tc, True, dev, sparse)
            for mask, n_launches in ((None, by_key["warp_alpha_ctx"][n, False]),
                                     (io, mat_by_key["warp_alpha_ctx"][n, True])):
                rows.append(k1_row(card_name, f"warp_alpha_ctx N={n}"
                                   + (" object-sparse" if sparse else "")
                                   + ("" if mask is None else " is_obj"), a, g, o, mask, tp,
                                   tc * tp, n_launches,
                                   errs["warp_alpha_ctx", n, mask is not None, sparse]))
            del a, g, o, io
            torch.cuda.empty_cache()

        img, grid = k2_inputs(rng, f, h, w, 23, tp, h, w, dev)
        rows.append(k2_row(card_name, f"grid_sample_ctx N={n}", img, grid, tp,
                           by_key["grid_sample"][n], errs["grid_sample", n]))
        del img, grid
        torch.cuda.empty_cache()

    # the warp on the exact inputs the flagship predict handed it, with
    # their share of zero (pixel, layer) samples and of samples the box
    # test skips
    zero_shares = []
    for a, g, o, io, tp, tcp in k1_seen:
        n = g.shape[0]
        err = k1_check(a, g, o, io, tp, tcp, "the flagship predict's")
        zero_shares.append(k1_input_shares(a, g, io, tp, f"warp_alpha_ctx N={n} on the "
                                                         f"flagship predict's inputs"))
        rows.append(k1_row(card_name, f"warp_alpha_ctx N={n} flagship inputs"
                           + ("" if io is None else " is_obj"), a, g, o, io, tp, tcp,
                           by_key["warp_alpha_ctx"][n, io is not None], err))
        torch.cuda.empty_cache()

    # the pre-pass alone, on the flagship warp's texture shape
    tex = sparse_alpha(rng, 4, 256, 512, 17, dev)
    rows.append(plane_boxes_row(card_name, "plane_boxes 4x256x512x17", tex,
                                launches["plane_boxes"]))
    del tex

    # bias_act at MAT's largest call; no single PyTorch call adds a bias,
    # activates, scales and clamps
    x = torch.from_numpy(rng.randn(*K3_SHAPE).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(K3_SHAPE[-1]).astype(np.float32)).to(dev)
    gain = _ACTS["lrelu"][1]
    ms = cuda_time(lambda: bias_act_cuda(x, b, "lrelu", gain, None), 20)
    plain = cuda_time(lambda: bias_act_plain(x, b, -1, "lrelu", gain, None), 5)
    b_ms, b_by = bound(card_name, 4 * (2 * x.numel() + b.numel()), 3 * x.numel())
    rows.append({"name": "bias_act " + "x".join(map(str, K3_SHAPE)) + " lrelu", "route": "cuda",
                 "source": K3_SOURCE, "replaces": K3_REPLACES, "launches": k3_launches,
                 "max_abs_err": errs["bias_act"], "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None})
    del x
    torch.cuda.empty_cache()
    log_rows(rows)
    return rows, zero_shares


def train_lvd_flags(path=TRAIN_SCRIPT):
    """The flags a training script (scripts/cityscapes/train_lvd.sh by
    default) hands the training CLI, without its pass-through arguments."""
    import shlex

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)) as fh:
        text = fh.read().replace("\\\n", " ")
    for line in text.splitlines():
        if "cli.train" in line:
            return [a for a in shlex.split(line.split("cli.train", 1)[1])
                    if a not in ("$@", "${@:2}")]
    raise RuntimeError(f"no training command in {path}")


def small_train_cfg():
    """A small float32 LVD training config that still puts both samples of
    the path on their kernels (K2' always on the card; K2's batch mode needs
    128x256 frames and 16 channels of context, 3 + 13 layout classes), with
    the scatter inversion. Its pose head starts at zero (the config's
    default), so the object poses start at their biases on both sides: with
    train_lvd.sh's random pose head the card's and the CPU's nets, which sum
    in other orders, put a few pixels on the other side of the inversions'
    hard decisions (rounding to a pixel, the hole and convergence masks),
    and per-leaf gradients then differ by a few per cent."""
    from waldo_tpu_torch.config import Config, DataConfig, ModelConfig

    return Config(
        dim=128, aspect_ratio=2.0, batch_size_vid=1, compute_dtype="float32",
        data=DataConfig(num_lyt=13, fg_idx=[0, 1, 4, 5], bg_idx=[2, 3], other_idx=[6], vid_len=3,
                        dataset="synthetic"),
        model=ModelConfig(
            patch_size=16, latent_shape=(8, 16), obj_shape=(2, 2), embed_dim=64, num_heads=4,
            num_obj=4, oe_depth=1, pe_depth=1, oe_num_timesteps=5, ctx_len=2, use_pe=True,
            use_pg=False, use_ii=False, sample_precision="float32"))


def scatter_inversion_check(dev, rows=64, seed=5):
    """The scatter inversion of train_lvd's object layers (64x64 textures
    into 128x256 frames) on the card against the CPU, on the same forward
    grids (smooth random affine warps). Returns (share of pixels that
    differ by more than 1e-4, max|err| elsewhere)."""
    import torch
    from waldo_tpu_torch.ops import InverseWarp

    rng = np.random.RandomState(seed)
    g = smooth_grids(rng, rows, 1, 64, 64, "cpu", hole_frac=0.0)[:, 0] * 0.35
    got = InverseWarp(64, 64, 128, 256, device=dev)(g.to(dev)).cpu()
    want = InverseWarp(64, 64, 128, 256, device="cpu")(g)
    err = (got - want).abs().amax(dim=-1)
    off = err > 1e-4
    return float(off.float().mean()), float(err[~off].max())


def train_kernel_inputs(rng, f, h, w, c, dev):
    """The training path's two samples at their shapes, with the backward's
    edge cases in named layers / rows: per-channel texture (F, H, W, C) with
    layer 0 dense, layer 1 all zero, the others object-sparse; grids with
    layer 2 exactly on the pixel lattice (flow 0), layer 3 on it shifted by
    whole pixels, layer 4 wholly out of range, layer 5 a 3-fold shrink
    about a random centre per row (a zoom), the rest smooth warps with
    holes. Batch-mode texture (F, H, W, 23) dense, rows 0-1 zero, rows
    2-3 object-sparse; grid rows 4-5 on the lattice, 6-7 out of range, 8-9
    a 3-fold shrink (the K2 backward's texture windows then exceed its
    cap)."""
    import torch
    from waldo_tpu_torch.ops import get_grid

    base = torch.as_tensor(get_grid(h, w), device=dev)
    shift = torch.tensor([6.0 / w, -4.0 / h], device=dev)
    tex = sparse_alpha(rng, f, h, w, c, dev)
    tex[..., 1] = 0.0
    grids = smooth_grids(rng, f, c, h, w, dev)
    grids[:, 2] = base
    grids[:, 3] = base + shift
    grids[:, 4] += 3.0
    centre = torch.from_numpy(rng.uniform(-0.5, 0.5, (f, 1, 1, 2)).astype(np.float32)).to(dev)
    grids[:, 5] = base * 3.0 + centre
    img = torch.from_numpy(rng.rand(f, h, w, 23).astype(np.float32) * 2 - 1).to(dev)
    img[:2] = 0.0
    img[2:4] *= (sparse_alpha(rng, 2, h, w, 2, dev)[..., 1:] > 0)
    grid = smooth_grids(rng, f, 1, h, w, dev)[:, 0].contiguous()
    grid[4] = base
    grid[5] = base - shift
    grid[6:8] += 3.0
    grid[8:10] = base * 3.0
    return tex, grids.contiguous(), img, grid


_YARDSTICKS = {}


def yardstick(source, symbol, argtypes):
    """An earlier design of a kernel, kept in csrc/yardstick/ as the
    current one's yardstick: built and launched by this script alone, never
    counted."""
    from waldo_tpu_torch.ops.kernels.build import CudaKernel

    if source not in _YARDSTICKS:
        _YARDSTICKS[source] = CudaKernel(source, symbol, argtypes)
    return _YARDSTICKS[source]


def rows_bwd():
    """The per-channel backward's row-strip design (device atomics into
    planes, then a permute)."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return yardstick(ROWS_BWD_SOURCE, "waldo_grid_sample_per_channel_bwd_rows",
                     [p] * 6 + [i] * 6 + [p])


def shared_bwd_first(img, grid, gout, tp, need_img):
    """The shared backward's first design (a block-wide walk of its values,
    one in flight a thread, two block barriers) on contiguous float32
    inputs, as the wrapper of the current kernel takes them: (grad_img or
    None, grad_grid)."""
    import ctypes

    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    k = yardstick(SHARED_BWD_FIRST_SOURCE, "waldo_grid_sample_shared_bwd_first",
                  [p] * 5 + [i] * 7 + [p])
    f, h, w, c = img.shape
    rows, ho, wo = grid.shape[:3]
    g_grid = torch.empty_like(grid)
    g_img = torch.zeros_like(img) if need_img else None
    k.launch(None, img.data_ptr(), grid.data_ptr(), gout.data_ptr(), g_grid.data_ptr(),
             None if g_img is None else g_img.data_ptr(), h, w, c, rows, ho, wo, tp,
             torch.cuda.current_stream().cuda_stream)
    return g_img, g_grid


def rows_bwd_call(planes, boxes, grids, gout, g_grid, g_planes):
    import torch

    f, c, h, w = planes.shape
    rows_bwd().launch(None, planes.data_ptr(), boxes.data_ptr(), grids.data_ptr(),
                      gout.data_ptr(), g_grid.data_ptr(),
                      None if g_planes is None else g_planes.data_ptr(), h, w, c, f,
                      grids.shape[2], grids.shape[3], torch.cuda.current_stream().cuda_stream)


def rows_bwd_wrapper(planes, boxes, grids, gout):
    """The row-strip design as it ran on the training step: grad_out made
    channel-last (its autograd function's copy), zero-filled planes, the
    kernel, a permute copy to (F, H, W, C)."""
    import torch

    gout = gout.contiguous()
    g_grid, g_planes = torch.empty_like(grids), torch.zeros_like(planes)
    rows_bwd_call(planes, boxes, grids, gout, g_grid, g_planes)
    return g_planes.permute(0, 2, 3, 1).contiguous(), g_grid


def bwd_split(planes, boxes, grids, gout, reps=10):
    """Both per-channel backward designs on one grad_out (F, Ho, Wo, C), laid
    out as planes where the training step hands it over so: (a) the wrapper,
    (b) the kernel launch alone into preallocated outputs, (c) the kernel
    without grad_img, (d) the wrapper's other passes alone (the row-strip
    design's copy of grad_out to channel-last, memset and permute; the plane
    design has none on planes and pays one copy to planes on a channel-last
    grad_out, (e)). CUDA events after warm-up; the two wrappers in turns
    (row-strip, plane, plane, row-strip)."""
    import torch
    from waldo_tpu_torch.ops.kernels import grid_sample_per_channel_bwd_cuda
    from waldo_tpu_torch.ops.kernels.grid_sample import per_channel_bwd_launch

    gout_cl, gout_planes = gout.contiguous(), gout.permute(0, 3, 1, 2).contiguous()
    g_grid, g_planes = torch.empty_like(grids), torch.zeros_like(planes)
    rows = lambda: rows_bwd_wrapper(planes, boxes, grids, gout)
    plane = lambda: grid_sample_per_channel_bwd_cuda(planes, boxes, grids, gout, True)
    out = {"rows": dict(
        kernel=cuda_time(lambda: rows_bwd_call(planes, boxes, grids, gout_cl, g_grid, g_planes),
                         reps),
        kernel_no_img=cuda_time(lambda: rows_bwd_call(planes, boxes, grids, gout_cl, g_grid, None),
                                reps),
        copy_grad_out=cuda_time(lambda: gout.contiguous(), reps),
        memset=cuda_time(lambda: torch.zeros_like(planes), reps),
        permute=cuda_time(lambda: g_planes.permute(0, 2, 3, 1).contiguous(), reps)),
        "plane": dict(
        kernel=cuda_time(lambda: per_channel_bwd_launch(planes, boxes, grids, gout_planes, g_grid,
                                                        g_planes), reps),
        kernel_no_img=cuda_time(lambda: per_channel_bwd_launch(planes, boxes, grids, gout_planes,
                                                               g_grid, None), reps),
        wrapper_channel_last=cuda_time(lambda: grid_sample_per_channel_bwd_cuda(
            planes, boxes, grids, gout_cl, True), reps))}
    del g_grid, g_planes, gout_cl
    out["rows"]["wrapper"], out["plane"]["wrapper"] = [], []
    for k, fn in (("rows", rows), ("plane", plane), ("plane", plane), ("rows", rows)):
        out[k]["wrapper"].append(cuda_time(fn, reps))
    return out


def log_split(label, sp):
    r, t = sp["rows"], sp["plane"]
    log(f"  K2' backward, {label} (ms; wrappers in turns row-strip, plane, plane, row-strip): "
        f"row-strip (a) wrapper {r['wrapper'][0]:.4f} / {r['wrapper'][1]:.4f}, (b) kernel "
        f"{r['kernel']:.4f}, (c) no grad_img {r['kernel_no_img']:.4f}, (d) grad_out copy "
        f"{r['copy_grad_out']:.4f}, memset {r['memset']:.4f}, permute {r['permute']:.4f}; plane "
        f"(a) {t['wrapper'][0]:.4f} / {t['wrapper'][1]:.4f}, (b) {t['kernel']:.4f}, (c) "
        f"{t['kernel_no_img']:.4f}, (e) on channel-last grad_out {t['wrapper_channel_last']:.4f}")


def grad_out_stats(gout):
    """How a backward's grad_out (rows, Ho, Wo, C) is handed over: its type,
    strides, whether it is contiguous or laid out as (rows, C, Ho, Wo)
    planes, the share of it that is exactly 0 (those samples read no
    texel) and the channels that are not 0 everywhere."""
    live = (gout != 0).flatten(0, -2).any(0)
    return {"dtype": str(gout.dtype), "stride": list(gout.stride()),
            "contiguous": gout.is_contiguous(), "planes": gout.permute(0, 3, 1, 2).is_contiguous(),
            "zero_share": float((gout == 0).float().mean()),
            "live_channels": [int(c) for c in live.nonzero()[:, 0]]}


def capture_k2_bwd_inputs(tr, mode, batch):
    """One training step with the K2 backward's inputs copied as its
    autograd function holds them: the texture and grid it saved, and the
    output gradient autograd hands it (how that is laid out is read before
    the copy). Returns (the step's metrics, (img, grid, tp_sz, grad_out,
    grad_out's stats))."""
    import importlib

    gs = importlib.import_module("waldo_tpu_torch.ops.grid_sample")
    orig, seen = gs._grid_sample_kernel, []

    def spy(img, grid, tp_sz):
        out = orig(img, grid, tp_sz)
        if out.requires_grad:
            rec = [img.detach().contiguous().clone(), grid.detach().float().contiguous().clone(),
                   tp_sz]
            out.register_hook(lambda g: rec.extend([g.detach().clone(), grad_out_stats(g)]))
            seen.append(rec)
        return out

    gs._grid_sample_kernel = spy
    try:
        metrics = tr.step(mode, batch, 0)
    finally:
        gs._grid_sample_kernel = orig
    check(len(seen) == 1 and len(seen[0]) == 5,
          f"expected one K2 sample with a backward in the step, got {len(seen)}")
    return metrics, seen[0]


def capture_pc_bwd_inputs(tr, mode, batch):
    """One training step with the K2' backward's inputs (planes, boxes,
    grids, grad_out) copied as the autograd function hands them over, in
    their memory layout (clone keeps the strides)."""
    import importlib

    # the module (the package's grid_sample attribute is the function)
    gs = importlib.import_module("waldo_tpu_torch.ops.grid_sample")
    orig, seen = gs.grid_sample_per_channel_bwd_cuda, []

    def spy(planes, boxes, grids, grad_out, need_img):
        seen.append([t.clone() for t in (planes, boxes, grids, grad_out)] + [need_img])
        return orig(planes, boxes, grids, grad_out, need_img)

    gs.grid_sample_per_channel_bwd_cuda = spy
    try:
        tr.step(mode, batch, 0)
    finally:
        gs.grid_sample_per_channel_bwd_cuda = orig
    check(len(seen) == 1 and seen[0][4], f"expected one K2' backward with grad_img in a step, got "
                                         f"{len(seen)}")
    return seen[0][:4]


def phase_train_kernels(dev, card_name, run_launches, step_inputs, k2_step_inputs):
    """The training path's samples at train_lvd's shapes (B*Tc*Tp = 112 rows of
    128x256): K2' (per-channel, C=17) and K2 in batch mode (C=23), each
    forward and hand-written backward against the plain version's autograd,
    on the edge cases of train_kernel_inputs and on dense inputs (the K2
    backward also at ragged shapes and tp_sz > 1); then each timed beside
    its bound, the plain version and one ATen call. Each backward is also
    timed in turns against its earlier design (csrc/yardstick/), on those
    inputs and on the ones a training step handed it (step_inputs for K2',
    k2_step_inputs, from a step with pxl_vid, for K2); the K2' backward is
    split into its wrapper's parts."""
    import torch
    import torch.nn.functional as F
    from waldo_tpu_torch.ops import get_grid
    from waldo_tpu_torch.ops.grid_sample import (BWD_PLANE_CAP, grid_sample_ctx_plain,
                                                 grid_sample_multigrid_plain, grid_sample_plain,
                                                 shared_bwd_windows)
    from waldo_tpu_torch.ops.kernels import (grid_sample_bwd_cuda, grid_sample_cuda,
                                             grid_sample_per_channel_bwd_cuda,
                                             grid_sample_per_channel_cuda)

    rng = np.random.RandomState(4)
    f, h, w, c, p = 112, 128, 256, 17, 128 * 256
    rows, errs, bwd_res = [], {}, {}

    def rel(got, want, label):
        scale = float(want.abs().max())
        e = float((got - want).abs().max())
        log(f"  {label}: max|err| {e:.3g} of max|plain| {scale:.3g}")
        check(bool(torch.isfinite(got).all()) and e <= TOL_F32 * max(scale, 1e-30),
              f"{label} disagrees with the plain version: {e} > {TOL_F32} x {scale}")
        return e

    def plain_grads(fn, inputs, need, gout):
        ins = [x.detach().clone().requires_grad_(n) for x, n in zip(inputs, need)]
        out = fn(*ins)
        gs = torch.autograd.grad(out, [x for x, n in zip(ins, need) if n], gout)
        return out.detach(), list(gs)

    tex, grids, img, grid = train_kernel_inputs(rng, f, h, w, c, dev)
    # the K2' backward's grad_out laid out as planes, as the training step hands it over
    gout_pc = torch.randn(f, c, h, w, device=dev).permute(0, 2, 3, 1)
    gout_b = torch.randn(f, h, w, 23, device=dev)

    # K2' forward and backward, edge cases by layer
    log(f"K2' per-channel sample {f}x{h}x{w} C={c}, forward and backward against the plain "
        f"version (tolerance {TOL_F32} x max|plain|)")
    out, planes, boxes = grid_sample_per_channel_cuda(tex, grids)
    g_img, g_grid = grid_sample_per_channel_bwd_cuda(planes, boxes, grids, gout_pc, True)
    w_out, (w_img, w_grid) = plain_grads(grid_sample_multigrid_plain, (tex, grids),
                                         (True, True), gout_pc)
    torch.cuda.synchronize()
    errs["pc_fwd"] = rel(out, w_out, "forward, object-sparse with the edge layers")
    e_img = rel(g_img, w_img, "grad_img, all layers")
    e_grid = rel(g_grid, w_grid, "grad_grid, all layers")
    check(float(w_img[..., 1].abs().max()) > 0, "the all-zero plane's plain grad_img is 0")
    rel(g_img[..., 1], w_img[..., 1], "grad_img of the all-zero plane (layer 1)")
    rel(g_grid[:, 2:4], w_grid[:, 2:4], "grad_grid on the pixel lattice (layers 2, 3)")
    rel(g_img[..., 2:4], w_img[..., 2:4], "grad_img on the pixel lattice (layers 2, 3)")
    check(not bool(g_grid[:, 4].any()) and not bool(w_grid[:, 4].any()),
          "grad_grid of a grid wholly out of range is not 0")
    rel(g_img[..., 5], w_img[..., 5], "grad_img of the zoom layer (5)")
    rel(g_grid[:, 5], w_grid[:, 5], "grad_grid of the zoom layer (5)")
    rel(g_grid[:, 6:], w_grid[:, 6:], "grad_grid of the object-sparse layers")
    errs["pc_bwd"] = max(float((g_img - w_img).abs().max()), float((g_grid - w_grid).abs().max()))
    y_img, y_grid = rows_bwd_wrapper(planes, boxes, grids, gout_pc)
    torch.cuda.synchronize()
    rel(y_img, w_img, "row-strip yardstick: grad_img")
    rel(y_grid, w_grid, "row-strip yardstick: grad_grid")
    del out, g_img, g_grid, w_out, w_img, w_grid, y_img, y_grid
    bwd_res["split_edge_inputs"] = bwd_split(planes, boxes, grids, gout_pc)
    log_split("train_kernel_inputs", bwd_res["split_edge_inputs"])
    del planes, boxes

    # planes over the kernel's shared-memory cap take its device-atomic branch
    fo, ho_, wo_, co = 4, 256, 512, 3
    check(ho_ * wo_ > BWD_PLANE_CAP, "the oversized planes fit the shared-memory cap")
    tex_o = torch.rand(fo, ho_, wo_, co, device=dev)
    grids_o = smooth_grids(rng, fo, co, ho_, wo_, dev)
    grids_o[:, 0] = torch.as_tensor(get_grid(ho_, wo_), device=dev) * 3.0  # a zoom too
    gout_o = torch.randn(fo, co, ho_, wo_, device=dev).permute(0, 2, 3, 1)
    _, planes_o, boxes_o = grid_sample_per_channel_cuda(tex_o, grids_o)
    g_img, g_grid = grid_sample_per_channel_bwd_cuda(planes_o, boxes_o, grids_o, gout_o, True)
    _, (w_img, w_grid) = plain_grads(grid_sample_multigrid_plain, (tex_o, grids_o), (True, True),
                                     gout_o)
    torch.cuda.synchronize()
    log(f"K2' backward on {fo}x{ho_}x{wo_} C={co} planes, over the {BWD_PLANE_CAP}-texel cap:")
    errs["pc_bwd"] = max(errs["pc_bwd"], rel(g_img, w_img, "grad_img"),
                         rel(g_grid, w_grid, "grad_grid"))
    del tex_o, grids_o, gout_o, planes_o, boxes_o, g_img, g_grid, w_img, w_grid

    # K2' backward on the inputs a training step handed it
    s_planes, s_boxes, s_grids, s_gout = step_inputs
    s_tex = s_planes.permute(0, 2, 3, 1).contiguous()
    st = bwd_res["step_inputs"] = grad_out_stats(s_gout)
    log(f"K2' backward on one training step's own inputs {tuple(s_gout.shape)}: grad_out "
        f"strides {st['stride']} ({'planes' if st['planes'] else 'not planes'}), "
        f"{st['zero_share']:.4g} of it exactly 0")
    g_img, g_grid = grid_sample_per_channel_bwd_cuda(s_planes, s_boxes, s_grids, s_gout, True)
    _, (w_img, w_grid) = plain_grads(grid_sample_multigrid_plain, (s_tex, s_grids), (True, True),
                                     s_gout)
    torch.cuda.synchronize()
    errs["pc_bwd"] = max(errs["pc_bwd"], rel(g_img, w_img, "grad_img, a training step's inputs"),
                         rel(g_grid, w_grid, "grad_grid, a training step's inputs"))
    del g_img, g_grid, w_img, w_grid, s_tex
    bwd_res["split_step_inputs"] = bwd_split(s_planes, s_boxes, s_grids, s_gout)
    log_split("a training step's inputs", bwd_res["split_step_inputs"])
    del s_planes, s_boxes, s_grids, s_gout, step_inputs
    torch.cuda.empty_cache()

    # K2' on dense inputs, checked and timed
    tex = torch.rand(f, h, w, c, device=dev)
    grids = smooth_grids(rng, f, c, h, w, dev)
    out, planes, boxes = grid_sample_per_channel_cuda(tex, grids)
    g_img, g_grid = grid_sample_per_channel_bwd_cuda(planes, boxes, grids, gout_pc, True)
    ins = [tex.clone().requires_grad_(), grids.clone().requires_grad_()]
    w_out = grid_sample_multigrid_plain(*ins)
    w_img, w_grid = torch.autograd.grad(w_out, ins, gout_pc, retain_graph=True)
    log("K2' on dense inputs:")
    errs["pc_fwd"] = max(errs["pc_fwd"], rel(out, w_out.detach(), "forward"))
    errs["pc_bwd"] = max(errs["pc_bwd"], rel(g_img, w_img, "grad_img"),
                         rel(g_grid, w_grid, "grad_grid"))
    del w_img, w_grid
    bwd_res["split_dense"] = bwd_split(planes, boxes, grids, gout_pc)
    log_split("dense inputs", bwd_res["split_dense"])
    tex_fold = tex.permute(0, 3, 1, 2).reshape(f * c, 1, h, w).contiguous()
    grids_fold = grids.reshape(f * c, h, w, 2)
    gout_fold = gout_pc.permute(0, 3, 1, 2).reshape(f * c, 1, h, w)  # a view: planes
    aten_bwd = torch.ops.aten.grid_sampler_2d_backward
    fwd = dict(
        ms=cuda_time(lambda: grid_sample_per_channel_cuda(tex, grids), 10),
        plain_ms=cuda_time(lambda: grid_sample_multigrid_plain(tex, grids), 3),
        library_ms=cuda_time(lambda: F.grid_sample(tex_fold, grids_fold, mode="bilinear",
                                                   padding_mode="zeros", align_corners=False), 10))
    bwd = dict(
        ms=cuda_time(lambda: grid_sample_per_channel_bwd_cuda(planes, boxes, grids, gout_pc, True),
                     10),
        plain_ms=cuda_time(lambda: torch.autograd.grad(w_out, ins, gout_pc, retain_graph=True), 3),
        library_ms=cuda_time(lambda: aten_bwd(gout_fold, tex_fold, grids_fold, 0, 0, False,
                                              [True, True]), 10))
    n_s = f * c * p  # samples
    texel_b, grid_b = 4 * f * h * w * c, 8 * n_s
    b_fwd = bound(card_name, texel_b + grid_b + 4 * n_s, 24 * n_s)
    b_bwd = bound(card_name, 2 * grid_b + 4 * n_s + 2 * texel_b, 40 * n_s)
    rows.append({"name": f"grid_sample_per_channel {f}x{h}x{w} C={c}", "route": "cuda",
                 "source": K2_SOURCE, "replaces": K2_REPLACES,
                 "launches": run_launches["grid_sample_per_channel"], "max_abs_err": errs["pc_fwd"],
                 **fwd, "bound_ms": b_fwd[0], "bound_by": b_fwd[1]})
    rows.append({"name": f"grid_sample_per_channel_bwd {f}x{h}x{w} C={c}", "route": "cuda",
                 "source": BWD_SOURCE, "replaces": K2PC_BWD_REPLACES,
                 "launches": run_launches["grid_sample_per_channel_bwd"],
                 "max_abs_err": errs["pc_bwd"], **bwd, "bound_ms": b_bwd[0], "bound_by": b_bwd[1]})
    del tex, grids, out, planes, boxes, g_img, g_grid, ins, w_out, tex_fold, grids_fold, gout_fold
    torch.cuda.empty_cache()


    # K2 batch mode forward and backward, edge cases by row
    log(f"K2 batch-mode sample {f}x{h}x{w} C=23, forward and backward")
    out = grid_sample_cuda(img, grid, 1)
    g_img, g_grid = grid_sample_bwd_cuda(img, grid, gout_b, 1, True)
    _, g_grid_only = grid_sample_bwd_cuda(img, grid, gout_b, 1, False)
    w_out, (w_img, w_grid) = plain_grads(grid_sample_plain, (img, grid), (True, True), gout_b)
    y_img, y_grid = shared_bwd_first(img, grid, gout_b, 1, True)
    torch.cuda.synchronize()
    errs["b_fwd"] = rel(out, w_out, "forward")
    rel(g_img, w_img, "grad_img (not asked for on the path)")
    rel(g_grid, w_grid, "grad_grid")
    check(torch.equal(g_grid, g_grid_only), "grad_grid depends on whether grad_img is asked for")
    check(float(w_img[:2].abs().max()) > 0, "the all-zero textures' plain grad_img is 0")
    rel(g_img[:2], w_img[:2], "grad_img of the all-zero textures (rows 0, 1)")
    rel(g_grid[2:4], w_grid[2:4], "grad_grid of the object-sparse textures (rows 2, 3)")
    rel(g_grid[4:6], w_grid[4:6], "grad_grid on the pixel lattice (rows 4, 5)")
    rel(g_img[4:6], w_img[4:6], "grad_img on the pixel lattice (rows 4, 5)")
    check(not bool(g_grid[6:8].any()) and not bool(w_grid[6:8].any()),
          "grad_grid of a grid wholly out of range is not 0")
    staged = shared_bwd_windows(grid[8:10], h, w, 23)[..., 5]
    check(not bool(staged.all()), "the shrink's texture windows all fit the cap")
    rel(g_grid[8:10], w_grid[8:10], f"grad_grid of the 3-fold shrink (rows 8, 9; "
                                    f"{float(staged.float().mean()):.2f} of its tiles staged)")
    rel(y_img, w_img, "first-design yardstick: grad_img")
    rel(y_grid, w_grid, "first-design yardstick: grad_grid")
    errs["b_bwd"] = max(float((g_grid - w_grid).abs().max()), float((g_img - w_img).abs().max()))
    del out, g_img, g_grid, g_grid_only, w_out, w_img, w_grid, y_img, y_grid
    errs["b_bwd"] = max(errs["b_bwd"], k2_bwd_ragged_checks(dev, rng, rel, plain_grads))

    # K2 on dense inputs, checked and timed
    torch.cuda.empty_cache()
    img = torch.rand(f, h, w, 23, device=dev) * 2 - 1
    grid = smooth_grids(rng, f, 1, h, w, dev)[:, 0].contiguous()
    out = grid_sample_cuda(img, grid, 1)
    _, g_grid = grid_sample_bwd_cuda(img, grid, gout_b, 1, False)
    grid_p = grid.clone().requires_grad_()
    w_out = grid_sample_plain(img, grid_p)
    (w_grid,) = torch.autograd.grad(w_out, grid_p, gout_b, retain_graph=True)
    log("K2 batch mode on dense inputs:")
    errs["b_fwd"] = max(errs["b_fwd"], rel(out, w_out.detach(), "forward"))
    errs["b_bwd"] = max(errs["b_bwd"], rel(g_grid, w_grid, "grad_grid"))
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    gout_nchw = gout_b.permute(0, 3, 1, 2).contiguous()
    bwd = dict(
        ms=cuda_time(lambda: grid_sample_bwd_cuda(img, grid, gout_b, 1, False), 10),
        plain_ms=cuda_time(lambda: torch.autograd.grad(w_out, grid_p, gout_b, retain_graph=True),
                           3),
        library_ms=aten_grid_bwd_ms(img_nchw, grid, gout_nchw))
    del img_nchw, gout_nchw
    k2b = bwd_res["k2_backward"] = {"dense": k2_bwd_turns(img, grid, gout_b)}
    k2b["dense"]["tiles_staged"] = float(shared_bwd_windows(grid, h, w, 23)[..., 5].float().mean())
    # ATen on the channel-last tensors themselves (NCHW views), beside its NCHW time
    k2b["dense"]["aten_channel_last"] = aten_grid_bwd_ms(img.permute(0, 3, 1, 2), grid,
                                                         gout_b.permute(0, 3, 1, 2))
    b_bwd = k2_bwd_bound(card_name, img, grid, gout_b)
    rows.append(k2_row(card_name, f"grid_sample batch mode {f}x{h}x{w} C=23", img, grid, 1,
                       run_launches["grid_sample"], errs["b_fwd"]))
    k2_bwd_row = {"name": f"grid_sample_bwd batch mode {f}x{h}x{w} C=23, grid only "
                      f"(launched by an LVD step with pxl_vid)",
              "route": "cuda", "source": BWD_SOURCE, "replaces": K2_BWD_REPLACES,
              "launches": run_launches["grid_sample_bwd"], "max_abs_err": errs["b_bwd"],
              **bwd, "bound_ms": b_bwd[0], "bound_by": b_bwd[1]}
    rows.append(k2_bwd_row)
    del img, grid, out, g_grid, grid_p, w_out, w_grid, gout_pc, gout_b
    torch.cuda.empty_cache()

    # K2 backward on the inputs the pxl_vid step handed it
    s_img, s_grid, s_tp, s_gout, st = k2_step_inputs
    st["tiles_staged"] = float(shared_bwd_windows(s_grid, *s_img.shape[1:])[..., 5].float().mean())
    log(f"K2 backward on the pxl_vid step's own inputs: img {tuple(s_img.shape)}, grid "
        f"{tuple(s_grid.shape)}, tp_sz {s_tp}; grad_out {st['dtype']} strides {st['stride']} "
        f"({'contiguous' if st['contiguous'] else 'not contiguous'}), {st['zero_share']:.4g} of "
        f"it exactly 0, channels not 0 everywhere {st['live_channels']}; "
        f"{st['tiles_staged']:.4g} of the tiles' texture windows staged")
    s_in = s_gout.float().contiguous()  # as the autograd function hands it to the wrapper
    g_img, g_grid = grid_sample_bwd_cuda(s_img, s_grid, s_in, s_tp, True)
    _, (w_img, w_grid) = plain_grads(lambda i, g: grid_sample_ctx_plain(i, g, s_tp),
                                     (s_img, s_grid), (True, True), s_gout)
    torch.cuda.synchronize()
    errs["b_bwd"] = max(errs["b_bwd"], rel(g_grid, w_grid, "grad_grid, the pxl_vid step's inputs"),
                        rel(g_img, w_img, "grad_img, the pxl_vid step's inputs"))
    del g_img, g_grid, w_img, w_grid
    b_step = k2_bwd_bound(card_name, s_img, s_grid, s_gout)
    k2b["step_inputs"] = dict(
        grad_out=st, bound_ms=b_step[0],
        ms=cuda_time(lambda: grid_sample_bwd_cuda(s_img, s_grid, s_in, s_tp, False), 10),
        **k2_bwd_turns(s_img, s_grid, s_gout, s_tp))
    k2_bwd_row["max_abs_err"] = errs["b_bwd"]
    k2_bwd_row["turns"] = {k: {"first": v["first"], "new": v["new"]} for k, v in k2b.items()}
    del s_img, s_grid, s_gout, s_in, k2_step_inputs
    torch.cuda.empty_cache()
    log_rows(rows)
    d, t = k2b["dense"], k2b["step_inputs"]
    log(f"K2 backward, grid only, in turns first design, tiles, tiles, first design (ms, as the "
        f"autograd function runs each): dense {d['first'][0]:.4f} / {d['new'][0]:.4f} / "
        f"{d['new'][1]:.4f} / {d['first'][1]:.4f} ({d['tiles_staged']:.4g} of the windows staged; "
        f"ATen NCHW {k2_bwd_row['library_ms']:.4f}, ATen on the channel-last views "
        f"{d['aten_channel_last']:.4f}); the pxl_vid step's inputs {t['first'][0]:.4f} / "
        f"{t['new'][0]:.4f} / {t['new'][1]:.4f} / {t['first'][1]:.4f} (bound on these inputs "
        f"{t['bound_ms']:.4f})")
    return rows, bwd_res


def aten_grid_bwd_ms(img, grid, gout, reps=10):
    """ATen's grid_sampler_2d_backward, grid gradient only, on (N, C, H, W)
    tensors (bilinear, zero padding, align_corners=False)."""
    import torch

    return cuda_time(lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, img, grid, 0, 0, False, [False, True]), reps)


def k2_bwd_bound(card_name, img, grid, gout):
    """The K2 backward's bound (grid gradient only) on these inputs: grad_out,
    the grid and grad_grid once, and of the texture the channels that some
    nonzero output gradient reads (a texture row's channel whose output
    gradient is 0 everywhere needs no byte); 16 operations a pixel for its
    taps and 12 a value with a nonzero output gradient."""
    f, h, w, c = img.shape
    rows = grid.shape[0]
    live = (gout != 0).reshape(f, rows // f, -1, c).any(2).any(1)  # (F, C)
    nbytes = 4 * (h * w * int(live.sum()) + 4 * grid[..., 0].numel() + gout.numel())
    return bound(card_name, nbytes, 16 * grid[..., 0].numel() + 12 * int((gout != 0).sum()))


def k2_bwd_turns(img, grid, gout, tp=1, reps=10):
    """The K2 backward, grid only, as its autograd function runs it (grad_out
    made contiguous float32, then the wrapper), in its first design and the
    tile kernel, in turns: first, new, new, first."""
    from waldo_tpu_torch.ops.kernels import grid_sample_bwd_cuda

    new = lambda: grid_sample_bwd_cuda(img, grid, gout.float().contiguous(), tp, False)
    old = lambda: shared_bwd_first(img, grid, gout.float().contiguous(), tp, False)
    out = {"first": [], "new": []}
    for k, fn in (("first", old), ("new", new), ("new", new), ("first", old)):
        out[k].append(cuda_time(fn, reps))
    return out


def k2_bwd_ragged_checks(dev, rng, rel, plain_grads):
    """The K2 backward at small ragged shapes against the plain autograd:
    runs of pixels that end inside a warp, odd widths, tp_sz > 1, channel
    counts that take one, an even and several chunks of the kernel, and a
    grad_out whose first float is not 16-byte aligned (the kernel stages it
    by scalar loads then), whose grad_grid must equal the aligned one's."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import grid_sample_ctx_plain
    from waldo_tpu_torch.ops.kernels import grid_sample_bwd_cuda

    err = 0.0
    for f, h, w, c, tp, ho, wo in ((3, 31, 45, 7, 2, 19, 70), (2, 37, 53, 37, 3, 29, 61),
                                   (2, 24, 40, 23, 2, 25, 41), (2, 20, 33, 16, 1, 17, 35),
                                   (1, 9, 11, 1, 4, 13, 7), (2, 40, 24, 32, 2, 33, 31)):
        img, grid = k2_inputs(rng, f, h, w, c, tp, ho, wo, dev)
        gout = torch.randn(f * tp, ho, wo, c, device=dev)
        shifted = torch.empty(gout.numel() + 1, device=dev)[1:].view(gout.shape)
        shifted.copy_(gout)
        g_img, g_grid = grid_sample_bwd_cuda(img, grid, gout, tp, True)
        _, g_grid_s = grid_sample_bwd_cuda(img, grid, shifted, tp, False)
        _, (w_img, w_grid) = plain_grads(lambda i, g: grid_sample_ctx_plain(i, g, tp),
                                         (img, grid), (True, True), gout)
        torch.cuda.synchronize()
        label = f"K2 backward {f}x{h}x{w} C={c} tp_sz {tp} -> {ho}x{wo}"
        err = max(err, rel(g_grid, w_grid, f"{label}: grad_grid"),
                  rel(g_img, w_img, f"{label}: grad_img"))
        check(torch.equal(g_grid, g_grid_s), f"{label}: grad_grid differs on a grad_out that is "
                                             f"not 16-byte aligned")
    return err


def phase_train(dev, card_name, root, profile_dir=None):
    """The LVD training path: train_lvd.sh's config on synthetic clips,
    saving under ``root``, Trainer.run for TRAIN_ITERS iterations (launch
    counts, finite loss, no skipped step, parameters moved, the "latest"
    slot restores equal), then TRAIN_TIMED steps timed on one fixed batch,
    the loader's iterations, the samples' kernels against their plain
    versions at the path's shapes, and a small float32 step on the card
    against the same step on the CPU. Returns the run's checkpoint dir too:
    phases 8 and 9 restore their LVD teacher from it."""
    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.train import Trainer
    from waldo_tpu_torch.train.checkpoint import _flatten

    log(f"== 7. training path: LVD training ({TRAIN_SCRIPT}) on synthetic clips")
    mode = "vid_object_extractor"
    cfg = parse_cli(train_lvd_flags() + ["--data.dataset", "synthetic", "--save_path", root,
                                         "--datetime", "smoke"])
    m = cfg.model
    shape = (cfg.batch_size_vid, cfg.data.vid_len, cfg.dim, cfg.width_size, m.embed_dim,
             m.num_obj, cfg.data.num_lyt, m.oe_depth, m.pe_depth)
    log(f"config (B, T, H, W, embed, objects, layout classes, LVD depths): {shape}; "
        f"load_dim {cfg.load_dim}, fast_inverse_warp {m.fast_inverse_warp}, sample_precision "
        f"{m.sample_precision!r}, compute {cfg.compute_dtype}, ctx_mode {m.ctx_mode!r}, "
        f"include_self {m.include_self}, pe_estimator_init_mode {m.pe_estimator_init_mode!r}, "
        f"losses {m.vid_object_extractor_losses}, {m.optimizer} lr {m.lr} betas "
        f"({m.beta1}, {m.beta2})")
    check(shape == (8, 14, 128, 256, 512, 16, 20, 2, 2) and cfg.load_dim == 0
          and not m.fast_inverse_warp and m.sample_precision == "fast"
          and cfg.compute_dtype == "float32" and m.ctx_mode == "prev" and m.include_self
          and m.pe_estimator_init_mode == "" and m.optimizer == "adam",
          "the parsed train_lvd.sh config is not the expected one")
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    before = [p.detach().clone() for p in tr.syn.lvd.parameters()]
    log(f"trainer ready in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in before)} LVD parameters)")

    unlogged(tr)
    reset_launches()
    t0 = time.perf_counter()
    tr.run(num_iter=TRAIN_ITERS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches, run_keys = read_launches()
    st = tr.states["pe"]
    log(f"Trainer.run({TRAIN_ITERS}): {run_s:.1f} s (synthetic clips made on the host "
        f"included); launches {run_launches} by key {run_keys}; step count {int(st.count)}, "
        f"nancount {int(st.nancount)}")
    n = TRAIN_ITERS
    # train_lvd.sh's four losses read no output of the context fusion
    # (the fused frames enter only metrics), so autograd never asks for
    # that sample's backward: K2's backward runs in the pxl_vid step below
    check(run_launches == {"warp_alpha_ctx": 0, "grid_sample": n,
                           "grid_sample_per_channel": n, "grid_sample_bwd": 0,
                           "grid_sample_per_channel_bwd": n, "bias_act": 0, "plane_boxes": n},
          f"expected one launch of K2' forward and backward, of K2's batch-mode forward and "
          f"of the pre-pass per step, got {run_launches}")
    check(run_keys["grid_sample"] == {112: n}
          and run_keys["grid_sample_per_channel"] == {112: n},
          f"unexpected sample shapes {run_keys}")
    check(int(st.nancount) == 0 and int(st.count) == n, "a step was skipped (non-finite loss)")
    unmoved = [k for (k, p), b in zip(tr.syn.lvd.named_parameters(), before)
               if torch.equal(p, b)]
    log(f"{len(before) - len(unmoved)} of {len(before)} LVD parameter tensors changed")
    check(not unmoved, f"LVD parameters that did not change: {unmoved}")
    check(tr.ckpt.exists("pe", "latest"), "no latest checkpoint was written")
    now = _flatten(to_jax(tr.syn)["pe"])
    back = _flatten(tr.ckpt.restore("pe", to_jax(tr.syn)["pe"], "latest", strict=True))
    check(all(np.array_equal(now[k], back[k]) for k in now), "the latest slot restores unequal")
    log(f"latest checkpoint restores equal ({len(now)} leaves)")
    del before, now, back

    batch, res = time_steps(tr, mode, "train", profile_dir)
    step_launches = res["launches_per_step"]
    check(all(v == (0 if k in ("warp_alpha_ctx", "bias_act", "grid_sample_bwd") else 1)
              for k, v in step_launches.items()), f"launches in one step: {step_launches}")
    step_inputs = capture_pc_bwd_inputs(tr, mode, batch)
    res["logging"] = logging_check(tr, mode, batch, "LVD")
    res["trace"] = trace_check(tr, mode, batch, "LVD")
    res["loader"] = loader_timing(tr, mode, res["ms_per_step"], profile_dir, "_train")

    # pxl_vid, a loss of the mode that reads the fused frames, puts the
    # context fusion's backward (K2 batch mode) on the step
    losses = list(m.vid_object_extractor_losses)
    m.vid_object_extractor_losses = losses + ["pxl_vid"]
    reset_launches()
    px, k2_step_inputs = capture_k2_bwd_inputs(tr, mode, batch)
    torch.cuda.synchronize()
    px_launches, _ = read_launches()
    m.vid_object_extractor_losses = losses
    log(f"one step with pxl_vid added to the losses: launches {px_launches}, loss "
        f"{float(px['loss']):.5f}")
    check(all(v == (0 if k in ("warp_alpha_ctx", "bias_act") else 1)
              for k, v in px_launches.items()) and bool(torch.isfinite(px["loss"])),
          f"launches in a step with pxl_vid: {px_launches}")
    lvd_dir = cfg.checkpoint_path
    del tr, batch, px
    torch.cuda.empty_cache()

    # each kernel's launches from the run; K2's backward's from the pxl_vid step
    rows, bwd_res = phase_train_kernels(
        dev, card_name, dict(run_launches, grid_sample_bwd=px_launches["grid_sample_bwd"]),
        step_inputs, k2_step_inputs)

    res["small_step"] = small_step_check(dev, small_train_cfg(), "extract_object_loss", "pe",
                                         "LVD")
    res["small_visuals"] = small_visuals_check(dev)
    share, e_inv = scatter_inversion_check(dev)
    log(f"scatter inversion (64 object grids, 64x64 -> 128x256), card vs CPU on the same grids: "
        f"{share:.3g} of the pixels differ by more than 1e-4 (tol 1e-4: a displacement within "
        f"rounding of a half pixel), max|err| {e_inv:.3g} elsewhere (tol 1e-5)")
    check(share <= 1e-4 and e_inv <= 1e-5,
          "the scatter inversion on the card disagrees with the CPU")
    res.update(run_seconds=run_s, launches_run=run_launches, launches_pxl_vid_step=px_launches,
               scatter_inversion_diff_share=share, scatter_inversion_err=e_inv,
               backwards=bwd_res)
    return res, rows, lvd_dir


# ---------------------------------------------------------------------------
# FLP and WIF training (phases 8 and 9), and the loader
# ---------------------------------------------------------------------------


def loader_timing(tr, mode, step_ms, profile_dir=None, label="", ways=None):
    """Trainer.run's loop body (a batch, its copy to the card, one optimizer
    step; for a list of modes, a batch and a step of each in turn) for
    LOADER_ITERS iterations after one warm-up, three ways (or ``ways``, a
    tuple of worker counts, 0 for the consumer's thread): the prefetching
    loader with the script's workers and with one, and batches made in the
    consumer's thread, a batch's clips in order (a loader without
    prefetch); and the host's time to make one batch's clips one by one.
    Under --profile, one iteration of each way is traced (its idle
    share)."""
    import torch
    from waldo_tpu_torch.data import DataLoader, InfiniteLoader, collate, create_dataset

    cfg, b = tr.cfg, tr.cfg.batch_size_vid
    ds = create_dataset(cfg, phase="train")
    t0 = time.perf_counter()
    collate([ds.make_clip(i, ds.draw(i)) for i in range(b)])
    res = {"clip_s_per_batch": time.perf_counter() - t0, "step_ms": step_ms}

    def in_thread(ds):
        k = 0
        while True:
            yield collate([ds[j % len(ds)] for j in range(k, k + b)])
            k += b

    modes = [mode] if isinstance(mode, str) else list(mode)
    for workers in ways or (cfg.data.num_workers, 1, 0):
        if workers:
            loader = InfiniteLoader(DataLoader(create_dataset(cfg, phase="train"), b,
                                               shuffle=True, seed=cfg.seed, num_workers=workers))
            next_batch, close, key = loader.next, loader.close, f"workers_{workers}"
        else:
            it = in_thread(create_dataset(cfg, phase="train"))
            next_batch, close, key = it.__next__, it.close, "synchronous"
        waits = []

        def one():
            for m in modes:
                t0 = time.perf_counter()
                batch = next_batch()
                t1 = time.perf_counter()
                tr.step(m, tr._to_device(batch), 0)
                waits.append((t1 - t0, time.perf_counter() - t1))

        try:
            one()
            torch.cuda.synchronize()
            waits.clear()
            t0 = time.perf_counter()
            for _ in range(LOADER_ITERS):
                one()
            torch.cuda.synchronize()
            it_s = (time.perf_counter() - t0) / LOADER_ITERS
            prof = (phase_profile(one, profile_dir, f"{label}_iteration_{key}")
                    if profile_dir else None)
        finally:
            close()
        n_w = LOADER_ITERS * len(modes)
        r = res[key] = {
            "iteration_s": it_s,
            "loader_wait_s": sum(w for w, _ in waits[:n_w]) / LOADER_ITERS,
            "copy_and_step_host_s": sum(c for _, c in waits[:n_w]) / LOADER_ITERS,
            "idle_share_profiled": None if prof is None else prof["idle_share"]}
        log(f"loader, {key.replace('_', ' ')}: {it_s * 1e3:.1f} ms an iteration over "
            f"{LOADER_ITERS} (waiting on the loader {r['loader_wait_s'] * 1e3:.1f} ms, copy + "
            f"step on the host {r['copy_and_step_host_s'] * 1e3:.1f} ms) against a "
            f"{step_ms:.1f} ms step; one batch's clips made one by one on the host take "
            f"{res['clip_s_per_batch'] * 1e3:.1f} ms"
            + ("" if prof is None else f"; idle share of one profiled iteration "
                                       f"{prof['idle_share']:.3f}"))
    return res


def unlogged(tr):
    """Close the trainer's logger and turn logging off, so that Trainer.run
    and the iterations timed on it are comparable with the unlogged rows
    of earlier runs (logging_check times a logged iteration)."""
    tr.logger.close()
    tr.logger = None


def logging_check(tr, mode, batch, label):
    """The trainer's logging of ``mode`` on one fixed batch: a
    Synthesizer.visuals call alone (ms by CUDA events, its kernel launches,
    its peak memory), LOG_TURNS logged and unlogged iterations in turns (a
    step, plus Trainer.log_iteration; its host time split into the visuals
    on the card, the copy to the host, the rendering and the writing), and
    the event files read back (every tag of the payload, the points and
    motion among them, and the scalars, with no "could not render" line)."""
    import contextlib
    import io

    import torch
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.train import Logger

    cfg = tr.cfg
    gen = lambda: torch.Generator(device=tr.device).manual_seed(cfg.seed)
    tr.syn.visuals(mode, batch, generator=gen())
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    arrays, pts = tr.syn.visuals(mode, batch, generator=gen())
    torch.cuda.synchronize()
    launches, by_key = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = {k: tuple(v.shape) for k, v in {**arrays, **pts}.items()}
    check(all(bool(torch.isfinite(v).all()) for v in {**arrays, **pts}.values()),
          f"{label}: non-finite visuals")
    del arrays, pts
    vis_ms = cuda_time(lambda: tr.syn.visuals(mode, batch, generator=gen()), 3, warmup=0)
    log(f"{label} visuals: {vis_ms:.2f} ms a call (CUDA events, 3 calls), peak memory "
        f"{peak_gb:.2f} GB, launches {launches} by key {by_key}; payload {shapes}")
    check(launches["warp_alpha_ctx"] == 0 and launches["grid_sample_per_channel"] >= 1
          and launches["plane_boxes"] >= 1 and launches["grid_sample_bwd"] == 0
          and launches["grid_sample_per_channel_bwd"] == 0,
          f"{label}: the visuals' unfused decode launched {launches}")

    # the parts of a logged iteration, timed by wrapping them
    tr.logger = Logger(cfg.log_path)
    parts = {"visuals": 0.0, "render_and_write": 0.0, "write": 0.0}

    def timed(key, fn, sync=False):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            return out
        return wrapped

    tr.syn.visuals = timed("visuals", tr.syn.visuals, sync=True)
    tr.logger.log_visuals = timed("render_and_write", tr.logger.log_visuals)
    tr.logger.writer.add_images = timed("write", tr.logger.writer.add_images)
    tr.logger.writer.add_scalar = timed("write", tr.logger.writer.add_scalar)
    out = io.StringIO()
    times = {"unlogged": [], "logged": [], "log_iteration": []}
    try:
        with contextlib.redirect_stdout(out):
            for turn in range(LOG_TURNS):  # the steps and visuals are warm already
                for logged in (False, True):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    metrics = tr.step(mode, batch, 0)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    if logged:
                        tr.log_iteration(mode, batch, metrics, turn)
                        torch.cuda.synchronize()
                        times["log_iteration"].append(time.perf_counter() - t1)
                    times["logged" if logged else "unlogged"].append(time.perf_counter() - t0)
    finally:
        del tr.syn.visuals  # the instance's wrapper; the method shows again
        tr.logger.close()
    printed = out.getvalue()
    sys.stdout.write(printed)
    n = LOG_TURNS
    split = {"visuals": parts["visuals"] / n,
             "render": (parts["render_and_write"] - parts["write"]) / n,
             "write": parts["write"] / n}
    split["copy_and_scalars"] = sum(times["log_iteration"]) / n - sum(split.values())
    res = {"visuals_ms": vis_ms, "visuals_peak_gb": peak_gb, "visuals_launches": launches,
           "visuals_launches_by_key": by_key,
           "unlogged_iteration_ms": 1e3 * sum(times["unlogged"]) / n,
           "logged_iteration_ms": 1e3 * sum(times["logged"]) / n,
           "log_split_ms": {k: 1e3 * v for k, v in split.items()}}
    log(f"{label} iteration on a fixed batch, in turns ({n} each): unlogged "
        f"{res['unlogged_iteration_ms']:.1f} ms, logged {res['logged_iteration_ms']:.1f} ms; "
        f"the logging's host time split " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                                       res["log_split_ms"].items()))
    check("could not render" not in printed, f"{label}: a visual failed to render")

    acc = EventAccumulator(cfg.log_path, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    images = set(acc.Tags()["images"])
    want = {f"{mode}/train/{k.split('/', 1)[1]}" for k in shapes if "/" in k}
    want |= {f"{mode}/train/{p}{r}" for p in ("", "pred_") if f"{p}obj_pts" in shapes
             for r in ("pts", "mot")}
    steps = [e.step for e in acc.Scalars(f"{mode}/train/loss")]
    log(f"{label} event files: {len(images)} image tags {sorted(images)}; loss scalar at "
        f"steps {steps}")
    check(want <= images, f"{label}: tags missing from the event files: {sorted(want - images)}")
    check(steps == list(range(n)), f"{label}: loss logged at steps {steps}")
    for t in images:
        check(len(acc.Images(t)) == n, f"{label}: {t} logged {len(acc.Images(t))} times")
    tr.logger = None
    res["tags"] = sorted(images)
    return res


def trace_check(tr, mode, batch, label):
    """One step of ``mode`` traced by profiling.trace (a Chrome trace in
    the run's log dir), and profiling.memory_stats() against
    torch.cuda.max_memory_allocated (within 1 %)."""
    import torch
    from waldo_tpu_torch.utils import profiling

    trace_dir = os.path.join(tr.cfg.log_path, "trace")
    torch.cuda.reset_peak_memory_stats()
    with profiling.trace(trace_dir):
        tr.step(mode, batch, 0)
        torch.cuda.synchronize()
    files = os.listdir(trace_dir)
    peak = torch.cuda.max_memory_allocated()
    stats = profiling.memory_stats()["cuda:0"]
    rel = abs(stats["peak_bytes_gb"] * 2 ** 30 - peak) / peak
    log(f"{label} profiling.trace wrote {files} "
        f"({sum(os.path.getsize(os.path.join(trace_dir, f)) for f in files) / 1e6:.1f} MB); "
        f"memory_stats {stats} against max_memory_allocated {peak / 2 ** 30:.3f} GiB "
        f"(relative {rel:.2g}, tol 1e-2); provenance {profiling.provenance()}")
    check(len(files) == 1 and os.path.getsize(os.path.join(trace_dir, files[0])) > 0,
          f"{label}: profiling.trace wrote {files}")
    check(rel <= 1e-2, f"{label}: memory_stats disagrees with max_memory_allocated")
    return {"trace_mb": os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6,
            "memory_stats": stats, "max_memory_allocated_gib": peak / 2 ** 30}


def small_visuals_check(dev):
    """Synthesizer.visuals of the three modes, a small float32 config on the
    card against the same on the CPU (the same seeded weights and clip):
    every array at the small predict's tolerance, 1e-3."""
    import torch
    from waldo_tpu_torch.data import create_dataset
    from waldo_tpu_torch.models import Synthesizer

    cfg_s = small_train_cfg()
    m = cfg_s.model
    m.use_pg, m.use_ii, m.ii_depth, m.ii_embed_dim = True, True, 2, 16
    m.vid_inpainting_losses = ["sharp_vid"]
    m.pg_num_timesteps = cfg_s.data.vid_len
    m.min_ctx_length_vid = m.max_ctx_length_vid = m.ctx_len
    ds = create_dataset(cfg_s, phase="train", rng=random.Random(3))
    b_np = {k: v[None] for k, v in ds[0].items() if isinstance(v, np.ndarray)}
    syns = {d: Synthesizer(cfg_s, device=d, seed=3) for d in (dev, "cpu")}
    errs = {}
    for mode in ("vid_object_extractor", "vid_pose_generator", "vid_inpainting"):
        out = {}
        for d, syn in syns.items():
            a, p = syn.visuals(mode, {k: torch.from_numpy(v).to(d) for k, v in b_np.items()})
            out[d] = {k: v.float().cpu() for k, v in {**a, **p}.items()}
        errs[mode] = max(float((out[dev][k] - out["cpu"][k]).abs().max()) for k in out["cpu"])
    log(f"small float32 visuals, card vs CPU: max|err| per mode {errs} (tol 1e-3)")
    check(max(errs.values()) <= 1e-3, "the visuals on the card disagree with the CPU")
    return errs


def restored_equal(tr, lvd_dir):
    """The trainer's LVD teacher against the "latest" slot of phase 7's run."""
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.train import CheckpointManager
    from waldo_tpu_torch.train.checkpoint import _flatten

    now = to_jax(tr.syn)["pe"]
    want = _flatten(CheckpointManager(lvd_dir).restore("pe", now, "latest", strict=True))
    now = _flatten(now)
    return set(now) == set(want) and all(np.array_equal(now[k], want[k]) for k in want)


def run_and_check(tr, nets, n, label):
    """Trainer.run(n) of modes that train ``nets`` ({net: the synthesizer's
    attribute}) against the frozen LVD teacher: no skipped step, every
    parameter of the nets moved, none of LVD's, no gradient on LVD, and the
    "latest" slots of every net restore equal. Returns (seconds, launches,
    launches by key)."""
    import torch
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.train.checkpoint import _flatten

    before = {net: [p.detach().clone() for p in getattr(tr.syn, attr).parameters()]
              for net, attr in nets.items()}
    lvd_before = [p.detach().clone() for p in tr.syn.lvd.parameters()]
    unlogged(tr)
    reset_launches()
    t0 = time.perf_counter()
    tr.run(num_iter=n)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, by_key = read_launches()
    counts = {net: (int(tr.states[net].count), int(tr.states[net].nancount)) for net in nets}
    log(f"{label}: Trainer.run({n}) {run_s:.1f} s; launches {launches} by key {by_key}; step "
        f"count and nancount {counts}")
    check(sorted(tr.states) == sorted(nets),
          f"optimizer states for {list(tr.states)}, not only {list(nets)}")
    check(all(c == (n, 0) for c in counts.values()), "a step was skipped (non-finite loss)")
    for net, attr in nets.items():
        named = getattr(tr.syn, attr).named_parameters()
        unmoved = [k for (k, p), b in zip(named, before[net]) if torch.equal(p, b)]
        log(f"{len(before[net]) - len(unmoved)} of {len(before[net])} {attr} parameter tensors "
            f"changed")
        check(not unmoved, f"{attr} parameters that did not change: {unmoved}")
    lvd_moved = [k for (k, p), b in zip(tr.syn.lvd.named_parameters(), lvd_before)
                 if not torch.equal(p, b)]
    log(f"{len(lvd_moved)} of {len(lvd_before)} LVD parameter tensors changed")
    check(not lvd_moved and all(p.grad is None for p in tr.syn.lvd.parameters()),
          f"the frozen LVD teacher changed or holds gradients: {lvd_moved}")
    for label_ in ["pe"] + list(nets):
        now = _flatten(to_jax(tr.syn)[label_])
        back = _flatten(tr.ckpt.restore(label_, to_jax(tr.syn)[label_], "latest", strict=True))
        check(all(np.array_equal(now[k], back[k]) for k in now),
              f"the latest {label_} slot restores unequal")
    log(f"latest pe and {' and '.join(nets)} slots restore equal")
    return run_s, launches, by_key


def time_steps(tr, mode, label, profile_dir=None, batch=None):
    """TRAIN_TIMED steps on one fixed batch (the loader's next, or
    ``batch``) after 2 warm-up steps (CUDA events): ms per step, clips/s,
    the peak memory of one step, its metrics; under --profile, one step
    traced."""
    import torch
    from waldo_tpu_torch.ops.kernels import reset_launches

    if batch is None:
        batch = tr._to_device(tr.train_loader.next())
        tr.train_loader.close()
    for _ in range(2):
        tr.step(mode, batch, 0)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    metrics = tr.step(mode, batch, 0)
    torch.cuda.synchronize()
    step_launches, _ = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(bool(torch.isfinite(v)) for v in metrics.values())
          and int(metrics["nancount"]) == 0, f"non-finite metrics {metrics}")
    ms = cuda_time(lambda: tr.step(mode, batch, 0), TRAIN_TIMED, warmup=0)
    clips = tr.cfg.batch_size_vid / (ms / 1e3)
    log(f"{label} step: {ms:.2f} ms over {TRAIN_TIMED} steps -> {clips:.3f} clips/s "
        f"({tr.cfg.batch_size_vid} clips of {tr.cfg.data.vid_len} frames); peak memory "
        f"{peak_gb:.2f} GB; metrics " + " ".join(f"{k} {float(v):.5f}"
                                                 for k, v in sorted(metrics.items()))
        + f"; launches per step {step_launches}")
    prof = (phase_profile(lambda: tr.step(mode, batch, 0), profile_dir, f"_{label}")
            if profile_dir else None)
    return batch, {"ms_per_step": ms, "clips_per_s": clips, "peak_gb": peak_gb,
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "launches_per_step": step_launches, "profile": prof}


def small_step_check(dev, cfg_s, loss_name, net, label, loss_kw=None, metrics=()):
    """A small float32 training step on the card against the same step on
    the CPU (the same seeded weights and clip), per leaf of ``net``'s
    gradient at phase 7's tolerance, 1e-4 on the loss and on the named
    ``metrics``; ``loss_kw`` goes to the loss."""
    import torch
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.data import create_dataset
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.train.checkpoint import _flatten

    # a training clip drawn from a seeded stream (the same in every process)
    ds = create_dataset(cfg_s, phase="train", rng=random.Random(3))
    b_np = {k: v[None] for k, v in ds[0].items() if isinstance(v, np.ndarray)}
    res = []
    for d in (dev, "cpu"):  # the same seeded weights on both
        syn = Synthesizer(cfg_s, device=d, seed=3)
        syn.lvd.requires_grad_(net == "pe")  # the frozen teacher, unless LVD is trained
        loss, m = getattr(syn, loss_name)({k: torch.from_numpy(v).to(d) for k, v in b_np.items()},
                                          0, generator=torch.Generator(device=d).manual_seed(0),
                                          **(loss_kw or {}))
        loss.backward()
        res.append((float(loss.detach()), _flatten(to_jax(syn, grads=True)[net]),
                    {k: float(m[k]) for k in metrics}))
    (l_gpu, g_gpu, m_gpu), (l_cpu, g_cpu, m_cpu) = res
    # per leaf: 5e-3 of the leaf's largest gradient (the CPU tests' factor
    # against JAX) plus 1e-5 of the largest of all leaves, since a leaf whose
    # gradient sums many cancelling terms carries the whole step's rounding
    # (other summation orders, the K2' backward's atomics) at that scale
    top = max(float(np.abs(v).max()) for v in g_cpu.values())
    check(top > 0, f"the small {label} step has no gradient")
    ratio, leaf = max((float(np.abs(g_gpu[k] - g_cpu[k]).max())
                       / (5e-3 * float(np.abs(g_cpu[k]).max()) + 1e-5 * top), k) for k in g_cpu)
    e_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"small float32 {label} step, card vs CPU: loss {l_gpu:.6f} / {l_cpu:.6f} (relative "
        f"{e_loss:.3g}, tol 1e-4); per-leaf gradients within {ratio:.3g} of their tolerance "
        f"(5e-3 x max|CPU leaf| + 1e-5 x max|CPU grad| = {top:.3g}), the tightest {leaf}")
    e_metrics = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in metrics}
    if metrics:
        log(f"  metrics card / CPU: " + ", ".join(f"{k} {m_gpu[k]:.6g} / {m_cpu[k]:.6g} "
                                                   f"(relative {e_metrics[k]:.3g})" for k in metrics))
    check(e_loss <= 1e-4 and ratio <= 1.0 and all(e <= 1e-4 for e in e_metrics.values()),
          f"the small {label} step on the card disagrees with the CPU")
    return {"loss_err": e_loss, "grad_tol_ratio": ratio, "metric_errs": e_metrics}


def phase_flp(dev, card_name, root, lvd_dir, profile_dir=None):
    """FLP training (scripts/cityscapes/train_flp.sh) on synthetic clips from
    phase 7's LVD teacher: the parsed config, the teacher restored equal,
    Trainer.run (no kernel launch: the path has none), the steps timed, the
    loader's iterations and a small float32 step card vs CPU."""
    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.train import Trainer

    log(f"== 8. FLP training ({FLP_SCRIPT}) on synthetic clips, LVD teacher from phase 7")
    mode = "vid_pose_generator"
    cfg = parse_cli(train_lvd_flags(FLP_SCRIPT) + [
        "--data.dataset", "synthetic", "--save_path", root, "--datetime", "smoke",
        "--s_load_path", lvd_dir])
    m = cfg.model
    shape = (cfg.batch_size_vid, cfg.data.vid_len, cfg.dim, cfg.width_size, m.embed_dim,
             m.num_obj, m.pg_num_timesteps, m.oe_num_timesteps, m.ctx_len,
             m.min_ctx_length_vid, m.max_ctx_length_vid)
    log(f"config (B, T, H, W, embed, objects, pg/oe timesteps, ctx, ctx range): {shape}; "
        f"FLP depths {m.pg_com_depth}/{m.pg_enc_depth}/{m.pg_dec_depth}, "
        f"pe_estimator_init_mode {m.pe_estimator_init_mode!r}, losses "
        f"{m.vid_pose_generator_losses}, workers {cfg.data.num_workers}, load_path {m.load_path}")
    check(shape == (4, 14, 128, 256, 512, 16, 14, 5, 4, 4, 4) and cfg.load_dim == 0
          and m.pe_estimator_init_mode == "zero" and m.use_pg and m.load_path == lvd_dir
          and cfg.vid_modes == [mode], "the parsed train_flp.sh config is not the expected one")
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    log(f"trainer ready in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in tr.syn.flp.parameters())} FLP parameters)")
    check(restored_equal(tr, lvd_dir), "the LVD teacher did not restore equal to phase 7's slot")
    log("LVD teacher restored equal to phase 7's latest slot")
    run_s, launches, _ = run_and_check(tr, {"pg": "flp"}, TRAIN_ITERS, "FLP")
    check(not any(launches.values()), f"the FLP path launched a kernel: {launches}")
    batch, res = time_steps(tr, mode, "flp", profile_dir)
    check(not any(res["launches_per_step"].values()), "an FLP step launched a kernel")
    res["logging"] = logging_check(tr, mode, batch, "FLP")
    del batch
    res["loader"] = loader_timing(tr, mode, res["ms_per_step"], profile_dir, "_flp")
    res.update(run_seconds=run_s, launches_run=launches, checkpoint_path=tr.cfg.checkpoint_path)
    del tr
    torch.cuda.empty_cache()
    # FLP's loss runs no warp, so no inversion: random pose heads on both
    # nets, else the teacher's and FLP's poses start equal and the loss has
    # no gradient
    cfg_s = small_train_cfg()
    cfg_s.model.use_pg, cfg_s.model.zero_init_dec = True, False
    cfg_s.model.pe_estimator_init_mode = ""
    cfg_s.model.pg_num_timesteps = cfg_s.data.vid_len
    cfg_s.model.min_ctx_length_vid = cfg_s.model.max_ctx_length_vid = cfg_s.model.ctx_len
    res["small_step"] = small_step_check(dev, cfg_s, "generate_pose_loss", "pg", "FLP")
    return res


def write_random_lpips_vgg(path, seed=0):
    """Seeded random VGG16 LPIPS weights in the npz both packages read:
    He-scaled conv kernels (kh,kw,I,O), small biases, positive lin heads."""
    from waldo_tpu_torch.eval.lpips import VGG16_SPEC

    rng = np.random.RandomState(seed)
    arrays, cin, i = {}, 3, 0
    for slice_i, n in enumerate(VGG16_SPEC):
        ch = min(64 * 2 ** slice_i, 512)
        for _ in range(n):
            arrays[f"conv{i}_kernel"] = (rng.randn(3, 3, cin, ch)
                                         * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
            arrays[f"conv{i}_bias"] = (rng.randn(ch) * 0.01).astype(np.float32)
            cin, i = ch, i + 1
        arrays[f"lin{slice_i}"] = (rng.rand(ch) * 0.1).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)


def capture_wif_sample_inputs(tr, mode, batch):
    """One WIF step with the inputs of its two sample kernels copied: the
    per-channel sample's (texture, grids) and the batch-mode sample's
    (texture, grid)."""
    import importlib

    gs = importlib.import_module("waldo_tpu_torch.ops.grid_sample")
    pc, sh, seen = gs.grid_sample_per_channel_cuda, gs._grid_sample_kernel, {}

    def spy_pc(img, grids):
        seen.setdefault("pc", []).append((img.clone(), grids.clone()))
        return pc(img, grids)

    def spy_sh(img, grid, tp_sz):
        seen.setdefault("batch", []).append((img.clone(), grid.float().contiguous().clone(),
                                             tp_sz))
        return sh(img, grid, tp_sz)

    gs.grid_sample_per_channel_cuda, gs._grid_sample_kernel = spy_pc, spy_sh
    try:
        tr.step(mode, batch, 0)
    finally:
        gs.grid_sample_per_channel_cuda, gs._grid_sample_kernel = pc, sh
    check(len(seen.get("pc", [])) == 1 and len(seen.get("batch", [])) == 1
          and seen["batch"][0][2] == 1,
          f"expected one per-channel and one batch-mode sample in a WIF step, got "
          f"{ {k: len(v) for k, v in seen.items()} }")
    return seen["pc"][0], seen["batch"][0][:2]


def tapped_texels(grids, h, w, boxes=None, chunk=17):
    """The distinct texel positions the bilinear taps of grids (R, Ho, Wo,
    2) read on R planes of h x w: each sample's in-range taps. With the
    planes' nonzero boxes (R, 4), a sample whose footprint misses its box
    reads none (csrc/bilinear.cuh: sample_boxed)."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import _top_left, tap_footprint_skips

    n = 0
    for r0 in range(0, grids.shape[0], chunk):
        g = grids[r0:r0 + chunk]
        x0, y0 = _top_left(g[..., 0], w), _top_left(g[..., 1], h)
        row = torch.arange(r0, r0 + g.shape[0], device=g.device)[:, None, None].expand_as(x0)
        if boxes is not None:
            live = ~tap_footprint_skips(g[:, None], boxes[r0:r0 + chunk, None], h, w)[:, 0]
            x0, y0, row = x0[live], y0[live], row[live]
        keys = []
        for y in (y0, y0 + 1):
            for x in (x0, x0 + 1):
                inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                keys.append(((row * h + y) * w + x)[inside])
        n += int(torch.unique(torch.cat(keys)).numel())
    return n


def wif_kernel_rows(card_name, run_launches, pc_inputs, batch_inputs, what="WIF decode"):
    """K2' and K2's batch mode on the inputs one WIF step handed them (the
    decode at 512x1024, ``what`` names the step): each against its plain
    version, timed beside its bound and one F.grid_sample call."""
    import torch
    import torch.nn.functional as F
    from waldo_tpu_torch.ops.grid_sample import (grid_sample_multigrid_plain, grid_sample_plain,
                                                 plane_boxes_plain)
    from waldo_tpu_torch.ops.kernels import grid_sample_cuda, grid_sample_per_channel_cuda

    rows = []
    tex, grids = pc_inputs
    f, h, w, c = tex.shape
    p = grids.shape[2] * grids.shape[3]
    tol = TOL_F32 if tex.dtype == torch.float32 else TOL_BF16
    out = grid_sample_per_channel_cuda(tex, grids)[0]
    want = grid_sample_multigrid_plain(tex, grids)
    err = float((out.float() - want.float()).abs().max())
    zero = float((want == 0).float().mean())
    log(f"K2' on the {what}'s inputs: texture {tuple(tex.shape)} {tex.dtype}, grids "
        f"{tuple(grids.shape)}; max|err| {err:.3g} (tol {tol}); {zero:.4g} of the samples are 0")
    check(bool(torch.isfinite(out).all()) and err <= tol, f"K2' on the {what} inputs: {err}")
    del out, want
    tex_fold = tex.permute(0, 3, 1, 2).reshape(f * c, 1, h, w).contiguous()
    grids_fold = grids.reshape(f * c, grids.shape[2], grids.shape[3], 2)
    timed = dict(
        ms=cuda_time(lambda: grid_sample_per_channel_cuda(tex, grids), 10),
        plain_ms=cuda_time(lambda: grid_sample_multigrid_plain(tex, grids), 3),
        library_ms=cuda_time(lambda: F.grid_sample(tex_fold, grids_fold, mode="bilinear",
                                                   padding_mode="zeros", align_corners=False), 10))
    # the bound counts the texels this data makes the kernel read (its
    # sparsity skip reads none for most samples), beside the dense count
    n_s, es = f * c * p, tex.element_size()
    _, boxes = plane_boxes_plain(tex)
    texels = tapped_texels(grids.reshape(f * c, *grids.shape[2:]), h, w,
                           boxes.reshape(f * c, 4))
    box_texels = int(((boxes[..., 1] - boxes[..., 0] + 1).clamp(min=0)
                      * (boxes[..., 3] - boxes[..., 2] + 1).clamp(min=0)).sum())
    b = bound(card_name, es * texels + (8 + es) * n_s, 24 * n_s)
    b_dense = bound(card_name, es * f * h * w * c + (8 + es) * n_s, 24 * n_s)
    log(f"K2' on the {what}'s inputs: the samples' taps read {texels} distinct texels, "
        f"{texels / (f * h * w * c):.4f} of the texture (the planes' nonzero boxes hold "
        f"{box_texels / (f * h * w * c):.4f} of it); bound {b[0]:.4f} ms on the texels read, "
        f"{b_dense[0]:.4f} ms on a dense read of the texture")
    rows.append({"name": f"grid_sample_per_channel {what} {f}x{h}x{w} C={c}", "route": "cuda",
                 "source": K2_SOURCE, "replaces": K2_REPLACES,
                 "launches": run_launches["grid_sample_per_channel"], "max_abs_err": err,
                 **timed, "bound_ms": b[0], "bound_by": b[1], "zero_share": zero,
                 "texels_read_share": texels / (f * h * w * c),
                 "box_share": box_texels / (f * h * w * c), "dense_bound_ms": b_dense[0]})
    del tex, grids, tex_fold, grids_fold, pc_inputs, boxes
    torch.cuda.empty_cache()

    img, grid = batch_inputs
    f, h, w, c = img.shape
    p = grid.shape[1] * grid.shape[2]
    tol = TOL_F32 if img.dtype == torch.float32 else TOL_BF16
    out = grid_sample_cuda(img, grid, 1)
    want = grid_sample_plain(img, grid)
    err = float((out.float() - want.float()).abs().max())
    log(f"K2 batch mode on the {what}'s inputs: texture {tuple(img.shape)} {img.dtype}, grid "
        f"{tuple(grid.shape)}; max|err| {err:.3g} (tol {tol})")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"K2 batch mode on the {what} inputs: {err}")
    del out, want
    # the bound counts the texels the grid's taps reach, every channel of each
    texels = tapped_texels(grid, h, w)
    log(f"K2 batch mode on the {what}'s inputs: the grid's taps read "
        f"{texels / (f * h * w):.4f} of the texture")
    rows.append(k2_row(card_name, f"grid_sample batch mode {what} {f}x{h}x{w} C={c}", img,
                       grid, 1, run_launches["grid_sample"], err, texels,
                       texels_read_share=texels / (f * h * w)))
    del img, grid, batch_inputs
    torch.cuda.empty_cache()
    log_rows(rows)
    return rows


def phase_wif(dev, card_name, root, lvd_dir, profile_dir=None):
    """WIF training (scripts/cityscapes/train_wif.sh) on synthetic clips from
    phase 7's LVD teacher, (a) without LPIPS weights (the warning, L1 only)
    and (b) with seeded random VGG16 LPIPS weights: the parsed config, the
    teacher restored equal, Trainer.run with strict launch counts (the
    decode's K2' and K2 batch-mode sample and the pre-pass once a step), the
    steps timed; in (a) the loader's iterations and the two samples against
    their plain versions on the inputs a step hands them; a small float32
    step card vs CPU."""
    import contextlib
    import io

    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.train import Trainer

    log(f"== 9. WIF training ({WIF_SCRIPT}) on synthetic clips, LVD teacher from phase 7")
    mode = "vid_inpainting"
    lpips_dir = os.path.join(root, "lpips")
    cfg_args = train_lvd_flags(WIF_SCRIPT) + ["--data.dataset", "synthetic", "--save_path", root,
                                              "--s_load_path", lvd_dir]
    res, rows = {}, []
    old_env = os.environ.get("WALDO_LPIPS_WEIGHTS")
    os.environ["WALDO_LPIPS_WEIGHTS"] = lpips_dir
    try:
        for variant in ("l1", "lpips"):
            cfg = parse_cli(cfg_args + ["--datetime", f"smoke_{variant}"])
            m = cfg.model
            shape = (cfg.batch_size_vid, cfg.data.vid_len, cfg.dim, cfg.load_dim,
                     cfg.load_dim, int(cfg.load_dim * cfg.aspect_ratio), cfg.flow_dim, m.ii_depth, m.ii_embed_dim,
                     m.embed_dim, m.num_obj, m.ctx_len)
            log(f"-- variant {variant}: config (B, T, dim, load, H, W, flow_dim, ii depth, ii "
                f"embed, embed, objects, ctx): {shape}; ii_score {m.ii_score}, ii_ab {m.ii_ab}, "
                f"losses {m.vid_inpainting_losses}, sample_precision {m.sample_precision!r}, "
                f"workers {cfg.data.num_workers}")
            check(shape == (8, 5, 128, 512, 512, 1024, 128, 6, 512, 512, 16, 4) and m.ii_score
                  and m.ii_ab and m.use_ii and m.load_path == lvd_dir
                  and m.vid_inpainting_losses == ["sharp_vid", "lpips_vid"],
                  "the parsed train_wif.sh config is not the expected one")
            if variant == "lpips":
                write_random_lpips_vgg(os.path.join(lpips_dir, "lpips_vgg.npz"), seed=0)
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                tr = Trainer(cfg, device=dev)
            sys.stderr.write(err.getvalue())
            warned = "L1 ONLY" in err.getvalue()
            log(f"trainer ready in {time.perf_counter() - t0:.1f} s "
                f"({sum(p.numel() for p in tr.syn.wif.parameters())} WIF parameters); LPIPS "
                f"{'loaded' if tr.syn.lpips is not None else 'absent'}, warning "
                f"{'printed' if warned else 'not printed'}")
            check((tr.syn.lpips is None) == (variant == "l1") and warned == (variant == "l1"),
                  f"LPIPS wiring in variant {variant}")
            check(restored_equal(tr, lvd_dir),
                  "the LVD teacher did not restore equal to phase 7's slot")
            n = TRAIN_ITERS
            run_s, launches, by_key = run_and_check(tr, {"ii": "wif"}, n, f"WIF ({variant})")
            check(launches == {"warp_alpha_ctx": 0, "grid_sample": n,
                               "grid_sample_per_channel": n, "grid_sample_bwd": 0,
                               "grid_sample_per_channel_bwd": 0, "bias_act": 0,
                               "plane_boxes": n},
                  f"expected one launch of K2' forward, K2's batch-mode forward and the "
                  f"pre-pass per step, got {launches}")
            check(by_key["grid_sample"] == {32: n} and by_key["grid_sample_per_channel"] == {32: n},
                  f"unexpected sample shapes {by_key}")
            batch, r = time_steps(tr, mode, f"wif_{variant}", profile_dir)
            check(("lpips_vid" in r["metrics"]) == (variant == "lpips"),
                  f"lpips_vid metric in variant {variant}: {sorted(r['metrics'])}")
            check(all(v == (1 if k in ("grid_sample", "grid_sample_per_channel", "plane_boxes")
                            else 0) for k, v in r["launches_per_step"].items()),
                  f"launches in one WIF step: {r['launches_per_step']}")
            r.update(run_seconds=run_s, launches_run=launches,
                     checkpoint_path=tr.cfg.checkpoint_path)
            if variant == "l1":
                r["logging"] = logging_check(tr, mode, batch, "WIF")
                pc_inputs, batch_inputs = capture_wif_sample_inputs(tr, mode, batch)
                del batch
                # the script's workers only: the one-worker and in-thread ways
                # (~11 and ~9 s an iteration) took ~80 s of the script
                r["loader"] = loader_timing(tr, mode, r["ms_per_step"], profile_dir, "_wif",
                                            ways=(cfg.data.num_workers,))
                del tr
                torch.cuda.empty_cache()
                rows = wif_kernel_rows(card_name, launches, pc_inputs, batch_inputs)
                del pc_inputs, batch_inputs
            else:
                del tr, batch
            torch.cuda.empty_cache()
            res[variant] = r
        os.environ["WALDO_LPIPS_WEIGHTS"] = os.path.join(root, "no_lpips")
        # without ii_ab's zero-initialized output conv, so that every WIF
        # leaf has a gradient to compare
        cfg_s = small_train_cfg()
        cfg_s.model.use_ii, cfg_s.model.ii_depth, cfg_s.model.ii_embed_dim = True, 2, 16
        cfg_s.model.ii_ab = False
        cfg_s.model.vid_inpainting_losses = ["sharp_vid"]
        res["small_step"] = small_step_check(dev, cfg_s, "inpaint_loss", "ii", "WIF")
    finally:
        if old_env is None:
            os.environ.pop("WALDO_LPIPS_WEIGHTS", None)
        else:
            os.environ["WALDO_LPIPS_WEIGHTS"] = old_env
    return res, rows


# ---------------------------------------------------------------------------
# test.sh and test_mat.sh through the test CLI (phase 10)
# ---------------------------------------------------------------------------


def eval_script_flags(path=TEST_SCRIPT):
    """The flags an inference script (scripts/cityscapes/test.sh by default)
    hands the test CLI, with the run tags left as the words LVD_TAG, FLP_TAG
    and WIF_TAG and without the pass-through arguments; a script that runs
    a sibling script with the three tags (test_mat.sh, demo.sh) gives the
    sibling's flags, then its own."""
    import re
    import shlex

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, path)) as fh:
        text = fh.read().replace("\\\n", " ")
    for tag in ("LVD_TAG", "FLP_TAG", "WIF_TAG"):
        text = text.replace("${%s}" % tag, tag)
    for line in text.splitlines():
        if "cli.test" in line:
            return [a for a in shlex.split(line.split("cli.test", 1)[1]) if a != "${@:4}"]
        sibling = re.search(r'/(\w+\.sh)"', line)
        if sibling and line.lstrip().startswith("bash"):
            args = shlex.split(line[sibling.end():])[3:]  # after the three tags
            return (eval_script_flags(os.path.join(os.path.dirname(path), sibling.group(1)))
                    + [a for a in args if a != "${@:4}"])
    raise RuntimeError(f"no test command in {path}")


def dumped_frames(fmt, frames):
    """What a dump of ``frames`` (T, H, W, 3) in [-1, 1] decodes to in the
    format the evaluator wrote it: the uint8 frames in a PNG folder, their
    round trip through Pillow's JPEG codec at the writer's quality in an
    MJPG .avi."""
    import inspect
    import io

    import PIL.Image
    from waldo_tpu_torch.data import write_mjpeg_avi

    u8 = ((np.clip(frames, -1, 1) + 1) / 2 * 255).astype(np.uint8)
    if fmt == "png":
        return u8
    check(fmt == "avi", f"no decoder model for dumps written as {fmt}")
    quality = inspect.signature(write_mjpeg_avi).parameters["quality"].default
    out = []
    for fr in u8:
        buf = io.BytesIO()
        PIL.Image.fromarray(fr).save(buf, format="JPEG", quality=quality)
        out.append(np.asarray(PIL.Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    return np.stack(out)


class recording_evaluators:
    """Within it, the test CLI's evaluators are kept in ``made`` as they
    are made, every video an evaluator dumps is checked finite (into
    ``finite``) before it is encoded, and the MAT post-processing's warps
    that fall in the sampler kernel's envelope are counted by their rows
    (``mat_kernel_samples``) and by their shapes and dtype
    (``mat_kernel_shapes``), with a copy of the first (texture, grid) of
    each shape as the kernel was handed it (``mat_kernel_inputs``)."""

    def __enter__(self):
        import collections

        import waldo_tpu_torch.cli.test as cli_test
        import waldo_tpu_torch.models.mat_pipeline as mat_pipeline
        import waldo_tpu_torch.train.evaluator as evaluator
        from waldo_tpu_torch.ops.grid_sample import in_kernel_envelope

        self.made, self.finite = [], []
        self.mat_kernel_samples = collections.Counter()
        self.mat_kernel_shapes = collections.Counter()
        self.mat_kernel_inputs = {}
        self._mods = cli_test, evaluator, mat_pipeline
        self._orig = cli_test.Evaluator, evaluator.save_video_frames, mat_pipeline.grid_sample

        def make(*args, **kwargs):
            self.made.append(self._orig[0](*args, **kwargs))
            return self.made[-1]

        def save(vid, path, fps=4):
            self.finite.append(bool(np.isfinite(vid).all()))
            return self._orig[1](vid, path, fps=fps)

        def sample(img, grid):
            if img.is_cuda and in_kernel_envelope(img.shape, grid.shape):
                self.mat_kernel_samples[grid.shape[0]] += 1
                key = (tuple(img.shape), tuple(grid.shape), str(img.dtype))
                self.mat_kernel_shapes[key] += 1
                if key not in self.mat_kernel_inputs:
                    self.mat_kernel_inputs[key] = (img.contiguous().clone(),
                                                   grid.float().contiguous().clone())
            return self._orig[2](img, grid)

        cli_test.Evaluator, evaluator.save_video_frames, mat_pipeline.grid_sample = (
            make, save, sample)
        return self

    def __exit__(self, *exc):
        (self._mods[0].Evaluator, self._mods[1].save_video_frames,
         self._mods[2].grid_sample) = self._orig


def run_test_cli(flags, label):
    """``waldo_tpu_torch.cli.test.main(flags)`` with the launch counts set to
    0 just before and read just after; returns (metrics, evaluator,
    seconds, launches, launches by key, peak GB, the MAT warps in the
    sampler kernel's envelope by rows, and by shape with the first inputs
    of each)."""
    import torch
    import waldo_tpu_torch.cli.test as cli_test
    from waldo_tpu_torch.ops.kernels import reset_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording_evaluators() as rec:
        reset_launches()
        t0 = time.perf_counter()
        metrics = cli_test.main(list(flags))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, by_key = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(rec.made) == 1, f"{label}: the CLI made {len(rec.made)} evaluators")
    ev = rec.made[0]
    log(f"{label} through the CLI: {run_s:.1f} s (evaluator set-up and {len(ev.iteration_times)} "
        f"clips); launches {launches} by key {by_key}; peak memory {peak_gb:.2f} GB; "
        f"dumps written as {ev.dump_format}")
    check(bool(rec.finite) and all(rec.finite), f"{label}: a dumped video is not finite")
    check(all(np.isfinite(v) for v in metrics.values()), f"{label}: metrics {metrics}")
    mat_inputs = {k: (n, *rec.mat_kernel_inputs[k]) for k, n in rec.mat_kernel_shapes.items()}
    return (metrics, ev, run_s, launches, by_key, peak_gb, dict(rec.mat_kernel_samples),
            mat_inputs)


def check_eval_launches(label, launches, by_key, n, k3=0, mat_samples=None):
    """n predicts' strict launch counts: K1 with its ghost mask at N=56 and
    N=40, K2 at N=56 and N=40 (and in batch mode once for each MAT warp in
    its envelope, by rows), the pre-pass twice, bias_act k3 times, no
    training kernel."""
    import collections

    k2 = collections.Counter({56: n, 40: n}) + collections.Counter(mat_samples or {})
    check(by_key["warp_alpha_ctx"] == {(56, True): n, (40, True): n}
          and by_key["grid_sample"] == dict(k2) and by_key["plane_boxes"] == {4: 2 * n}
          and launches["bias_act"] == k3
          and not any(launches[k] for k in ("grid_sample_per_channel", "grid_sample_bwd",
                                            "grid_sample_per_channel_bwd")),
          f"{label}: expected per predict K1 with its ghost mask at N=56 and N=40, K2 at N=56 "
          f"and N=40 and the pre-pass twice ({n} predicts, {k3} bias_act launches), got "
          f"{launches} by key {by_key}")


def eval_timing(ev):
    """Host ms of the evaluator's iterations after the first (a warm-up):
    the iteration, and its waits on the loader and on the dumps."""
    its = ev.iteration_times[1:] or ev.iteration_times
    mean = lambda k: 1e3 * sum(t[k] for t in its) / len(its)
    res = {"iteration_ms": mean("loader_s") + mean("predict_s") + mean("dump_s"),
           "loader_wait_ms": mean("loader_s"), "predict_ms": mean("predict_s"),
           "dump_ms": mean("dump_s"), "iterations": len(its),
           "first_iteration_ms": 1e3 * sum(ev.iteration_times[0].values())}
    log(f"evaluator iteration: {res['iteration_ms']:.1f} ms over {len(its)} (waiting on the "
        f"loader {res['loader_wait_ms']:.1f} ms, copy + predict + metrics + copy back "
        f"{res['predict_ms']:.1f} ms, dumps {res['dump_ms']:.1f} ms); the first "
        f"{res['first_iteration_ms']:.1f} ms")
    return res


def check_dumps(cfg, ev, n):
    """Every dump of n clips is written, and each real_vid dump decodes to
    the loader's frames in the dump format's round trip."""
    from waldo_tpu_torch.data import create_dataset
    from waldo_tpu_torch.eval.metrics import load_video
    from waldo_tpu_torch.train.evaluator import DUMPS

    ext = {"avi": ".avi", "png": "", "mp4": ".mp4"}[ev.dump_format]
    for name in DUMPS:
        got = sorted(os.listdir(os.path.join(cfg.result_path, name)))
        check(got == [f"vid_{i:05d}{ext}" for i in range(n)], f"{name} dumps: {got}")
    ds = create_dataset(cfg, phase=cfg.data.eval_phase)
    for i in range(n):
        want = dumped_frames(ev.dump_format, ds[i]["vid"])
        path = os.path.join(cfg.result_path, "real_vid", f"vid_{i:05d}{ext}")
        got = np.rint(load_video(path) * 255).astype(np.uint8)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"real_vid dump {i} differs from the loader's frames beyond the "
              f"{ev.dump_format} round trip")
    log(f"{len(DUMPS)} x {n} dumps written; each real_vid dump equals the loader's frames "
        f"through the {ev.dump_format} round trip")


def eval_kernel_rows(dev, card_name, launches, by_key, k1_seen, k2_seen):
    """K1 with its ghost mask, K2 and the pre-pass at test.sh's 512x1024
    load, on the inputs one predict handed them (emptying the two lists)
    and on dense inputs: each against its plain version and timed beside
    its bound (K2 also beside F.grid_sample), with the share of zero
    samples in its inputs."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import grid_sample_ctx_plain
    from waldo_tpu_torch.ops.kernels import grid_sample_cuda

    rows, shares = [], []

    def k2_check(img, grid, tp, what):
        got = grid_sample_cuda(img, grid, tp)
        want = grid_sample_ctx_plain(img, grid, tp)
        err = float((got - want).abs().max())
        check(err <= TOL_F32, f"grid_sample_ctx on {what} disagrees: {err}")
        zero = float((want == 0).float().mean())
        log(f"grid_sample_ctx N={grid.shape[0]} on {what}: max|err| {err:.3g}; zero samples "
            f"{zero:.4f}")
        shares.append({"n": grid.shape[0], "k2_zero_share": zero, "inputs": what})
        return err

    while k1_seen:
        a, g, o, io, tp, tcp = k1_seen.pop(0)
        n = g.shape[0]
        err = k1_check(a, g, o, io, tp, tcp, "test.sh's")
        shares.append(dict(k1_input_shares(a, g, io, tp, f"warp_alpha_ctx N={n} on test.sh's "
                                                         f"inputs"), inputs="test.sh"))
        rows.append(k1_row(card_name, f"warp_alpha_ctx N={n} is_obj 512x1024 test.sh inputs",
                           a, g, o, io, tp, tcp, by_key["warp_alpha_ctx"][n, True], err))
        if not k1_seen:
            rows.append(plane_boxes_row(card_name, "plane_boxes 4x512x1024x17 test.sh inputs",
                                        a, launches["plane_boxes"]))
        del a, g, o, io
        torch.cuda.empty_cache()
    while k2_seen:
        img, grid, tp = k2_seen.pop(0)
        n = grid.shape[0]
        err = k2_check(img, grid, tp, "test.sh's inputs")
        rows.append(k2_row(card_name, f"grid_sample_ctx N={n} 512x1024 test.sh inputs", img,
                           grid, tp, by_key["grid_sample"][n], err))
        del img, grid
        torch.cuda.empty_cache()

    rng = np.random.RandomState(3)
    f, h, w, c, tc = 4, 512, 1024, 17, 4
    for tp in (14, 10):
        n = f * tp
        a, g, o, io = k1_inputs(rng, f, h, w, c, tp, tc, True, dev)
        err = k1_check(a, g, o, io, tp, tc * tp, "dense HD")
        shares.append(dict(k1_input_shares(a, g, io, tp, f"warp_alpha_ctx N={n} on dense HD "
                                                         f"inputs"), inputs="dense"))
        rows.append(k1_row(card_name, f"warp_alpha_ctx N={n} is_obj 512x1024", a, g, o, io, tp,
                           tc * tp, by_key["warp_alpha_ctx"][n, True], err))
        del a, g, o, io
        torch.cuda.empty_cache()
        img, grid = k2_inputs(rng, f, h, w, 23, tp, h, w, dev)
        err = k2_check(img, grid, tp, "dense HD inputs")
        rows.append(k2_row(card_name, f"grid_sample_ctx N={n} 512x1024", img, grid, tp,
                           by_key["grid_sample"][n], err))
        del img, grid
        torch.cuda.empty_cache()
    tex = sparse_alpha(rng, f, h, w, c, dev)
    rows.append(plane_boxes_row(card_name, "plane_boxes 4x512x1024x17", tex,
                                launches["plane_boxes"]))
    del tex
    torch.cuda.empty_cache()
    log_rows(rows)
    return rows, shares


def mat_warp_rows(card_name, mat_inputs):
    """K2's batch mode on the MAT post-processing's whole-frame warps of
    test_mat.sh at 512x1024, one row for each shape the CLI run handed it:
    on the first inputs of that shape, against its plain version, timed
    (k2_row: a call and on the device, beside the first-design yardstick and one
    F.grid_sample call) beside its bound (the texels the grid's taps
    reach), with where a call's host time goes (k2_host_split); its
    launches are the run's of that shape."""
    import torch
    from waldo_tpu_torch.ops.grid_sample import _grid_sample_kernel, grid_sample_plain

    rows, seen = [], []
    with torch.inference_mode():  # as the MAT path runs, and its copies were made
        for (img_shape, grid_shape, dtype), (n, img, grid) in sorted(mat_inputs.items()):
            f, h, w, c = img.shape
            tol = TOL_F32 if img.dtype == torch.float32 else TOL_BF16
            out = _grid_sample_kernel(img, grid, 1)
            want = grid_sample_plain(img, grid)
            err = float((out.float() - want.float()).abs().max())
            zero = float((want == 0).float().mean())
            log(f"K2 batch mode on test_mat.sh's MAT warp: texture {img_shape} {dtype}, grid "
                f"{grid_shape}, {n} launches in the run; max|err| {err:.3g} (tol {tol}); "
                f"{zero:.4g} of the samples are 0")
            check(bool(torch.isfinite(out).all()) and err <= tol,
                  f"K2 batch mode on test_mat.sh's MAT warp {img_shape} {dtype}: {err}")
            seen.append({"texture": img_shape, "grid": grid_shape, "dtype": dtype,
                         "launches": n, "max_abs_err": err, "zero_share": zero})
            del out, want
            texels = tapped_texels(grid, h, w)
            rows.append(k2_row(card_name, f"grid_sample batch mode MAT warp {f}x{h}x{w} C={c} "
                                          f"{dtype.replace('torch.', '')} test_mat.sh inputs",
                               img, grid, 1, n, err, texels,
                               texels_read_share=texels / (f * h * w),
                               host_split=k2_host_split(img, grid)))
            log(f"{rows[-1]['name']}: where a call's time goes {rows[-1]['host_split']}")
    log_rows(rows)
    return rows, seen


def write_flax_conv_npz(module, path, collection):
    """A module of convolutions (the port's Inception or I3D) as the JAX
    package's weight file: its flax tree, kernels channel-last, pickled
    under "params" (with a "params" collection for Inception, as its
    converter writes it)."""
    tree = {}
    for key, t in module.state_dict().items():
        *parents, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":  # (O, I, k...) -> (k..., I, O)
            leaf, a = "kernel", a.transpose(tuple(range(2, a.ndim)) + (1, 0))
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, params=np.asarray({"params": tree} if collection else tree, dtype=object))


def fid_fvd_check(dev, root, tag, vid_len, ctx_len):
    """The metrics CLI with ssim, msssim, fid and fvd on test.sh's dumps,
    (a) without Inception or I3D weights (the warnings; rfid and
    rfvd_proxy from a seeded random Inception) and (b) with seeded random
    Inception and I3D weight files in the JAX package's layout, so that fid
    and the true fvd run (I3D on the 14 x 512 x 1024 videos, no resize); all
    values finite. Then each extractor timed on the dumps: ms per frame for
    Inception (16 frames a call, resized to 299), ms per video for I3D, and
    the peak memory of each."""
    import contextlib
    import io

    import torch
    from waldo_tpu_torch.eval import metrics as metrics_cli
    from waldo_tpu_torch.eval.i3d import I3D, I3DExtractor
    from waldo_tpu_torch.eval.inception import (InceptionExtractor, InceptionV3Features,
                                                init_random)

    wdir = os.path.join(root, "fid_weights")
    argv = [tag, str(vid_len), str(ctx_len), "--results_root", os.path.join(root, "results"),
            "--metrics", "ssim", "msssim", "fid", "fvd"]
    keys = {"none": ["cum_msssim", "cum_ssim", "rfid", "rfvd_proxy"],
            "random": ["cum_msssim", "cum_ssim", "fid", "fvd"]}
    saved = {k: os.environ.get(k) for k in ("WALDO_INCEPTION_WEIGHTS", "WALDO_I3D_WEIGHTS")}
    res = {}
    try:
        for variant in ("none", "random"):
            d = os.path.join(wdir, variant)
            os.environ["WALDO_INCEPTION_WEIGHTS"] = os.environ["WALDO_I3D_WEIGHTS"] = d
            t0 = time.perf_counter()
            if variant == "random":
                write_flax_conv_npz(init_random(InceptionV3Features(), 1),
                                    InceptionExtractor.weights_path(), collection=True)
                write_flax_conv_npz(init_random(I3D(), 2), I3DExtractor.weights_path(),
                                    collection=False)
            write_s = time.perf_counter() - t0
            err, out = io.StringIO(), io.StringIO()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
                got = metrics_cli.main(argv)
            cli_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            warned = ("reported as rfid, not FID" in err.getvalue(),
                      "rfvd_proxy, NOT comparable" in err.getvalue())
            lines = [f"{k} {v:.4g}" for k, v in got.items() if "fid" in k or "fvd" in k]
            log(f"metrics CLI with fid and fvd, weights {variant}: {cli_s:.1f} s (weight files "
                f"written in {write_s:.1f} s), peak memory {peak_gb:.2f} GB; " + " | ".join(lines)
                + f"; cum_ssim {got.get('cum_ssim', float('nan')):.4f}; warnings (rfid, "
                f"rfvd_proxy) {warned}")
            check(sorted(got) == keys[variant] and all(np.isfinite(v) for v in got.values()),
                  f"the metrics CLI with fid and fvd (weights {variant}) gave {got}")
            check(warned == ((True, True) if variant == "none" else (False, False)),
                  f"the fid / fvd warnings with weights {variant}: {warned}")
            res[variant] = {"values": got, "cli_s": cli_s, "peak_gb": peak_gb}

        # the extractors on the dumps, timed
        real_dir = os.path.join(root, "results", tag, "real_vid")
        vids = np.stack([metrics_cli.load_video(os.path.join(real_dir, f))
                         for f in sorted(os.listdir(real_dir))]).astype(np.float32)
        frames = vids.reshape((-1,) + vids.shape[2:])[:16]
        ex, vex = InceptionExtractor.maybe_load(device=dev), I3DExtractor.maybe_load(device=dev)
        for name, fn, n in (("inception", lambda: ex(frames), len(frames)),
                            ("i3d", lambda: vex(vids[:1]), 1)):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3 / n
            res[name] = {"ms_per_item": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "items_a_call": n}
        log(f"extractors on the dumps ({vids.shape[0]} videos of {vids.shape[1:]}): Inception "
            f"{res['inception']['ms_per_item']:.3f} ms a frame ({len(frames)} frames a call, "
            f"resized to 299x299, copies included), peak {res['inception']['peak_gb']:.2f} GB; "
            f"I3D {res['i3d']['ms_per_item']:.2f} ms a video (one video a call), peak "
            f"{res['i3d']['peak_gb']:.2f} GB")
        del ex, vex, vids, frames
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    return res


def small_eval_check(dev, root):
    """A small float32 evaluator on the card against the same evaluator on
    the CPU: small_cfg() on a Cityscapes-format tree at 64x128 (flows at
    32x64), its two clips, the same seeded weights on both sides. The
    videos of a clip agree within the float32 predict tolerance (1e-3) and
    so do the metrics (L1 and SSIM absolute, PSNR relative)."""
    import torch
    from waldo_tpu_torch.data import create_dataset
    from waldo_tpu_torch.train import Evaluator

    data_root = os.path.join(root, "cityscapes_small")
    write_cityscapes_tree(data_root, 64, 32, 2, num_cls=6)
    outs = []
    for d in (dev, torch.device("cpu")):
        cfg = small_cfg()
        cfg.data.dataset, cfg.data.dataroot, cfg.data.eval_phase = "cityscapes", data_root, "test"
        cfg.data.skip_first, cfg.data.num_workers = True, 2
        cfg.true_dim, cfg.flow_dim = 64, 32
        cfg.model.restrict_to_ctx = True
        cfg.save_path, cfg.name, cfg.datetime = root, "small_eval", f"small_{d.type}"
        ev = Evaluator(cfg, device=d)
        metrics = ev.run(dump=False)
        clip = create_dataset(cfg, phase="test")[0]
        batch = {k: torch.from_numpy(v[None]).to(d) for k, v in clip.items()
                 if isinstance(v, np.ndarray)}
        outs.append((metrics, {k: v.float().cpu() for k, v in ev.predict(batch).items()}))
    (m_card, v_card), (m_cpu, v_cpu) = outs
    err = max(float((v_card[k] - v_cpu[k]).abs().max()) for k in v_cpu)
    m_err = {k: abs(m_card[k] - m_cpu[k]) / (abs(m_cpu[k]) if k.startswith("psnr") else 1.0)
             for k in m_cpu}
    log(f"small float32 evaluator (2 clips), card vs CPU: videos max|err| {err:.3g} (tol 1e-3); "
        f"metrics max diff {max(m_err.values()):.3g} (tol 1e-3; PSNR relative)")
    check(set(m_card) == set(m_cpu) and err <= 1e-3 and max(m_err.values()) <= 1e-3,
          f"the small evaluator on the card disagrees with the CPU: {err}, {m_err}")
    return {"video_err": err, "metric_errs": m_err, "metrics_card": m_card, "metrics_cpu": m_cpu}


def phase_eval(dev, card_name, root, runs, mat_per_forward, profile_dir=None):
    """scripts/cityscapes/test.sh, and test_mat.sh, through the test CLI
    (``waldo_tpu_torch.cli.test.main``) on a Cityscapes-format tree written
    at the scripts' geometry, restoring the three nets from phases 7-9's
    runs, as ``test.sh LVD_TAG FLP_TAG WIF_TAG`` does after the training
    scripts: the slots restore equal, strict launch counts, the dumps
    written and equal to the loader's frames through the dump format, the
    metrics finite; ms per predict, per evaluator iteration and per MAT
    clip; the metrics CLI on the dumps; K1 with its ghost mask, K2 and the
    pre-pass at 512x1024 against their plain versions and timed; a small
    evaluator card vs CPU."""
    import contextlib
    import io

    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.data import create_dataset
    from waldo_tpu_torch.eval import metrics as metrics_cli
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.train import CheckpointManager
    from waldo_tpu_torch.train.checkpoint import _flatten

    log(f"== 10. {TEST_SCRIPT} and {TEST_MAT_SCRIPT} through the test CLI on a "
        f"Cityscapes-format tree")
    t_phase = time.perf_counter()
    res = {}
    data_root = os.path.join(root, "cityscapes")
    t0 = time.perf_counter()
    write_cityscapes_tree(data_root, 512, 128, EVAL_CLIPS)
    log(f"wrote {EVAL_CLIPS} sequences of 30 frames at 512x1024 (labels, flows at 128x256) in "
        f"{time.perf_counter() - t0:.1f} s")
    loads = ["--s_load_path", runs["lvd"], "--s_pg_load_path", runs["flp"],
             "--s_ii_load_path", runs["wif"]]
    flags = eval_script_flags() + ["--data.dataroot", data_root, "--save_path", root,
                                   "--datetime", "smoke"] + loads
    cfg = parse_cli(list(flags))
    m = cfg.model
    shape = (cfg.batch_size_vid, cfg.data.vid_len, cfg.dim, cfg.load_dim, cfg.true_dim,
             cfg.flow_dim, m.embed_dim, m.num_obj, m.ctx_len, cfg.data.num_workers)
    log(f"config (B, T, dim, load, true, flow, embed, objects, ctx, workers): {shape}; compute "
        f"{cfg.compute_dtype}, sample_precision {m.sample_precision!r}, fast_inverse_warp "
        f"{m.fast_inverse_warp}, restrict_to_ctx {m.restrict_to_ctx}, eval_phase "
        f"{cfg.data.eval_phase}")
    check(shape == (1, 14, 128, 512, 512, 128, 512, 16, 4, 8) and m.restrict_to_ctx
          and cfg.data.eval_phase == "test" and cfg.data.dataset == "cityscapes"
          and (m.load_path, m.pg_load_path, m.ii_load_path) == (runs["lvd"], runs["flp"],
                                                                 runs["wif"]),
          "the parsed test.sh config is not the expected one")

    metrics, ev, run_s, launches, by_key, peak_gb, mat_samples, _ = run_test_cli(flags,
                                                                                 "test.sh")
    check(not mat_samples, f"test.sh ran a MAT warp: {mat_samples}")
    check_eval_launches("test.sh", launches, by_key, EVAL_CLIPS)
    trees = to_jax(ev.syn)
    for label, key in (("pe", "lvd"), ("pg", "flp"), ("ii", "wif")):
        want = _flatten(CheckpointManager(runs[key]).restore(label, trees[label], "latest",
                                                             strict=True))
        now = _flatten(trees[label])
        check(set(now) == set(want) and all(np.array_equal(now[k], want[k]) for k in want),
              f"the evaluator's {label} did not restore equal to the {key} run's slot")
    log("pe, pg and ii restored equal to the LVD, FLP and WIF runs' latest slots")
    want_keys = {f"{s}_{k}" for s in ("l1", "psnr", "ssim")
                 for k in ("pred", "rec", "inp_pred", "inp_rec")}
    check(set(metrics) == want_keys, f"metrics {sorted(metrics)}")
    log("metrics: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
    check_dumps(cfg, ev, EVAL_CLIPS)
    res["test_sh"] = {"metrics": metrics, "run_s": run_s, "launches": launches,
                      "launches_by_key": by_key, "peak_gb": peak_gb,
                      "dump_format": ev.dump_format, "iterations": eval_timing(ev)}

    # one predict at B=1 on the first clip: strict counts, CUDA-event time
    clip = create_dataset(cfg, phase="test")[0]
    batch = {k: torch.from_numpy(v[None]).to(dev) for k, v in clip.items()
             if isinstance(v, np.ndarray)}
    ev.predict(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ev.predict(batch)
    torch.cuda.synchronize()
    p_launches, p_by_key = read_launches()
    p_peak = torch.cuda.max_memory_allocated() / 1e9
    check_eval_launches("one test.sh predict", p_launches, p_by_key, 1)
    ms = cuda_time(lambda: ev.predict(batch), 3, warmup=1)
    fps = (cfg.data.vid_len - m.ctx_len) / (ms / 1e3)
    log(f"test.sh predict at 512x1024, B=1: {ms:.2f} ms per call over 3 -> {fps:.3f} predicted "
        f"frames/s; peak memory {p_peak:.2f} GB")
    res["predict"] = {"ms": ms, "fps": fps, "peak_gb": p_peak, "launches": p_launches}
    if profile_dir:  # one iteration's work on a batch the loader has made
        np_batch = {k: v[None] for k, v in clip.items() if isinstance(v, np.ndarray)}
        res["profile_iteration"] = phase_profile(lambda: ev.step(0, np_batch, {}), profile_dir,
                                                 "_eval_iteration")
    k1_seen, k2_seen = capture_sample_inputs(lambda: ev.predict(batch))
    del ev, batch
    torch.cuda.empty_cache()

    # the metrics CLI on the dumps; no LPIPS weights: the warning and ssim
    tag = os.path.basename(cfg.result_path)
    old_env = os.environ.get("WALDO_LPIPS_WEIGHTS")
    os.environ["WALDO_LPIPS_WEIGHTS"] = os.path.join(root, "no_lpips")
    err, out = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            cum = metrics_cli.main([tag, str(cfg.data.vid_len), str(m.ctx_len),
                                    "--results_root", os.path.join(root, "results")])
    finally:
        if old_env is None:
            os.environ.pop("WALDO_LPIPS_WEIGHTS", None)
        else:
            os.environ["WALDO_LPIPS_WEIGHTS"] = old_env
    metrics_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    log(f"metrics CLI ({metrics_s:.1f} s): " + " | ".join(ln for ln in lines if "cum" in ln
                                                          and ":13]" in ln))
    check("falling back to ssim" in err.getvalue(), "no LPIPS fallback warning")
    check(sorted(cum) == ["cum_msssim", "cum_ssim"] and all(np.isfinite(v) for v in cum.values())
          and sum("[cum " in ln for ln in lines) == 2 * (cfg.data.vid_len - m.ctx_len),
          f"the metrics CLI's cumulative lines: {cum}")
    res["metrics_cli"] = {"cum": cum, "seconds": metrics_s}

    res["fid_fvd"] = fid_fvd_check(dev, root, tag, cfg.data.vid_len, m.ctx_len)

    rows, res["sample_shares"] = eval_kernel_rows(dev, card_name, launches, by_key, k1_seen,
                                                  k2_seen)
    res["small_eval"] = small_eval_check(dev, root)

    # test_mat.sh through the same CLI at its 512x1024 load, MAT with seeded
    # random weights (Places512 is not in the repo)
    mat_flags = eval_script_flags(TEST_MAT_SCRIPT) + [
        "--data.dataroot", data_root, "--save_path", root, "--datetime", "smoke_mat",
        "--s_inpainter_path", "", "--max_batch_eval_vid", str(EVAL_MAT_CLIPS)] + loads
    cfg_mat = parse_cli(list(mat_flags))
    check(cfg_mat.model.use_mat_inpainter and cfg_mat.model.use_inpainter
          and cfg_mat.model.inpainter_path == "" and cfg_mat.load_dim == 512
          and cfg_mat.max_batch_eval_vid == EVAL_MAT_CLIPS,
          "the parsed test_mat.sh config is not the expected one")
    metrics, ev, run_s, launches, by_key, peak_gb, mat_samples, mat_inputs = run_test_cli(
        mat_flags, "test_mat.sh")
    forwards = ev.inpainter.calls
    check(forwards > 0 and forwards % 3 == 0, f"{forwards} MAT forwards")
    # at this load the MAT post-processing's warps of whole frames fall in
    # the sampler kernel's envelope (at phase 5's 256x512 they do not)
    check(sum(mat_samples.values()) > 0, "no MAT warp went to the sampler kernel")
    check_eval_launches("test_mat.sh", launches, by_key, EVAL_MAT_CLIPS,
                        k3=mat_per_forward * forwards, mat_samples=mat_samples)
    names = sorted(os.listdir(os.path.join(cfg_mat.result_path, "inp_pred_vid")))
    check(len(names) == EVAL_MAT_CLIPS, f"inp_pred_vid dumps {names}")
    clip_ms = [1e3 * t["predict_s"] for t in ev.iteration_times]
    log(f"test_mat.sh: {forwards} MAT forwards, bias_act {launches['bias_act']} launches "
        f"({mat_per_forward} a forward), MAT warps on the sampler kernel by rows "
        f"{mat_samples}; ms per clip (predict + MAT + metrics + copy back) "
        + ", ".join(f"{t:.1f}" for t in clip_ms))
    res["test_mat_sh"] = {"metrics": metrics, "run_s": run_s, "launches": launches,
                          "launches_by_key": by_key, "peak_gb": peak_gb,
                          "mat_forwards": forwards, "mat_kernel_samples": mat_samples,
                          "clip_ms": clip_ms,
                          "iterations": eval_timing(ev)}
    del ev
    torch.cuda.empty_cache()
    mat_rows, res["test_mat_sh"]["mat_warps"] = mat_warp_rows(card_name, mat_inputs)
    rows += mat_rows
    del mat_inputs
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 took {res['seconds']:.1f} s")
    return res, rows


# ---------------------------------------------------------------------------
# the weight converters (phase 11)
# ---------------------------------------------------------------------------


def phase_convert(dev, root):
    """Weights from the reference's formats into the port, under ``root``:
    {pe,pg,ii}_net_0.pth written in the reference's names and layouts from
    the flagship's seeded weights (the port's own rules run backwards, the
    buffers from expected_buffers) and loaded by load_reference_checkpoints
    into a synthesizer of other seeded weights: every parameter bitwise
    equal to its source, one flagship predict equal to the source's; and a
    MAT persistence pickle at 512 written from a MatInpainter's seeded
    weights, converted by convert_mat_weights, loaded by
    MatInpainter(weights_path=...): one MAT forward equal to the source
    inpainter's, with K3 once per MAT layer. Each conversion is timed."""
    import torch
    from waldo_tpu_torch.config import flagship_cfg
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.models.convert import load_reference_checkpoints
    from waldo_tpu_torch.models.mat import MatInpainter
    from waldo_tpu_torch.models.mat.convert import convert_mat_weights
    from waldo_tpu_torch.ops.kernels import reset_launches

    log("== 11. converters: reference checkpoints and the MAT pickle into the port")
    os.makedirs(root, exist_ok=True)
    res = {}
    cfg = flagship_cfg()
    src = Synthesizer(cfg, device=dev, seed=0)
    t0 = time.perf_counter()
    for net in src.nets():
        torch.save(reference_state_dict(src, net), os.path.join(root, f"{net}_net_0.pth"))
    res["pth_write_s"] = time.perf_counter() - t0
    dst = Synthesizer(cfg, device=dev, seed=7)
    t0 = time.perf_counter()
    load_reference_checkpoints(dst, root, 0)
    torch.cuda.synchronize()
    res["pth_load_s"] = time.perf_counter() - t0
    n_params, unequal = 0, []
    for net, module in src.nets().items():
        theirs = dict(dst.nets()[net].named_parameters())
        for k, p in module.named_parameters():
            n_params += 1
            if not torch.equal(theirs[k], p):
                unequal.append(f"{net}.{k}")
    batch = flagship_batch(cfg, dev)
    want, got = src.predict(batch), dst.predict(batch)
    differ = [k for k, v in want.items() if torch.is_tensor(v) and not torch.equal(v, got[k])]
    log(f"reference checkpoints: written in {res['pth_write_s']:.2f} s ("
        f"{sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e6:.1f} MB), "
        f"loaded by load_reference_checkpoints in {res['pth_load_s']:.2f} s; {n_params} "
        f"parameters, {len(unequal)} unequal to the source; flagship predict outputs unequal "
        f"to the source's: {differ}")
    check(not unequal, f"parameters unequal after the reference round trip: {unequal[:8]}")
    check(not differ, f"the predict from converted weights differs in {differ}")
    del src, dst, want, got, batch

    inp = MatInpainter(resolution=512, device=dev, seed=0)
    pkl, npz = os.path.join(root, "mat_512.pkl"), os.path.join(root, "mat_512.npz")
    t0 = time.perf_counter()
    write_mat_pickle(mat_reference_state_dict(inp.net), pkl)
    res["mat_pkl_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_mat_weights(pkl, npz, img_resolution=512)
    res["mat_convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inp2 = MatInpainter(weights_path=npz, resolution=512, device=dev, seed=0)
    torch.cuda.synchronize()
    res["mat_load_s"] = time.perf_counter() - t0
    theirs = inp2.net.state_dict()
    unequal = [k for k, v in inp.net.state_dict().items() if not torch.equal(theirs[k], v)]
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((1, 512, 512, 3), generator=g, device=dev) * 2 - 1
    mask = torch.zeros((1, 512, 512, 1), device=dev)
    mask[:, 128:320, 160:400] = 1.0
    outs, k3 = [], []
    for m in (inp, inp2):
        reset_launches()
        outs.append(m(x, mask))
        torch.cuda.synchronize()
        k3.append(read_launches()[0]["bias_act"])
    err = float((outs[0] - outs[1]).abs().max())
    log(f"MAT pickle: written in {res['mat_pkl_write_s']:.2f} s ({os.path.getsize(pkl) / 1e6:.1f} "
        f"MB), converted by convert_mat_weights in {res['mat_convert_s']:.2f} s, loaded by "
        f"MatInpainter(weights_path=...) in {res['mat_load_s']:.2f} s; {len(unequal)} of "
        f"{len(theirs)} tensors unequal; one forward each: max|err| {err:.3g} (bitwise "
        f"equal: {torch.equal(outs[0], outs[1])}), bias_act launches {k3}")
    check(not unequal, f"MAT tensors unequal after the pickle round trip: {unequal[:8]}")
    check(torch.equal(outs[0], outs[1]) and bool(torch.isfinite(outs[0]).all()),
          "the MAT forward from converted weights differs from the source's")
    check(k3 == [196, 196], f"bias_act launches per MAT forward: {k3}")
    res.update(pth_params=n_params, mat_tensors=len(theirs), mat_bias_act_launches=k3)
    del inp, inp2, outs
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# data parallelism over processes (phase 12)
# ---------------------------------------------------------------------------

DIST_ITERS = 3  # iterations of the torchrun training run, then 2 more on resume
DIST_TIMED = 5  # steps a turn when the step is timed under the process group and without one
DIST_TURNS = 2
DIST_STEPS = 2  # steps the ranks compare with world 1
DIST_TIMEOUT_S = 300  # each torchrun command's time limit


def torchrun(nproc, args, label):
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc
    args`` from the repo root, in a session of its own, killed whole at
    DIST_TIMEOUT_S; returns (seconds, its output)."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc)] + list(args)
    # the ranks meet over the loopback device (the card's machine has no network)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{label}: no end within {DIST_TIMEOUT_S} s; its output ends:\n"
                           f"{out[-4000:]}")
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{label} exited with {proc.returncode}; its output ends:\n"
                                f"{out[-6000:]}")
    return seconds, out


def dist_flags(root, *extra):
    """train_lvd.sh's flags as phase 7 parses them, saving under ``root``."""
    return train_lvd_flags() + ["--data.dataset", "synthetic", "--save_path", root,
                                "--datetime", "dist"] + list(extra)


def fixed_rows(cfg, shard):
    """The shard's rows of one fixed global batch of synthetic training
    clips: every row's seed drawn in order, the rank's clips made."""
    from waldo_tpu_torch.data import collate, create_dataset

    ds = create_dataset(cfg, phase="train", rng=random.Random(3))
    draws = [ds.draw(i) for i in range(shard.total)]
    return collate([ds.make_clip(i, draws[i])
                    for i in range(shard.offset, shard.offset + shard.size)])


def tf32_off():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dist_worker_nccl(out_dir, root):
    """One rank under torchrun with NCCL (world 1): the torchrun run resumed
    by a cont_train trainer (2 more iterations), then on one fixed batch the
    launches of one step, its peak memory, the step and ``gradients`` timed
    under the process group, the all-reduce of the step's buffer alone
    (CUDA events), and then, after the group is destroyed, the same step and
    ``gradients`` in this process without one (world 1's path, which only
    lacks the all-reduce)."""
    import torch
    import torch.distributed as dist
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.parallel import mesh
    from waldo_tpu_torch.train import Trainer

    tf32_off()
    mode = "vid_object_extractor"
    cfg = parse_cli(dist_flags(root, "--cont_train", "true", "--num_iter",
                               str(DIST_ITERS + 2), "--log_freq", "0"))
    tr = Trainer(cfg)
    st = tr.states["pe"]
    tr.run()
    torch.cuda.synchronize()
    res = {"backend": mesh.backend(), "world": mesh.world_size(),
           "device": str(tr.device), "resumed_count": int(st.count),
           "resumed_nancount": int(st.nancount), "latest_iter": tr.ckpt.latest_iter("pe")}
    batch = tr._to_device(fixed_rows(cfg, mesh.BatchShard.of_rank(cfg.batch_size_vid)))
    for _ in range(2):
        tr.step(mode, batch, 0)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    metrics = tr.step(mode, batch, 0)
    torch.cuda.synchronize()
    res["launches_per_step"] = read_launches()[0]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["loss"] = float(metrics["loss"])
    loss = torch.zeros((), device=tr.device)

    def timings(key):
        res["step_ms"][key] = [cuda_time(lambda: tr.step(mode, batch, 0), DIST_TIMED, warmup=1)
                               for _ in range(DIST_TURNS)]
        res[f"gradients_ms_{key}"] = cuda_time(lambda: st.gradients(loss), 20)

    res["step_ms"] = {}
    timings("reduced")
    flat = torch.ones(sum(p.numel() for p in st.params) + 1, device=tr.device)
    res["all_reduce_bytes"] = flat.numel() * flat.element_size()
    res["all_reduce_ms"] = cuda_time(lambda: dist.all_reduce(flat), 20)
    res["copy_ms"] = cuda_time(lambda: flat.clone(), 20)
    dist.destroy_process_group()
    check(not mesh.distributed(), "the process group outlived destroy_process_group")
    timings("local")
    tr.train_loader = None
    with open(os.path.join(out_dir, "nccl.json"), "w") as fh:
        json.dump(res, fh)


def dist_worker_ranks(out_dir, root, backend):
    """One of several ranks (torchrun) that take DIST_STEPS steps of LVD at
    train_lvd.sh's widths with the zero pose head on their rows of one fixed
    global batch: gloo with every rank on card 0, or NCCL with a card each.
    After each step the ranks hold rank 0's parameters against their own
    (bitwise); then the step is timed. Rank 0 writes the losses, the
    parameters, each rank's peak memory and the times."""
    import torch
    import torch.distributed as dist
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.parallel import mesh
    from waldo_tpu_torch.train import NetState

    tf32_off()
    dev = "cuda:0" if backend == "gloo" else "cuda"
    mesh.init_distributed(dev, backend=backend)
    dev = mesh.local_device(dev)
    cfg = parse_cli(dist_flags(root, "--s_pe_estimator_init_mode", "zero"))
    syn = Synthesizer(cfg, device=dev, seed=cfg.seed)
    st = NetState(syn.lvd, cfg.model)
    shard = mesh.BatchShard.of_rank(cfg.batch_size_vid // mesh.world_size())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in fixed_rows(cfg, shard).items()
             if isinstance(v, np.ndarray)}
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)

    def step(it):
        st.zero_grad()
        loss, _ = syn.extract_object_loss(batch, it, generator=gen, shard=shard)
        loss.backward()
        st.apply(loss)
        return loss

    torch.cuda.reset_peak_memory_stats(dev)
    losses, equal = [], []
    for it in range(DIST_STEPS):
        losses.append(float(step(it).detach()))
        flat = torch.cat([p.detach().reshape(-1) for p in st.params])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        same = torch.tensor([float(torch.equal(flat, ref))], device=dev)
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        equal.append(bool(same.item() == 1.0))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    params = [p.detach().cpu() for p in st.params] if mesh.is_main() else None
    step_ms = cuda_time(lambda: step(DIST_STEPS), 3, warmup=1)
    flat = torch.ones(sum(p.numel() for p in st.params) + 1, device=dev)
    reduce_ms = cuda_time(lambda: dist.all_reduce(flat), 5)
    every = [None] * mesh.world_size()
    dist.all_gather_object(every, {"rank": mesh.rank(), "device": str(dev), "losses": losses,
                                   "peak_gb": peak, "step_ms": step_ms,
                                   "all_reduce_ms": reduce_ms})
    if mesh.is_main():
        torch.save({"backend": mesh.backend(), "world": mesh.world_size(), "equal": equal,
                    "ranks": every, "params": params,
                    "all_reduce_bytes": flat.numel() * flat.element_size()},
                   os.path.join(out_dir, f"ranks_{backend}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def world1_reference(dev, root):
    """World 1 in this process: DIST_STEPS steps on the whole fixed batch,
    the ranks' config and draws. Returns (losses, parameters)."""
    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.parallel import BatchShard
    from waldo_tpu_torch.train import NetState

    cfg = parse_cli(dist_flags(root, "--s_pe_estimator_init_mode", "zero"))
    syn = Synthesizer(cfg, device=dev, seed=cfg.seed)
    st = NetState(syn.lvd, cfg.model)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in fixed_rows(cfg, BatchShard.whole(cfg.batch_size_vid)).items()
             if isinstance(v, np.ndarray)}
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    losses = []
    for it in range(DIST_STEPS):
        st.zero_grad()
        loss, _ = syn.extract_object_loss(batch, it, generator=gen)
        loss.backward()
        st.apply(loss)
        losses.append(float(loss.detach()))
    params = [p.detach().cpu() for p in st.params]
    del syn, st, batch
    torch.cuda.empty_cache()
    return losses, params


def compare_ranks(got, want, label, steps=DIST_STEPS, strict=True):
    """The ranks' run against world 1: the ranks bitwise equal after each
    step; the ranks' mean loss within 2e-4 relative of world 1's; each
    parameter within 2 x 1e-4 x ``steps`` (4e-4 for two steps: what that
    many Adam steps at lr 1e-4 can move one, so an element whose gradient
    sits near 0 may take the other direction), and 99.9 % of each tensor's
    elements within 2e-6 (tests/test_torch_train.py's tolerances for two
    steps against JAX); with ``strict`` False only the ranks' equality is
    held here, and the caller judges the numbers returned."""
    w_losses, w_params = want
    tol = 2e-4 * steps
    res = {"equal_after_each_step": got["equal"], "loss_rel_err": [], "ranks": got["ranks"]}
    for it in range(steps):
        mean = float(np.mean([r["losses"][it] for r in got["ranks"]]))
        res["loss_rel_err"].append(abs(mean - w_losses[it]) / abs(w_losses[it]))
    worst, worst_share, off = 0.0, 0.0, []
    names = got.get("names") or [str(i) for i in range(len(w_params))]
    for name, g, w in zip(names, got["params"], w_params):
        diff = (g - w).abs()
        worst = max(worst, float(diff.max()))
        share = float((diff > 2e-6).float().mean())
        worst_share = max(worst_share, share)
        if share > 1e-3:
            off.append((name, tuple(w.shape), int((diff > 2e-6).sum()), float(diff.max()),
                        float(w.abs().max())))
    res.update(param_max_err=worst, param_share_over_2e6=worst_share, tensors_off=off)
    if off:
        log(f"{label}: tensors with more than 1e-3 of their elements over 2e-6 from world 1 "
            f"(name, shape, count, max|err|, max|world 1|): {off[:12]}")
    log(f"{label}: ranks bitwise equal after each step {got['equal']}; mean loss against world "
        f"1 relative {['%.3g' % e for e in res['loss_rel_err']]} (tol 2e-4); parameters max|err| "
        f"{worst:.3g} (tol {tol:.3g}), the largest share of a tensor's elements over 2e-6 "
        f"{worst_share:.3g} (tol 1e-3)")
    for r in got["ranks"]:
        log(f"  rank {r['rank']} on {r['device']}: losses {['%.6f' % v for v in r['losses']]}, "
            f"peak {r['peak_gb']:.2f} GB, a step {r['step_ms']:.2f} ms, the {got['all_reduce_bytes']}"
            f"-byte all-reduce {r['all_reduce_ms']:.3f} ms")
    check(all(got["equal"]), f"{label}: the ranks' parameters differ")
    check(not strict or (max(res["loss_rel_err"]) <= 2e-4 and worst <= tol
                         and worst_share <= 1e-3), f"{label} disagrees with world 1")
    return res


def phase_dist(dev, root):
    """Data parallelism over processes on this machine's cards: (a) torchrun
    with NCCL at world 1 at train_lvd.sh's full width, through the training
    CLI, then resumed and timed by a rank of this script; (b) two gloo ranks
    on card 0, B = 8 split 4 + 4, against world 1 in this process; (c) NCCL
    across the cards where there are several."""
    import torch
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    log("== 12. distributed: torchrun ranks (train_lvd.sh, NCCL at world 1, gloo pair)")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved) while the ranks run")
    shutil.rmtree(root, ignore_errors=True)
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir)
    here = os.path.abspath(__file__)
    res = {}

    # (a) the training CLI under torchrun, NCCL, world 1
    flags = dist_flags(root, "--num_iter", str(DIST_ITERS), "--log_freq", "0")
    secs, out = torchrun(1, ["-m", "waldo_tpu_torch.cli.train"] + flags, "torchrun cli.train")
    cfg_line = [ln for ln in out.splitlines() if ln.startswith("[dist]")]
    log(f"torchrun -m waldo_tpu_torch.cli.train ({DIST_ITERS} iterations): {secs:.1f} s; "
        f"{cfg_line}")
    check(cfg_line and "nccl process group of 1" in cfg_line[0],
          f"the CLI did not report an NCCL process group of 1: {out[-2000:]}")
    runs = {d: sorted(os.listdir(os.path.join(root, d))) for d in ("checkpoints", "logs")}
    check(all(v == ["dist-train_lvd_cityscapes"] for v in runs.values()),
          f"run directories {runs}, not one")
    acc = EventAccumulator(os.path.join(root, "logs", "dist-train_lvd_cityscapes"))
    acc.Reload()
    loss = [(e.step, e.value) for e in acc.Scalars("vid_object_extractor/train/loss")]
    nan = [e.value for e in acc.Scalars("vid_object_extractor/train/nancount")]
    log(f"logged losses {loss}, nancount {nan}")
    check([s for s, _ in loss] == list(range(DIST_ITERS))
          and all(np.isfinite(v) for _, v in loss) and nan == [0.0] * DIST_ITERS,
          "a loss was not finite or a step was skipped")
    res["cli"] = {"seconds": secs, "losses": loss, "nancount": nan, "runs": runs}

    secs, out = torchrun(1, [here, "--dist-worker", "nccl", "--dist-root", root],
                         "torchrun rank (resume, timing)")
    with open(os.path.join(out_dir, "nccl.json")) as fh:
        w = json.load(fh)
    turns = w["step_ms"]
    log(f"resumed rank ({secs:.1f} s): {w['backend']}, world {w['world']} on {w['device']}; "
        f"{w['resumed_count']} steps after the slot of iteration {DIST_ITERS - 1}, latest "
        f"slot {w['latest_iter']}; launches per step {w['launches_per_step']}; peak "
        f"{w['peak_gb']:.2f} GB; the step under the group {turns['reduced']} ms, then in the "
        f"same process without one {turns['local']} ms; gradients() {w['gradients_ms_reduced']:.3f} "
        f"ms under the group, {w['gradients_ms_local']:.3f} without; the all-reduce alone "
        f"{w['all_reduce_ms']:.4f} ms for {w['all_reduce_bytes']} bytes (a device copy of "
        f"the buffer {w['copy_ms']:.4f} ms)")
    check(w["backend"] == "nccl" and w["world"] == 1, "the rank's group is not NCCL at world 1")
    check(w["resumed_count"] == 2 and w["resumed_nancount"] == 0
          and w["latest_iter"] == DIST_ITERS + 1, "the cont_train run did not resume the slot")
    check(all(v == (0 if k in ("warp_alpha_ctx", "bias_act", "grid_sample_bwd") else 1)
              for k, v in w["launches_per_step"].items()),
          f"launches in one step under the process group: {w['launches_per_step']}")
    res["nccl_world1"] = w

    # (b) two gloo ranks on card 0, against world 1 in this process
    secs, out = torchrun(2, [here, "--dist-worker", "gloo", "--dist-root", root],
                         "torchrun gloo ranks")
    got = torch.load(os.path.join(out_dir, "ranks_gloo.pt"), weights_only=False)
    log(f"two gloo ranks on card 0 ({secs:.1f} s): backend {got['backend']}, world "
        f"{got['world']}")
    check(got["backend"] == "gloo" and got["world"] == 2, "the pair is not two gloo ranks")
    t0 = time.perf_counter()
    want = world1_reference(dev, root)
    log(f"world 1 in this process, B = {len(got['ranks']) * 4}: {time.perf_counter() - t0:.1f} s, "
        f"losses {['%.6f' % v for v in want[0]]}")
    res["gloo_pair"] = compare_ranks(got, want, "gloo pair")
    res["gloo_pair"]["seconds"] = secs

    # (c) NCCL across the cards
    n = torch.cuda.device_count()
    if n > 1:
        secs, out = torchrun(n, [here, "--dist-worker", "nccl-cards", "--dist-root", root],
                             f"torchrun NCCL over {n} cards")
        got = torch.load(os.path.join(out_dir, "ranks_nccl.pt"), weights_only=False)
        res["nccl_cards"] = compare_ranks(got, want, f"NCCL over {n} cards")
        res["nccl_cards"]["seconds"] = secs
    else:
        log("NCCL across cards: not run (this machine has one card)")
    shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# WIF adversarial training (phase 13)
# ---------------------------------------------------------------------------

GAN_LOSSES = "sharp_vid lpips_vid adv dis"
GAN_TURNS = 2  # turns of phase 9b's plain WIF step and the G step, TRAIN_TIMED steps each
# iterations of the GAN through the training CLI under torchrun: one steps
# both modes and saves every slot (3 took ~20 s more of a 1200 s budget)
GAN_CLI_ITERS = 1


def gan_flags(root, lvd_dir, *extra):
    """train_wif.sh's flags with the GAN losses and the adaptive lambda, on
    synthetic clips, the LVD teacher from ``lvd_dir``."""
    return train_lvd_flags(WIF_SCRIPT) + [
        "--data.dataset", "synthetic", "--save_path", root, "--s_load_path", lvd_dir,
        "--s_vid_inpainting_losses", GAN_LOSSES, "--s_use_adaptive_lambda", "true"] + list(extra)


def gan_turns(tr, batch):
    """Phase 9b's plain WIF step (L1 and LPIPS, no adversarial term) and the
    G step on one batch, TRAIN_TIMED steps each after one warm-up, in
    GAN_TURNS turns (CUDA events)."""
    st = tr.states["ii"]

    def plain():
        st.zero_grad()
        loss, _ = tr.syn.inpaint_loss(batch, 0)
        loss.backward()
        st.apply(loss)

    out = {"plain_ms": [], "g_ms": []}
    for _ in range(GAN_TURNS):
        out["plain_ms"].append(cuda_time(plain, TRAIN_TIMED, warmup=1))
        out["g_ms"].append(cuda_time(lambda: tr.step("vid_inpainting", batch, 0), TRAIN_TIMED,
                                     warmup=1))
    log(f"plain WIF step (phase 9b's) {['%.2f' % v for v in out['plain_ms']]} ms against the G "
        f"step {['%.2f' % v for v in out['g_ms']]} ms, in turns")
    return out


def gan_torchrun(root, lvd_dir):
    """The training CLI with the GAN flags under torchrun, NCCL at world 1,
    GAN_CLI_ITERS iterations: the group reported, both modes' losses logged
    finite with no skipped step, the "id" slot saved."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    flags = gan_flags(root, lvd_dir, "--datetime", "gan_dist", "--num_iter", str(GAN_CLI_ITERS),
                      "--log_freq", "0")
    secs, out = torchrun(1, ["-m", "waldo_tpu_torch.cli.train"] + flags, "torchrun cli.train GAN")
    cfg_line = [ln for ln in out.splitlines() if ln.startswith("[dist]")]
    check(cfg_line and "nccl process group of 1" in cfg_line[0],
          f"the CLI did not report an NCCL process group of 1: {out[-2000:]}")
    run = [d for d in os.listdir(os.path.join(root, "logs")) if d.startswith("gan_dist-")]
    check(len(run) == 1, f"run directories {run}")
    acc = EventAccumulator(os.path.join(root, "logs", run[0]))
    acc.Reload()
    res = {"seconds": secs}
    for tag in ("vid_inpainting/train/loss", "vid_inpainting/train/adaptive_lambda",
                "vid_inpainting_dis/train/dis", "vid_inpainting/train/nancount",
                "vid_inpainting_dis/train/nancount"):
        res[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
        check([st for st, _ in res[tag]] == list(range(GAN_CLI_ITERS))
              and all(np.isfinite(v) for _, v in res[tag])
              and (not tag.endswith("nancount") or all(v == 0 for _, v in res[tag])),
              f"{tag}: {res[tag]}")
    slots = sorted(os.listdir(os.path.join(root, "checkpoints", run[0])))
    check("id_latest.npz" in slots and "ii_latest.npz" in slots, f"slots {slots}")
    log(f"torchrun -m waldo_tpu_torch.cli.train with the GAN losses ({GAN_CLI_ITERS} iterations): "
        f"{secs:.1f} s; {cfg_line}; losses {res['vid_inpainting/train/loss']}, dis "
        f"{res['vid_inpainting_dis/train/dis']}, lambda "
        f"{res['vid_inpainting/train/adaptive_lambda']}")
    return res


def decode_layer_check(dev, lvd_dir, root):
    """Synthesizer.decode_layer once on phase 7's fixed batch (train_lvd.sh's
    flags, B = 8 synthetic clips, the teacher from ``lvd_dir``), without
    gradients: its launches (K2's batch mode on the background's gather,
    which the JAX package's routing envelope gives the Pallas kernel; the
    other samples are F.grid_sample) and its outputs against the same call
    with every sample plain."""
    import importlib

    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.convert import from_jax, to_jax
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.ops.grid_sample import grid_sample_plain
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.parallel import BatchShard
    from waldo_tpu_torch.train import CheckpointManager

    cfg = parse_cli(train_lvd_flags() + ["--data.dataset", "synthetic", "--save_path", root])
    syn = Synthesizer(cfg, device=dev, seed=cfg.seed)
    trees = to_jax(syn)
    trees["pe"] = CheckpointManager(lvd_dir).restore("pe", trees["pe"], "latest", strict=True)
    from_jax(trees, syn)
    rows = fixed_rows(cfg, BatchShard.whole(cfg.batch_size_vid))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items() if isinstance(v, np.ndarray)}
    warper = importlib.import_module("waldo_tpu_torch.models.warper")
    with torch.no_grad():
        p = syn.lvd_pass(syn.make_input(batch["vid"], batch["lyt"], batch["flow"]),
                         cfg.model.ctx_len)
        occ, obj_alpha, bg_alpha, grids = syn.alpha_grid_occ(
            p["x_obj"], p["obj_pose"], p["bg_pose"], p["occ_score"])
        x = torch.cat([batch["vid"], batch["lyt"]], dim=-1)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = syn.decode_layer(x, grids, occ, obj_alpha, bg_alpha)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, by_key = read_launches()
        sample = warper.grid_sample
        warper.grid_sample = grid_sample_plain
        try:
            want = syn.decode_layer(x, grids, occ, obj_alpha, bg_alpha)
        finally:
            warper.grid_sample = sample
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    log(f"decode_layer on phase 7's batch (x {tuple(x.shape)}): {secs * 1e3:.1f} ms; outputs "
        f"{[tuple(g.shape) for g in got]}; launches {launches} by key {by_key}; max|err| "
        f"against every sample plain {errs} (tol {TOL_F32})")
    check(launches["grid_sample"] == 1 and all(v == 0 for k, v in launches.items()
                                               if k != "grid_sample"),
          f"decode_layer's launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in got) and max(errs) <= TOL_F32,
          f"decode_layer on the card disagrees with its plain samples: {errs}")
    return {"ms": secs * 1e3, "launches": launches, "max_abs_err": errs}


def phase_gan(dev, card_name, root, lvd_dir, profile_dir=None):
    """WIF adversarial training: train_wif.sh's flags with the GAN losses
    ("sharp_vid lpips_vid adv dis") and the adaptive lambda, on synthetic
    clips from phase 7's LVD teacher, phase 9's seeded random VGG16 LPIPS:
    Trainer.run in this process with strict launch counts (the decode's K2',
    K2 batch mode and pre-pass once in each G and D step), the G and D steps
    timed on one batch, phase 9b's plain WIF step timed in turns with the G
    step, the GAN iteration (two batches) with the script's loader workers,
    K2', K2 and the pre-pass against their plain versions on the D step's
    decode; the training CLI under torchrun (NCCL, world 1); decode_layer on
    phase 7's batch; small float32 G and D steps card vs CPU, lambda
    included."""
    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.train import Trainer

    log(f"== 13. WIF adversarial training ({WIF_SCRIPT} with {GAN_LOSSES!r} and the adaptive "
        f"lambda) on synthetic clips, LVD teacher from phase 7")
    t_phase = time.perf_counter()
    modes = ["vid_inpainting", "vid_inpainting_dis"]
    lpips_path = os.path.join(root, "lpips", "lpips_vgg.npz")
    if not os.path.exists(lpips_path):
        write_random_lpips_vgg(lpips_path, seed=0)
    old_env = os.environ.get("WALDO_LPIPS_WEIGHTS")
    os.environ["WALDO_LPIPS_WEIGHTS"] = os.path.dirname(lpips_path)
    res, rows = {}, []
    try:
        cfg = parse_cli(gan_flags(root, lvd_dir, "--datetime", "smoke_gan"))
        m = cfg.model
        shape = (cfg.batch_size_vid, cfg.data.vid_len, cfg.load_dim,
                 int(cfg.load_dim * cfg.aspect_ratio), m.ii_depth, m.ii_embed_dim,
                 cfg.compute_dtype, m.sample_precision, cfg.data.num_workers)
        log(f"config (B, T, H, W, ii depth, ii embed, nets, sampling, workers): {shape}; losses "
            f"{m.vid_inpainting_losses}, adaptive lambda {m.use_adaptive_lambda}, lambda_adv "
            f"{m.lambda_adv}, lambda_dis {m.lambda_dis}")
        check(shape == (8, 5, 512, 1024, 6, 512, "float32", "fast", 8) and m.use_adaptive_lambda
              and m.vid_inpainting_losses == GAN_LOSSES.split() and m.load_path == lvd_dir,
              "the parsed config is not train_wif.sh's with the GAN losses")
        tr = Trainer(cfg, device=dev)
        log(f"modes {tr._train_modes}; {sum(p.numel() for p in tr.syn.disc.parameters())} "
            f"discriminator parameters; the adaptive lambda's WIF parameter "
            f"{tr.syn.adaptive_leaf}")
        check(tr._train_modes == modes and tr.syn.lpips is not None
              and tr.syn.adaptive_leaf == "unet.deconv_layers.3.norm.weight",
              "the GAN trainer's wiring")
        check(restored_equal(tr, lvd_dir), "the LVD teacher did not restore equal to phase 7's")
        torch.cuda.reset_peak_memory_stats()
        n = TRAIN_ITERS
        run_s, launches, by_key = run_and_check(tr, {"ii": "wif", "id": "disc"}, n, "GAN")
        res.update(run_seconds=run_s, launches_run=launches,
                   run_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(launches == {"warp_alpha_ctx": 0, "grid_sample": 2 * n,
                           "grid_sample_per_channel": 2 * n, "grid_sample_bwd": 0,
                           "grid_sample_per_channel_bwd": 0, "bias_act": 0,
                           "plane_boxes": 2 * n},
              f"expected K2', K2's batch mode and the pre-pass once in each G and D step, got "
              f"{launches}")
        per_step = lambda r: all(v == (1 if k in ("grid_sample", "grid_sample_per_channel",
                                                  "plane_boxes") else 0)
                                 for k, v in r["launches_per_step"].items())
        batch, g = time_steps(tr, modes[0], "gan_g", profile_dir)
        _, d = time_steps(tr, modes[1], "gan_d", profile_dir, batch=batch)
        check(per_step(g) and per_step(d), f"launches per G step {g['launches_per_step']}, per "
                                           f"D step {d['launches_per_step']}")
        check({"adv", "adaptive_lambda", "lpips_vid"} <= set(g["metrics"])
              and {"dis", "real_score", "fake_score"} <= set(d["metrics"]),
              f"metrics {sorted(g['metrics'])}, {sorted(d['metrics'])}")
        res.update(g_step=g, d_step=d, turns=gan_turns(tr, batch))
        pc_inputs, batch_inputs = capture_wif_sample_inputs(tr, modes[1], batch)
        del batch
        res["loader"] = loader_timing(tr, modes, g["ms_per_step"] + d["ms_per_step"], profile_dir,
                                      "_gan", ways=(cfg.data.num_workers,))
        del tr
        torch.cuda.empty_cache()
        tex = pc_inputs[0]
        rows.append(plane_boxes_row(card_name, f"plane_boxes D step decode {tuple(tex.shape)}",
                                    tex, launches["plane_boxes"]))
        del tex
        rows += wif_kernel_rows(card_name, launches, pc_inputs, batch_inputs, "D step decode")
        del pc_inputs, batch_inputs
        torch.cuda.empty_cache()
        log(f"this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB while torchrun runs")
        res["torchrun"] = gan_torchrun(root, lvd_dir)
        res["decode_layer"] = decode_layer_check(dev, lvd_dir, root)
        torch.cuda.empty_cache()
        os.environ["WALDO_LPIPS_WEIGHTS"] = os.path.join(root, "no_lpips")
        # phase 9's small WIF (no zero-initialized output conv) with the GAN
        cfg_s = small_train_cfg()
        cfg_s.model.use_ii, cfg_s.model.ii_depth, cfg_s.model.ii_embed_dim = True, 2, 16
        cfg_s.model.ii_ab = False
        cfg_s.model.vid_inpainting_losses = ["sharp_vid", "adv", "dis"]
        cfg_s.model.use_adaptive_lambda = True
        res["small_g"] = small_step_check(dev, cfg_s, "inpaint_loss", "ii", "WIF G (adv)",
                                          loss_kw={"adv": True},
                                          metrics=("adv", "adaptive_lambda"))
        res["small_d"] = small_step_check(dev, cfg_s, "discriminate_loss", "id", "discriminator",
                                          metrics=("dis", "real_score", "fake_score"))
    finally:
        if old_env is None:
            os.environ.pop("WALDO_LPIPS_WEIGHTS", None)
        else:
            os.environ["WALDO_LPIPS_WEIGHTS"] = old_env
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 took {res['seconds']:.1f} s")
    return res, rows


# ---------------------------------------------------------------------------
# sequence sharding over a (data, seq) grid, the VGG19 loss, MAT's options
# (phase 14)
# ---------------------------------------------------------------------------

SEQ_STEPS = 3  # steps the seq ranks compare with world 1
# clips a step: train_lvd.sh's 8 halved, since at 1 x 2 both seq ranks hold
# the whole batch on the one card (train_flp.sh's is 4 already)
SEQ_BATCH = 4
SEQ_GRID = ["--mesh_shape", "1,2", "--mesh_axes", "data,seq"]
SEQ_MODES = (("lvd", "vid_object_extractor", "pe"), ("flp", "vid_pose_generator", "pg"))
# launches a step: LVD's K2' forward and backward, K2's batch mode and the
# pre-pass once each; FLP's path launches none
SEQ_LAUNCHES = {"lvd": {"grid_sample_per_channel": 1, "grid_sample_per_channel_bwd": 1,
                        "grid_sample": 1, "plane_boxes": 1},
                "flp": {}}
VGG_PAIRS = 8  # frame pairs at train_wif.sh's 512x1024 in the VGG19 loss's timing


def seq_flags(root, net, lvd_dir=None, *extra, batch=SEQ_BATCH):
    """train_lvd.sh's flags (net "lvd", the zero pose head, as phase 12's
    pair) or train_flp.sh's (net "flp", the teacher in ``lvd_dir``) at B =
    ``batch`` (None: the script's), saving under ``root``."""
    if net == "lvd":
        flags = train_lvd_flags() + ["--s_pe_estimator_init_mode", "zero"]
    else:
        flags = train_lvd_flags(FLP_SCRIPT) + ["--s_load_path", lvd_dir]
    flags += ["--data.dataset", "synthetic", "--save_path", root, "--datetime", f"seq{net}"]
    return flags + (["--batch_size_vid", str(batch)] if batch else []) + list(extra)


def seq_worker(out_dir, root, backend="gloo"):
    """One rank of phase 14's grid (torchrun). With gloo, one of two ranks
    on card 0, the grid 1 x 2 of ("data", "seq") at B = SEQ_BATCH: (a)
    SEQ_STEPS LVD steps at train_lvd.sh's width through Trainer.step on one
    fixed batch, then the trainer's LVD saved as (b)'s teacher with a seeded
    random pose head, (b) SEQ_STEPS FLP steps at train_flp.sh's. With NCCL,
    a card a rank, the grid W/2 x 2 at train_lvd.sh's batch: (a) alone. Each
    step's launches, bytes through the collectives (the step's gradient
    all-reduce apart from the token gathers) and token shards, the ranks'
    parameters against rank 0's (bitwise) after each step, the peak memory,
    then the step timed. Rank 0 writes every rank's results and its
    parameters."""
    import torch
    import torch.distributed as dist
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.models import flp as flp_mod
    from waldo_tpu_torch.models import lvd as lvd_mod
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.parallel import mesh
    from waldo_tpu_torch.train import Trainer

    tf32_off()
    gloo = backend == "gloo"
    dev = torch.device("cuda", 0) if gloo else mesh.local_device("cuda")
    mesh.init_distributed(dev, backend=backend)
    grid_flags = SEQ_GRID if gloo else ["--mesh_shape", f"{mesh.world_size() // 2},2",
                                        "--mesh_axes", "data,seq"]
    sent = {"gradients": 0, "tokens": 0}
    all_reduce = dist.all_reduce

    def counting_all_reduce(t, *args, **kwargs):
        sent["gradients" if t.dim() == 1 else "tokens"] += t.numel() * t.element_size()
        return all_reduce(t, *args, **kwargs)

    dist.all_reduce = counting_all_reduce
    sites = []
    for mod in (lvd_mod, flp_mod):
        def logged(n, on, _orig=mod.token_shard):
            ts = _orig(n, on)
            sites.append((type(sys._getframe(1).f_locals["self"]).__name__, n, ts.world))
            return ts

        mod.token_shard = logged
    res, params, lvd_dir = {}, {}, None
    for net, mode, key in (SEQ_MODES if gloo else SEQ_MODES[:1]):
        cfg = parse_cli(seq_flags(root, net, lvd_dir, *grid_flags,
                                  batch=SEQ_BATCH if gloo else None))
        tr = Trainer(cfg, device=dev)
        st = tr.states[key]
        kept = first_gradients(st)
        grid = mesh.grid()
        batch = tr._to_device(fixed_rows(cfg, mesh.BatchShard.of_rank(
            cfg.batch_size_vid // grid.data_world)))
        r = {"grid": [grid.data_rank, grid.data_world, grid.seq_rank, grid.seq_world],
             "rank": mesh.rank(), "device": str(tr.device), "losses": [], "equal": [],
             "launches": [], "bytes": [], "sites": []}
        torch.cuda.reset_peak_memory_stats(dev)
        for it in range(SEQ_STEPS):
            reset_launches()
            sites.clear()
            sent.update(gradients=0, tokens=0)
            metrics = tr.step(mode, batch, it)
            torch.cuda.synchronize()
            r["launches"].append(read_launches()[0])
            r["bytes"].append(dict(sent))
            r["sites"].append(sorted(set(sites)))
            r["losses"].append(float(metrics["loss"]))
            flat = torch.cat([p.detach().reshape(-1) for p in st.params])
            ref = flat.clone()
            dist.broadcast(ref, 0)
            same = torch.tensor([float(torch.equal(flat, ref))], device=dev)
            dist.all_reduce(same, op=dist.ReduceOp.MIN)
            r["equal"].append(bool(same.item() == 1.0))
        r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        if mesh.is_main():
            params[net] = [p.detach().cpu() for p in st.params]
            params[f"{net}_names"] = [n for n, p in tr.syn.nets()[key].named_parameters()
                                      if p.requires_grad]
            params[f"{net}_grads"] = list(kept)
        # the SEQ_STEPS checked steps warmed it up
        r["step_ms"] = cuda_time(lambda: tr.step(mode, batch, 0), 2, warmup=0)
        flat = torch.ones(sum(p.numel() for p in st.params) + 1, device=dev)
        r["all_reduce_ms"] = cuda_time(lambda: all_reduce(flat), 5)
        r["all_reduce_bytes"] = flat.numel() * flat.element_size()
        res[net] = r
        if net == "lvd":
            # (b)'s teacher: a seeded random pose head (the zero one would
            # hand FLP poses that no token of the stacks moves)
            head = tr.syn.lvd.pose_estimator.head.weight
            with torch.no_grad():
                head.copy_(torch.randn(head.shape, generator=torch.Generator().manual_seed(3))
                           * 0.02)
            tr.save(0, name="latest")
            lvd_dir = tr.cfg.checkpoint_path
        del tr, st, batch, flat
        torch.cuda.empty_cache()
    every = [None] * mesh.world_size()
    dist.all_gather_object(every, res)
    if mesh.is_main():
        torch.save({"backend": mesh.backend(), "world": mesh.world_size(), "ranks": every,
                    "params": params, "lvd_dir": lvd_dir},
                   os.path.join(out_dir, f"seq_{backend}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def first_gradients(st):
    """Makes ``st`` (a NetState) keep, on the host, the reduced gradients of
    its first step; returns the list they land in."""
    kept, gradients = [], st.gradients

    def keeping(loss):
        grads, finite = gradients(loss)
        if not kept:
            kept.extend(g.detach().cpu() for g in grads)
        return grads, finite

    st.gradients = keeping
    return kept


def seq_world1(dev, root, net, lvd_dir, timed=True, batch=SEQ_BATCH):
    """World 1 in this process at B = ``batch`` (None: the script's):
    SEQ_STEPS steps of the ranks' trainer on the whole fixed batch, then
    (``timed``) the step timed. Returns ((losses, parameters), the first
    step's gradients, ms a step, peak GB)."""
    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.parallel import BatchShard
    from waldo_tpu_torch.train import Trainer

    _, mode, key = next(m for m in SEQ_MODES if m[0] == net)
    cfg = parse_cli(seq_flags(root, net, lvd_dir, "--datetime", f"seq{net}w1", batch=batch))
    tr = Trainer(cfg, device=dev)
    grads = first_gradients(tr.states[key])
    batch = tr._to_device(fixed_rows(cfg, BatchShard.whole(cfg.batch_size_vid)))
    torch.cuda.reset_peak_memory_stats()
    losses = [float(tr.step(mode, batch, it)["loss"]) for it in range(SEQ_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = [p.detach().cpu() for p in tr.states[key].params]
    ms = cuda_time(lambda: tr.step(mode, batch, 0), 3, warmup=1) if timed else None
    del tr, batch
    torch.cuda.empty_cache()
    return (losses, params), grads, ms, peak


def gradients_close(got, want, names, label):
    """The first step's reduced gradients against world 1's, per leaf: within
    1e-4 x the leaf's largest plus 1e-7 x the largest of all leaves
    (tests/test_torch_distributed.py's tolerance). Returns the worst leaf's
    error over its largest."""
    top = max(float(w.abs().max()) for w in want)
    worst, bad = (0.0, None), []
    for name, g, w in zip(names, got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        if scale > 0 and err / scale > worst[0]:
            worst = (err / scale, name)
        if err > 1e-4 * scale + 1e-7 * top:
            bad.append((name, err, scale))
    log(f"{label}: the first step's reduced gradients against world 1's: the worst leaf "
        f"{worst[1]} at {worst[0]:.3g} of its largest (tol 1e-4, plus 1e-7 x {top:.3g})")
    check(not bad, f"{label}: gradients off world 1's: {bad[:8]}")
    return worst[0]


def random_vgg19_convs(seed=0):
    """Seeded random VGG19 weights, He-scaled (kh, kw, I, O) kernels and
    small biases: the (kernel, bias) pairs VGGLoss takes."""
    from waldo_tpu_torch.nn.perceptual import _VGG19_LAYOUT

    rng, cin, convs = np.random.RandomState(seed), 3, []
    for co in (c for c in _VGG19_LAYOUT if c != "P"):
        convs.append(((rng.randn(3, 3, cin, co) * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                      (rng.randn(co) * 0.01).astype(np.float32)))
        cin = co
    return convs


def vgg_check(dev):
    """The VGG19 loss on the card against the CPU (float32, 2 pairs of
    32x64, the loss and its gradient in x; the CPU's native convolutions,
    since its oneDNN backward is 2.4e-3 off float64), then timed on
    VGG_PAIRS frame pairs of 512x1024 with seeded random weights: the
    forward alone and the forward and backward, with the peak memory."""
    import torch
    from waldo_tpu_torch.nn.perceptual import VGGLoss

    convs = random_vgg19_convs()
    rng = np.random.RandomState(1)
    a = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.3, -1, 1)
    out = []
    for d in (dev, "cpu"):
        loss = VGGLoss(convs, device=d)
        x = torch.from_numpy(a).to(d).requires_grad_()
        with torch.backends.mkldnn.flags(enabled=False):
            v = loss(x, torch.from_numpy(b).to(d))
            v.backward()
        out.append((float(v), x.grad.cpu()))
    (got, g_got), (want, g_want) = out
    loss_err = abs(got - want) / abs(want)
    scale = float(g_want.abs().max())
    grad_err = float((g_got - g_want).abs().max())
    log(f"VGG19 loss, card vs CPU on 2 x 32x64 float32: loss {got:.6f} against {want:.6f} "
        f"(relative {loss_err:.3g}, tol 1e-4); its gradient max|err| {grad_err:.3g} (tol 1e-3 x "
        f"{scale:.3g})")
    check(loss_err <= 1e-4 and grad_err <= 1e-3 * scale, "the VGG19 loss disagrees with the CPU")
    loss = VGGLoss(convs, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(VGG_PAIRS, 512, 1024, 3, generator=g, device=dev) * 2 - 1
    y = (x + 0.3 * torch.randn(x.shape, generator=g, device=dev)).clamp(-1, 1)
    with torch.no_grad():
        fwd_ms = cuda_time(lambda: loss(x, y), 3, warmup=1)
    xg = x.clone().requires_grad_()

    def fwd_bwd():
        xg.grad = None
        loss(xg, y).backward()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(xg.grad).all()), "the VGG19 loss's gradient is not finite")
    ms = cuda_time(fwd_bwd, 3, warmup=0)
    log(f"VGG19 loss on {VGG_PAIRS} frame pairs of 512x1024: forward {fwd_ms:.2f} ms, forward "
        f"and backward {ms:.2f} ms, peak memory {peak:.2f} GB")
    del loss, x, y, xg
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_err": grad_err, "grad_scale": scale,
            "forward_ms": fwd_ms, "forward_backward_ms": ms, "peak_gb": peak}


def mat_options_check(dev):
    """A MAT Generator at 128 with a bias-free layer (its synthesis's
    to_square built with use_bias=False) and the options (truncation_psi
    0.5, truncation_cutoff 3, update_w_avg, return_stg1), on the card
    against the CPU; bias_act launched once per MAT layer call, the
    bias-free ones (no bias) included."""
    import copy

    import torch
    from waldo_tpu_torch.models.mat import basic as mat_basic
    from waldo_tpu_torch.models.mat import mat as mat_mat
    from waldo_tpu_torch.nn import init_module
    from waldo_tpu_torch.ops.bias_act import bias_act
    from waldo_tpu_torch.ops.kernels import BIAS_ACT, reset_launches

    net = mat_mat.Generator(img_resolution=128)
    net.synthesis.to_square = mat_basic.FullyConnectedLayer(512, 16 * 16, activation="lrelu",
                                                            use_bias=False)
    init_module(net, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        net.mapping.w_avg.copy_(torch.randn(net.mapping.w_avg.shape, generator=g) * 0.1)
    rng = np.random.RandomState(6)
    x = torch.from_numpy((rng.rand(2, 128, 128, 3) * 2 - 1).astype(np.float32))
    keep = torch.ones(2, 128, 128, 1)
    keep[:, 30:90, 40:100] = 0.0
    z = torch.from_numpy(rng.randn(2, 512).astype(np.float32))
    calls = {"all": 0, "no_bias": 0}

    def counting_bias_act(x, b=None, *args, **kwargs):
        calls["all"] += 1
        calls["no_bias"] += b is None
        return bias_act(x, b, *args, **kwargs)

    outs = []
    for d in (dev, "cpu"):
        m = copy.deepcopy(net).to(d).eval()
        calls.update(all=0, no_bias=0)
        reset_launches()
        mat_basic.bias_act = counting_bias_act
        try:
            with torch.no_grad():
                img, stg1 = m(x.to(d), keep.to(d), z.to(d), truncation_psi=0.5,
                              noise_mode="const", truncation_cutoff=3, update_w_avg=True,
                              return_stg1=True)
        finally:
            mat_basic.bias_act = bias_act
        outs.append((img.cpu(), stg1.cpu(), m.mapping.w_avg.cpu(), dict(calls),
                     BIAS_ACT.launches))
    (img, stg1, w_avg, card_calls, launches), (img_w, stg1_w, w_avg_w, cpu_calls, _) = outs
    errs = {k: (float((a - b).abs().max()), float(b.abs().max()))
            for k, a, b in (("img", img, img_w), ("stg1", stg1, stg1_w), ("w_avg", w_avg, w_avg_w))}
    moved = float((w_avg_w - net.mapping.w_avg).abs().max())
    log(f"MAT Generator at 128 with the options and a bias-free layer, card vs CPU: "
        + ", ".join(f"{k} max|err| {e:.3g} (tol 1e-3 x {s:.3g})" for k, (e, s) in errs.items())
        + f"; w_avg moved {moved:.3g}; bias_act {launches} launches for {card_calls['all']} MAT "
          f"layer calls, {card_calls['no_bias']} of them without a bias")
    check(all(e <= 1e-3 * s for e, s in errs.values()) and moved > 0,
          "the MAT options on the card disagree with the CPU")
    check(launches == card_calls["all"] == cpu_calls["all"] and card_calls["no_bias"] == 1,
          f"bias_act launched {launches} times for {card_calls} layer calls")
    return {"errs": errs, "w_avg_moved": moved, "bias_act_launches": launches,
            "layer_calls": card_calls}


def seq_against_world1(dev, root, got, net, label, batch, spread=None):
    """One net's run on the grid (``got``, seq_worker's file) against world
    1 in this process at B = ``batch``: the ranks' grid coordinates, strict
    launches and token shards a step, the first step's reduced gradients,
    the losses and the parameters after SEQ_STEPS Adam steps, the latter
    within twice the card's own spread (``spread``, else world 1 run twice
    here). Returns compare_ranks' results with world 1's step and peak."""
    ranks = [r[net] for r in got["ranks"]]
    s_world = ranks[0]["grid"][3]
    check([r["grid"] for r in ranks] == [[i // s_world, len(ranks) // s_world, i % s_world,
                                          s_world] for i in range(len(ranks))],
          f"{label}: the ranks' grid coordinates {[r['grid'] for r in ranks]}")
    want = SEQ_LAUNCHES[net]
    for r in ranks:
        for it, launches in enumerate(r["launches"]):
            check(all(v == want.get(k, 0) for k, v in launches.items()),
                  f"{label}: rank {r['rank']} step {it} launched {launches}")
        sites = r["sites"][0]
        check(all(w == (1 if n % s_world else s_world) for _, n, w in sites)
              and {"PoseEstimator", "LayerEstimator"} <= {m for m, _, _ in sites}
              and (net == "lvd") == ("PoseEncoder" not in {m for m, _, _ in sites}),
              f"{label}: token shards {sites}")
    t0 = time.perf_counter()
    w, w_grads, w_ms, w_peak = seq_world1(dev, root, net, got["lvd_dir"], batch=batch)
    log(f"{label} world 1 in this process: {time.perf_counter() - t0:.1f} s, losses "
        f"{['%.6f' % v for v in w[0]]}, a step {w_ms:.2f} ms, peak {w_peak:.2f} GB")
    names = got["params"][f"{net}_names"]
    grad_err = gradients_close(got["params"][f"{net}_grads"], w_grads, names, label)
    if spread is None:
        # world 1 again: the card's own spread after SEQ_STEPS Adam steps (the
        # backward kernels' and cuDNN's atomics sum in no fixed order)
        w2, *_ = seq_world1(dev, root, net, got["lvd_dir"], timed=False, batch=batch)
        spread = compare_ranks({"equal": [True] * SEQ_STEPS, "params": w2[1], "names": names,
                                "ranks": [{"rank": 0, "device": str(dev), "losses": w2[0],
                                           "peak_gb": w_peak, "step_ms": w_ms,
                                           "all_reduce_ms": 0.0}],
                                "all_reduce_bytes": 0}, w, f"{label} world 1 twice",
                               steps=SEQ_STEPS, strict=False)
    r0 = ranks[0]
    log(f"{label} token shards a step (stack, tokens, S): {r0['sites'][0]}; bytes through the "
        f"collectives a step and rank: {r0['bytes'][-1]}; launches a step {r0['launches'][-1]}")
    cmp = compare_ranks({"equal": [all(e) for e in zip(*[r["equal"] for r in ranks])],
                         "ranks": ranks, "params": got["params"][net], "names": names,
                         "all_reduce_bytes": r0["all_reduce_bytes"]},
                        w, f"{label} grid", steps=SEQ_STEPS, strict=False)
    log(f"{label}: a step {[round(r['step_ms'], 2) for r in ranks]} ms on the ranks against "
        f"world 1's {w_ms:.2f} ms; peak {[round(r['peak_gb'], 2) for r in ranks]} GB a rank "
        f"against world 1's {w_peak:.2f} GB")
    check(max(cmp["loss_rel_err"]) <= 2e-4 and cmp["param_max_err"] <= 2e-4 * SEQ_STEPS
          and cmp["param_share_over_2e6"] <= max(1e-3, 2 * spread["param_share_over_2e6"]),
          f"{label}: the grid is further from world 1 than the card's own spread")
    return dict(cmp, world1_ms=w_ms, world1_peak_gb=w_peak, grad_err=grad_err,
                world1_spread=spread)


def phase_seq(dev, card_name, root):
    """Sequence sharding over a (data, seq) process grid: (a) and (b) two
    gloo ranks of a 1 x 2 grid on card 0 (seq_worker) against world 1 in
    this process at B = SEQ_BATCH; (c) NCCL over several cards where there
    are several; (d) the VGG19 loss; (e) MAT's options."""
    import torch
    from waldo_tpu_torch.config import parse_cli

    log("== 14. sequence sharding: a 1 x 2 (data, seq) grid of gloo ranks (train_lvd.sh, "
        "train_flp.sh), the VGG19 loss, MAT's options")
    log(f"card: {card_name}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir)
    here = os.path.abspath(__file__)
    res = {}
    secs, out = torchrun(2, [here, "--dist-worker", "seq", "--dist-root", root],
                         "torchrun seq ranks")
    cfg_line = [ln for ln in out.splitlines() if ln.startswith("[dist]")]
    got = torch.load(os.path.join(out_dir, "seq_gloo.pt"), weights_only=False)
    log(f"two gloo ranks on card 0 ({secs:.1f} s): backend {got['backend']}, world "
        f"{got['world']}; {cfg_line[:1]}")
    check(got["backend"] == "gloo" and got["world"] == 2, "the pair is not two gloo ranks")
    for net, label in (("lvd", "(a) LVD"), ("flp", "(b) FLP")):
        res[net] = seq_against_world1(dev, root, got, net, label, SEQ_BATCH)
    res["seconds_ranks"] = secs
    n = torch.cuda.device_count()
    batch = parse_cli(seq_flags(root, "lvd", batch=None)).batch_size_vid
    if n > 1 and batch % (n // 2) == 0:
        secs, out = torchrun(2 * (n // 2), [here, "--dist-worker", "seq-nccl", "--dist-root",
                                            root], f"torchrun NCCL seq grid over {n} cards")
        got = torch.load(os.path.join(out_dir, "seq_nccl.pt"), weights_only=False)
        log(f"(c) NCCL over {got['world']} cards ({secs:.1f} s), a {got['world'] // 2} x 2 grid "
            f"at B = {batch}")
        res["nccl_cards"] = seq_against_world1(dev, root, got, "lvd", "(c) LVD over cards", None,
                                               spread=res["lvd"]["world1_spread"])
        res["nccl_cards"]["seconds"] = secs
    else:
        log(f"(c) NCCL over several cards: not run (this machine has {n} card"
            f"{'s' if n > 1 else ''}; the grid needs two or more, and its data axis must "
            f"divide B = {batch})")
    res["vgg"] = vgg_check(dev)
    res["mat_options"] = mat_options_check(dev)
    shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {res['seconds']:.1f} s")
    return res


def gan_teacher(dev, root):
    """For --gan: an LVD run's "latest" slot of seeded weights at
    train_lvd.sh's flags, in place of phase 7's run. Returns its dir."""
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.train import Trainer

    tr = Trainer(parse_cli(train_lvd_flags() + ["--data.dataset", "synthetic", "--save_path",
                                                root, "--datetime", "teacher"]), device=dev)
    tr.save(0, name="latest")
    return tr.cfg.checkpoint_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10, help="timed predicts")
    ap.add_argument("--out", default=None, help="write the full results as JSON here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one flagship predict, one MAT clip, and one step and one "
                         "loop iteration of each training phase with torch.profiler into DIR")
    ap.add_argument("--k1-stress", type=int, default=0, metavar="REPS",
                    help="only run phase 1 and then phase 3's flagship fused-warp cases REPS "
                         "times each, into outputs that start as NaN (k1_stress); the last "
                         "line is its JSON summary and the exit code 1 if any call failed")
    ap.add_argument("--k1-cases", type=int, default=8,
                    help="with --k1-stress, the first this many of the eight cases")
    ap.add_argument("--k2-fwd", action="store_true",
                    help="only run phases 1 and 2 and then K2's forward at every row's shapes "
                         "on dense inputs (k2_fwd_study); the last line is its JSON summary")
    ap.add_argument("--dist", action="store_true",
                    help="only run phases 1, 2 and 12 (the distributed runs); the last line is "
                         "its JSON summary")
    ap.add_argument("--gan", action="store_true",
                    help="only run phases 1, 2 and 13 (WIF adversarial training), the teacher a "
                         "seeded LVD slot; the last line is its JSON summary")
    ap.add_argument("--seq", action="store_true",
                    help="only run phases 1, 2 and 14 (sequence sharding, the VGG19 loss, "
                         "MAT's options); the last line is its JSON summary")
    ap.add_argument("--dist-worker", choices=["nccl", "gloo", "nccl-cards", "seq", "seq-nccl"],
                    default=None,
                    help="run as one rank of phase 12 or 14 under torchrun (the phase starts "
                         "them)")
    ap.add_argument("--dist-root", default=None, help="phase 12's or 14's directory, for its "
                                                      "ranks")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import waldo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if args.dist_worker == "nccl":
        dist_worker_nccl(os.path.join(args.dist_root, "out"), args.dist_root)
        return 0
    if args.dist_worker in ("seq", "seq-nccl"):
        seq_worker(os.path.join(args.dist_root, "out"), args.dist_root,
                   "gloo" if args.dist_worker == "seq" else "nccl")
        return 0
    if args.dist_worker:
        dist_worker_ranks(os.path.join(args.dist_root, "out"), args.dist_root,
                          "gloo" if args.dist_worker == "gloo" else "nccl")
        return 0
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name, card_line = phase_device()
    if args.k1_stress:
        res = k1_stress(dev, args.k1_stress, args.k1_cases)
        print(json.dumps({"k1_stress": jsonable(res)}), flush=True)
        return int(any(res["calls_failing"].values()))
    build_s, bwd_sass, resources = phase_build()
    if args.k2_fwd:
        k2_rows, extra = k2_fwd_study(dev, name)
        print(json.dumps(jsonable({"k2_fwd": k2_rows, **extra})), flush=True)
        return 0
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train")
    if args.dist:
        try:
            res = phase_dist(dev, os.path.join(root, "dist"))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"dist": jsonable(res)}), flush=True)
        return 0
    if args.seq:
        try:
            res = phase_seq(dev, card_line, os.path.join(root, "seq"))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"seq": jsonable(res)}), flush=True)
        return 0
    if args.gan:
        shutil.rmtree(root, ignore_errors=True)
        try:
            res, gan_rows = phase_gan(dev, name, root, gan_teacher(dev, root), args.profile)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(jsonable({"card": card_line, "gan": res, "kernels": gan_rows}), fh,
                          indent=1)
        print(json.dumps({"gan": jsonable(res), "kernels": gan_rows}), flush=True)
        return 0
    errs, per_channel = phase_kernels(dev)
    main_res, k1_seen = phase_main(dev, args.iters, args.profile)
    mat_res = phase_mat(dev, args.profile)
    rows, zero_shares = phase_timings(dev, name, errs, main_res["launches_by_key"],
                                      mat_res["launches_by_key"], main_res["launches"],
                                      mat_res["launches"]["bias_act"], k1_seen)
    del k1_seen
    shutil.rmtree(root, ignore_errors=True)
    try:
        train_res, train_rows, lvd_dir = phase_train(dev, name, root, args.profile)
        rows += train_rows
        flp_res = phase_flp(dev, name, root, lvd_dir, args.profile)
        wif_res, wif_rows = phase_wif(dev, name, root, lvd_dir, args.profile)
        rows += wif_rows
        runs = {"lvd": lvd_dir, "flp": flp_res["checkpoint_path"],
                "wif": wif_res["l1"]["checkpoint_path"]}
        eval_res, eval_rows = phase_eval(dev, name, root, runs, mat_res["bias_act_per_forward"],
                                         args.profile)
        rows += eval_rows
        convert_res = phase_convert(dev, os.path.join(root, "convert"))
        dist_res = phase_dist(dev, os.path.join(root, "dist"))
        gan_res, gan_rows = phase_gan(dev, name, root, lvd_dir, args.profile)
        rows += gan_rows
        seq_res = phase_seq(dev, card_line, os.path.join(root, "seq"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"chip_smoke done in {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(jsonable({"card": card_line, "build_s": build_s,
                                "bwd_sass_atomics": bwd_sass, "ptxas": resources,
                                "per_channel": per_channel,
                                "main": main_res, "mat": mat_res, "train": train_res,
                                "flp": flp_res, "wif": wif_res, "eval": eval_res,
                                "convert": convert_res, "dist": dist_res, "gan": gan_res,
                                "seq": seq_res,
                                "flagship_warp_inputs": zero_shares, "kernels": rows}),
                      fh, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

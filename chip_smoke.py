#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (waldo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--iters N] [--out results.json] [--profile DIR]

Phases, in order; any failure exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit and the
     TF32 settings (both set off: the checks below are float32);
  2. build: compiles every CUDA kernel of the port from its sources, and
     the two backwards' yardsticks (their earlier designs); prints each
     kernel's registers and spills and the atomics in the backwards' SASS;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at ragged small shapes (bias_act: all nine
     activations, with and without bias, gain and clamp); the samplers'
     pre-pass (planes and nonzero boxes) for equality; the fused warp and the
     per-channel sampler on dense and object-sparse inputs and on the skip's
     edge cases (an all-zero plane, a layer grid wholly out of range, boxes
     touching each border, a texel reached by one tap only, C=32);
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
     zero output gradient); a small float32 step, card vs CPU.
With --profile DIR, phases 4, 5 and 7 also trace one predict, one MAT clip
and one training step with torch.profiler and write the device time per
span and per kernel, and the device's idle share, to
DIR/profile{,_mat,_train}.json and .txt.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import random
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
TRAIN_SCRIPT = "scripts/cityscapes/train_lvd.sh"
TRAIN_ITERS = 3  # Trainer.run iterations of the training phase
TRAIN_TIMED = 5  # timed steps on one fixed batch
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
    # every kernel of the port, and the backwards' yardsticks
    report = build(sorted({k.source for k in KERNELS.values()}
                          | {ROWS_BWD_SOURCE, SHARED_BWD_FIRST_SOURCE}))
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
        check(e <= TOL_F32 and all(torch.isfinite(x).all() for x in got),
              f"warp_alpha_ctx {label} disagrees: {e}")
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
    k1_inputs_seen = capture_warp_inputs(syn, batch)
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


def capture_warp_inputs(syn, batch):
    """The (alpha, grid, occ, is_obj, tp_sz, tcp) of every fused warp call
    in one predict, copied, for phase 6 to time the kernel on them."""
    from waldo_tpu_torch.models import warper

    seen, fused = [], warper.warp_alpha_ctx

    def capturing(alpha, grids, occ, is_obj, *, tp_sz, tcp):
        seen.append(tuple(None if t is None else t.float().contiguous().clone()
                          for t in (alpha, grids, occ, is_obj)) + (tp_sz, tcp))
        return fused(alpha, grids, occ, is_obj, tp_sz=tp_sz, tcp=tcp)

    warper.warp_alpha_ctx = capturing
    try:
        syn.predict(batch)
    finally:
        warper.warp_alpha_ctx = fused
    return seen


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


def phase_timings(dev, card_name, errs, by_key, mat_by_key, launches, k3_launches, k1_seen):
    import torch
    import torch.nn.functional as F
    from waldo_tpu_torch.ops.bias_act import _ACTS, bias_act_plain
    from waldo_tpu_torch.ops.grid_sample import (grid_sample_ctx_plain,
                                                 grid_sample_multigrid_plain, plane_boxes_plain,
                                                 tap_footprint_skips, warp_alpha_ctx_plain)
    from waldo_tpu_torch.ops.kernels import (PLANE_BOXES, bias_act_cuda, grid_sample_cuda,
                                             plane_boxes_cuda, warp_alpha_ctx_cuda)

    log("== 6. kernel timings at the main paths' shapes")
    bw, fp32 = card_rates(card_name)
    log(f"bounds at {bw / 1e12:.2f} TB/s and {fp32 / 1e12:.0f} TFLOP/s float32 ({card_name})")
    rng = np.random.RandomState(1)
    rows = []

    def k1_row(label, a, g, o, mask, tp, tcp, n_launches, err):
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
        rows.append({"name": label, "route": "cuda", "source": K1_SOURCE,
                     "replaces": K1_REPLACES, "launches": n_launches, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})

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
                k1_row(f"warp_alpha_ctx N={n}" + (" object-sparse" if sparse else "")
                       + ("" if mask is None else " is_obj"), a, g, o, mask, tp, tc * tp,
                       n_launches, errs["warp_alpha_ctx", n, mask is not None, sparse])
            del a, g, o, io
            torch.cuda.empty_cache()

        c = 23
        img, grid = k2_inputs(rng, f, h, w, c, tp, h, w, dev)
        ms = cuda_time(lambda: grid_sample_cuda(img, grid, tp), 20)
        plain = cuda_time(lambda: grid_sample_ctx_plain(img, grid, tp), 3)
        rep = img.repeat_interleave(tp, dim=0).permute(0, 3, 1, 2).contiguous()
        lib = cuda_time(lambda: F.grid_sample(rep, grid, mode="bilinear", padding_mode="zeros",
                                              align_corners=False), 20)
        nbytes = 4 * (f * p * c + n * p * 2 + n * p * c)
        b_ms, b_by = bound(card_name, nbytes, n * p * (16 + 8 * c))
        rows.append({"name": f"grid_sample_ctx N={n}", "route": "cuda", "source": K2_SOURCE,
                     "replaces": K2_REPLACES, "launches": by_key["grid_sample"][n],
                     "max_abs_err": errs["grid_sample", n], "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        del img, grid, rep
        torch.cuda.empty_cache()

    # the warp on the exact inputs the flagship predict handed it, with
    # their share of zero (pixel, layer) samples and of samples the box
    # test skips
    zero_shares = []
    for a, g, o, io, tp, tcp in k1_seen:
        n, c, gh, gw, _ = g.shape
        got = warp_alpha_ctx_cuda(a, g, o, io, tp, tcp)
        err = max_err(got, warp_alpha_ctx_plain(a, g, o, io, tp_sz=tp, tcp=tcp))
        check(err <= TOL_F32, f"warp_alpha_ctx on the flagship predict's inputs disagrees: {err}")
        del got
        _, boxes = plane_boxes_plain(a)
        frame = torch.arange(n, device=dev) // tp
        skip = float(tap_footprint_skips(g, boxes[frame], a.shape[1], a.shape[2]).float().mean())
        sam = grid_sample_multigrid_plain(a.repeat_interleave(tp, dim=0), g)
        zero = float((sam == 0).float().mean())
        zero_obj = float((sam[..., 1:] == 0).float().mean())
        del sam
        box_area = ((boxes[..., 1] - boxes[..., 0] + 1).clamp(min=0)
                    * (boxes[..., 3] - boxes[..., 2] + 1).clamp(min=0)).float()
        box_share = float(box_area.mean()) / (a.shape[1] * a.shape[2])
        log(f"warp_alpha_ctx N={n} on the flagship predict's inputs: max|err| {err:.3g}; zero "
            f"samples {zero:.4f} of all (pixel, layer), {zero_obj:.4f} of the object layers'; "
            f"the box test skips {skip:.4f}; boxes cover {box_share:.4f} of a plane on average")
        zero_shares.append({"n": n, "zero_share": zero, "zero_share_objects": zero_obj,
                            "skip_share": skip})
        k1_row(f"warp_alpha_ctx N={n} flagship inputs" + ("" if io is None else " is_obj"),
               a, g, o, io, tp, tcp, by_key["warp_alpha_ctx"][n, io is not None], err)
        torch.cuda.empty_cache()

    # the pre-pass alone, on the flagship warp's texture shape. Its ~0.03 ms
    # on the card is close to the host's cost of one wrapper call (checks,
    # two allocations, the launch), so the kernel is timed launched into
    # outputs made once, and the wrapper's time is logged beside it. One
    # permute copy (what the warp's wrapper did before) is logged as a
    # yardstick: it computes the planes but not the boxes.
    tex = sparse_alpha(rng, 4, 256, 512, 17, dev)
    got = plane_boxes_cuda(tex)
    want = plane_boxes_plain(tex)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, want)), "plane_boxes disagrees")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = cuda_time(lambda: PLANE_BOXES.launch(None, tex.data_ptr(), got[0].data_ptr(),
                                              got[1].data_ptr(), *tex.shape, 0, stream), 100)
    wrapper_ms = cuda_time(lambda: plane_boxes_cuda(tex), 100)
    plain = cuda_time(lambda: plane_boxes_plain(tex), 5)
    copy_ms = cuda_time(lambda: tex.permute(0, 3, 1, 2).contiguous(), 100)
    b_ms, b_by = bound(card_name, 2 * tex.numel() * 4 + want[1].numel() * 4, tex.numel())
    log(f"plane_boxes 4x256x512x17: through its wrapper {wrapper_ms:.4f} ms; permute copy "
        f"alone {copy_ms:.4f} ms")
    rows.append({"name": "plane_boxes 4x256x512x17", "route": "cuda", "source": PRE_SOURCE,
                 "replaces": PRE_REPLACES, "launches": launches["plane_boxes"],
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None})
    del tex, got, want

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
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.0%} of it), plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms")
    return rows, zero_shares


def train_lvd_flags(path=TRAIN_SCRIPT):
    """The flags scripts/cityscapes/train_lvd.sh hands the training CLI."""
    import shlex

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)) as fh:
        text = fh.read().replace("\\\n", " ")
    for line in text.splitlines():
        if "cli.train" in line:
            return [a for a in shlex.split(line.split("cli.train", 1)[1]) if a != "$@"]
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


def flat_grads(syn):
    """The LVD gradients by flax path, as numpy arrays."""
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.train.checkpoint import _flatten

    return _flatten(to_jax(syn, grads=True)["pe"])


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
    fwd = dict(
        ms=cuda_time(lambda: grid_sample_cuda(img, grid, 1), 10),
        plain_ms=cuda_time(lambda: grid_sample_plain(img, grid), 3),
        library_ms=cuda_time(lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                                   padding_mode="zeros", align_corners=False), 10))
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
    texel_b, grid_b, out_b = 4 * f * h * w * 23, 8 * f * p, 4 * f * p * 23
    b_fwd = bound(card_name, texel_b + grid_b + out_b, f * p * (16 + 8 * 23))
    b_bwd = k2_bwd_bound(card_name, img, grid, gout_b)
    rows.append({"name": f"grid_sample batch mode {f}x{h}x{w} C=23", "route": "cuda",
                 "source": K2_SOURCE, "replaces": K2_REPLACES,
                 "launches": run_launches["grid_sample"], "max_abs_err": errs["b_fwd"],
                 **fwd, "bound_ms": b_fwd[0], "bound_by": b_fwd[1]})
    k2_row = {"name": f"grid_sample_bwd batch mode {f}x{h}x{w} C=23, grid only "
                      f"(launched by an LVD step with pxl_vid)",
              "route": "cuda", "source": BWD_SOURCE, "replaces": K2_BWD_REPLACES,
              "launches": run_launches["grid_sample_bwd"], "max_abs_err": errs["b_bwd"],
              **bwd, "bound_ms": b_bwd[0], "bound_by": b_bwd[1]}
    rows.append(k2_row)
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
    k2_row["max_abs_err"] = errs["b_bwd"]
    k2_row["turns"] = {k: {"first": v["first"], "new": v["new"]} for k, v in k2b.items()}
    del s_img, s_grid, s_gout, s_in, k2_step_inputs
    torch.cuda.empty_cache()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.0%} of it), plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']:.4f} ms")
    d, t = k2b["dense"], k2b["step_inputs"]
    log(f"K2 backward, grid only, in turns first design, tiles, tiles, first design (ms, as the "
        f"autograd function runs each): dense {d['first'][0]:.4f} / {d['new'][0]:.4f} / "
        f"{d['new'][1]:.4f} / {d['first'][1]:.4f} ({d['tiles_staged']:.4g} of the windows staged; "
        f"ATen NCHW {k2_row['library_ms']:.4f}, ATen on the channel-last views "
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


def phase_train(dev, card_name, profile_dir=None):
    """The LVD training path: train_lvd.sh's config on synthetic clips,
    Trainer.run for TRAIN_ITERS iterations (launch counts, finite loss, no
    skipped step, parameters moved, the "latest" slot restores equal), then
    TRAIN_TIMED steps timed on one fixed batch, the samples' kernels against
    their plain versions at the path's shapes, and a small float32 step on
    the card against the same step on the CPU."""
    import shutil

    import torch
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.data import create_dataset
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.ops.kernels import reset_launches
    from waldo_tpu_torch.train import Trainer
    from waldo_tpu_torch.train.checkpoint import _flatten

    log(f"== 7. training path: LVD training ({TRAIN_SCRIPT}) on synthetic clips")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    mode = "vid_object_extractor"
    try:
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

        batch = tr._to_device(tr.train_loader.next())
        for _ in range(2):
            tr.step(mode, batch, 0)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        metrics = tr.step(mode, batch, 0)
        torch.cuda.synchronize()
        step_launches, _ = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(all(v == (0 if k in ("warp_alpha_ctx", "bias_act", "grid_sample_bwd") else 1)
                  for k, v in step_launches.items()), f"launches in one step: {step_launches}")
        loss = float(metrics["loss"])
        check(np.isfinite(loss) and all(bool(torch.isfinite(v)) for v in metrics.values())
              and int(metrics["nancount"]) == 0, f"non-finite metrics {metrics}")
        ms = cuda_time(lambda: tr.step(mode, batch, 0), TRAIN_TIMED, warmup=0)
        clips = cfg.batch_size_vid / (ms / 1e3)
        log(f"train step: {ms:.2f} ms over {TRAIN_TIMED} steps -> {clips:.3f} clips/s "
            f"({cfg.batch_size_vid} clips of {cfg.data.vid_len} frames); peak memory "
            f"{peak_gb:.2f} GB; loss {loss:.5f}; launches per step {step_launches}")
        prof = (phase_profile(lambda: tr.step(mode, batch, 0), profile_dir, "_train")
                if profile_dir else None)
        step_inputs = capture_pc_bwd_inputs(tr, mode, batch)

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
        del tr, batch, metrics, px
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # each kernel's launches from the run; K2's backward's from the pxl_vid step
    rows, bwd_res = phase_train_kernels(
        dev, card_name, dict(run_launches, grid_sample_bwd=px_launches["grid_sample_bwd"]),
        step_inputs, k2_step_inputs)

    # a small float32 step on the card against the same step on the CPU, on
    # a training clip drawn from a seeded stream (the same in every process)
    cfg_s = small_train_cfg()
    ds = create_dataset(cfg_s, phase="train", rng=random.Random(3))
    b_np = {k: v[None] for k, v in ds[0].items() if isinstance(v, np.ndarray)}
    res = []
    for d in (dev, "cpu"):  # the same seeded weights on both
        syn = Synthesizer(cfg_s, device=d, seed=3)
        s_loss, _ = syn.extract_object_loss({k: torch.from_numpy(v).to(d) for k, v in b_np.items()})
        s_loss.backward()
        res.append((float(s_loss.detach()), flat_grads(syn)))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = res
    # per leaf: 5e-3 of the leaf's largest gradient (the CPU tests' factor
    # against JAX) plus 1e-5 of the largest of all leaves, since a leaf whose
    # gradient sums many cancelling terms carries the whole step's rounding
    # (other summation orders, the K2' backward's atomics) at that scale
    top = max(float(np.abs(v).max()) for v in g_cpu.values())
    ratio, leaf = max((float(np.abs(g_gpu[k] - g_cpu[k]).max())
                       / (5e-3 * float(np.abs(g_cpu[k]).max()) + 1e-5 * top), k) for k in g_cpu)
    e_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"small float32 train step, card vs CPU: loss {l_gpu:.6f} / {l_cpu:.6f} (relative "
        f"{e_loss:.3g}, tol 1e-4); per-leaf gradients within {ratio:.3g} of their tolerance "
        f"(5e-3 x max|CPU leaf| + 1e-5 x max|CPU grad| = {top:.3g}), the tightest {leaf}")
    check(e_loss <= 1e-4 and ratio <= 1.0,
          "the small train step on the card disagrees with the CPU")
    share, e_inv = scatter_inversion_check(dev)
    log(f"scatter inversion (64 object grids, 64x64 -> 128x256), card vs CPU on the same grids: "
        f"{share:.3g} of the pixels differ by more than 1e-4 (tol 1e-4: a displacement within "
        f"rounding of a half pixel), max|err| {e_inv:.3g} elsewhere (tol 1e-5)")
    check(share <= 1e-4 and e_inv <= 1e-5,
          "the scatter inversion on the card disagrees with the CPU")
    return {"ms_per_step": ms, "clips_per_s": clips, "peak_gb": peak_gb, "loss": loss,
            "run_seconds": run_s, "launches_run": run_launches, "launches_per_step": step_launches,
            "launches_pxl_vid_step": px_launches,
            "small_step_loss_err": e_loss, "small_step_grad_tol_ratio": ratio,
            "scatter_inversion_diff_share": share, "scatter_inversion_err": e_inv,
            "backwards": bwd_res, "profile": prof}, rows



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10, help="timed predicts")
    ap.add_argument("--out", default=None, help="write the full results as JSON here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one flagship predict, one MAT clip and one training step "
                         "with torch.profiler into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import waldo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name, card_line = phase_device()
    build_s, bwd_sass, resources = phase_build()
    errs, per_channel = phase_kernels(dev)
    main_res, k1_seen = phase_main(dev, args.iters, args.profile)
    mat_res = phase_mat(dev, args.profile)
    rows, zero_shares = phase_timings(dev, name, errs, main_res["launches_by_key"],
                                      mat_res["launches_by_key"], main_res["launches"],
                                      mat_res["launches"]["bias_act"], k1_seen)
    del k1_seen
    train_res, train_rows = phase_train(dev, name, args.profile)
    rows += train_rows
    log(f"chip_smoke done in {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(jsonable({"card": card_line, "build_s": build_s,
                                "bwd_sass_atomics": bwd_sass, "ptxas": resources,
                                "per_channel": per_channel,
                                "main": main_res, "mat": mat_res, "train": train_res,
                                "flagship_warp_inputs": zero_shares, "kernels": rows}),
                      fh, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The per-channel backward kernel's split of grad_img, on the CPU.

The kernel (csrc/grid_sample_bwd.cu, per-channel mode) gives each plane a
block; a plane of at most ``BWD_PLANE_CAP`` texels is its window, summed in
shared memory and stored once, and a larger plane's tap terms go straight
into grad_img by device atomics. ``bwd_tap_routes`` models that split in
plain PyTorch. Here, on the edge cases of chip_smoke.py's
``train_kernel_inputs`` at a small size and on a 3-fold zoom, with the
kernel's cap and with one the plane overflows: every live tap (on the plane,
with a nonzero output gradient) takes exactly one route, the two routes
accumulated in that order give the plain grad_img, and the plain grad_img
agrees with ``jax.vjp`` of the JAX package's references: the TPU path's VJP
(``_pallas_mg_bwd``) off the pixel lattice, ``grid_sample_ref``'s on it
(tests/test_torch_train_ops.py). Tolerance, float32: 2e-5 absolute / 1e-4
relative, the repo's sampler tolerance (the routes sum the same terms in
another order).
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.ops import get_grid

from waldo_tpu_torch.ops.grid_sample import (BWD_PLANE_CAP, bwd_tap_routes,
                                             grid_sample_multigrid_plain)

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")

ATOL, RTOL = 2e-5, 1e-4
F_, H_, W_, C_ = 2, 48, 128, 3
CAPS = [BWD_PLANE_CAP, H_ * W_ - 1]  # the kernel's; one the plane overflows by a texel
CASES = ["dense", "zero_plane", "lattice", "lattice_shift", "out_of_range", "smooth", "zoom"]
ON_LATTICE = ("lattice", "lattice_shift")


def _case(name, seed=0):
    """Texture (F, H, W, C), per-layer grids (F, C, H, W, 2) and a dense
    grad_out (F, H, W, C), every layer of the named kind: a dense texture
    sampled along smooth warps ("dense"), an all-zero texture ("zero_plane"),
    grids on the pixel lattice, as is and shifted by whole pixels, grids
    wholly out of range, smooth warps with the inverse warp's 4.0 holes over
    an object-sparse texture ("smooth"), and a 3-fold shrink about a random
    centre ("zoom")."""
    rng = np.random.RandomState(seed)
    base = get_grid(H_, W_).astype(np.float32)  # (H, W, 2)
    tex = rng.rand(F_, H_, W_, C_).astype(np.float32)
    a = np.eye(2, dtype=np.float32) + rng.uniform(-0.1, 0.1, (F_, C_, 2, 2))
    t = rng.uniform(-0.3, 0.3, (F_, C_, 1, 1, 2))
    grids = np.einsum("hwc,flcd->flhwd", base, a) + t
    if name == "zero_plane":
        tex[:] = 0.0
    elif name == "lattice":
        grids = np.broadcast_to(base, grids.shape).copy()
    elif name == "lattice_shift":
        shift = rng.randint(-5, 6, (F_, C_, 1, 1, 2)) * np.array([2.0 / W_, 2.0 / H_])
        grids = base + shift
    elif name == "out_of_range":
        grids = grids + 3.0
    elif name == "smooth":
        tex *= rng.rand(F_, H_, W_, C_) < 0.1
        grids[rng.rand(*grids.shape[:-1]) < 0.05] = 4.0
    elif name == "zoom":
        grids = base * 3.0 + rng.uniform(-0.5, 0.5, (F_, C_, 1, 1, 2))
    gout = rng.randn(F_, H_, W_, C_).astype(np.float32)
    return tex, np.ascontiguousarray(grids, np.float32), gout


def _tap_terms(grids, gout, h, w):
    """Each tap's texel (x, y) and term (its bilinear weight times the output
    gradient), (F, C, Ho, Wo, 4), with the kernels' step-rounded taps."""
    def taps(g, size):
        i = ((g + 1.0) * (size * 0.5) - 0.5).clamp(-2.0, size + 1.0)
        i0 = torch.floor(i)
        return i0.long(), i - i0

    x0, tx = taps(grids[..., 0], w)
    y0, ty = taps(grids[..., 1], h)
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    wx = torch.stack([1 - tx, tx, 1 - tx, tx], dim=-1)
    wy = torch.stack([1 - ty, 1 - ty, ty, ty], dim=-1)
    return xs, ys, wx * wy * gout.permute(0, 3, 1, 2)[..., None]


def _accumulate(routes, grids, gout, h, w):
    """grad_img (F, H, W, C) from the window taps first, then the fallback's."""
    f, c = grids.shape[:2]
    xs, ys, terms = _tap_terms(grids, gout, h, w)
    lay = torch.arange(f * c).reshape(f, c, 1, 1, 1).expand_as(xs)
    acc = torch.zeros(f * c * h * w)
    for route in (1, 2):
        sel = routes == route
        idx = (lay[sel] * h + ys[sel]) * w + xs[sel]
        acc.index_add_(0, idx, terms[sel])
    return acc.reshape(f, c, h, w).permute(0, 2, 3, 1)


def _plain_grad_img(tex, grids, gout):
    t = torch.from_numpy(tex).requires_grad_()
    grid_sample_multigrid_plain(t, torch.from_numpy(grids)).backward(torch.from_numpy(gout))
    return t.grad


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", CASES)
def test_every_live_tap_takes_one_route(case, cap):
    tex, grids, gout = _case(case)
    g, go = torch.from_numpy(grids), torch.from_numpy(gout)
    routes = bwd_tap_routes(g, go, H_, W_, cap=cap)
    xs, ys, _ = _tap_terms(g, go, H_, W_)
    on_plane = (xs >= 0) & (xs < W_) & (ys >= 0) & (ys < H_)
    live = on_plane & (go.permute(0, 3, 1, 2) != 0)[..., None]
    assert routes.dtype == torch.int8 and routes.shape == xs.shape
    assert torch.equal(routes != 0, live), "a live tap without a route, or a dead one with one"
    # a plane within the cap is its window; a larger one has none
    assert set(routes[live].unique().tolist()) <= ({1} if H_ * W_ <= cap else {2})
    if case == "out_of_range":
        assert not bool(routes.any())
    else:
        assert bool(live.any())


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", CASES)
def test_routes_accumulate_to_the_plain_grad_img(case, cap):
    """Window taps, then fallback taps, summed: the plain grad_img."""
    tex, grids, gout = _case(case)
    g, go = torch.from_numpy(grids), torch.from_numpy(gout)
    got = _accumulate(bwd_tap_routes(g, go, H_, W_, cap=cap), g, go, H_, W_)
    want = _plain_grad_img(tex, grids, gout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def _folded_ref(im, gr):
    b, h, w, c = im.shape
    out = jgs.grid_sample_ref(jnp.moveaxis(im, -1, 1).reshape(b * c, h, w, 1),
                              gr.reshape((b * c,) + gr.shape[2:]))
    return jnp.moveaxis(out.reshape((b, c) + out.shape[1:-1]), 1, -1)


@pytest.mark.parametrize("case", CASES)
def test_plain_grad_img_matches_jax(case):
    """The plain grad_img against the JAX package: the TPU path's VJP off
    the lattice, grid_sample_ref's VJP on it."""
    tex, grids, gout = _case(case)
    want_img = _plain_grad_img(tex, grids, gout).numpy()
    if case in ON_LATTICE:
        _, vjp = jax.vjp(_folded_ref, jnp.asarray(tex), jnp.asarray(grids))
        w_img, _ = vjp(jnp.asarray(gout))
    else:
        w_img, _ = jgs._pallas_mg_bwd("float32", (jnp.asarray(tex), jnp.asarray(grids)),
                                      jnp.asarray(gout))
    np.testing.assert_allclose(want_img, np.asarray(w_img), atol=ATOL, rtol=RTOL)
    if case != "out_of_range":
        assert np.abs(want_img).max() > 0


def test_backward_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel's wrapper silently: it raises."""
    from waldo_tpu_torch.ops.kernels import grid_sample_per_channel_bwd_cuda

    planes, boxes = torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        grid_sample_per_channel_bwd_cuda(planes, boxes, torch.zeros(1, 2, 8, 8, 2),
                                         torch.zeros(1, 8, 8, 2), True)

"""The port's geometry ops against the JAX package, on the CPU.

Each test makes its inputs with numpy from a seed and feeds the same arrays
to the JAX function and to its waldo_tpu_torch counterpart. On CPU tensors
the port runs the plain PyTorch versions of its kernels, which are compared
with the Pallas kernels run in interpret mode and with the JAX references.
Tolerance: atol 2e-5 / rtol 1e-4 in float32 (the repo's sampler tolerance,
tests/test_ops_geometry.py) unless a test says otherwise.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from waldo_tpu.ops.grid_sample import _warp_alpha_ctx_ref, grid_sample_ref
from waldo_tpu.ops.pallas.grid_sample import grid_sample_pallas, warp_alpha_ctx_pallas

from waldo_tpu_torch.ops.grid_sample import (grid_sample, grid_sample_ctx,
                                             grid_sample_multigrid, warp_alpha_ctx)

ATOL, RTOL = 2e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=msg)


@pytest.mark.parametrize("h,w,gh,gw,with_io,sparse", [
    (32, 128, 40, 130, True, False),
    (24, 96, 32, 128, False, False),
    (32, 128, 64, 128, True, True),
])
def test_warp_alpha_ctx_matches_pallas_and_ref(h, w, gh, gw, with_io, sparse):
    """The plain fused alpha_ctx warp (sample, ghost mask, disocc max,
    occlusion product, flow sum) against warp_alpha_ctx_pallas (interpret)
    and _warp_alpha_ctx_ref, on non-tile-aligned shapes."""
    rng = np.random.RandomState(7)
    b, tc, tp, c = 1, 2, 2, 3
    f, n, tcp = b * tc, b * tc * tp, tc * tp
    alpha = rng.rand(f, h, w, c).astype(np.float32)
    if sparse:
        alpha[:, :, :, 1] = 0.0
        alpha[:, 8:20, 32:80, 1] = rng.rand(f, 12, 48)
        alpha[:, :, :, 2] = 0.0
    grids = (rng.rand(n, c, gh, gw, 2) * 2.4 - 1.2).astype(np.float32)
    if sparse:
        grids[:2, 0] += 4.0  # a fully out-of-range layer grid
    occ = rng.rand(n, c, c).astype(np.float32)
    io = (rng.rand(b * tp, c, gh, gw) > 0.3).astype(np.float32) if with_io else None

    got = warp_alpha_ctx(_t(alpha), _t(grids), _t(occ), None if io is None else _t(io),
                         tp_sz=tp, tcp=tcp)
    jio = None if io is None else jnp.asarray(io)
    want_ref = _warp_alpha_ctx_ref(jnp.asarray(alpha), jnp.asarray(grids), jnp.asarray(occ),
                                   jio, tp_sz=tp, tcp=tcp, precision="float32")
    want_pal = warp_alpha_ctx_pallas(jnp.asarray(alpha), jnp.asarray(grids), jnp.asarray(occ),
                                     jio, tp_sz=tp, tcp=tcp, precision="float32",
                                     interpret=True)
    for name, g, wr, wp in zip(("alpha_occ", "disocc", "flow"), got, want_ref, want_pal):
        assert tuple(g.shape) == tuple(wr.shape), name
        _close(g, wr, msg=f"{name} vs ref")
        _close(g, wp, msg=f"{name} vs pallas")


def test_grid_sample_ctx_matches_pallas_tp_mapping():
    """Shared-texture sample with tp_sz > 1 (row i reads texture i // tp_sz)
    against grid_sample_pallas(tp_sz=...) in interpret mode."""
    rng = np.random.RandomState(7)
    f, tp, h, w, c, gh, gw = 2, 3, 64, 128, 5, 40, 66
    img = rng.rand(f, h, w, c).astype(np.float32)
    img[1] = 0.0
    grid = (rng.rand(f * tp, gh, gw, 2) * 2.4 - 1.2).astype(np.float32)
    got = grid_sample_ctx(_t(img), _t(grid), tp_sz=tp)
    want = grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid), interpret=True, tp_sz=tp)
    assert tuple(got.shape) == (f * tp, gh, gw, c)
    _close(got, want)


def test_grid_sample_multigrid_matches_pallas():
    """Per-channel grids (channel k rides grids[:, k]) against the Pallas
    kernel's per-channel mode in interpret mode."""
    rng = np.random.RandomState(3)
    b, h, w, c, gh, gw = 2, 64, 128, 5, 48, 70
    img = rng.rand(b, h, w, c).astype(np.float32)
    grids = (rng.rand(b, c, gh, gw, 2) * 2.4 - 1.2).astype(np.float32)
    got = grid_sample_multigrid(_t(img), _t(grids))
    want = grid_sample_pallas(jnp.asarray(img), jnp.asarray(grids), interpret=True)
    _close(got, want)


@pytest.mark.parametrize("b,h,w,c,gh,gw", [(2, 24, 40, 3, 24, 40), (1, 16, 16, 1, 33, 129),
                                           (2, 64, 96, 2, 17, 9)])
def test_grid_sample_matches_ref(b, h, w, c, gh, gw):
    """Generic sampler against grid_sample_ref, with coordinates reaching far
    outside [-1, 1] (zero padding) and the inverse warp's 4.0 hole value."""
    rng = np.random.RandomState(0)
    img = rng.randn(b, h, w, c).astype(np.float32)
    grid = (rng.rand(b, gh, gw, 2) * 3 - 1.5).astype(np.float32)
    grid[:, 0, :3] = 4.0
    got = grid_sample(_t(img), _t(grid))
    _close(got, grid_sample_ref(jnp.asarray(img), jnp.asarray(grid)))


def test_tps_warp_matches_jax():
    from waldo_tpu.ops import TPSWarp as JTPS, get_grid
    from waldo_tpu_torch.ops import TPSWarp

    rng = np.random.RandomState(1)
    pts = get_grid(4, 8).reshape(-1, 2)
    src = (pts[None] + rng.randn(3, 32, 2) * 0.05).astype(np.float32)
    want = JTPS(16, 32, pts)(jnp.asarray(src))
    got = TPSWarp(16, 32, pts, device="cpu")(_t(src))
    _close(got, want, atol=1e-5)


def test_inverse_warp_iterative_matches_jax():
    """Fixed-point grid inversion in float32. Its hole mask is a hard
    threshold on the last step; at this seed no pixel lands on the other
    side of it, so every pixel is held to the tolerance."""
    from waldo_tpu.ops import InverseWarp as JInv, TPSWarp as JTPS, get_grid
    from waldo_tpu_torch.ops import InverseWarp

    rng = np.random.RandomState(2)
    pts = get_grid(2, 2).reshape(-1, 2)
    src = (pts[None] * 0.5 + rng.randn(4, 4, 2) * 0.05).astype(np.float32)
    fwd = np.asarray(JTPS(16, 16, pts)(jnp.asarray(src)))  # (4,16,16,2)
    want = JInv(16, 16, 32, 64).iterative(jnp.asarray(fwd), precision="float32")
    got = InverseWarp(16, 16, 32, 64, device="cpu").iterative(_t(fwd))
    assert (np.asarray(want) == 4.0).any() and (np.asarray(want) != 4.0).any()
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("shape_in,scale,shape", [
    ((2, 3, 16, 24, 5), 2.0, None),   # integer upsample (phase path in JAX)
    ((2, 16, 24, 5), 0.5, None),      # downsample
    ((1, 3, 10, 14, 2), None, (32, 48)),  # explicit shape, up
    ((3, 33, 20, 2), None, (16, 24)),     # explicit shape, non-integer
])
def test_resize_matches_jax(shape_in, scale, shape):
    from waldo_tpu.ops import resize as jresize
    from waldo_tpu_torch.ops import resize

    x = np.random.RandomState(3).randn(*shape_in).astype(np.float32)
    want = jresize(jnp.asarray(x), scale, shape=shape)
    got = resize(_t(x), scale, shape=shape)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-5)


def test_gather_time_matches_jax():
    from waldo_tpu.utils import gather_time as jgather
    from waldo_tpu_torch.utils import gather_time

    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3, 4, 2).astype(np.float32)
    ts = rng.randint(0, 5, (2, 3, 4))
    want = jgather(jnp.asarray(x), jnp.asarray(ts))
    got = gather_time(_t(x), _t(ts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

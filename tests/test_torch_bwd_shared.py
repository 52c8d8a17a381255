"""The shared-grid (batch-mode) sample backward on the CPU.

The training step hands the K2 backward its output gradient as the Warper's
``cat`` leaves it: under float32 sampling a channel slice of a wider tensor.
The plain backward (``grid_sample`` on a CPU tensor, autograd through
``F.grid_sample``) gives the same gradients for that slice as for its
contiguous copy, and agrees with the JAX package's VJPs: the TPU path's
(``_pallas_bwd``) off the pixel lattice, ``grid_sample_ref``'s on it
(tests/test_torch_train_ops.py). The kernel (csrc/grid_sample_bwd.cu,
shared mode) gives each 16 x 16 tile of output pixels a block that stages
the texture window its taps reach; ``shared_bwd_windows`` models those
windows in plain PyTorch. Here the windows hold every tap they serve, and
gathering the taps from windows laid out as the kernel stages them, by the
kernel's index arithmetic, gives the plain grad_grid. Tolerances, float32:
grad_img 2e-5 absolute / 1e-4 relative, the repo's sampler tolerance;
grad_grid 1e-4 of its largest magnitude, the repo's gradient tolerance
(tests/test_torch_train_ops.py): it sums C channel terms of either sign
scaled by W/2, so a sum that cancels to near 0 carries the terms' rounding
(one element of 5760 off by 3.4e-4 of itself, 1.4e-4 absolute, against
``_pallas_bwd``'s matrix-product summation).
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.ops import get_grid

from waldo_tpu_torch.ops.grid_sample import (BWD_MAX_C, BWD_TILE, BWD_WINDOW_CAP, grid_sample,
                                             grid_sample_ctx_plain, shared_bwd_windows)

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")

ATOL, RTOL = 2e-5, 1e-4
GRAD_REL = 1e-4
F_, H_, W_, C_ = 3, 24, 40, 23
CASES = ["smooth", "lattice", "lattice_shift", "zoom", "out_of_range"]
ON_LATTICE = ("lattice", "lattice_shift")


def _case(name, seed=0, c=C_):
    """Texture (F, H, W, c), grid (F, H, W, 2) of the named kind (smooth
    warps with the inverse warp's 4.0 holes, the pixel lattice as is and
    shifted by whole pixels, a 3-fold shrink about a random centre, wholly
    out of range) and a dense grad_out (F, H, W, c)."""
    rng = np.random.RandomState(seed)
    base = get_grid(H_, W_).astype(np.float32)
    tex = rng.rand(F_, H_, W_, c).astype(np.float32) * 2 - 1
    a = np.eye(2, dtype=np.float32) + rng.uniform(-0.1, 0.1, (F_, 2, 2))
    grid = np.einsum("hwc,fcd->fhwd", base, a) + rng.uniform(-0.3, 0.3, (F_, 1, 1, 2))
    if name == "smooth":
        grid[rng.rand(*grid.shape[:-1]) < 0.05] = 4.0
    elif name == "lattice":
        grid = np.broadcast_to(base, grid.shape).copy()
    elif name == "lattice_shift":
        grid = base + rng.randint(-5, 6, (F_, 1, 1, 2)) * np.array([2.0 / W_, 2.0 / H_])
    elif name == "zoom":
        grid = base * 3.0 + rng.uniform(-0.5, 0.5, (F_, 1, 1, 2))
    elif name == "out_of_range":
        grid = grid + 3.0
    gout = rng.randn(F_, H_, W_, c).astype(np.float32)
    return tex, np.ascontiguousarray(grid, np.float32), gout


def _close_rel(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_REL * float(np.abs(want).max()), err


def _plain_grads(tex, grid, gout, tp=1):
    t, g = tex.clone().requires_grad_(), grid.clone().requires_grad_()
    out = grid_sample(t, g) if tp == 1 else grid_sample_ctx_plain(t, g, tp)
    out.backward(gout)
    return t.grad, g.grad


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_takes_a_channel_slice(case):
    """A grad_out that is channels [0, C) of a (C+1)-channel tensor (the
    Warper's ``cat`` of the sampled frames and the fusion score) gives the
    gradients its contiguous copy gives, and both agree with the JAX VJPs."""
    tex, grid, gout = _case(case)
    wide = torch.zeros(F_, H_, W_, C_ + 1)
    wide[..., :C_] = torch.from_numpy(gout)
    sliced = wide[..., :C_]
    assert not sliced.is_contiguous() and sliced.stride()[-2] == C_ + 1
    t, g = torch.from_numpy(tex), torch.from_numpy(grid)
    g_img, g_grid = _plain_grads(t, g, sliced)
    c_img, c_grid = _plain_grads(t, g, sliced.contiguous())
    assert torch.equal(g_img, c_img) and torch.equal(g_grid, c_grid)
    if case in ON_LATTICE:
        _, vjp = jax.vjp(jgs.grid_sample_ref, jnp.asarray(tex), jnp.asarray(grid))
        w_img, w_grid = vjp(jnp.asarray(gout))
    else:
        w_img, w_grid = jgs._pallas_bwd("float32", (jnp.asarray(tex), jnp.asarray(grid)),
                                        jnp.asarray(gout))
    np.testing.assert_allclose(g_img.numpy(), np.asarray(w_img), atol=ATOL, rtol=RTOL)
    _close_rel(g_grid.numpy(), w_grid)
    if case == "out_of_range":
        assert not g_grid.any() and not g_img.any()
    else:
        assert g_grid.abs().max() > 0


def test_plain_backward_with_tp_sz_matches_jax():
    """With tp_sz 3 (grid row i samples texture i // 3) the plain backward
    sums the texture's gradient over its rows, as JAX's VJP of the sample
    of the repeated texture does."""
    tex, grid, gout = _case("smooth", seed=1)
    tex = tex[:1]  # one texture for the three grid rows
    g_img, g_grid = _plain_grads(*(torch.from_numpy(a) for a in (tex, grid, gout)), tp=F_)
    w_img, w_grid = jgs._pallas_bwd("float32", (jnp.repeat(jnp.asarray(tex), F_, axis=0),
                                                jnp.asarray(grid)), jnp.asarray(gout))
    w_img = np.asarray(w_img).sum(axis=0, keepdims=True)
    np.testing.assert_allclose(g_img.numpy(), w_img, atol=ATOL, rtol=RTOL)
    _close_rel(g_grid.numpy(), w_grid)


def _tile(ty, tx):
    return (slice(ty * BWD_TILE, (ty + 1) * BWD_TILE), slice(tx * BWD_TILE, (tx + 1) * BWD_TILE))


def _taps(grid, h, w):
    """Top-left taps (x0, y0), fractions and the validity of each tap, with
    the kernels' step-rounded arithmetic."""
    def one(g, size):
        i = ((g + 1.0) * (size * 0.5) - 0.5).clamp(-2.0, size + 1.0)
        i0 = torch.floor(i)
        return i0.long(), i - i0

    x0, tx = one(grid[..., 0], w)
    y0, ty = one(grid[..., 1], h)
    vx = [(x0 >= 0) & (x0 < w), (x0 + 1 >= 0) & (x0 + 1 < w)]
    vy = [(y0 >= 0) & (y0 < h), (y0 + 1 >= 0) & (y0 + 1 < h)]
    return x0, y0, tx, ty, vx, vy


@pytest.mark.parametrize("case", CASES)
def test_windows_hold_every_tap_they_serve(case):
    """Each tile's window is the box of its valid taps, the stride pads a
    row to 16 mod 32 floats, and a window is staged exactly where it fits
    the kernel's cap."""
    _, grid, _ = _case(case)
    g = torch.from_numpy(grid)
    win = shared_bwd_windows(g, H_, W_, C_)
    assert win.shape == (F_, -(-H_ // BWD_TILE), -(-W_ // BWD_TILE), 6)
    x0, y0, _, _, vx, vy = _taps(g, H_, W_)
    for f, ty, tx in np.ndindex(*win.shape[:3]):
        sl = (f,) + _tile(ty, tx)
        xs = [x0[sl][vx[k][sl] & (vy[0][sl] | vy[1][sl])] + k for k in (0, 1)]
        ys = [y0[sl][vy[k][sl] & (vx[0][sl] | vx[1][sl])] + k for k in (0, 1)]
        xlo, xhi, ylo, yhi, stride, staged = win[f, ty, tx].tolist()
        xs, ys = torch.cat(xs), torch.cat(ys)
        if xs.numel() == 0:
            assert (xlo, xhi, ylo, yhi) == (W_, -1, H_, -1)
        else:
            assert (xlo, xhi, ylo, yhi) == (xs.min().item(), xs.max().item(), ys.min().item(),
                                            ys.max().item())
        row = max(xhi - xlo + 1, 0) * min(C_, BWD_MAX_C)
        assert stride >= row and stride % 32 == 16 and stride - row < 32
        assert staged == int(max(yhi - ylo + 1, 0) * stride <= BWD_WINDOW_CAP)
    if case == "out_of_range":
        assert (win[..., 1] == -1).all()
    if case == "zoom":  # a 3-fold shrink reaches past the cap somewhere
        assert (win[..., 5] == 0).any()


def _window_gather_grad_grid(tex, grid, gout):
    """grad_grid by the kernel's arithmetic: per tile, each pixel's taps
    gathered from the window as the kernel lays it out (rows of the
    window's stride, texel (y, x) channel c at (y - y_lo) * stride + (x -
    x_lo) * C + c) where it is staged, else from the texture, and the sums
    sx0 = sum_c g (v1 - v0) and so on combined as the kernel combines them."""
    f, h, w, c = tex.shape
    win = shared_bwd_windows(grid, h, w, c)
    x0, y0, tx, ty, vx, vy = _taps(grid, h, w)
    out = torch.zeros_like(grid)
    flat = tex.reshape(f, -1)
    for n, tyi, txi in np.ndindex(*win.shape[:3]):
        sl = _tile(tyi, txi)
        xlo, xhi, ylo, yhi, stride, staged = win[n, tyi, txi].tolist()
        px0, py0 = x0[n][sl].reshape(-1), y0[n][sl].reshape(-1)
        ok = [(vy[j][n][sl] & vx[i][n][sl]).reshape(-1) for j in (0, 1) for i in (0, 1)]
        ch = torch.arange(c)
        if staged and xhi >= xlo:
            rows = torch.arange(ylo, yhi + 1)[:, None] * (w * c) + xlo * c + torch.arange(
                (xhi - xlo + 1) * c)
            window = torch.zeros((yhi - ylo + 1) * stride)
            window.view(yhi - ylo + 1, stride)[:, :rows.shape[1]] = flat[n][rows]
            src, base, xs, rs = window, (py0 - ylo) * stride + (px0 - xlo) * c, c, stride
        else:
            src, base, xs, rs = flat[n], (py0 * w + px0) * c, c, w * c
        v = []
        for k, off in enumerate((0, xs, rs, rs + xs)):
            idx = torch.where(ok[k], base + off, 0)[:, None] + ch
            v.append(torch.where(ok[k][:, None], src[idx], 0.0))
        g = gout[n][sl].reshape(-1, c)
        sx0, sx1 = (g * (v[1] - v[0])).sum(1), (g * (v[3] - v[2])).sum(1)
        sy0, sy1 = (g * (v[2] - v[0])).sum(1), (g * (v[3] - v[1])).sum(1)
        tyv, txv = ty[n][sl].reshape(-1), tx[n][sl].reshape(-1)
        d = torch.stack([(sx0 + tyv * (sx1 - sx0)) * (w * 0.5),
                         (sy0 + txv * (sy1 - sy0)) * (h * 0.5)], dim=-1)
        out[n][sl] = d.reshape(out[n][sl].shape)
    return out


@pytest.mark.parametrize("case", CASES)
def test_window_gather_gives_the_plain_grad_grid(case):
    tex, grid, gout = (torch.from_numpy(a) for a in _case(case, seed=2))
    got = _window_gather_grad_grid(tex, grid, gout)
    _, want = _plain_grads(tex, grid, gout)
    _close_rel(got.numpy(), want.numpy())


def test_backward_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel's wrapper silently: it raises."""
    from waldo_tpu_torch.ops.kernels import grid_sample_bwd_cuda

    with pytest.raises(ValueError, match="CUDA"):
        grid_sample_bwd_cuda(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 2),
                             torch.zeros(1, 8, 8, 3), 1, False)

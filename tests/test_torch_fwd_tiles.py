"""The shared-grid forward kernel's schedule (K2, csrc/grid_sample.cu), on the CPU.

With more than FWD_FEW_C channels the kernel gives each 16 x 8 tile of
output pixels of one grid row a block, in tile-major order with the tp_sz
grid rows of one texture's tile side by side (``fwd_block``). A warp holds
two of the tile's rows; runs of consecutive warps (bands) stage the texture
window their valid taps reach, each window within ``fwd_window_cap``
elements, and a band of one warp over the cap reads its texels from the
texture (``shared_fwd_windows`` models the windows in plain PyTorch). With
at most FWD_FEW_C channels a thread takes a pixel and reads the taps that
lie on the texture straight from it. Here each window holds the taps it
serves, gathering by the kernel's index arithmetic (through the windows, or
from the texture for few channels) equals ``grid_sample_ctx_plain``, and
both equal ``grid_sample_pallas(..., interpret=True, tp_sz=...)``. The CUDA
kernel itself runs only on the card (``chip_smoke.py``: ``k2_edge_checks``
and the K2 rows). Tolerances: the
gather against the plain version 1e-5 in float32 (both sum four float32
products, in other orders) and 2^-7 for bf16 outputs (both round one
float32 sum to bf16, which may land one bf16 step apart); against the Pallas
kernel the repo's sampler tolerance, atol 2e-5 / rtol 1e-4.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from waldo_tpu.ops.pallas.grid_sample import grid_sample_pallas

from waldo_tpu_torch.ops import get_grid
from waldo_tpu_torch.ops.grid_sample import (FWD_FEW_C, FWD_TILE_H, FWD_TILE_W, FWD_WARPS,
                                             _wants_grad, fwd_block, fwd_window_cap,
                                             grid_sample_ctx, grid_sample_ctx_plain,
                                             shared_fwd_windows)

TOL_F32, TOL_BF16 = 1e-5, 2 ** -7
# name: textures F x H x W x C, tp_sz, output Ho x Wo, grid kind, texture dtype
CASES = {
    "c1_tp3": (2, 37, 52, 1, 3, 29, 45, "smooth", torch.float32),
    "c3_unaligned_rows": (2, 37, 53, 3, 1, 40, 37, "smooth", torch.float32),
    "c23_tp1": (3, 40, 48, 23, 1, 45, 61, "smooth", torch.float32),
    "c23_tp3": (2, 31, 44, 23, 3, 19, 70, "smooth", torch.float32),
    "c32_tp3": (2, 33, 64, 32, 3, 37, 29, "smooth", torch.float32),
    "shrink1.5_bands": (1, 64, 96, 23, 3, 64, 96, "shrink1.5", torch.float32),
    "shrink6_over_cap": (1, 200, 256, 23, 1, 33, 40, "shrink6", torch.float32),
    "out_of_range": (2, 37, 52, 23, 3, 20, 30, "out_of_range", torch.float32),
    "bf16_c23": (2, 37, 52, 23, 3, 29, 45, "smooth", torch.bfloat16),
    "bf16_shrink3_bands": (1, 64, 96, 23, 1, 64, 96, "shrink3", torch.bfloat16),
}


def _case(name, seed=0):
    """Texture (F, H, W, C) in [-1, 1) and grid (F*tp, Ho, Wo, 2): smooth
    random affine warps with 5 % of the pixels at the inverse warp's hole
    value 4.0, a shrink about the centre by the named factor, or smooth
    warps moved wholly out of range."""
    f, h, w, c, tp, ho, wo, kind, dtype = CASES[name]
    rng = np.random.RandomState(seed)
    tex = torch.from_numpy(rng.rand(f, h, w, c).astype(np.float32) * 2 - 1).to(dtype)
    base = get_grid(ho, wo).astype(np.float32)
    if kind.startswith("shrink"):
        grid = np.broadcast_to(base * float(kind[6:]), (f * tp, ho, wo, 2)).copy()
    else:
        a = np.eye(2, dtype=np.float32) + rng.uniform(-0.1, 0.1, (f * tp, 2, 2))
        grid = np.einsum("hwc,ncd->nhwd", base, a) + rng.uniform(-0.3, 0.3, (f * tp, 1, 1, 2))
        grid[rng.rand(*grid.shape[:-1]) < 0.05] = 4.0
        if kind == "out_of_range":
            grid += 3.0
    return tex, torch.from_numpy(np.ascontiguousarray(grid, np.float32)), tp


def _taps(grid, h, w):
    """Top-left taps (x0, y0), fractions and each tap's validity, with the
    kernels' step-rounded arithmetic (csrc/bilinear.cuh: top_left_tap)."""
    def one(g, size):
        i = ((g + 1.0) * (size * 0.5) - 0.5).clamp(-2.0, size + 1.0)
        i0 = torch.floor(i)
        return i0.long(), i - i0

    x0, tx = one(grid[..., 0], w)
    y0, ty = one(grid[..., 1], h)
    vx = [(x0 >= 0) & (x0 < w), (x0 + 1 >= 0) & (x0 + 1 < w)]
    vy = [(y0 >= 0) & (y0 < h), (y0 + 1 >= 0) & (y0 + 1 < h)]
    return x0, y0, tx, ty, vx, vy


def _vec(w, c, itemsize):
    return 16 // itemsize if (w * c * itemsize) % 16 == 0 else 1


def _stride(width, c, vec):
    n = width * c + vec - 1
    return n + (16 - n) % 32


def _bands(win, n, ti, tj):
    """The tile's bands: (first warp, last warp + 1, the band's row of win)."""
    starts = win[n, ti, tj, :, 4].tolist()
    out = []
    for k, s in enumerate(starts):
        if s == k:
            end = k + 1
            while end < FWD_WARPS and starts[end] == k:
                end += 1
            out.append((k, end, win[n, ti, tj, k].tolist()))
    return out


def _tap_box(x0, y0, vx, vy, n, rows, cols):
    """The box (x_lo, x_hi, y_lo, y_hi) of the valid taps of these pixels,
    or None where none is valid."""
    xs = [x0[n, rows, cols][vx[k][n, rows, cols] & (vy[0][n, rows, cols] | vy[1][n, rows, cols])]
          + k for k in (0, 1)]
    ys = [y0[n, rows, cols][vy[k][n, rows, cols] & (vx[0][n, rows, cols] | vx[1][n, rows, cols])]
          + k for k in (0, 1)]
    xs, ys = torch.cat(xs), torch.cat(ys)
    if xs.numel() == 0:
        return None
    return xs.min().item(), xs.max().item(), ys.min().item(), ys.max().item()


def _rows_cols(ti, tj, k0, k1, ho, wo):
    return (slice(ti * FWD_TILE_H + 2 * k0, min(ti * FWD_TILE_H + 2 * k1, ho)),
            slice(tj * FWD_TILE_W, min((tj + 1) * FWD_TILE_W, wo)))


@pytest.mark.parametrize("name", [k for k, v in CASES.items() if v[3] > FWD_FEW_C])
def test_windows_hold_every_tap_they_serve(name):
    """Each band's window is the box of its warps' valid taps, rows of a
    stride padded to 16 mod 32; the band is staged exactly where it fits
    the cap, and it stops where the next warp's taps would take it past
    the cap; warps with no output pixel belong to no band."""
    tex, grid, tp = _case(name)
    f, h, w, c = tex.shape
    ho, wo = grid.shape[1:3]
    es = tex.element_size()
    vec, cap = _vec(w, c, es), fwd_window_cap(es)
    win = shared_fwd_windows(grid, h, w, c, es)
    assert win.shape == (f * tp, -(-ho // FWD_TILE_H), -(-wo // FWD_TILE_W), FWD_WARPS, 7)
    x0, y0, _, _, vx, vy = _taps(grid, h, w)

    def elems(box):
        return 0 if box is None else (box[3] - box[2] + 1) * _stride(box[1] - box[0] + 1, c, vec)

    for n, ti, tj in np.ndindex(*win.shape[:3]):
        live_warps = (min(FWD_TILE_H, ho - ti * FWD_TILE_H) + 1) // 2
        assert (win[n, ti, tj, live_warps:, 4] == -1).all()
        bands = _bands(win, n, ti, tj)
        assert bands[0][0] == 0 and bands[-1][1] == live_warps
        for (k0, k1, (xlo, xhi, ylo, yhi, _, stride, staged)), nxt in zip(
                bands, bands[1:] + [None]):
            box = _tap_box(x0, y0, vx, vy, n, *_rows_cols(ti, tj, k0, k1, ho, wo))
            assert (xlo, xhi, ylo, yhi) == (box or (w, -1, h, -1))
            assert stride == (0 if box is None else _stride(xhi - xlo + 1, c, vec))
            assert staged == int(elems(box) <= cap)
            if nxt is not None:  # the next warp would not have fit
                more = _tap_box(x0, y0, vx, vy, n, *_rows_cols(ti, tj, k0, nxt[0] + 1, ho, wo))
                assert elems(more) > cap
    starts = win[..., 4]
    n_bands = int((starts == torch.arange(FWD_WARPS)).sum())
    if "bands" in name:  # tiles whose whole window passes the cap are split
        assert n_bands > win.shape[0] * win.shape[1] * win.shape[2]
    if name == "shrink6_over_cap":  # and bands of one warp past it read the texture
        assert ((starts >= 0) & (win[..., 6] == 0)).any()
    if name == "out_of_range":
        assert (win[..., 1] == -1).all()


def _kernel_gather(tex, grid, tp):
    """The forward by the kernel's arithmetic. With at most FWD_FEW_C
    channels each pixel's taps that lie on the texture, read from it; else,
    for each band, the window
    staged as the kernel lays it out (rows of the band's stride, texel (y,
    x) channel c at (y - y_lo) * stride + (x - x_lo) * C + c + sh, sh the
    offset of the window's first element in its 16-byte vector where rows
    are copied by vectors), each pixel's taps clamped into the window (a
    tap off the texture carries weight 0) or, for a band over the cap, into
    the texture; the four products summed in tap order in float32 and
    stored in the texture's type."""
    f, h, w, c = tex.shape
    rows_n, ho, wo = grid.shape[:3]
    es = tex.element_size()
    vec = _vec(w, c, es)
    win = shared_fwd_windows(grid, h, w, c, es)
    x0, y0, tx, ty, vx, vy = _taps(grid, h, w)
    wt = [torch.where(vy[j] & vx[i], (tx if i else 1 - tx) * (ty if j else 1 - ty), 0.0)
          for j in (0, 1) for i in (0, 1)]
    flat = tex.float().reshape(f, -1)
    ch = torch.arange(c)
    if c <= FWD_FEW_C:
        acc = torch.zeros(rows_n, ho, wo, c)
        src = flat[torch.arange(rows_n) // tp]
        for k, (j, i) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            on = vy[j] & vx[i]
            idx = torch.where(on, ((y0 + j) * w + x0 + i) * c, 0)
            val = torch.gather(src, 1, (idx.reshape(rows_n, -1, 1) + ch).reshape(rows_n, -1))
            acc = acc + torch.where(on[..., None], wt[k][..., None] * val.reshape(acc.shape), 0.0)
        return acc.to(tex.dtype)
    out = torch.full((rows_n, ho, wo, c), float("nan"))
    for n, ti, tj in np.ndindex(*win.shape[:3]):
        t = n // tp
        for k0, k1, (xlo, xhi, ylo, yhi, _, rs, staged) in _bands(win, n, ti, tj):
            rows, cols = _rows_cols(ti, tj, k0, k1, ho, wo)
            px, py = x0[n, rows, cols].reshape(-1), y0[n, rows, cols].reshape(-1)
            if xlo > xhi:  # no tap of the band lies on the texture
                out[n, rows, cols] = 0.0
                continue
            if staged:
                sh = ((ylo * w + xlo) * c) % vec
                window = torch.full(((yhi - ylo + 1) * rs,), float("nan"))
                for r in range(yhi - ylo + 1):
                    e0 = ((ylo + r) * w + xlo) * c
                    window[r * rs + sh: r * rs + sh + (xhi - xlo + 1) * c] = \
                        flat[t, e0: e0 + (xhi - xlo + 1) * c]
                cx = [px.clamp(xlo, xhi) - xlo, (px + 1).clamp(xlo, xhi) - xlo]
                cy = [py.clamp(ylo, yhi) - ylo, (py + 1).clamp(ylo, yhi) - ylo]
                src, offs = window, [cy[j] * rs + cx[i] * c + sh for j in (0, 1) for i in (0, 1)]
            else:
                cx = [px.clamp(0, w - 1), (px + 1).clamp(0, w - 1)]
                cy = [py.clamp(0, h - 1), (py + 1).clamp(0, h - 1)]
                src, offs = flat[t], [(cy[j] * w + cx[i]) * c for j in (0, 1) for i in (0, 1)]
            acc = torch.zeros(px.numel(), c)
            for k in range(4):
                acc = acc + wt[k][n, rows, cols].reshape(-1, 1) * src[offs[k][:, None] + ch]
            out[n, rows, cols] = acc.reshape(out[n, rows, cols].shape)
    return out.to(tex.dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_gather_equals_the_plain_version(name):
    tex, grid, tp = _case(name, seed=1)
    got = _kernel_gather(tex, grid, tp)
    want = grid_sample_ctx_plain(tex, grid, tp)
    assert got.dtype == tex.dtype and bool(torch.isfinite(got).all())
    tol = TOL_F32 if tex.dtype == torch.float32 else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=0)


def test_kernel_gather_equals_pallas():
    """The gather and the port's tp_sz sampler against the JAX package's
    Pallas kernel (interpret mode) with the same tp_sz mapping, on smooth
    warps with holes."""
    tex, grid, tp = _case("c23_tp3", seed=2)
    want = np.asarray(grid_sample_pallas(jnp.asarray(tex.numpy()), jnp.asarray(grid.numpy()),
                                         interpret=True, tp_sz=tp))
    for got in (_kernel_gather(tex, grid, tp), grid_sample_ctx(tex, grid, tp_sz=tp)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rows,tp,tiles_y,tiles_x", [(6, 3, 2, 5), (4, 1, 3, 2), (56, 14, 2, 3)])
def test_block_order_is_tile_major(rows, tp, tiles_y, tiles_x):
    """Every (grid row, tile) has exactly one block, and the tp_sz grid rows
    that read one texture's tile are consecutive blocks."""
    order = [fwd_block(b, tp, tiles_y, tiles_x) for b in range(rows * tiles_y * tiles_x)]
    assert sorted(order) == [(n, y, x) for n in range(rows) for y in range(tiles_y)
                             for x in range(tiles_x)]
    for b0 in range(0, len(order), tp):
        group = order[b0:b0 + tp]
        assert [n % tp for n, _, _ in group] == list(range(tp))
        assert len({(n // tp, y, x) for n, y, x in group}) == 1


def test_lean_launch_keeps_autograd_where_a_gradient_is_wanted():
    """On the card a sample skips the autograd function unless autograd has
    to record it (``_wants_grad``); on the CPU the plain route records the
    sample whenever a gradient is wanted, and its gradient reaches the grid."""
    tex, grid, tp = _case("c23_tp3")
    assert not _wants_grad(tex, grid)
    g = grid.clone().requires_grad_()
    assert _wants_grad(tex, g)
    with torch.no_grad():
        assert not _wants_grad(tex, g)
        assert grid_sample_ctx(tex, g, tp_sz=tp).grad_fn is None
    with torch.inference_mode():
        assert not _wants_grad(tex, g)
    out = grid_sample_ctx(tex, g, tp_sz=tp)
    assert out.grad_fn is not None
    (gg,) = torch.autograd.grad(out.sum(), g)
    assert bool(torch.isfinite(gg).all()) and float(gg.abs().max()) > 0


def test_forward_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel's wrapper silently: it raises."""
    from waldo_tpu_torch.ops.kernels import grid_sample_cuda

    with pytest.raises(ValueError, match="CUDA"):
        grid_sample_cuda(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 2), 1)

"""The samplers' pre-pass and sparsity skip, on the CPU.

``plane_boxes_plain`` (planes and nonzero boxes) is held to a numpy
computation, and ``tap_footprint_skips``, the plain mirror of the kernels'
skip test, to the JAX package: every (row, layer, pixel) it marks as
skippable must sample exactly 0.0 in the JAX references. The CUDA kernels
themselves are checked against these plain versions on the card
(chip_smoke.py phase 3).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from waldo_tpu.ops.grid_sample import _warp_alpha_ctx_ref, grid_sample_ref

from waldo_tpu_torch.ops.grid_sample import plane_boxes_plain, tap_footprint_skips
from waldo_tpu_torch.ops.kernels import plane_boxes_cuda


def _np_boxes(tex):
    """(F, H, W, C) -> (F, C, 4) inclusive nonzero boxes, by loops."""
    f, h, w, c = tex.shape
    out = np.zeros((f, c, 4), np.int32)
    for i in range(f):
        for k in range(c):
            ys, xs = np.nonzero(tex[i, :, :, k] != 0)
            out[i, k] = (ys.min(), ys.max(), xs.min(), xs.max()) if ys.size else (h, -1, w, -1)
    return out


def _sparse_planes(rng, f, h, w, c):
    """Planes that are empty, single-texel, border-touching, NaN-holding,
    -0.0-holding and dense, one kind per layer, cycling."""
    tex = np.zeros((f, h, w, c), np.float32)
    for i in range(f):
        for k in range(c):
            kind = (i + k) % 6
            if kind == 1:
                tex[i, rng.randint(h), rng.randint(w), k] = rng.rand() + 0.5
            elif kind == 2:  # one side of the plane per frame
                side = (i + k // 6) % 4
                ys = slice(0, 3) if side == 0 else slice(h - 3, h) if side == 1 else slice(2, h - 2)
                xs = slice(0, 2) if side == 2 else slice(w - 2, w) if side == 3 else slice(3, w - 3)
                tex[i, ys, xs, k] = rng.rand(*tex[i, ys, xs, k].shape) + 0.1
            elif kind == 3:
                tex[i, 2, 3, k] = np.nan
                tex[i, h - 2, w - 1, k] = -0.0
            elif kind == 4:
                tex[i, :, :, k] = rng.rand(h, w)
            elif kind == 5:  # a quad somewhere inside
                y, x = rng.randint(h - 4), rng.randint(w - 5)
                tex[i, y:y + 4, x:x + 5, k] = rng.rand(4, 5) - 0.5
    return tex


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 9, 13, 6), (2, 16, 40, 17), (1, 5, 7, 32)])
def test_plane_boxes_plain_matches_numpy(shape, dtype):
    rng = np.random.RandomState(sum(shape))
    tex = _sparse_planes(rng, *shape)
    t = torch.from_numpy(tex).to(dtype)
    planes, boxes = plane_boxes_plain(t)
    assert planes.dtype == dtype and boxes.dtype == torch.int32
    assert tuple(planes.shape) == (shape[0], shape[3], shape[1], shape[2])
    np.testing.assert_array_equal(planes.float().numpy(),
                                  np.moveaxis(t.float().numpy(), -1, 1))
    np.testing.assert_array_equal(boxes.numpy(), _np_boxes(t.float().numpy()))


def test_plane_boxes_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        plane_boxes_cuda(torch.zeros(1, 4, 4, 3))


def _skip_case(rng, f, h, w, c, rows_per_frame, gh, gw):
    """Object-sparse planes (layer 0 dense, the others one small quad, one
    empty, one single texel) and per-layer grids around and beyond the
    plane, with the inverse warp's 4.0 holes and one layer wholly out of
    range."""
    tex = np.zeros((f, h, w, c), np.float32)
    tex[..., 0] = rng.rand(f, h, w)
    for k in range(1, c):
        y, x = rng.randint(h - 6), rng.randint(w - 8)
        tex[:, y:y + 6, x:x + 8, k] = rng.rand(f, 6, 8) + 0.05
    tex[:, :, :, c - 1] = 0.0
    if c > 2:
        tex[:, :, :, c - 2] = 0.0
        tex[:, h // 2, w // 3, c - 2] = 0.7
    n = f * rows_per_frame
    grids = (rng.rand(n, c, gh, gw, 2) * 2.6 - 1.3).astype(np.float32)
    grids[:, :, :2, :5] = 4.0
    grids[0, 1] += 5.0
    return tex, grids


@pytest.mark.parametrize("f,h,w,c,tp,gh,gw", [(2, 20, 36, 5, 2, 24, 40),
                                              (1, 16, 64, 17, 3, 16, 64)])
def test_skipped_samples_are_zero_in_the_jax_reference(f, h, w, c, tp, gh, gw):
    rng = np.random.RandomState(c)
    tex, grids = _skip_case(rng, f, h, w, c, tp, gh, gw)
    n = f * tp
    _, boxes = plane_boxes_plain(torch.from_numpy(tex))
    rows = torch.arange(n) // tp
    skip = tap_footprint_skips(torch.from_numpy(grids), boxes[rows], h, w).numpy()
    # the JAX sampler on every layer plane: channels folded into the batch
    planes = np.repeat(np.moveaxis(tex, -1, 1), tp, axis=0).reshape(n * c, h, w, 1)
    want = np.asarray(grid_sample_ref(jnp.asarray(planes),
                                      jnp.asarray(grids.reshape(n * c, gh, gw, 2))))
    want = want.reshape(n, c, gh, gw)
    assert 0.3 < skip.mean() < 1.0, skip.mean()
    assert (want[skip] == 0.0).all(), np.abs(want[skip]).max()
    assert (want[~skip] != 0.0).any()
    # the fused warp's reference: a skipped layer's occluded alpha is 0 too
    occ = rng.rand(n, c, c).astype(np.float32)
    a_occ = np.asarray(_warp_alpha_ctx_ref(jnp.asarray(tex), jnp.asarray(grids),
                                           jnp.asarray(occ), None, tp_sz=tp, tcp=tp,
                                           precision="float32")[0])
    assert (np.moveaxis(a_occ, -1, 1)[skip] == 0.0).all()


def test_footprint_touching_the_box_by_one_texel_is_not_skipped():
    """A plane whose only nonzero texel is reached by exactly one tap of a
    sample: the footprint touches the box, so the sample is kept, and it is
    nonzero in the JAX reference; the neighbouring samples one texel further
    out are skipped and zero."""
    h, w = 8, 10
    tex = np.zeros((1, h, w, 1), np.float32)
    tex[0, 4, 6, 0] = 1.0
    _, boxes = plane_boxes_plain(torch.from_numpy(tex))
    # pixel-space points: (x, y) = (5.5, 3.5) reaches (6, 4) with its
    # bottom-right tap only; (4.5, 3.5) and (5.5, 2.5) miss it
    pts = np.array([[5.5, 3.5], [4.5, 3.5], [5.5, 2.5], [6.5, 4.5]], np.float32)
    g = np.stack([(pts[:, 0] + 0.5) / (w * 0.5) - 1.0, (pts[:, 1] + 0.5) / (h * 0.5) - 1.0], -1)
    grids = g.reshape(1, 1, 1, 4, 2).astype(np.float32)
    skip = tap_footprint_skips(torch.from_numpy(grids), boxes, h, w).numpy()[0, 0, 0]
    want = np.asarray(grid_sample_ref(jnp.asarray(tex), jnp.asarray(grids[:, 0])))[0, 0, :, 0]
    assert skip.tolist() == [False, True, True, False]
    assert want[0] > 0.0 and want[1] == 0.0 and want[2] == 0.0 and want[3] > 0.0

"""The ops of the LVD training path, the port against the JAX package, on
the CPU: the losses' gaussian blur and flow-edge filters, the scatter grid
inversion (value and VJP), the samplers' backward (the plain versions,
which the card's backward kernels are held to) and the Warper's unfused
training branches.

Each test makes its inputs with numpy from a seed and feeds the same arrays
to both sides. Tolerances, float32: 2e-5 absolute / 1e-4 relative on
values (the repo's sampler tolerance); gradients within 1e-4 of their
largest magnitude, since a grid gradient carries the W/2 and H/2 of the
unnormalization.

The samplers' gradient with respect to the grid follows ``F.grid_sample``
(floor taps): off the pixel lattice it agrees with the TPU path's VJP
(``_pallas_bwd``, ``_pallas_mg_bwd``: the MXU formulation's VJP), on the
lattice with ``jax.vjp(grid_sample_ref)``; the MXU VJP takes another
one-sided derivative there, which one test pins.
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.ops import get_grid
from waldo_tpu.ops import image as jimage
from waldo_tpu.ops.inverse_warp import InverseWarp as JInverseWarp

from waldo_tpu_torch.ops import EdgeExtractor, InverseWarp, gaussian_blur
from waldo_tpu_torch.ops.grid_sample import (grid_sample_multigrid, grid_sample_plain,
                                             in_kernel_envelope)

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")

ATOL, RTOL = 2e-5, 1e-4
GRAD_REL = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close_rel(got, want, rel=GRAD_REL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{msg}: max|err| {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("shape,sigma,k", [((2, 3, 20, 30, 4), 2.0, 23), ((3, 16, 24, 2), 2.0, 3),
                                           ((1, 2, 12, 40, 1), 0.7, 5)])
def test_gaussian_blur_matches_jax(shape, sigma, k):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jimage.gaussian_blur(jnp.asarray(x), sigma, k)
    np.testing.assert_allclose(gaussian_blur(_t(x), sigma, k).numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [3, 15])
def test_edge_extractor_matches_jax(k):
    """Edges within the tolerance; the dominant-flow mask, a hard comparison,
    equal at every pixel at this seed."""
    f = (np.random.RandomState(1).randn(2, 3, 24, 40, 2) * 0.05).astype(np.float32)
    e_want, d_want = jimage.EdgeExtractor(k)(jnp.asarray(f))
    e_got, d_got = EdgeExtractor(k)(_t(f))
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_want), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))


def _fwd_grids(case):
    """Forward (target -> source) grids for the scatter inversion: "fold"
    squeezes a TPS-like warp so that many sources land on one destination
    (duplicates) and leaves holes; "shift" moves most points out of bounds;
    "noise" is the identity plus per-pixel noise at another resolution."""
    rng = np.random.RandomState(2)
    if case == "noise":
        g = get_grid(32, 64)[None] + rng.randn(3, 32, 64, 2).astype(np.float32) * 0.05
        return g.astype(np.float32), (32, 64, 32, 64)
    base = get_grid(16, 16)[None]
    if case == "fold":
        g = base * rng.uniform(0.3, 0.6, (4, 1, 1, 2)) + rng.randn(4, 1, 1, 2) * 0.1
        return g.astype(np.float32), (16, 16, 16, 16)
    g = base + np.array([1.3, -0.4]) + rng.randn(4, 16, 16, 2) * 0.02
    return g.astype(np.float32), (16, 16, 32, 64)


@pytest.mark.parametrize("case", ["fold", "shift", "noise"])
@pytest.mark.parametrize("erode", [True, False])
def test_scatter_inverse_warp_matches_jax(case, erode):
    """Value and VJP of the scatter inversion. The rounding of each
    displacement to a destination is a hard decision; at these seeds no
    displacement sits at a half pixel, so every pixel is held to the
    tolerance, holes (2W, 2H) and out-of-bounds writes included."""
    g, sizes = _fwd_grids(case)
    jinv = JInverseWarp(*sizes)
    want, vjp = jax.vjp(lambda x: jinv(x, erode=erode), jnp.asarray(g))
    holes = np.asarray(want)[..., 0] > 2.5
    assert (case == "noise" or holes.any()) and not holes.all(), case
    if case == "fold":  # many sources round to one destination pixel
        d = (g - get_grid(16, 16)) * 8.0
        dest = np.round(np.arange(16)[None, None, :] + d[..., 0]) + 16 * np.round(
            np.arange(16)[None, :, None] + d[..., 1])
        assert min(len(np.unique(x)) for x in dest.reshape(4, -1)) < 256 // 2
    got_in = _t(g, grad=True)
    got = InverseWarp(*sizes, device="cpu")(got_in, erode=erode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=RTOL)
    cot = np.random.RandomState(3).randn(*got.shape).astype(np.float32)
    got.backward(_t(cot))
    (want_grad,) = vjp(jnp.asarray(cot))
    _close_rel(got_in.grad, want_grad, msg=f"VJP {case}")


def _sample_inputs(seed, lattice=False, per_channel=False):
    rng = np.random.RandomState(seed)
    b, h, w, c = 2, 16, 32, 4
    img = rng.randn(b, h, w, c).astype(np.float32)
    img[1, ..., 2] = 0.0  # an all-zero plane
    lead = (b, c) if per_channel else (b,)
    if lattice:
        # texel centres shifted by whole pixels: (g + 1) * W/2 - 0.5 exact
        shift = rng.randint(-3, 4, lead + (1, 1, 2)) * np.array([2.0 / w, 2.0 / h])
        grid = (get_grid(h, w) + shift).astype(np.float32)
    else:
        grid = (rng.rand(*lead, 12, 20, 2) * 2.4 - 1.2).astype(np.float32)
    gout_shape = grid.shape[:1] + grid.shape[-3:-1] + (c,)
    return img, grid, rng.randn(*gout_shape).astype(np.float32)


def _port_grads(fn, img, grid, gout):
    ti, tg = _t(img, grad=True), _t(grid, grad=True)
    fn(ti, tg).backward(_t(gout))
    return ti.grad, tg.grad


def _folded_ref(im, gr):
    b, h, w, c = im.shape
    out = jgs.grid_sample_ref(jnp.moveaxis(im, -1, 1).reshape(b * c, h, w, 1),
                              gr.reshape((b * c,) + gr.shape[2:]))
    return jnp.moveaxis(out.reshape((b, c) + out.shape[1:-1]), 1, -1)


@pytest.mark.parametrize("per_channel", [False, True])
def test_sample_backward_off_lattice_matches_tpu_vjp(per_channel):
    """The plain backward against the VJP the JAX package attaches to the
    TPU kernel (``_pallas_bwd`` / ``_pallas_mg_bwd``, run on the CPU), off
    the pixel lattice; an all-zero plane's texture gradient included."""
    img, grid, gout = _sample_inputs(4, per_channel=per_channel)
    fn = grid_sample_multigrid if per_channel else grid_sample_plain
    g_img, g_grid = _port_grads(fn, img, grid, gout)
    bwd = jgs._pallas_mg_bwd if per_channel else jgs._pallas_bwd
    w_img, w_grid = bwd("float32", (jnp.asarray(img), jnp.asarray(grid)), jnp.asarray(gout))
    _close_rel(g_img, w_img, msg="grad_img")
    _close_rel(g_img[1, ..., 2], np.asarray(w_img)[1, ..., 2], msg="grad_img, zero plane")
    assert np.abs(np.asarray(w_img)[1, ..., 2]).max() > 0
    _close_rel(g_grid, w_grid, msg="grad_grid")


@pytest.mark.parametrize("per_channel", [False, True])
def test_sample_backward_on_lattice_matches_gather_vjp(per_channel):
    """On the pixel lattice (the per-layer grids where a layer's flow is 0)
    the plain backward takes torch's one-sided derivative, which the JAX
    gather path's VJP takes too."""
    img, grid, gout = _sample_inputs(5, lattice=True, per_channel=per_channel)
    fn = grid_sample_multigrid if per_channel else grid_sample_plain
    g_img, g_grid = _port_grads(fn, img, grid, gout)
    ref = _folded_ref if per_channel else jgs.grid_sample_ref
    _, vjp = jax.vjp(ref, jnp.asarray(img), jnp.asarray(grid))
    w_img, w_grid = vjp(jnp.asarray(gout))
    _close_rel(g_img, w_img, msg="grad_img")
    _close_rel(g_grid, w_grid, msg="grad_grid")


def test_mxu_vjp_differs_on_the_lattice():
    """Pins the JAX reference's own difference (ROADMAP.md section 3): on the
    lattice the MXU VJP's grid gradient is not the gather path's (and so not
    the port's); off it they agree (the test above)."""
    img, grid, gout = _sample_inputs(5, lattice=True)
    _, g_grid = _port_grads(grid_sample_plain, img, grid, gout)
    _, w_grid = jgs._pallas_bwd("float32", (jnp.asarray(img), jnp.asarray(grid)),
                                jnp.asarray(gout))
    diff = float(np.abs(g_grid.numpy() - np.asarray(w_grid)).max())
    assert diff > 0.1 * float(np.abs(g_grid.numpy()).max()), diff


@pytest.mark.parametrize("img_shape,grid_shape", [
    ((112, 128, 256, 23), (112, 128, 256, 2)),   # the training path's context fusion
    ((1904, 64, 64, 1), (1904, 128, 256, 2)),    # LVD training's object layers
    ((112, 128, 256, 2), (112, 128, 256, 2)),    # flow to the output frame
    ((56, 256, 512, 23), (56, 256, 512, 2)),     # the predict's fusion, tp_sz copies
    ((1, 256, 512, 3), (1, 256, 512, 2)),        # a MAT-path frame warp
    ((3, 128, 256, 16), (3, 128, 256, 2)),       # the card's small train step
    ((300, 128, 256, 23), (300, 128, 256, 2)),   # more rows than the kernel's envelope
])
def test_kernel_envelope_is_the_jax_routing(img_shape, grid_shape):
    """The generic sampler takes the batch-mode kernel on a CUDA tensor
    exactly where the JAX package routes a sample to grid_sample_pallas."""
    want = jgs.auto_impl(img_shape, grid_shape, "tpu") == "pallas"
    assert in_kernel_envelope(img_shape, grid_shape) == want


def test_samplers_refuse_a_bf16_texture_with_a_gradient():
    """The backward kernels are float32 only; the check comes before any
    device work, so it shows on the CPU through the wrapper's own rule."""
    from waldo_tpu_torch.ops.grid_sample import _require_float32

    img = torch.zeros(1, 4, 4, 2, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(TypeError):
        _require_float32(img, torch.zeros(1, 4, 4, 2), "grid_sample")
    _require_float32(img.detach(), torch.zeros(1, 4, 4, 2), "grid_sample")


@pytest.fixture(scope="module")
def warper_case():
    """A tiny warper (32x64 frames, 2 objects of 16x16, 4 frames, ctx_mode
    prev with include_self) and its inputs, for both packages."""
    from waldo_tpu.config import Config, DataConfig, ModelConfig, to_dict
    from waldo_tpu_torch.config import from_dict

    cfg = Config(dim=32, aspect_ratio=2.0,
                 data=DataConfig(num_lyt=5, vid_len=4),
                 model=ModelConfig(patch_size=8, latent_shape=(4, 8), obj_shape=(2, 2),
                                   num_obj=2, sample_precision="float32"))
    rng = np.random.RandomState(6)
    b, t, no = 2, 4, 2
    obj_pose = (get_grid(2, 2).reshape(1, 1, 1, 4, 2) * rng.uniform(0.2, 0.4, (b, t, no, 1, 1))
                + rng.randn(b, t, no, 1, 2) * 0.3 + rng.randn(b, t, no, 4, 2) * 0.02)
    bg_pose = get_grid(4, 8).reshape(1, 1, 32, 2) * 1.1 + rng.randn(b, t, 32, 2) * 0.02
    # smooth frames: a sample's error then stays near the grids' own
    yy, xx = np.mgrid[0:32, 0:64].astype(np.float32)
    fr = rng.uniform(0.05, 0.2, (b, t, 1, 1, 8, 2))
    x = np.sin(fr[..., 0] * xx[..., None] + fr[..., 1] * yy[..., None]
               + rng.uniform(0, 6.3, (b, t, 1, 1, 8))).astype(np.float32)
    occ = rng.rand(b, t, no + 1, no + 1).astype(np.float32)
    obj_alpha = np.tanh(rng.randn(b, no, 16, 16, 1) * 2).astype(np.float32)
    bg_alpha = np.ones((b, 32, 64, 1), np.float32)
    cls = rng.dirichlet(np.ones(5), (b, no)).astype(np.float32)
    ctx_ts = np.broadcast_to(np.roll(np.arange(t), 1)[None, None], (b, 1, t)).copy()
    arrays = dict(obj_pose=obj_pose.astype(np.float32), bg_pose=bg_pose.astype(np.float32), x=x,
                  occ=occ, obj_alpha=obj_alpha, bg_alpha=bg_alpha, cls=cls, ctx_ts=ctx_ts)
    return cfg, from_dict(to_dict(cfg)), arrays


@pytest.mark.parametrize("precision", ["float32", "fast"])
def test_warper_training_branches_match_jax(warper_case, precision):
    """Grids by the scatter inversion, then the unfused grid_to_flow and the
    gathered input_to_output (the training path) against the JAX Warper;
    "fast" stores the alpha maps in bf16 on both sides (2e-2 absolute, the
    predict's "fast" tolerance: one bf16 step may round differently)."""
    from waldo_tpu.models.warper import Warper as JWarper
    from waldo_tpu_torch.models.warper import Warper

    jcfg, tcfg, a = warper_case
    jcfg.model.sample_precision = tcfg.model.sample_precision = precision
    tol = 1e-4 if precision == "float32" else 2e-2
    jw, tw = JWarper(jcfg), Warper(tcfg, device="cpu")
    j = {k: jnp.asarray(v) for k, v in a.items()}
    tt = {k: torch.from_numpy(v) for k, v in a.items()}
    pred_ts = np.arange(a["x"].shape[1])

    def run(w, arr, ts):
        grids = w(arr["obj_pose"], arr["bg_pose"])
        out = w.grid_to_flow(arr["x"], grids, arr["occ"], arr["obj_alpha"], arr["bg_alpha"],
                             arr["cls"], arr["ctx_ts"], ts)
        fused, raw = w.input_to_output(arr["x"], out[3], out[0], arr["ctx_ts"])
        return (grids.src_obj, grids.src_bg) + tuple(out) + (fused, raw)

    want = run(jw, j, jnp.asarray(pred_ts))
    got = run(tw, tt, torch.from_numpy(pred_ts))
    names = ("src_obj", "src_bg", "flow", "alpha_unflt", "alpha", "alpha_ctx", "disocc",
             "fused", "raw")
    for name, g, w in zip(names, got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{name} ({precision}): max|err| {err:.3g}"

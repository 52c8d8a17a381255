"""The MAT post-processing path (``predict`` then ``inpaint_with_mat``, the
test_mat path) of the port against the JAX package's, on the CPU.

Tiny config of tests/test_torch_predict.py with the test_mat flags
(``loop_ii``, object inpainting, soft shadows, expansion, ``restrict_to_ctx``),
float32 sampling, and MAT at resolution 128 (the 64x128 frames run as three
128x128 crops). Both pipelines get the same numpy batch, the same perturbed
net parameters (``from_jax``), the same MAT weights (one ``.npz`` in the JAX
package's layout, read by both ``MatInpainter``s) and the same z sequence.
Tolerance: max|err| <= 1e-3 * max|want|; random MAT weights do not bound
the filled pixels to [-1, 1]. The chain thresholds its masks (> 0.1, > 0.9,
> 1 - 0.1); at these seeds no pixel falls on the other side of a threshold
between the two sides, so no pixel is exempt from the tolerance.

The ``propagate_obj`` case feeds both sides one ``alpha_ctx`` with a region
no layer covers (a hole whose MAT fill reaches the output), an object on the
left and one on the right border, and a seeded ``pred_flow`` as numpy: the
JAX branch writes into ``np.asarray(pred_flow + src_grid)``, which is a
read-only view when ``pred_flow`` is a JAX array.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.config import to_dict
from waldo_tpu.models import Synthesizer as JaxSynthesizer
from waldo_tpu.models.mat import Generator as JaxGenerator
from waldo_tpu.models.mat.inpainter import MatInpainter as JaxMatInpainter
from waldo_tpu.models.mat.inpainter import expand_mask as jexpand_mask
from waldo_tpu.models import mat_pipeline as jpipe
from waldo_tpu.models.warper import Warper as JaxWarper, WarpGrids as JaxWarpGrids

from waldo_tpu_torch.config import from_dict
from waldo_tpu_torch.convert import from_jax
from waldo_tpu_torch.models import Synthesizer, Warper, WarpGrids
from waldo_tpu_torch.models import mat_pipeline as tpipe
from waldo_tpu_torch.models.mat import MatInpainter, expand_mask

from test_torch_nets import perturbed_params, tiny_cfg
from test_torch_predict import tiny_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL_OPS = 1e-4
REL_CHAIN = 1e-3
MAT_RES = 128



def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _check(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max|err| {err:.3g} > {rel} * {scale:.3g}"


def mat_cfg(propagate_obj=False):
    cfg = tiny_cfg()
    m = cfg.model
    m.sample_precision = "float32"
    m.use_inpainter = m.use_mat_inpainter = True
    m.loop_ii = m.inpaint_obj = m.propagate_unique = True
    m.use_expansion = m.use_shadows = m.soft_shadow = True
    m.propagate_obj = propagate_obj
    m.restrict_to_ctx = True
    return cfg


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("helper", ["grid_to_bg_flow_from_ref_to_pred",
                                    "grid_to_bg_flow_from_ctx_to_ref",
                                    "grid_to_obj_flow_from_ref_to_pred"])
def test_warper_mat_flows_match_jax(helper):
    cfg = mat_cfg()
    rng = np.random.RandomState(0)
    b, t, no = 1, cfg.data.vid_len, cfg.model.num_obj
    ho = wo = cfg.model.obj_shape[0] * cfg.model.patch_size
    h, w = cfg.dim, int(cfg.dim * cfg.aspect_ratio)
    arrs = [(rng.rand(*s) * 2.4 - 1.2).astype(np.float32)
            for s in ((b, t, no, ho, wo, 2), (b, t, no, h, w, 2), (b, t, h, w, 2), (b, t, h, w, 2))]
    jw, tw = JaxWarper(cfg), Warper(from_dict(to_dict(cfg)), device="cpu")
    args = (cfg.model.ctx_len, -1) + ((2,) if "obj" in helper else ())
    want = getattr(jw, helper)(JaxWarpGrids(*[jnp.asarray(a) for a in arrs]), *args)
    got = getattr(tw, helper)(WarpGrids(*[_t(a) for a in arrs]), *args)
    _check(got, want, REL_OPS, helper)


def test_mask_helpers_match_jax():
    rng = np.random.RandomState(1)
    m = (rng.rand(2, 3, 17, 23, 1) > 0.9).astype(np.float32)
    np.testing.assert_array_equal(expand_mask(_t(m), 3).numpy(),
                                  np.asarray(jexpand_mask(jnp.asarray(m), 3)))
    soft = rng.rand(2, 17, 23, 1).astype(np.float32) * (rng.rand(2, 17, 23, 1) > 0.8)
    _check(tpipe.soft_expand(_t(soft), num=6),
           jpipe.soft_expand(jnp.asarray(soft), num=6), REL_OPS, "soft_expand")
    yy, xx = np.mgrid[0:20, 0:40].astype(np.float32)
    pts = np.stack([xx, yy], -1)[None] + 0.25
    corners = [(0, 3.5), (0, 15.2), (27.3, 18.0), (31.0, 2.2)]
    got = tpipe.point_in_polygon(_t(pts), corners)
    want = jpipe.point_in_polygon(jnp.asarray(pts), corners)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.2 < float(got.mean()) < 0.8


# ---------------------------------------------------------------------------
# the whole chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    cfg = mat_cfg()
    params = perturbed_params(JaxSynthesizer(cfg))
    batch = tiny_batch(cfg)
    jsyn = JaxSynthesizer(cfg)
    want = jax.jit(jsyn.predict)(jax.tree.map(jnp.asarray, params),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    tsyn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, tsyn)
    got = tsyn.predict({k: torch.from_numpy(v) for k, v in batch.items()})

    net = JaxGenerator(img_resolution=MAT_RES)
    variables = jax.jit(lambda k1, k2, *a: net.init({"params": k1, "noise": k2}, *a,
                                                    noise_mode="const"))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jnp.zeros((1, MAT_RES, MAT_RES, 3)),
        jnp.ones((1, MAT_RES, MAT_RES, 1)), jnp.zeros((1, 512)))
    path = tmp_path_factory.mktemp("mat") / "mat128.npz"
    np.savez(path, params=np.array(jax.tree.map(np.asarray, variables), dtype=object))
    jinp = JaxMatInpainter(str(path), resolution=MAT_RES)
    tinp = MatInpainter(str(path), resolution=MAT_RES, device="cpu")
    return cfg, batch, jsyn, params, want, tsyn, got, jinp, tinp


def _same_z(jinp, tinp, seed):
    zs = np.random.RandomState(seed).randn(64, 1, 512).astype(np.float32)
    jz, tz = iter(zs), iter(zs)
    jinp._next_z = lambda b: jnp.asarray(next(jz))
    tinp._next_z = lambda b: torch.from_numpy(next(tz))


def _run_both(chain, propagate_obj):
    cfg, batch, jsyn, params, want, tsyn, got, jinp, tinp = chain
    cfg = mat_cfg(propagate_obj)
    ctx = cfg.model.ctx_len
    j_args = [want[k] for k in ("pred_raw_output", "pred_alpha", "pred_alpha_ctx")]
    t_args = [got[k] for k in ("pred_raw_output", "pred_alpha", "pred_alpha_ctx")]
    j_flow, t_flow = want["pred_flow"], got["pred_flow"]
    if propagate_obj:
        # a hole, object 1 on the left border, object 2 on the right, in
        # every frame
        ac = np.array(want["pred_alpha_ctx"], np.float32)
        ac[..., 16:32, 40:64, :] = -1.0
        ac[..., 8:20, 0:6, 1] = 1.0
        ac[..., 30:44, -6:, 2] = 1.0
        j_args[2], t_args[2] = jnp.asarray(ac), _t(ac)
        flow = np.random.RandomState(3).randn(*np.shape(j_flow)).astype(np.float32) * 1e-3
        j_flow, t_flow = flow, _t(flow)
    _same_z(jinp, tinp, seed=4)
    tinp.calls = 0
    jwant = jpipe.inpaint_with_mat(
        cfg, jsyn.warper, lambda r: jsyn.wif.apply(jax.tree.map(jnp.asarray, params["ii"]), r),
        jinp, *j_args, jnp.asarray(batch["vid"]), j_flow, ctx, want["pred_grids"])
    tgot = tpipe.inpaint_with_mat(cfg, tsyn.warper, tsyn.wif, tinp, *t_args,
                                  torch.from_numpy(batch["vid"]), t_flow, ctx, got["pred_grids"])
    return jwant, tgot, tinp.calls


@pytest.mark.parametrize("propagate_obj", [False, True])
def test_inpaint_with_mat_chain_matches_jax(chain, propagate_obj):
    jwant, tgot, calls = _run_both(chain, propagate_obj)
    batch = chain[1]
    tp = batch["vid"].shape[1] - tiny_cfg().model.ctx_len
    # one reference inpaint and one per predicted frame, plus one per
    # border object completed, each as three 128x128 crops
    assert calls == 3 * (1 + tp + (2 if propagate_obj else 0))
    _check(tgot, jwant, REL_CHAIN, f"inp_pred_vid propagate_obj={propagate_obj}")
    ctx = tiny_cfg().model.ctx_len
    np.testing.assert_array_equal(tgot[:, :ctx].numpy(), batch["vid"][:, :ctx])

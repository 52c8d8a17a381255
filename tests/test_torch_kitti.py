"""The KITTI family (scripts/kitti/) at a small KITTI geometry, the port
against the JAX package, on the CPU.

The configs are the KITTI scripts' own flags through both packages'
``parse_cli``, cut to a small size (SMALL): 32 x 104 frames (aspect 3.25) on
a 4 x 13 latent grid (an odd latent width), 10 frames of which 4 are
context, 19 layout classes; test.sh's load at 64 x 208 with flows at
32 x 104. Parameters are the port's seeded init in the JAX package's layout
(``to_jax``) with every leaf perturbed by seeded numpy noise (seeded_params),
carried to the port by ``from_jax``; the evaluator restores them from the
port's slots. The data is a KITTI-format tree written by
``chip_smoke.write_kitti_tree``, the card's phase-15 writer. The JAX side
samples through its plain gather path (``set_impl("gather")``) and runs
jitted: the predict once a precision, shared with (ii) and (iv), and in (ii)
the WIF decode and the MAT inpainter's crops, resizes and blend.

At this geometry the predict is ill-conditioned at a few pixels: moving the
port's own input flow by 1e-7 of itself moves its videos by up to 0.064 on
up to 0.1 % of their elements (the fused warp's alpha edges and the layers'
flows carry a grid's last bits to whole pixels of the warped one-hot
layouts), while the nets agree with JAX to ~5e-7 and the fused warp on the
same inputs to ~4e-7. So the videos are held within the stated tolerance on
all but chip_smoke.STEEP_SHARE of their elements, each within
chip_smoke.STEEP_ATOL (check_steep).

  (i)   Synthesizer.predict at test.sh's flags: atol 1e-3 with float32
        sampling, 2e-2 with "fast" (tests/test_torch_predict.py's reasons),
        by check_steep.
  (ii)  predict + inpaint_with_mat at test_mat.sh's flags with a 128
        MatInpainter: the 64 x 208 frames take MAT's non-square path,
        resized to 128 x 256 by non-integer factors, three 128 x 128 crops
        blended with triangular weights, resized back, seven inpainter calls
        a side. Held by check_steep at 1e-3 x max|want|
        (tests/test_torch_mat_pipeline.py's chain tolerance). Both sides run
        one cheap stand-in for MAT's Generator (a Generator call at 128
        takes ~3 s a side on one CPU thread; tests/test_torch_mat.py holds
        the Generator itself), with the same z a crop.
  (iii) one LVD step at train_lvd.sh's flags (its losses, Adam) on two of
        the tree's training clips, float32 sampling, against JAX's
        ``train_step_fn`` under ``set_impl("gather")``, at
        tests/test_torch_train.py's tolerances: metrics 1e-6 + 2e-4 x |value|;
        gradients per leaf 5e-3 x max|JAX leaf| + 1e-6 x max over all
        leaves; the parameters after the step within 2e-6 on 99.9 % of the
        elements whose gradient exceeds that tolerance, and every element
        within the 2e-4 one step can move it.
  (iv)  the port's Evaluator against JAX's (on one CPU device, with (i)'s
        float32 predict, which is its own at the same model config) on the
        tree's test split, one 12-frame sequence, at test.sh's flags, float32
        sampling, without skip_first (with it the JAX package loads no KITTI
        test clip: test_kitti_test_windows_skip_first): the window, every
        dump, the metrics, at tests/test_torch_evaluator.py's tolerances, the
        videos by check_steep outside its near-hole exemption.
"""
import copy
import importlib
import os
import random

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np
import optax
import pytest
import torch

import waldo_tpu.config as jconfig
import waldo_tpu.data as jdata
import waldo_tpu.train.evaluator as jevaluator
from waldo_tpu.models import Synthesizer as JaxSynthesizer
from waldo_tpu.models import mat_pipeline as jpipe
from waldo_tpu.models.mat.inpainter import MatInpainter as JaxMatInpainter
from waldo_tpu.train import Evaluator as JaxEvaluator
from waldo_tpu.train.train_state import NetState as JNetState, make_optimizer, train_step_fn

import waldo_tpu_torch.train.evaluator as tevaluator
from waldo_tpu_torch.config import parse_cli, to_dict
from waldo_tpu_torch.convert import from_jax, to_jax
from waldo_tpu_torch.data import collate, create_dataset
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.models import mat_pipeline as tpipe
from waldo_tpu_torch.models.mat import MatInpainter
from waldo_tpu_torch.train import CheckpointManager, Evaluator, NetState
from waldo_tpu_torch.train.checkpoint import _flatten

from chip_smoke import eval_script_flags, steep_check, train_lvd_flags, write_kitti_tree
from test_torch_evaluator import KEYS, VID_TOL, capturing, near_holes
from test_torch_predict import tiny_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")

SMALL = ["--dim", "32", "--s_patch_size", "8", "--s_latent_shape", "4,13", "--s_obj_shape", "2,2",
         "--s_embed_dim", "64", "--s_num_heads", "4", "--s_num_obj", "4", "--s_oe_depth", "1",
         "--s_pe_depth", "1", "--s_pg_com_depth", "1", "--s_pg_enc_depth", "1",
         "--s_pg_dec_depth", "2", "--s_ii_depth", "2", "--s_ii_embed_dim", "32",
         "--s_edge_size", "3", "--data.num_workers", "2", "--datetime", "kitti"]
TEST_LOAD = ["--load_dim", "64", "--true_dim", "64", "--flow_dim", "32"]
ATOL = {"float32": 1e-3, "fast": 2e-2}
PREDICT_KEYS = ("rec_vid", "inp_rec_vid", "pred_vid", "inp_pred_vid", "pred_flow")
MAT_RES = 128
REL_CHAIN = 1e-3
SPREAD_CAP = 0.25  # the JAX LVD gradient's own spread, of its leaf's largest


def check_steep(got, want, atol, name):
    """chip_smoke.steep_check on numpy arrays (the module's docstring says
    why)."""
    steep_check(torch.from_numpy(np.asarray(got, np.float32)),
                torch.from_numpy(np.asarray(want, np.float32)), atol, name)


def both_cfgs(script, *extra):
    """A KITTI script's flags cut to SMALL, with ``extra``, through the JAX
    package's parse_cli and the port's (which must agree)."""
    path = f"scripts/kitti/{script}"
    flags = (train_lvd_flags(path) if "/train_" in path else eval_script_flags(path))
    flags = flags + SMALL + list(extra)
    jcfg = jconfig.parse_cli(list(flags))
    tcfg = parse_cli(list(flags))
    assert to_dict(tcfg) == jconfig.to_dict(jcfg)
    return jcfg, tcfg


def seeded_params(tcfg, seed=1, scale=0.02):
    """The port's seeded init at ``tcfg`` in the JAX package's layout, every
    leaf moved by seeded numpy noise (the init laws do not matter here, and
    the JAX package's init takes ~11 s on the CPU)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (rng.randn(*np.shape(a)) * scale).astype(np.float32),
        to_jax(Synthesizer(tcfg, device="cpu", seed=0)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames at 32 and 64 (32 x 104, 64 x 208), flows at 32: 2 training
    sequences of 20 frames (a 20-frame chunk each), one test sequence of 12
    (a 10-frame window)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    return write_kitti_tree(root, (32, 64), 32, {"train": (2, 20), "test": (1, 12)})


@pytest.fixture(scope="module")
def params():
    return seeded_params(both_cfgs("test.sh", *TEST_LOAD)[1])


@pytest.fixture
def gather():
    """The JAX samplers' plain gather path (on the CPU the default is the
    hat-matmul path, ~8x slower here)."""
    jgs.set_impl("gather")
    yield
    jgs.set_impl("auto")


def test_kitti_geometry():
    """The small configs keep KITTI's shape: aspect 3.25, an odd latent
    width, 10 frames with 4 of context, 19 layout classes, the test load
    twice the net's size."""
    for script, extra in (("test.sh", TEST_LOAD), ("test_mat.sh", TEST_LOAD),
                          ("train_lvd.sh", ()), ("train_flp.sh", ()), ("train_wif.sh", TEST_LOAD)):
        _, cfg = both_cfgs(script, *extra)
        m, d = cfg.model, cfg.data
        assert (cfg.aspect_ratio, cfg.width_size, m.latent_shape, m.ctx_len, d.num_lyt,
                d.dataset, d.load_all) == (3.25, 104, (4, 13), 4, 19, "kitti", True), script
        assert (d.load_vid_len or d.vid_len) == 10, script


@pytest.fixture(scope="module")
def predict_of(params):
    """predict_of(precision): test.sh's predict on one seeded batch, JAX's
    (jitted once a precision, under gather) and the port's, as a dict."""
    made = {}

    def get(precision):
        if precision not in made:
            jcfg, tcfg = both_cfgs("test.sh", *TEST_LOAD, "--s_sample_precision", precision)
            batch = tiny_batch(jcfg)
            jpredict = jax.jit(JaxSynthesizer(jcfg).predict)
            jgs.set_impl("gather")
            try:
                want = jpredict(jax.tree.map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
            finally:
                jgs.set_impl("auto")
            tsyn = Synthesizer(tcfg, device="cpu")
            from_jax(params, tsyn)
            got = tsyn.predict({k: torch.from_numpy(v) for k, v in batch.items()})
            made[precision] = dict(batch=batch, want=want, got=got, tsyn=tsyn,
                                   jpredict=jpredict)
        return made[precision]

    return get


@pytest.mark.parametrize("precision", ["float32", "fast"])
@pytest.mark.parametrize("key", PREDICT_KEYS)
def test_kitti_predict_matches_jax(predict_of, precision, key):
    batch, want, got = (predict_of(precision)[k] for k in ("batch", "want", "got"))
    w = np.asarray(want[key], np.float32)
    g = got[key].float().numpy()
    assert g.shape == w.shape, (key, g.shape, w.shape)
    assert g.shape[1] == (4 if key == "pred_flow" else 10) and g.shape[-2] == 208, g.shape
    assert np.isfinite(g).all()
    check_steep(g, w, ATOL[precision], f"{key} ({precision})")
    if key in ("pred_vid", "inp_pred_vid"):
        np.testing.assert_array_equal(g[:, :4], batch["vid"][:, :4])


# ---------------------------------------------------------------------------
# (ii) the MAT chain on the non-square path
# ---------------------------------------------------------------------------

# the stand-in Generator of the whole-chain test: a smooth function of the
# image, the mask and z, the same on both sides
_SA = np.random.RandomState(7).randn(3, 3).astype(np.float32) * 0.5
_SB = np.random.RandomState(8).randn(3).astype(np.float32) * 0.5
_SC = np.random.RandomState(9).randn(3).astype(np.float32) * 0.5


class StandInGenerator(torch.nn.Module):
    def forward(self, x, m, z, truncation_psi=1.0, noise_mode="const"):
        return torch.tanh(x @ torch.from_numpy(_SA) + (1 - m) * torch.from_numpy(_SB)
                          + z.mean(-1)[:, None, None, None] * torch.from_numpy(_SC))


def stand_in_jax(params, x, m, z):
    return jnp.tanh(x @ _SA + (1 - m) * _SB + z.mean(-1)[:, None, None, None] * _SC)


class JaxCrops:
    """JAX's MatInpainter at MAT_RES with the stand-in Generator on the
    non-square path, jitted: each call's three crops take the next three z
    of ``zs``, as the port's inpainter draws them."""

    def __init__(self, zs):
        inp = JaxMatInpainter.__new__(JaxMatInpainter)
        inp.res, inp.params, inp._apply = MAT_RES, None, stand_in_jax

        def call(x, mask, z, exp, is_masked):
            assert x.shape[1] != x.shape[2]
            crops = iter(z)
            inp._next_z = lambda b: next(crops)
            return JaxMatInpainter.__call__(inp, x, mask, exp, is_masked)

        self.zs, self.calls, self._call = zs, 0, jax.jit(call, static_argnums=(3, 4))

    def __call__(self, x, mask, exp=True, is_masked=True):
        self.calls += 3
        z = jnp.asarray(np.stack([next(self.zs) for _ in range(3)]))
        return self._call(x, mask, z, exp, is_masked)


def test_kitti_inpaint_with_mat_chain_matches_jax(predict_of, params, gather):
    batch, want, got, tsyn = (predict_of("float32")[k] for k in ("batch", "want", "got", "tsyn"))
    jcfg, tcfg = both_cfgs("test_mat.sh", *TEST_LOAD, "--s_sample_precision", "float32")
    zs = np.random.RandomState(4).randn(64, 1, 512).astype(np.float32)
    jinp = JaxCrops(iter(zs))
    tinp = MatInpainter(None, resolution=MAT_RES, device="cpu")
    tinp.net = StandInGenerator()
    tz = iter(zs)
    tinp._next_z = lambda b: torch.from_numpy(next(tz))
    jsyn = JaxSynthesizer(jcfg)
    jwif, pii = jax.jit(jsyn.wif.apply), jax.tree.map(jnp.asarray, params["ii"])
    keys = ("pred_raw_output", "pred_alpha", "pred_alpha_ctx")
    with pytest.MonkeyPatch.context() as mp:
        # the chain's array helpers jitted (op by op they compile ~200 ops)
        mp.setattr(jpipe, "_warp", jax.jit(jpipe._warp))
        mp.setattr(jpipe, "expand_mask", jax.jit(jpipe.expand_mask, static_argnames=("num",)))
        for name, static in (("grid_to_bg_flow_from_ref_to_pred", (1, 2)),
                             ("grid_to_bg_flow_from_ctx_to_ref", (1, 2)),
                             ("grid_to_obj_flow_from_ref_to_pred", (1, 2, 3))):
            mp.setattr(jsyn.warper, name, jax.jit(getattr(jsyn.warper, name),
                                                  static_argnums=static))
        jwant = jpipe.inpaint_with_mat(
            jcfg, jsyn.warper, lambda r: jwif(pii, r),
            jinp, *[want[k] for k in keys], jnp.asarray(batch["vid"]),
            # as numpy: the JAX propagate_obj branch writes into np.asarray of
            # pred_flow + src_grid, read-only for a JAX array (ROADMAP.md
            # section 3)
            np.array(want["pred_flow"]), 4, want["pred_grids"])
    tgot = tpipe.inpaint_with_mat(tcfg, tsyn.warper, tsyn.wif, tinp, *[got[k] for k in keys],
                                  torch.from_numpy(batch["vid"]), got["pred_flow"], 4,
                                  got["pred_grids"])
    # one reference inpaint and one per predicted frame, plus one per border
    # object completed, each as three crops
    assert tinp.calls in (3 * 7, 3 * 8, 3 * 9) and jinp.calls == tinp.calls, (tinp.calls,
                                                                             jinp.calls)
    want_np = np.asarray(jwant, np.float32)
    assert np.isfinite(tgot.numpy()).all()
    check_steep(tgot.numpy(), want_np, REL_CHAIN * float(np.abs(want_np).max()), "inp_pred_vid")
    np.testing.assert_array_equal(tgot[:, :4].numpy(), batch["vid"][:, :4])


# ---------------------------------------------------------------------------
# (iii) one LVD step
# ---------------------------------------------------------------------------

def kept_gradients():
    """An optax stage that passes the updates on unchanged and keeps them as
    its state: first in a chain, the step's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def lvd_step(tree):
    jcfg, tcfg = both_cfgs("train_lvd.sh", "--true_dim", "32", "--data.dataroot", tree,
                           "--batch_size_vid", "2", "--s_sample_precision", "float32")
    ds = create_dataset(tcfg, phase="train", rng=random.Random(3))
    assert len(ds) == 2  # a 20-frame chunk of each training sequence
    batch = {k: v for k, v in collate([ds[0], ds[1]]).items() if isinstance(v, np.ndarray)}
    assert batch["vid"].shape == (2, 10, 32, 104, 3) and batch["lyt"].shape[-1] == 19
    params = seeded_params(tcfg)

    js = JaxSynthesizer(jcfg)
    loss_fn = lambda p, b, r, i: js.extract_object_loss(p, b, r, i)
    lam = jcfg.model.lambda_ent_flt_edge

    def step_and_grads(state, b, r, i):
        """The step, its gradients (which the kept_gradients stage of the
        optimizer holds) and the gradients of all losses but
        ent_flt_edge."""
        def rest(p):
            loss, metrics = loss_fn(p, b, r, i)
            return loss - lam * metrics["ent_flt_edge"]

        new, metrics = train_step_fn(loss_fn)(state, b, r, i)
        return new, metrics, new.opt_state[0], jax.grad(rest)(state.params)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flat = lambda tree: _flatten(jax.tree.map(np.asarray, tree))
    jgs.set_impl("gather")
    try:
        state = JNetState.create(jax.tree.map(jnp.asarray, params["pe"]),
                                 optax.chain(kept_gradients(), make_optimizer(jcfg.model)))
        jstep = jax.jit(step_and_grads)
        new, jm, jg, jrest = jstep(state, jbatch, jax.random.PRNGKey(1), jnp.float32(0))
        jg, jrest = flat(jg), flat(jrest)
        # the reference's own spread: its gradient with the input flow moved
        # by 1e-7, 1e-6 and 1e-5 of itself
        spread = {k: np.zeros_like(v) for k, v in jg.items()}
        for eps in (1e-7, 1e-6, 1e-5):
            moved = flat(jstep(state, dict(jbatch, flow=jbatch["flow"] * np.float32(1 + eps)),
                               jax.random.PRNGKey(1), jnp.float32(0))[2])
            spread = {k: np.maximum(v, np.abs(moved[k] - jg[k])) for k, v in spread.items()}
    finally:
        jgs.set_impl("auto")

    def port_grads(losses):
        cfg = copy.deepcopy(tcfg)
        cfg.model.vid_object_extractor_losses = losses
        syn = Synthesizer(cfg, device="cpu")
        from_jax(params, syn)
        st = NetState(syn.lvd, cfg.model)
        st.zero_grad()
        loss, tm = syn.extract_object_loss({k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        loss.backward()
        return syn, st, loss, tm, _flatten(to_jax(syn, grads=True)["pe"])

    losses = tcfg.model.vid_object_extractor_losses
    trest = port_grads([k for k in losses if k != "ent_flt_edge"])[-1]
    syn, st, loss, tm, tg = port_grads(losses)
    st.apply(loss)
    return dict(jm={k: float(v) for k, v in jm.items()}, tm={k: float(v) for k, v in tm.items()},
                jg=jg, tg=tg, jrest=jrest, trest=trest,
                spread={k: float(v.max()) for k, v in spread.items()},
                jp=_flatten(jax.tree.map(np.asarray, new.params)), tp=_flatten(to_jax(syn)["pe"]),
                start=_flatten(params["pe"]), losses=losses)


def test_kitti_lvd_step_metrics_match_jax(lvd_step):
    jm, tm = lvd_step["jm"], lvd_step["tm"]
    assert lvd_step["losses"] == ["ent_flt_edge", "l1_flow", "cell_dis", "reg_mov"]
    assert set(jm) - {"nancount"} == set(tm) and jm["nancount"] == 0
    for k, v in tm.items():
        assert np.isfinite(v) and abs(v - jm[k]) <= 1e-6 + 2e-4 * abs(jm[k]), (k, v, jm[k])


@pytest.mark.parametrize("part", ["rest", "all"])
def test_kitti_lvd_step_gradients_match_jax(lvd_step, part):
    """Per leaf. "rest": the gradient of train_lvd.sh's losses but
    ent_flt_edge, within 5e-3 x max|JAX leaf| + 1e-6 x the largest of all
    leaves (tests/test_torch_train.py's tolerance). "all": the four losses'
    gradient within that plus twice the JAX gradient's own spread (its change
    when the input flow moves by 1e-7, 1e-6 or 1e-5 of itself), the spread
    at most SPREAD_CAP x max|JAX leaf|. ent_flt_edge's entropy of the
    normalized alphas has a gradient of order 1 / (the alphas' sum) at a
    pixel that no layer covers but for a bilinear sliver at the frame's
    border, and at KITTI's widths (13 x 2^k) such a sliver's weight carries
    the rounding of its pixel coordinate (ulp(103.99) = 7.6e-6 against a
    weight of 5.5e-5): one such pixel moves the JAX gradient itself by up to
    35 x the base tolerance under those moves, and the port's as much."""
    want, got = ((lvd_step["jrest"], lvd_step["trest"]) if part == "rest"
                 else (lvd_step["jg"], lvd_step["tg"]))
    assert set(got) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    assert top > 0
    if part == "rest":
        assert any(float(np.abs(want[k] - lvd_step["jg"][k]).max()) > 1e-3 * top for k in want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err, tol = float(np.abs(got[k] - w).max()), 5e-3 * scale + 1e-6 * top
        if part == "all":
            spread = lvd_step["spread"][k]
            assert spread <= SPREAD_CAP * scale + 1e-6 * top, (k, spread, scale)
            tol += 2 * spread
        assert err <= tol, f"{k}: max|err| {err:.3g} > {tol:.3g}"


def test_kitti_lvd_step_parameters_match_jax(lvd_step):
    """Adam's first step moves an element by lr g / (|g| + eps), about lr in
    the gradient's sign: an element whose gradient lies within the leaf's
    gradient tolerance of 0 (test_kitti_lvd_step_gradients_match_jax's
    "all") may step the other way. So the elements whose JAX gradient
    exceeds that tolerance are held at 2e-6 on 99.9 % of each leaf, every
    element within the 2e-4 the step can move it (plus the rounding of the
    two sides' parameters)."""
    want, got, start, jg = lvd_step["jp"], lvd_step["tp"], lvd_step["start"], lvd_step["jg"]
    assert set(got) == set(want)
    top = max(float(np.abs(g).max()) for g in jg.values())
    moved = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        tol = 5e-3 * float(np.abs(jg[k]).max()) + 1e-6 * top + 2 * lvd_step["spread"][k]
        live = np.abs(jg[k]) > tol
        share = float((diff[live] > 2e-6).sum()) / max(int(live.sum()), 1)
        step = 2e-4 + 2 * float(np.spacing(np.abs(w).max()))
        assert float(diff.max()) <= step and share <= 1e-3, (k, float(diff.max()), share)
        moved += int(np.abs(w - start[k]).max() > 1e-5)
    assert moved > len(want) // 2


# ---------------------------------------------------------------------------
# (iv) the evaluator on the tree's test split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def evals(tree, params, predict_of, tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_eval")
    # without skip_first, which leaves the JAX package no clip to load
    # (test_kitti_test_windows_skip_first)
    extra = [*TEST_LOAD, "--data.dataroot", tree, "--save_path", str(root),
             "--s_sample_precision", "float32", "--data.skip_first", "false"]
    jcfg, tcfg = both_cfgs("test.sh", *extra)
    # the JAX evaluator on one CPU device (a mesh over the suite's 8 virtual
    # devices would compute the predict on each), its batches on the default
    # device as (i)'s, its predict (i)'s at the same model config, compiled
    # once; its parameters are set below, neither drawn nor restored from
    # test.sh's tags
    jcfg.model.load_path = jcfg.model.pg_load_path = jcfg.model.ii_load_path = None
    jcfg.datetime, tcfg.datetime = "jax", "torch"
    float32 = predict_of("float32")
    model = both_cfgs("test.sh", *TEST_LOAD, "--s_sample_precision", "float32")[0].model
    model.load_path = model.pg_load_path = model.ii_load_path = None
    assert model == jcfg.model
    jvids, tvids = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jevaluator, "save_video_frames", capturing(jevaluator, jvids))
        mp.setattr(jevaluator, "make_mesh",
                   lambda *a: Mesh(np.asarray(jax.devices()[:1]), ("data",)))
        mp.setattr(jevaluator, "shard_batch",
                   lambda arrays, mesh: {k: jnp.asarray(v) for k, v in arrays.items()})
        mp.setattr(jevaluator.Synthesizer, "init_params", lambda self, key: params)
        jev = JaxEvaluator(jcfg)
        jev.params, jev._predict = jax.tree.map(jnp.asarray, params), float32["jpredict"]
        jgs.set_impl("gather")
        try:
            jmetrics = jev.run(dump=True)
        finally:
            jgs.set_impl("auto")
    for net, field in (("pe", "load_path"), ("pg", "pg_load_path"), ("ii", "ii_load_path")):
        run = str(root / "checkpoints" / f"{net}_run")
        CheckpointManager(run).save(net, params[net], 7, name="latest")
        setattr(tcfg.model, field, run)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevaluator, "save_video_frames", capturing(tevaluator, tvids))
        tev = Evaluator(tcfg, device="cpu")
        tmetrics = tev.run()
    return dict(jcfg=jcfg, tcfg=tcfg, jmetrics=jmetrics, tmetrics=tmetrics, jvids=jvids,
                tvids=tvids, tev=tev, near=[near_holes(tev, tcfg, 0)])


def test_kitti_test_windows_skip_first(tree):
    """test.sh sets --data.skip_first true. The JAX package's test windows
    hold vid_len frames (waldo_tpu/data/kitti.py:50-51), one short once the
    first is skipped, so it loads no clip; the port's hold one frame more,
    and a clip is the vid_len frames after the window's first."""
    jcfg, tcfg = both_cfgs("test.sh", *TEST_LOAD, "--data.dataroot", tree)
    assert jcfg.data.skip_first and tcfg.data.skip_first
    jds, tds = jdata.create_dataset(jcfg, phase="test"), create_dataset(tcfg, phase="test")
    jwin, twin = jds.data["vid_frame_paths"], tds.data["vid_frame_paths"]
    assert len(jwin) == len(twin) == 1
    for j, t in zip(jwin, twin):
        assert len(j) == 10 and t[:10] == j and len(t) == 11
    with pytest.raises(AssertionError):
        jds[0]
    _, plain = both_cfgs("test.sh", *TEST_LOAD, "--data.dataroot", tree, "--data.skip_first",
                         "false")
    unskipped = create_dataset(plain, phase="test")
    unskipped.data["vid_frame_paths"][0] = twin[0][1:]  # the window one frame on, unskipped
    np.testing.assert_array_equal(tds[0]["vid"], unskipped[0]["vid"])
    assert tds[0]["vid"].shape == (10, 64, 208, 3)


def test_kitti_evaluator_windows(evals):
    ds = create_dataset(evals["tcfg"], phase="test")
    clips = ds.data["vid_frame_paths"]
    assert len(clips) == 1 and len(clips[0]) == 10
    assert os.path.basename(clips[0][0]) == "000001.png"
    assert len(evals["tev"].iteration_times) == 1


@pytest.mark.parametrize("key", KEYS)
def test_kitti_evaluator_metrics_match_jax(evals, key):
    got, want = evals["tmetrics"], evals["jmetrics"]
    assert sorted(got) == sorted(want) == sorted(KEYS)
    assert np.isfinite(got[key])
    scale = abs(want[key]) if key.startswith("psnr") else 1.0
    assert abs(got[key] - want[key]) <= 1e-3 * scale, (key, got[key], want[key])


@pytest.mark.parametrize("name", list(tevaluator.DUMPS))
def test_kitti_evaluator_videos_match_jax(evals, name):
    got = {k: v for k, v in evals["tvids"].items() if k[0] == name}
    want = {k: v for k, v in evals["jvids"].items() if k[0] == name}
    assert sorted(got) == sorted(want) and len(want) == 1
    for k in want:
        assert got[k].shape == want[k].shape == (10, 64, 208, 3)
        diff = np.abs(got[k] - want[k])
        if name == "pred_vid":
            near = np.broadcast_to(evals["near"][int(k[1][4:9])], diff.shape)
            assert np.isfinite(got[k][near]).all() and np.abs(got[k][near]).max() <= 1
            assert near.mean() < 1e-2, near.mean()
            diff = np.where(near, 0, diff)
        check_steep(diff, np.zeros_like(diff), VID_TOL, f"{k}")

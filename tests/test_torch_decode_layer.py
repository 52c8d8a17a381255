"""The decode_layer path (Synthesizer.decode_layer: Warper.layer_from_input
and alpha_to_alpha, lvd.reduce_time) and lvd.reduce_comp, the port against
the JAX package on the CPU at tests/test_models_smoke.tiny_config()'s scale.

Both sides take the same grids, occlusions and alphas (the JAX package's
LVD pass and warper on perturbed parameters, jitted), so that the test
holds decode_layer alone; the JAX side samples through its gather path.
The time dropout's draws are made by the test from JAX's own key splits
(reduce_time's four: the objects' frame index and uniforms, the
background's) and handed to the port.

Tolerance: the samplers' float32 one (ROADMAP.md), 2e-5 + 1e-4 x max|JAX|,
on the gathers, the occluded alphas, reduce_time on the same inputs and
reduce_comp. End to end, reduce_time weighs each frame by (alpha + 1) / 2 +
1e-6 over their sum: where every frame's alpha is within ~1e-4 of -1 that
sum is ~1e-6 to 1e-4 and the alphas' float32 rounding (2e-7 apart) moves
the weights by percents, so the background texture is held there only to
lie within its frames' range, and to the tolerance where the sum is at
least 1e-3 (47 % of its pixels here).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldo_tpu.models import Synthesizer as JaxSynthesizer
from waldo_tpu.models.lvd import reduce_comp as jax_reduce_comp

from waldo_tpu_torch.config import from_dict, to_dict
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.models.lvd import reduce_comp, time_dropout_draws
from waldo_tpu_torch.models.warper import WarpGrids

from test_models_smoke import tiny_batch, tiny_config
from test_torch_flp_train import _perturbed_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 2e-5 + 1e-4 * float(np.abs(want).max()), err


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def inputs():
    """The JAX package's decode_layer inputs on a tiny clip, and its
    synthesizer and the port's (float32 sampling)."""
    cfg = tiny_config(use_pg=False, use_ii=False)
    cfg.model.sample_precision = "float32"
    params = _perturbed_params(cfg, 5)
    batch = tiny_batch(cfg)
    js = JaxSynthesizer(cfg)

    def front(b):
        real = js.make_input(b["vid"], b["lyt"], b["flow"])
        p = js.lvd_pass(params["pe"], real, cfg.model.ctx_len)
        occ, obj_alpha, bg_alpha, grids = js.alpha_grid_occ(
            params["pe"], p["x_obj"], p["obj_pose"], p["bg_pose"], p["occ_score"])
        x = jnp.concatenate([b["vid"], b["lyt"]], axis=-1)
        return x, grids, occ, obj_alpha, bg_alpha

    jgs.set_impl("gather")
    try:
        args = jax.jit(front)(batch)
    finally:
        jgs.set_impl("auto")
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    return js, syn, args


def _jax_decode_layer(js, args, key=None):
    jgs.set_impl("gather")
    try:
        return jax.jit(lambda *a: js.decode_layer(*a, time_dropout_rng=key))(*args)
    finally:
        jgs.set_impl("auto")


def _port_args(args):
    x, grids, occ, obj_alpha, bg_alpha = args
    return (_t(x), WarpGrids(*(_t(g) for g in grids)), _t(occ), _t(obj_alpha), _t(bg_alpha))


def _jax_gathers(js, args):
    """JAX's layer_from_input and alpha_to_alpha on the inputs."""
    x, grids, occ, obj_alpha, bg_alpha = args
    jgs.set_impl("gather")
    try:
        return jax.jit(lambda x, g, o, a, b: (js.warper.layer_from_input(x, g),
                                              js.warper.alpha_to_alpha(a, b, g, o)))(
            x, grids, occ, obj_alpha, bg_alpha)
    finally:
        jgs.set_impl("auto")


def test_gathers_and_alpha_to_alpha_match_jax(inputs):
    js, syn, args = inputs
    (jo, jb), ja = _jax_gathers(js, args)
    x, grids, occ, obj_alpha, bg_alpha = _port_args(args)
    to, tb = syn.warper.layer_from_input(x, grids)
    _close(to, jo)
    _close(tb, jb)
    for g, w in zip(syn.warper.alpha_to_alpha(obj_alpha, bg_alpha, grids, occ), ja):
        _close(g, w)


@pytest.mark.parametrize("dropout", [False, True])
def test_reduce_time_matches_jax(inputs, dropout):
    """reduce_time on JAX's own gathered textures and alphas, handed to
    both, with and without time dropout (JAX's draws)."""
    from waldo_tpu.models.lvd import reduce_time as jax_reduce_time
    from waldo_tpu_torch.models.lvd import reduce_time

    js, _, args = inputs
    (jo, jb), (joa, jba, _) = _jax_gathers(js, args)
    key = jax.random.PRNGKey(7) if dropout else None
    want = jax.jit(lambda *a: jax_reduce_time(*a, time_dropout_rng=key))(jo, jb, joa, jba)
    b, t, no = joa.shape[:3]
    draws = _jax_draws(key, b, t, no) if dropout else None
    got = reduce_time(_t(jo), _t(jb), _t(joa), _t(jba), draws=draws)
    for g, w in zip(got, want):
        _close(g, w)


def _decode_close(got, want, bg_scores):
    """decode_layer's outputs: the objects and alphas to the tolerance, the
    background to it where its weights are well conditioned (the score sum
    at least 1e-3) and within its frames' range elsewhere."""
    obj, bg, alpha = got
    _close(obj, want[0])
    _close(alpha, want[2])
    well = bg_scores >= 1e-3
    assert well.mean() > 0.25
    w_bg = np.asarray(want[1])
    err = np.abs(bg.detach().numpy() - w_bg)[np.broadcast_to(well, w_bg.shape)]
    assert float(err.max()) <= 2e-5 + 1e-4 * float(np.abs(w_bg).max()), float(err.max())
    return well


def _bg_scores(js, args, draws=None):
    """The background's weight sum over the (kept) frames, (B,H,W,1)."""
    _, (_, jba, _) = _jax_gathers(js, args)
    score = (np.asarray(jba) + 1) / 2 + 1e-6  # B T H W 1
    if draws is not None:
        _, _, ti_b, rd_b = (d.numpy() for d in draws)
        keep = rd_b >= np.take_along_axis(rd_b, ti_b, axis=1)
        score = score * keep[:, :, None, None, None]
    return score.sum(axis=1)


def test_decode_layer_matches_jax(inputs):
    js, syn, args = inputs
    want = _jax_decode_layer(js, args)
    got = syn.decode_layer(*_port_args(args))
    b, no = args[3].shape[:2]
    assert got[0].shape[:2] == (b, no) and got[0].shape[-1] == args[0].shape[-1] + 1
    well = _decode_close(got, want, _bg_scores(js, args))
    # elsewhere a convex combination of the frames' gathered background
    _, tb = syn.warper.layer_from_input(*_port_args(args)[:2])
    tb = torch.cat([tb, torch.zeros_like(tb[..., :1])], dim=-1).numpy()
    lo, hi = tb.min(axis=1) - 1e-5, tb.max(axis=1) + 1e-5
    bg = got[1].detach().numpy()[..., :-1]
    ill = np.broadcast_to(~well, bg.shape)
    assert np.all((bg >= lo[..., :-1]) & (bg <= hi[..., :-1]) | ~ill)


def _jax_draws(key, b, t, no):
    """reduce_time's draws from the JAX package's splits of ``key``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.randint(k1, (b, 1, 1), 0, t), jax.random.uniform(k2, (b, t, no)),
        jax.random.randint(k3, (b, 1), 0, t), jax.random.uniform(k4, (b, t))))


def test_decode_layer_time_dropout_matches_jax(inputs):
    """With time dropout: JAX's draws from its key, handed to the port."""
    js, syn, args = inputs
    key = jax.random.PRNGKey(7)
    want = _jax_decode_layer(js, args, key)
    b, t, no = args[2].shape[0], args[2].shape[1], args[3].shape[1]
    draws = _jax_draws(key, b, t, no)
    assert draws[0].dtype == torch.int32 and draws[1].shape == (b, t, no)
    got = syn.decode_layer(*_port_args(args), draws=draws)
    _decode_close(got, want, _bg_scores(js, args, draws))
    plain = syn.decode_layer(*_port_args(args))
    assert not torch.allclose(got[0], plain[0], atol=1e-4)


def test_time_dropout_from_a_generator(inputs):
    """A generator's draws: the same seed repeats them, and at least the
    drawn frame itself is kept for every clip and layer."""
    _, syn, args = inputs
    b, t, no = args[2].shape[0], args[2].shape[1], args[3].shape[1]
    run = lambda s: syn.decode_layer(*_port_args(args),
                                     generator=torch.Generator().manual_seed(s))[0]
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    ti_o, rd_o, ti_b, rd_b = time_dropout_draws(torch.Generator().manual_seed(3), b, t, no)
    keep = rd_o >= rd_o.gather(1, ti_o.expand(b, 1, no))
    assert bool(keep.any(dim=1).all()) and not bool(keep.all())


def test_reduce_comp_matches_jax():
    rng = np.random.RandomState(2)
    b, t, no, h, w = 2, 3, 3, 8, 16
    vid = np.tanh(rng.randn(b, t, no + 1, h, w, 4)).astype(np.float32)
    occ_score = rng.randn(b, t, no).astype(np.float32)
    from waldo_tpu.models.lvd import compute_occ

    occ = np.asarray(compute_occ(jnp.asarray(occ_score)))
    flow = (rng.randn(b, t - 1, no + 1, h, w, 2) * 0.1).astype(np.float32)
    want = jax_reduce_comp(jnp.asarray(vid), jnp.asarray(occ), jnp.asarray(flow))
    got = reduce_comp(_t(vid), _t(occ), _t(flow))
    for g, w_ in zip(got, want):
        _close(g, w_)

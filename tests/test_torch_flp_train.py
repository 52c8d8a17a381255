"""The FLP training loss, the port against the JAX package, on the CPU at
tests/test_models_smoke.tiny_config()'s scale: ``generate_pose_loss``
(metrics and FLP's per-leaf gradients) against the frozen LVD teacher, and
FLP's training noise. The helpers serve tests/test_torch_wif_train.py too.

The JAX side samples through its gather path (``set_impl("gather")``), the
plain reference of its TPU kernels, as tests/test_torch_train.py does.
FLP's context length is drawn from each side's own stream, so the config
pins it (tiny_config: 2 of 5 frames); the scripts' noise flags are off, as
in train_flp.sh.

Tolerances (tests/test_torch_train.py's):
  metrics, float32: 1e-6 + 2e-4 x |value|; "fast": 1e-5 + 2e-3 x |value|
           (both sides store the alpha maps and warped frames in bf16).
  gradients: per leaf, 5e-3 x max|JAX leaf| + 1e-6 x max over all leaves.
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.config import from_dict, to_dict
from waldo_tpu_torch.convert import from_jax, to_jax
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.parallel import BatchShard, RowStream
from waldo_tpu_torch.train.checkpoint import _flatten

from test_models_smoke import tiny_batch, tiny_config

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")
METRIC_TOL = {"float32": (1e-6, 2e-4), "fast": (1e-5, 2e-3)}
POSE_METRICS = ("loss", "rec_bg_pose", "rec_obj_pose", "rec_occ_score")


def _perturbed_params(cfg, seed):
    """JAX's init with every leaf perturbed by seeded noise (the zero-init
    heads would hide layers)."""
    params = jax.tree.map(np.asarray, JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: a + np.asarray(rng.randn(*a.shape) * 0.02, np.float32), params)


def _port(cfg, params):
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, syn)
    return syn


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_loss_and_grads(fn, params, batch):
    jgs.set_impl("gather")
    try:
        (jl, jm), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jgs.set_impl("auto")
    flat = {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jg)).items()}
    return {k: float(v) for k, v in jm.items()}, flat


def _jax_metrics(fn, params, batch):
    jgs.set_impl("gather")
    try:
        _, jm = jax.jit(fn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jgs.set_impl("auto")
    return {k: float(v) for k, v in jm.items()}


def _check_metrics(precision, got, want, names):
    atol, rtol = METRIC_TOL[precision]
    assert set(got) == set(want)
    for name in names:
        if name not in want:
            continue
        assert np.isfinite(got[name]), name
        assert abs(got[name] - want[name]) <= atol + rtol * abs(want[name]), \
            (name, got[name], want[name])


def _check_grads(got, want):
    assert set(got) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    assert top > 0
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        tol = 5e-3 * float(np.abs(w).max()) + 1e-6 * top
        assert err <= tol, f"{k}: max|err| {err:.3g} > {tol:.3g}"


# ---------------------------------------------------------------------------
# generate_pose_loss
# ---------------------------------------------------------------------------


def pose_cfg():
    cfg = tiny_config(use_pg=True, use_ii=False)
    cfg.model.sample_precision = "float32"
    return cfg


@pytest.fixture(scope="module")
def pose_pair():
    """JAX (metrics, FLP grads) and the port's (metrics, FLP grads, LVD
    grads) on one batch."""
    cfg = pose_cfg()
    params = _perturbed_params(cfg, 1)
    batch = {k: np.asarray(v) for k, v in tiny_batch(cfg).items()}
    js = JaxSynthesizer(cfg)
    jm, jg = _jax_loss_and_grads(
        lambda p, b: js.generate_pose_loss(p, params["pe"], b, jax.random.PRNGKey(1), 0),
        params["pg"], batch)
    syn = _port(cfg, params)
    loss, tm = syn.generate_pose_loss(_tb(batch), 0, generator=torch.Generator().manual_seed(1))
    loss.backward()
    grads = to_jax(syn, grads=True)
    return (jm, jg), ({k: float(v) for k, v in tm.items()}, _flatten(grads["pg"]),
                      [p.grad for p in syn.lvd.parameters()])


@pytest.mark.parametrize("name", POSE_METRICS)
def test_generate_pose_loss_metric_matches_jax(pose_pair, name):
    (jm, _), (tm, _, _) = pose_pair
    _check_metrics("float32", tm, jm, [name])


def test_generate_pose_loss_gradients_match_jax(pose_pair):
    """FLP's per-leaf gradients; the frozen LVD teacher gets none."""
    (_, jg), (_, tg, lvd_grads) = pose_pair
    _check_grads(tg, jg)
    assert all(g is None for g in lvd_grads)


# ---------------------------------------------------------------------------
# FLP's training noise
# ---------------------------------------------------------------------------


def noise_cfg(embed):
    cfg = pose_cfg()
    cfg.model.pg_inject_noise, cfg.model.pg_embed_noise = True, embed
    return cfg


def _flp_rollout(params, embed, strength, noise_seed):
    """The port's FLP, its decoder's noise strengths set to ``strength``, on
    the teacher's poses of one batch; ``noise_seed`` None runs deterministic
    inference."""
    cfg = noise_cfg(embed)
    syn = _port(cfg, params)
    with torch.no_grad():
        for blk in syn.flp.decode.self_blocks:
            blk.attn.noise_strength.fill_(strength)
    batch = _tb({k: np.asarray(v) for k, v in tiny_batch(cfg).items()})
    b, t = batch["vid"].shape[:2]
    with torch.no_grad():
        p = syn.lvd_pass(syn.make_input(batch["vid"], batch["lyt"], batch["flow"]),
                         cfg.model.ctx_len)
        ctx_mask = (torch.arange(t)[None] < cfg.model.ctx_len).expand(b, t)
        noise = None if noise_seed is None else RowStream(torch.Generator().manual_seed(noise_seed),
                                                          BatchShard.whole(b))
        return torch.cat([o.reshape(b, -1) for o in syn.flp(
            p["obj_pose"], p["bg_pose"], p["occ_score"], p["x_obj"], p["x_bg"], p["last_obj"],
            p["last_bg"], ctx_mask, noise=noise)], dim=1)


@pytest.fixture(scope="module")
def noise_params():
    """FLP parameters with the decoder's noise strengths (pg_inject_noise)."""
    return _perturbed_params(noise_cfg(False), 2)


def test_flp_inject_noise_of_strength_zero_is_deterministic(noise_params):
    """pg_inject_noise adds token noise times noise_strength (initialized to
    0): at strength 0 a training rollout equals inference."""
    want = _flp_rollout(noise_params, False, 0.0, None)
    assert torch.equal(_flp_rollout(noise_params, False, 0.0, 3), want)


@pytest.mark.parametrize("flag", ["pg_embed_noise", "pg_inject_noise"])
def test_flp_training_noise_differs_and_repeats_with_its_seed(noise_params, flag):
    """Each noise alone (the embedding's, or the tokens' at strength 0.5)
    moves a training rollout off inference; the same generator seed repeats
    it, another seed does not."""
    embed, strength = (True, 0.0) if flag == "pg_embed_noise" else (False, 0.5)
    want = _flp_rollout(noise_params, embed, strength, None)
    a = _flp_rollout(noise_params, embed, strength, 4)
    assert not torch.allclose(a, want, atol=1e-4)
    assert torch.equal(a, _flp_rollout(noise_params, embed, strength, 4))
    assert not torch.equal(a, _flp_rollout(noise_params, embed, strength, 5))


def test_flp_dropout_raises_in_training():
    cfg = pose_cfg()
    cfg.model.dropout = 0.1
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        syn.generate_pose_loss(_tb({k: np.asarray(v) for k, v in tiny_batch(cfg).items()}), 0,
                               generator=torch.Generator().manual_seed(0))

"""The rest of the attention zoo (waldo_tpu_torch/nn/transform.py) against
the JAX package's (waldo_tpu/nn/transform.py) on the CPU, and the features
the port refuses where the JAX package cannot run them.

  the ctx, block_causal and full_with_cond_norm types through ``Block`` and
      ``MultiBlocks`` (``causal_mask_sizes``), and the block-causal mask;
  SeedAttention, SkipAttention and Skip2Attention standalone (through a
      JAX ``Block`` they raise TypeError; the port's ``Block`` refuses them
      naming that), the skip types in inference and in training with the
      non-trivial mask, context masks and temporal dropout (all context
      frames dropped at p = 1, which needs no shared random stream; at
      p = 0.5 the generator's seed repeats the draw);
  pg_modulate_noise: JAX's init raises IndexError, the port refuses it;
  dropout: JAX's training losses raise flax's InvalidRngError, the port's
      refuse; inference (predict, the WIF loss's eval) is dropout 0's.

Tolerance: 1e-4 relative (ROADMAP.md's nets) on outputs, with parameters
carried over by the converter's rules (waldo_tpu_torch/convert.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldo_tpu.nn import transform as jt
from waldo_tpu_torch.convert import attention_rules, block_rules, load_from_jax
from waldo_tpu_torch.nn import transform as tt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DIM, HEADS = 32, 4


def _close(got, want, rtol=1e-4):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _arr(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _init(module, *args, seed=0, **kw):
    """The flax module's parameters, every leaf moved by seeded noise (the
    norms start at unit scale and zero bias)."""
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args, **kw))
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.05).astype(np.float32), params)


def _t(a):
    return torch.from_numpy(np.array(a))


def _block_inputs(block_type, rng):
    x = _arr(rng, 2, 6, DIM)
    kw = {}
    if block_type == "ctx":
        kw["x_ctx"] = _arr(rng, 2, 6, DIM)
    if block_type == "full_with_cond_norm":
        kw["z_cond"] = _arr(rng, 2, 1, DIM)
    return x, kw


CASES = [("ctx", "ln"), ("block_causal", "ln"), ("full_with_cond_norm", "ln_not_affine"),
         ("full_with_cond_norm", "ln")]


@pytest.mark.parametrize("block_type,norm", CASES)
def test_block_types_match_jax(block_type, norm):
    rng = np.random.RandomState(0)
    x, kw = _block_inputs(block_type, rng)
    sizes = (2, 3, 1)
    jb = jt.Block(dim=DIM, num_heads=HEADS, block_type=block_type, norm_layer=norm,
                  causal_mask_sizes=sizes)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = _init(jb, jnp.asarray(x), **jkw)
    want = jb.apply(params, jnp.asarray(x), **jkw)
    tb = tt.Block(DIM, HEADS, block_type, norm, causal_mask_sizes=sizes)
    load_from_jax(params, tb, block_rules(block_type, norm), block_type)
    _close(tb(_t(x), **{k: _t(v) for k, v in kw.items()}), want)


def test_multiblocks_block_causal_match_jax():
    rng = np.random.RandomState(1)
    x = _arr(rng, 2, 6, DIM)
    sizes = (1, 2, 3)
    jm = jt.MultiBlocks(depth=2, dim=DIM, num_heads=HEADS, block_type="block_causal",
                        causal_mask_sizes=sizes)
    params = _init(jm, jnp.asarray(x), seed=2)
    tm = tt.MultiBlocks(2, DIM, HEADS, "block_causal", "ln", causal_mask_sizes=sizes)
    rules = [(f"layers.{i}.{k}", f"Block_{i}/{f}", kind) for i in range(2)
             for k, f, kind in block_rules("block_causal", "ln")]
    load_from_jax(params, tm, rules, "multiblocks")
    _close(tm(_t(x)), jm.apply(params, jnp.asarray(x)))
    # the first block's rows see no later block: changing the last token
    # leaves the first three outputs alone
    x2 = x.copy()
    x2[:, -1] += 1.0
    a, b = tm(_t(x)), tm(_t(x2))
    assert torch.equal(a[:, :3], b[:, :3]) and not torch.equal(a[:, 3:], b[:, 3:])


@pytest.mark.parametrize("mask_diag", [False, True])
def test_causal_mask_matches_jax(mask_diag):
    want = np.asarray(jt.get_causal_mask((2, 3, 1), mask_diag=mask_diag))
    got = tt.get_causal_mask((2, 3, 1), mask_diag=mask_diag).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)


def test_seed_attention_matches_jax():
    rng = np.random.RandomState(3)
    x, z = _arr(rng, 2, 6, DIM), _arr(rng, 2, 2, DIM)
    jm = jt.SeedAttention(dim=DIM, num_heads=HEADS)
    params = _init(jm, jnp.asarray(x), jnp.asarray(z), seed=3)
    tm = tt.SeedAttention(DIM, HEADS)
    load_from_jax(params, tm, attention_rules("seed"), "seed")
    _close(tm(_t(x), _t(z)), jm.apply(params, jnp.asarray(x), jnp.asarray(z)))


L, T, T0 = 4, 3, 2


def _skip_inputs(kind, rng):
    x = _arr(rng, 2, T0 * L, DIM)
    x_ctx = _arr(rng, 2, T, L, DIM)
    dx_ctx = _arr(rng, 2, T, L, DIM) if kind == "skip" else _arr(rng, 2, T, T0 * L, DIM)
    ctx_mask = np.array([[True, True, False], [True, False, True]])
    return x, x_ctx, dx_ctx, ctx_mask


def _skip_pair(kind, p=0.0, seed=4):
    jcls, tcls = {"skip": (jt.SkipAttention, tt.SkipAttention),
                  "skip2": (jt.Skip2Attention, tt.Skip2Attention)}[kind]
    rng = np.random.RandomState(seed)
    inputs = _skip_inputs(kind, rng)
    jm = jcls(dim=DIM, num_heads=HEADS, latent_size=L, num_seeds=1, temporal_dropout=p,
              non_trivial=True)
    params = _init(jm, *(jnp.asarray(a) for a in inputs[:3]), seed=seed)
    tm = tcls(DIM, HEADS, L, num_seeds=1, temporal_dropout=p, non_trivial=True)
    load_from_jax(params, tm, attention_rules(kind), kind)
    return jm, params, tm, inputs


@pytest.mark.parametrize("mode", ["inference", "training"])
@pytest.mark.parametrize("kind", ["skip", "skip2"])
def test_skip_attention_matches_jax(kind, mode):
    """Inference, and training with the non-trivial mask (query frame t
    never sees context frame t + num_seeds), both under a context mask."""
    jm, params, tm, (x, x_ctx, dx_ctx, ctx_mask) = _skip_pair(kind)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(x_ctx), jnp.asarray(dx_ctx), mode=mode,
                    ctx_mask=jnp.asarray(ctx_mask))
    got = tm(_t(x), _t(x_ctx), _t(dx_ctx), mode=mode, ctx_mask=_t(ctx_mask))
    _close(got, want)
    if mode == "training":
        free = tm(_t(x), _t(x_ctx), _t(dx_ctx), mode="inference", ctx_mask=_t(ctx_mask))
        assert not torch.allclose(got, free, atol=1e-4)


@pytest.mark.parametrize("kind", ["skip", "skip2"])
def test_skip_temporal_dropout(kind):
    """p = 1 drops every context frame, in JAX's draw and the port's alike;
    at p = 0.5 the generator's seed repeats the drop, another seed does
    not, and without a generator (or outside training) nothing drops."""
    jm, params, tm, (x, x_ctx, dx_ctx, _) = _skip_pair(kind, p=1.0)
    args = (jnp.asarray(x), jnp.asarray(x_ctx), jnp.asarray(dx_ctx))
    want = jm.apply(params, *args, mode="training", deterministic=False,
                    rngs={"noise": jax.random.PRNGKey(9)})
    targs = (_t(x), _t(x_ctx), _t(dx_ctx))
    got = tm(*targs, mode="training", generator=torch.Generator().manual_seed(0))
    _close(got, want)
    tm.temporal_dropout = 0.5
    run = lambda s: tm(*targs, mode="training", generator=torch.Generator().manual_seed(s))
    base = tm(*targs, mode="training")
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), base)
    assert torch.equal(tm(*targs, mode="inference", generator=torch.Generator().manual_seed(1)),
                       tm(*targs, mode="inference"))


@pytest.mark.parametrize("block_type", ["seed", "skip", "skip2"])
def test_block_refuses_what_jax_block_cannot_run(block_type):
    """The JAX Block raises TypeError for these types (it calls every
    attention as attn(h, x_ctx=..., key_mask=...), and never passes the skip
    types' latent_size); the port's Block refuses them naming that."""
    x = jnp.zeros((1, 4, DIM))
    with pytest.raises(TypeError):
        jt.Block(dim=DIM, num_heads=HEADS, block_type=block_type).init(jax.random.PRNGKey(0), x)
    with pytest.raises(NotImplementedError, match="TypeError"):
        tt.Block(DIM, HEADS, block_type)
    with pytest.raises(ValueError, match="unknown attention"):
        tt.Block(DIM, HEADS, "axial")


def test_pg_modulate_noise_refused_as_jax_cannot_build_it():
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu_torch.config import from_dict, to_dict
    from waldo_tpu_torch.models import Synthesizer

    from test_models_smoke import tiny_config

    cfg = tiny_config(use_ii=False)
    cfg.model.pg_modulate_noise = True
    with pytest.raises(IndexError):
        JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="IndexError"):
        Synthesizer(from_dict(to_dict(cfg)), device="cpu")


def _dropout_cfgs(p):
    from test_models_smoke import tiny_config

    cfg = tiny_config()
    cfg.model.sample_precision = "float32"
    cfg.model.dropout = p
    return cfg


def test_training_dropout_refused_as_jax_raises():
    """The LVD loss with dropout > 0: flax raises InvalidRngError in the JAX
    package (no "dropout" rng), the port refuses naming it."""
    import flax

    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu_torch.config import from_dict, to_dict
    from waldo_tpu_torch.models import Synthesizer

    from test_models_smoke import tiny_batch

    cfg = _dropout_cfgs(0.1)
    js = JaxSynthesizer(cfg)
    params = js.init_params(jax.random.PRNGKey(0))
    batch = tiny_batch(cfg)
    with pytest.raises(flax.errors.InvalidRngError):
        js.extract_object_loss(params["pe"], batch, jax.random.PRNGKey(1), 0)
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        syn.extract_object_loss(tb, 0)


def test_dropout_leaves_inference_alone():
    """Dropout > 0 at inference: JAX's deterministic LVD pass is dropout
    0's, and so are the port's predict and its WIF loss (the trainer's
    eval of vid_inpainting), bitwise."""
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu_torch.config import from_dict, to_dict
    from waldo_tpu_torch.models import Synthesizer

    from test_models_smoke import tiny_batch

    batch = tiny_batch(_dropout_cfgs(0.0))
    params = JaxSynthesizer(_dropout_cfgs(0.0)).init_params(jax.random.PRNGKey(0))
    real = JaxSynthesizer(_dropout_cfgs(0.0)).make_input(batch["vid"], batch["lyt"],
                                                         batch["flow"])
    outs = [jax.jit(lambda pe, r, js=JaxSynthesizer(_dropout_cfgs(p)): js.lvd_pass(pe, r, 2)[
        "obj_pose"])(params["pe"], real) for p in (0.0, 0.1)]
    assert np.array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    tb = {k: _t(v) for k, v in batch.items()}
    got = []
    for p in (0.0, 0.1):
        syn = Synthesizer(from_dict(to_dict(_dropout_cfgs(p))), device="cpu", seed=1)
        pred = syn.predict(tb)
        with torch.no_grad():
            _, metrics = syn.inpaint_loss(tb)
        got.append((pred, metrics))
    (p0, m0), (p1, m1) = got
    flat = lambda d: {(k, i): v for k, t in d.items()
                      for i, v in enumerate(t if isinstance(t, tuple) else (t,))}
    a, b = flat(p0), flat(p1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)

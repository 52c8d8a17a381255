"""The port's nets (LVD, FLP, WIF) against their flax counterparts, on the
CPU, with the parameters carried across by ``waldo_tpu_torch.convert``.

Every parameter leaf is perturbed with seeded noise before it is converted:
the default zero-inits (the pose head, the FLP decoder heads, the alpha
decoder and WIF output convs) would otherwise hide whole layers from the
comparison. Inputs are numpy arrays from a seed, fed to both sides.
Tolerance: 1e-4 relative to each output's largest magnitude, the repo's net
tolerance (waldo_tpu/models/convert.py), in float32.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.config import Config, DataConfig, ModelConfig, to_dict
from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.config import from_dict
from waldo_tpu_torch.convert import from_jax
from waldo_tpu_torch.models import Synthesizer

REL = 1e-4


def tiny_cfg():
    return Config(
        dim=32, load_dim=64, aspect_ratio=2.0,
        data=DataConfig(num_lyt=6, fg_idx=[0, 1], bg_idx=[2, 3], other_idx=[4], vid_len=5),
        model=ModelConfig(
            patch_size=8, latent_shape=(4, 8), obj_shape=(2, 2), embed_dim=64, num_heads=4,
            num_obj=4, oe_depth=1, pe_depth=1, pg_com_depth=1, pg_enc_depth=1,
            pg_dec_depth=2, pg_num_timesteps=5, oe_num_timesteps=5, ii_depth=2,
            ii_embed_dim=32, ctx_len=2, min_ctx_length_vid=2, max_ctx_length_vid=2,
            edge_size=3, use_pe=True, use_pg=True, use_ii=True, fast_inverse_warp=True,
            vid_inpainting_losses=["sharp_vid"]),
    )


def perturbed_params(jsyn, seed=1, scale=0.02):
    params = jsyn.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (rng.randn(*np.shape(a)) * scale).astype(np.float32), params)


@pytest.fixture(scope="module")
def nets():
    cfg = tiny_cfg()
    jsyn = JaxSynthesizer(cfg)
    params = perturbed_params(jsyn)
    tsyn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, tsyn)
    return cfg, jsyn, params, tsyn


def _check(got, want, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{name}: max|err| {err:.3g} > {REL} * {scale:.3g}"


def _lvd(jsyn, params, method, *args):
    fn = jax.jit(lambda p, *a: jsyn.lvd.apply(p, *a, method=method))
    return fn(params["pe"], *[jnp.asarray(a) for a in args])


def test_lvd_encode_input(nets):
    cfg, jsyn, params, tsyn = nets
    x = np.random.RandomState(2).randn(1, 5, 64, 128, 8).astype(np.float32)
    want = _lvd(jsyn, params, "encode_input", x)
    with torch.no_grad():
        got = tsyn.lvd.encode_input(torch.from_numpy(x))
    _check(got, want, "tokens")


def test_lvd_estimate_layer(nets):
    cfg, jsyn, params, tsyn = nets
    x = np.random.RandomState(3).randn(1, 2, 32, 64).astype(np.float32)
    want = _lvd(jsyn, params, "estimate_layer", x)
    with torch.no_grad():
        got = tsyn.lvd.estimate_layer(torch.from_numpy(x))
    for name, g, w in zip(("x_obj", "x_bg", "cls"), got, want):
        _check(g, w, name)


def test_lvd_estimate_pose(nets):
    cfg, jsyn, params, tsyn = nets
    rng = np.random.RandomState(4)
    x = rng.randn(1, 5, 32, 64).astype(np.float32)
    x_obj = rng.randn(1, 4, 4, 64).astype(np.float32)
    x_bg = rng.randn(1, 32, 64).astype(np.float32)
    want = _lvd(jsyn, params, "estimate_pose", x, x_obj, x_bg)
    with torch.no_grad():
        got = tsyn.lvd.estimate_pose(*(torch.from_numpy(a) for a in (x, x_obj, x_bg)))
    names = ("obj_pose", "bg_pose", "occ_score", "rest_obj", "rest_bg", "last_obj", "last_bg")
    for name, g, w in zip(names, got, want):
        _check(g, w, name)


def test_lvd_decode_obj_alpha(nets):
    cfg, jsyn, params, tsyn = nets
    x_obj = np.random.RandomState(5).randn(1, 4, 4, 64).astype(np.float32)
    want = _lvd(jsyn, params, "decode_obj_alpha", x_obj)
    with torch.no_grad():
        got = tsyn.lvd.decode_obj_alpha(torch.from_numpy(x_obj))
    _check(got, want, "obj_alpha")


def test_flp_rollout(nets):
    cfg, jsyn, params, tsyn = nets
    rng = np.random.RandomState(6)
    b, t, no, lo, l, c = 1, 5, 4, 4, 32, 64
    args = [rng.randn(b, t, no, lo, 2).astype(np.float32) * 0.5,
            rng.randn(b, t, 1, l, 2).astype(np.float32) * 0.5,
            rng.randn(b, t, no).astype(np.float32),
            rng.randn(b, no, lo, c).astype(np.float32),
            rng.randn(b, l, c).astype(np.float32),
            rng.randn(b, no, 6 + 2 * lo).astype(np.float32) * 0.3,
            rng.randn(b, 1, 6 + 2 * l).astype(np.float32) * 0.3]
    ctx_mask = np.arange(t)[None] < cfg.model.ctx_len
    want = jax.jit(jsyn.flp.apply)(params["pg"], *[jnp.asarray(a) for a in args],
                                   jnp.asarray(ctx_mask))
    with torch.no_grad():
        got = tsyn.flp(*[torch.from_numpy(a) for a in args], torch.from_numpy(ctx_mask))
    for name, g, w in zip(("obj_pose", "bg_pose", "occ_score"), got, want):
        _check(g, w, name)


def test_wif_fusion(nets):
    cfg, jsyn, params, tsyn = nets
    c_raw = 3 + 6 + 4 + 1
    raw = np.random.RandomState(7).randn(1, 3, 3, 64, 128, c_raw).astype(np.float32)
    want = jax.jit(jsyn.wif.apply)(params["ii"], jnp.asarray(raw))
    with torch.no_grad():
        got = tsyn.wif(torch.from_numpy(raw))
    _check(got, want, "fused")

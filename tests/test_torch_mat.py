"""The port's MAT ops and modules against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, fed to both sides. On CPU tensors the
port's bias_act runs its plain version, which is held to the JAX XLA path
and to the Pallas kernel in interpret mode. Module parameters come from a
flax init, every leaf perturbed with seeded noise (the zero-initialized
biases and noise strengths would otherwise hide whole terms), and are
carried across by ``waldo_tpu_torch.convert.mat_from_jax``.
Tolerance: max|err| <= 1e-4 * max|want| in float32, the repo's net
tolerance (ROADMAP.md).
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.ops.bias_act import bias_act as jbias_act
from waldo_tpu.ops.pallas.bias_act import bias_act_pallas
from waldo_tpu.models.mat import basic as jbasic
from waldo_tpu.models.mat import mat as jmat

from waldo_tpu_torch.convert import mat_from_jax
from waldo_tpu_torch.nn import init_module
from waldo_tpu_torch.models.mat import basic as tbasic
from waldo_tpu_torch.models.mat import mat as tmat
from waldo_tpu_torch.ops import upfirdn2d as tufd
from waldo_tpu_torch.ops.bias_act import _ACTS, bias_act, bias_act_plain

REL = 1e-4
# the module, which waldo_tpu.ops shadows with its function of the same name
jufd = importlib.import_module("waldo_tpu.ops.upfirdn2d")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _check(got, want, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{name}: max|err| {err:.3g} > {REL} * {scale:.3g}"


def _perturbed(variables, seed=1, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + np.asarray(rng.randn(*np.shape(a)) * scale, np.float32),
        variables)


def _flax_and_port(jmod, tmod, *args):
    """Init the flax module on ``args``, perturb, carry into the port's
    module; returns the variables (numpy) and the port module."""
    variables = jax.jit(lambda k, *a: jmod.init({"params": k, "noise": k}, *a))(
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args])
    variables = _perturbed(variables)
    mat_from_jax(variables, tmod)
    return variables, tmod.eval()


# ---------------------------------------------------------------------------
# bias_act (K3's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", sorted(_ACTS))
def test_bias_act_plain_matches_jax_and_pallas(act):
    """Each activation at its default gain, with an explicit gain and a
    clamp, and with b=None, on a ragged channel-last shape, against the JAX
    XLA path and bias_act_pallas in interpret mode."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 37, 20) * 3).astype(np.float32)
    b = rng.randn(20).astype(np.float32)
    for kw in ({}, {"gain": 0.7, "clamp": 1.5}, {"gain": 2.0, "clamp": -1.0}):
        for bias in (b, None):
            jb = None if bias is None else jnp.asarray(bias)
            want = jbias_act(jnp.asarray(x), jb, act=act, **kw)
            gain = kw.get("gain", _ACTS[act][1])
            want_pal = bias_act_pallas(jnp.asarray(x), jb, act=act, gain=gain,
                                       clamp=kw.get("clamp"), interpret=True)
            got = bias_act(_t(x), None if bias is None else _t(bias), act=act, **kw)
            label = f"{act} {kw} bias={bias is not None}"
            _check(got, want, label + " vs xla")
            _check(got, want_pal, label + " vs pallas")


def test_bias_act_plain_other_dim():
    """The plain version broadcasts the bias along any axis, as the JAX
    function does (the kernel is channel-last only)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 7).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want = jbias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act="lrelu", clamp=0.8)
    got = bias_act_plain(_t(x), _t(b), dim=1, act="lrelu", gain=_ACTS["lrelu"][1], clamp=0.8)
    _check(got, want, "dim=1")


# ---------------------------------------------------------------------------
# upfirdn2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["up", "down", "filter", "crop", "identity_stride"])
def test_upfirdn2d_matches_jax(case):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, 14, 3).astype(np.float32)
    f = jufd.setup_filter([1, 3, 3, 1])
    np.testing.assert_array_equal(f, tufd.setup_filter([1, 3, 3, 1]))
    if case == "up":
        want = jufd.upsample2d(jnp.asarray(x), jnp.asarray(f))
        got = tufd.upsample2d(_t(x), f)
    elif case == "down":
        want = jufd.downsample2d(jnp.asarray(x), jnp.asarray(f))
        got = tufd.downsample2d(_t(x), f)
    elif case == "filter":
        want = jufd.filter2d(jnp.asarray(x), jnp.asarray(f), padding=1)
        got = tufd.filter2d(_t(x), f, padding=1)
    elif case == "crop":  # negative padding crops; up 2 with asymmetric pads
        want = jufd.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=2, padding=(-1, 2, 1, -2),
                              gain=4)
        got = tufd.upfirdn2d(_t(x), f, up=2, padding=(-1, 2, 1, -2), gain=4)
    else:
        want = jufd.upfirdn2d(jnp.asarray(x), None, down=2, padding=1)
        got = tufd.upfirdn2d(_t(x), None, down=2, padding=1)
    _check(got, want, case)


# ---------------------------------------------------------------------------
# basic modules
# ---------------------------------------------------------------------------

def test_fully_connected_layer():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 9, 24).astype(np.float32)
    jm = jbasic.FullyConnectedLayer(16, activation="lrelu", lr_multiplier=0.5, bias_init=0.3)
    v, tm = _flax_and_port(jm, tbasic.FullyConnectedLayer(24, 16, activation="lrelu",
                                                          lr_multiplier=0.5, bias_init=0.3), x)
    with torch.no_grad():
        _check(tm(_t(x)), jm.apply(v, jnp.asarray(x)), "fc")


@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2)])
def test_conv2d_layer(up, down):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 12, 10, 6).astype(np.float32)
    jm = jbasic.Conv2dLayer(8, 3, activation="lrelu", up=up, down=down, conv_clamp=0.9)
    tm = tbasic.Conv2dLayer(6, 8, 3, activation="lrelu", up=up, down=down, conv_clamp=0.9)
    v, tm = _flax_and_port(jm, tm, x)
    with torch.no_grad():
        _check(tm(_t(x), gain=0.8), jm.apply(v, jnp.asarray(x), gain=0.8), f"conv up{up} down{down}")


@pytest.mark.parametrize("up,demodulate", [(1, True), (2, True), (1, False)])
def test_modulated_conv2d(up, demodulate):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    s = rng.randn(2, 11).astype(np.float32)
    jm = jbasic.ModulatedConv2d(7, 3, demodulate=demodulate, up=up)
    tm = tbasic.ModulatedConv2d(5, 7, 3, 11, demodulate=demodulate, up=up)
    v, tm = _flax_and_port(jm, tm, x, s)
    with torch.no_grad():
        _check(tm(_t(x), _t(s)), jm.apply(v, jnp.asarray(x), jnp.asarray(s)), "modconv")


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_style_conv(noise_mode):
    rng = np.random.RandomState(6)
    x = rng.randn(1, 8, 8, 5).astype(np.float32)
    s = rng.randn(1, 11).astype(np.float32)
    jm = jbasic.StyleConv(6, 3, up=2)
    tm = tbasic.StyleConv(5, 6, 11, 16, 3, up=2)
    v = jax.jit(lambda k, a, b: jm.init({"params": k}, a, b, noise_mode="const"))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(s))
    v = _perturbed(v)
    mat_from_jax(v, tm)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(s), noise_mode=noise_mode)
    with torch.no_grad():
        _check(tm(_t(x), _t(s), noise_mode=noise_mode), want, f"styleconv {noise_mode}")


def test_to_rgb_with_skip():
    rng = np.random.RandomState(7)
    x = rng.randn(1, 8, 8, 5).astype(np.float32)
    s = rng.randn(1, 11).astype(np.float32)
    skip = rng.randn(1, 4, 4, 3).astype(np.float32)
    jm = jbasic.ToRGB(3)
    v, tm = _flax_and_port(jm, tbasic.ToRGB(5, 3, 11), x, s, skip)
    with torch.no_grad():
        _check(tm(_t(x), _t(s), _t(skip)),
               jm.apply(v, jnp.asarray(x), jnp.asarray(s), jnp.asarray(skip)), "torgb")


def test_conv2d_layer_partial_up_with_mask():
    """The partial conv's mask path with the nearest x2 upsample of the
    coverage map."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 8, 8, 6).astype(np.float32)
    mask = (rng.rand(1, 8, 8, 1) > 0.4).astype(np.float32)
    jm = jmat.Conv2dLayerPartial(6, 3, activation="lrelu", up=2)
    v, tm = _flax_and_port(jm, tmat.Conv2dLayerPartial(6, 6, 3, activation="lrelu", up=2),
                           x, mask)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(_t(x), _t(mask))
    _check(got[0], want[0], "x")
    _check(got[1], want[1], "mask")


def test_swin_block_shifted_with_mask():
    """A shifted Swin block on a 16x16 map with windows of 8 and a partial
    mask: the roll order, the -100 region mask, the -100 key mask and the
    mask update."""
    rng = np.random.RandomState(9)
    h = w = 16
    x = rng.randn(1, h * w, 24).astype(np.float32)
    mask = (rng.rand(1, h * w, 1) > 0.5).astype(np.float32)
    mask[:, :64] = 0.0  # whole windows with no valid key
    jm = jmat.SwinBlock(24, (h, w), 4, 8, shift_size=4)
    v = jax.jit(lambda k, a, m: jm.init({"params": k}, a, (h, w), m))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    v = _perturbed(v)
    tm = tmat.SwinBlock(24, 4, 8, shift_size=4)
    mat_from_jax(v, tm)
    want = jm.apply(v, jnp.asarray(x), (h, w), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(_t(x), (h, w), _t(mask))
    _check(got[0], want[0], "x")
    _check(got[1], want[1], "mask")


def test_random_noise_mode_draws_from_the_callers_generator():
    """noise_mode="random" (noise planes and the Bernoulli style-token map)
    draws from an explicit torch.Generator and refuses to run without one;
    the JAX package's draws come from its own PRNG, so only the port is
    checked here."""
    rng = np.random.RandomState(12)
    x, s = _t(rng.randn(1, 8, 8, 5)), _t(rng.randn(1, 11))
    tm = tbasic.StyleConv(5, 6, 11, 16, 3, up=2)
    init_module(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm.noise_strength.fill_(0.5)
        with pytest.raises(ValueError, match="torch.Generator"):
            tm(x, s, noise_mode="random")
        a = tm(x, s, noise_mode="random", generator=torch.Generator().manual_seed(1))
        b = tm(x, s, noise_mode="random", generator=torch.Generator().manual_seed(1))
        c = tm(x, s, noise_mode="const")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-3
    m = tmat._mul_map(torch.zeros(2, 64, 3), "random", torch.Generator().manual_seed(2))
    assert set(m.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(tmat._mul_map(torch.zeros(2, 3), "const", None), torch.full((2, 3), 0.5))


# ---------------------------------------------------------------------------
# the whole generator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generator_128():
    res = 128
    rng = np.random.RandomState(11)
    x = (rng.rand(1, res, res, 3) * 2 - 1).astype(np.float32)
    keep = np.ones((1, res, res, 1), np.float32)
    keep[:, 30:90, 40:100] = 0.0
    z = rng.randn(1, 512).astype(np.float32)
    jnet = jmat.Generator(img_resolution=res)
    v = jax.jit(lambda k1, k2, *a: jnet.init({"params": k1, "noise": k2}, *a,
                                             noise_mode="const"))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(keep),
        jnp.asarray(z))
    v = _perturbed(v)
    want = jax.jit(lambda v, a, m, zz: jnet.apply(v, a, m, zz, truncation_psi=0.5,
                                                  noise_mode="const"))(v, x, keep, z)
    tnet = tmat.Generator(img_resolution=res)
    mat_from_jax(v, tnet)
    with torch.no_grad():
        got = tnet.eval()(_t(x), _t(keep), _t(z), truncation_psi=0.5, noise_mode="const")
    return x, keep, np.asarray(want), got.numpy()


def test_generator_128_matches_jax(generator_128):
    x, keep, want, got = generator_128
    _check(got, want, "generator")


def test_generator_128_keeps_valid_pixels(generator_128):
    x, keep, want, got = generator_128
    k = keep[0, :, :, 0] > 0.5
    np.testing.assert_allclose(got[0][k], x[0][k], atol=1e-6)
    assert np.abs(got[0][~k] - x[0][~k]).max() > 1e-3  # the hole was filled


def test_mat_from_jax_is_strict():
    jm = jbasic.FullyConnectedLayer(4)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3))))
    tm = tbasic.FullyConnectedLayer(3, 4)
    with pytest.raises(ValueError, match="no port entry"):
        mat_from_jax({"params": {**v["params"], "scale": np.ones(4, np.float32)}}, tm)
    with pytest.raises(ValueError, match="no leaf fills"):
        mat_from_jax({"params": {"weight": v["params"]["weight"]}}, tm)
    with pytest.raises(ValueError, match="does not fit"):
        mat_from_jax({"params": {**v["params"], "bias": np.ones(5, np.float32)}}, tm)

"""The port's VGG19 perceptual loss (waldo_tpu_torch/nn/perceptual.py)
against the JAX package's (waldo_tpu/nn/perceptual.py) on the CPU: the
features and the weighted feature L1, and its gradient (torch's native CPU
convolutions: its oneDNN backward is 2.4e-3 off float64), on one seeded
random npz in the JAX package's layout read by both ``maybe_load``s through
WALDO_VGG_WEIGHTS, at 2 x 32 x 64 and 1e-4 relative (float32 convolutions
summed in other orders); a flax VGG19Features tree through
``convert.vgg19_from_jax``; the torchvision state-dict converter's round
trip and its refusals.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.nn import perceptual as jperc

from waldo_tpu_torch.nn import perceptual as tperc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-4


def _conv_shapes():
    shapes, cin = [], 3
    for item in tperc._VGG19_LAYOUT:
        if item != "P":
            shapes.append((3, 3, cin, item))
            cin = item
    return shapes


def write_random_vgg19(path, seed=0):
    """Seeded random VGG19 weights in the JAX package's npz layout:
    He-scaled kernels (kh, kw, I, O), small biases."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for i, (kh, kw, ci, co) in enumerate(_conv_shapes()):
        arrays[f"conv{i}_kernel"] = (rng.randn(kh, kw, ci, co)
                                     * np.sqrt(2.0 / (kh * kw * ci))).astype(np.float32)
        arrays[f"conv{i}_bias"] = (rng.randn(co) * 0.01).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


def _pair(seed=1, shape=(2, 32, 64, 3)):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + rng.randn(*shape).astype(np.float32) * 0.3, -1, 1)
    return a, b


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= RTOL * scale, float(np.abs(got - want).max())


def test_vgg_loss_matches_jax(tmp_path, monkeypatch):
    """The loss, and its gradient in x, on (2, 32, 64, 3) frames; the target's
    features carry no gradient on either side."""
    monkeypatch.setenv("WALDO_VGG_WEIGHTS", str(tmp_path))
    write_random_vgg19(str(tmp_path / "vgg19_features.npz"))
    a, b = _pair()
    jl = jperc.VGGLoss.maybe_load()
    want, (gx_want, gy_want) = jax.value_and_grad(lambda x, y: jl(x, y), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    port = tperc.VGGLoss.maybe_load(device="cpu")
    assert port is not None and not any(p.requires_grad for p in port.parameters())
    x = torch.from_numpy(a).requires_grad_()
    y = torch.from_numpy(b).requires_grad_()
    # torch's oneDNN (mkldnn) convolution backward on the CPU is 2.4e-3 of
    # the gradient's largest off its float64 value here; the native one is
    # 5e-7 off, as JAX's is
    with torch.backends.mkldnn.flags(enabled=False):
        got = port(x, y)
        got.backward()
    assert got.shape == ()
    _close(got.detach().numpy(), want)
    _close(x.grad.numpy(), gx_want)
    assert float(np.abs(np.asarray(gy_want)).max()) == 0.0 and y.grad is None
    assert float(port(x, x)) == 0.0


def test_vgg19_features_match_jax(tmp_path, monkeypatch):
    """The five taps (relu1_1 ... relu5_1), channel-first in the port."""
    monkeypatch.setenv("WALDO_VGG_WEIGHTS", str(tmp_path))
    write_random_vgg19(str(tmp_path / "vgg19_features.npz"))
    a, _ = _pair(seed=3)
    jl = jperc.VGGLoss.maybe_load()
    want = jl.module.apply(jl.params, jnp.asarray(a))
    port = tperc.VGGLoss.maybe_load(device="cpu")
    got = port.features(torch.from_numpy(a).permute(0, 3, 1, 2))
    assert [f.shape[1] for f in got] == [64, 128, 256, 512, 512]
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)


def test_vgg19_from_jax_tree():
    """A flax VGG19Features tree (JAX's init) through convert.vgg19_from_jax:
    the features agree; a leaf without a port entry raises."""
    from waldo_tpu_torch.convert import vgg19_from_jax

    a, _ = _pair(seed=4, shape=(1, 32, 32, 3))
    net = jperc.VGG19Features()
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(a))
    want = net.apply(params, jnp.asarray(a))
    tree = jax.tree.map(np.asarray, params)
    port = tperc.VGG19Features()
    vgg19_from_jax(tree, port)
    got = port(torch.from_numpy(a).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        _close(g.detach().permute(0, 2, 3, 1).numpy(), w)
    tree["params"]["conv13"] = tree["params"]["conv12"]
    with pytest.raises(ValueError, match="no port entry"):
        vgg19_from_jax(tree, tperc.VGG19Features())


def test_convert_vgg19_state_dict_round_trip(tmp_path, monkeypatch):
    """A torchvision vgg19 state dict (features.<i>, every layer's index)
    converts to the JAX package's arrays; the file convert_vgg19_weights
    writes loads into convolutions equal to the state dict's."""
    rng = np.random.RandomState(2)
    sd = {}
    for idx, (kh, kw, ci, co) in zip(tperc.VGG19_TORCH_CONV_IDX, _conv_shapes()):
        sd[f"features.{idx}.weight"] = torch.from_numpy(rng.randn(co, ci, kh, kw).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.randn(co).astype(np.float32))
    got, want = tperc.convert_vgg19_state_dict(sd), jperc.convert_vgg19_state_dict(sd)
    assert sorted(got) == sorted(want) and len(got) == 26
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    monkeypatch.setenv("WALDO_VGG_WEIGHTS", str(tmp_path / "vgg"))
    path = tperc.VGGLoss.weights_path()
    pth = str(tmp_path / "vgg19.pth")
    torch.save(sd, pth)
    assert tperc.convert_vgg19_weights(path, pth) == path
    port = tperc.VGGLoss.maybe_load(device="cpu")
    for i, idx in enumerate(tperc.VGG19_TORCH_CONV_IDX):
        conv = getattr(port.features, f"conv{i}")
        assert torch.equal(conv.weight, sd[f"features.{idx}.weight"])
        assert torch.equal(conv.bias, sd[f"features.{idx}.bias"])
    del sd["features.28.bias"]
    with pytest.raises(KeyError, match="features.28.bias"):
        tperc.convert_vgg19_state_dict(sd)


def test_vgg_loss_without_weights(tmp_path, monkeypatch):
    """maybe_load is None without the file, at the JAX package's path; the
    converter never downloads: without a state dict it raises, naming the
    missing file."""
    monkeypatch.setenv("WALDO_VGG_WEIGHTS", str(tmp_path))
    assert tperc.VGGLoss.weights_path() == jperc.VGGLoss.weights_path() \
        == str(tmp_path / "vgg19_features.npz")
    assert tperc.VGGLoss.maybe_load(device="cpu") is None
    with pytest.raises(FileNotFoundError, match="vgg19-dcbb9e9d.pth"):
        tperc.convert_vgg19_weights(str(tmp_path / "out.npz"))
    with pytest.raises(FileNotFoundError, match="nowhere.pth"):
        tperc.convert_vgg19_weights(str(tmp_path / "out.npz"), str(tmp_path / "nowhere.pth"))
    assert not (tmp_path / "out.npz").exists()


def test_vgg_loss_asks_for_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    monkeypatch.setenv("WALDO_VGG_WEIGHTS", str(tmp_path))
    write_random_vgg19(str(tmp_path / "vgg19_features.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tperc.VGGLoss.maybe_load()

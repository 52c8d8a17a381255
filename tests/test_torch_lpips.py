"""The port's LPIPS (waldo_tpu_torch/eval/lpips.py) against the JAX package's,
on the CPU: VGG16 (WIF's training loss) and AlexNet (the metric) on the same
seeded random weights, written as the JAX package's npz under tmp_path and
read by both ``maybe_load``s through WALDO_LPIPS_WEIGHTS, to the nets'
tolerance (1e-4 relative); ``maybe_load`` without the file; the torch
``lpips`` state-dict converter against the JAX package's.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from waldo_tpu.eval import lpips as jlpips

from waldo_tpu_torch.eval import lpips as tlpips


def write_random_lpips(path, net, seed):
    """Seeded random LPIPS weights in the JAX package's npz layout: He-scaled
    conv kernels (kh,kw,I,O), small biases, positive lin heads."""
    rng = np.random.RandomState(seed)
    if net == "alex":
        shapes = [(k, k, cin, f) for (f, k, *_), cin in
                  zip(jlpips.ALEX_SPEC, [3] + [f for f, *_ in jlpips.ALEX_SPEC])]
    else:
        shapes, cin = [], 3
        for slice_i, n in enumerate(jlpips.VGG16_SPEC):
            ch = min(64 * 2 ** slice_i, 512)
            for _ in range(n):
                shapes.append((3, 3, cin, ch))
                cin = ch
    arrays, outs = {}, []
    for i, (kh, kw, ci, co) in enumerate(shapes):
        arrays[f"conv{i}_kernel"] = (rng.randn(kh, kw, ci, co)
                                     * np.sqrt(2.0 / (kh * kw * ci))).astype(np.float32)
        arrays[f"conv{i}_bias"] = (rng.randn(co) * 0.01).astype(np.float32)
        outs.append(co)
    if net == "vgg":  # the slices' last convolutions feed the lin heads
        ends = np.cumsum(jlpips.VGG16_SPEC) - 1
        outs = [outs[e] for e in ends]
    for i, c in enumerate(outs):
        arrays[f"lin{i}"] = (rng.rand(c) * 0.1).astype(np.float32)
    np.savez(path, **arrays)


@pytest.mark.parametrize("net,hw", [("vgg", (32, 64)), ("alex", (64, 64))])
def test_lpips_matches_jax(tmp_path, monkeypatch, net, hw):
    monkeypatch.setenv("WALDO_LPIPS_WEIGHTS", str(tmp_path))
    write_random_lpips(str(tmp_path / f"lpips_{net}.npz"), net, seed=0)
    rng = np.random.RandomState(1)
    a = rng.uniform(-1, 1, (2, 3) + hw + (3,)).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.3, -1, 1)
    want = np.asarray(jlpips.LPIPS.maybe_load(net)(jnp.asarray(a), jnp.asarray(b)))
    port = tlpips.LPIPS.maybe_load(net, device="cpu")
    assert port is not None and not any(p.requires_grad for p in port.parameters())
    got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 3)
    assert float(np.abs(want).min()) > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_lpips_maybe_load_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("WALDO_LPIPS_WEIGHTS", str(tmp_path))
    assert tlpips.LPIPS.weights_path("vgg") == jlpips.LPIPS.weights_path("vgg") \
        == str(tmp_path / "lpips_vgg.npz")
    assert tlpips.LPIPS.maybe_load("vgg", device="cpu") is None
    assert tlpips.LPIPS.maybe_load("alex", device="cpu") is None


def test_lpips_asks_for_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    monkeypatch.setenv("WALDO_LPIPS_WEIGHTS", str(tmp_path))
    write_random_lpips(str(tmp_path / "lpips_alex.npz"), "alex", seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlpips.LPIPS.maybe_load("alex")


def test_convert_lpips_state_dict_matches_jax():
    """A torch lpips-package state dict (AlexNet's torchvision indices within
    each slice) converts to the JAX package's arrays."""
    rng = np.random.RandomState(2)
    sd, chans = {}, [3] + [f for f, *_ in jlpips.ALEX_SPEC]
    idx = [(1, 0), (2, 3), (3, 6), (4, 8), (5, 10)]
    for i, ((f, k, *_), (sl, j)) in enumerate(zip(jlpips.ALEX_SPEC, idx)):
        sd[f"net.slice{sl}.{j}.weight"] = torch.from_numpy(
            rng.randn(f, chans[i], k, k).astype(np.float32))
        sd[f"net.slice{sl}.{j}.bias"] = torch.from_numpy(rng.randn(f).astype(np.float32))
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(rng.rand(1, f, 1, 1).astype(np.float32))
    got, want = tlpips.convert_lpips_state_dict(sd), jlpips.convert_lpips_state_dict(sd)
    assert set(got) == set(want) and len(got) == 15
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    del sd["lin4.model.1.weight"]
    with pytest.raises(ValueError, match="5 lin heads"):
        tlpips.convert_lpips_state_dict(sd)

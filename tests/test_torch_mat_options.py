"""MAT's options in the port (waldo_tpu_torch/models/mat) against the JAX
package, on the CPU: ``truncation_cutoff`` and ``update_w_avg`` in
``MappingNet``, ``return_stg1`` through ``Generator`` and ``SynthesisNet``,
and ``use_bias=False`` in ``FullyConnectedLayer`` and ``Conv2dLayer``.

Inputs are numpy arrays from a seed. The layers' weights come from a flax
init, perturbed, carried across by ``convert.mat_from_jax`` (the bias-free
layers have no "bias" leaf on either side); the generator at 128 takes the
port's seeded init, perturbed, written out as the flax tree (the inverse of
``mat_from_jax``, checked by a round trip), and the JAX side runs its
``MappingNet`` and ``SynthesisNet`` on it, since the JAX ``Generator``
passes neither option on. Tolerance: tests/test_torch_mat.py's, max|err| <=
1e-4 * max|want| in float32.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.models.mat import basic as jbasic
from waldo_tpu.models.mat import mat as jmat

from waldo_tpu_torch.convert import mat_from_jax
from waldo_tpu_torch.models.mat import basic as tbasic
from waldo_tpu_torch.models.mat import mat as tmat
from waldo_tpu_torch.models.mat.convert import convert_state_dict, module_template
from waldo_tpu_torch.nn import init_module
from test_torch_mat import _check, _flax_and_port, _t
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RES = 128


def _to_flax(module):
    """The port MAT module's state as the flax variables (nested dicts of
    numpy arrays): the inverse of mat_from_jax's layouts and names."""
    tree = {}
    for key, t in module.state_dict().items():
        parts = key.split(".")
        if parts[-1] == "resample_filter":
            continue
        a = t.detach().numpy().astype(np.float32)
        if key == "mapping.w_avg":
            col = "w_stats"
        elif parts[-1] == "noise_const":
            col, parts = "noise_const", parts[:-1] + ["n"]
        else:
            col = "params"
            if parts[-1] == "weight" and a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif parts[-1] == "weight" and a.ndim == 2:
                a = a.T
        node = tree.setdefault(col, {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a.copy()
    return tree


@pytest.fixture(scope="module")
def generator():
    """A port Generator at 128, seeded and perturbed (w_avg too), its flax
    variables, and one clip: image, mask with a hole, z for two samples."""
    tnet = tmat.Generator(img_resolution=RES)
    init_module(tnet, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in list(tnet.parameters()) + [tnet.mapping.w_avg]:
            t.add_(torch.randn(t.shape, generator=g) * 0.02)
    rng = np.random.RandomState(11)
    x = (rng.rand(2, RES, RES, 3) * 2 - 1).astype(np.float32)
    keep = np.ones((2, RES, RES, 1), np.float32)
    keep[:, 30:90, 40:100] = 0.0
    z = rng.randn(2, 512).astype(np.float32)
    return tnet.eval(), _to_flax(tnet), x, keep, z


def test_flax_tree_round_trips(generator):
    tnet, v, *_ = generator
    other = tmat.Generator(img_resolution=RES)
    mat_from_jax(v, other)
    for k, t in tnet.state_dict().items():
        assert torch.equal(t, other.state_dict()[k]), k


def test_generator_options_match_jax(generator):
    """truncation_psi 0.5 with truncation_cutoff 3, update_w_avg and
    return_stg1 on a clip of two samples: the images, the first stage's
    images and the updated w_avg against JAX's MappingNet (its "w_stats"
    mutable) and SynthesisNet; the options off give the plain forward."""
    tnet, v, x, keep, z = generator
    num_ws = tnet.mapping.num_ws
    jmap = jbasic.MappingNet(512, 512, num_ws)
    jsyn = jmat.SynthesisNet(512, RES, 3)

    def jax_forward(v, x, keep, z):
        ws, stats = jmap.apply({"params": v["params"]["mapping"],
                                "w_stats": v["w_stats"]["mapping"]}, z, truncation_psi=0.5,
                               truncation_cutoff=3, update_w_avg=True, mutable=["w_stats"])
        img, stg1 = jsyn.apply({"params": v["params"]["synthesis"],
                                "noise_const": v["noise_const"]["synthesis"]}, x, keep, ws,
                               noise_mode="const", return_stg1=True)
        return img, stg1, stats["w_stats"]["w_avg"], ws

    img_w, stg1_w, w_avg_w, ws_w = jax.jit(jax_forward)(v, x, keep, z)
    before = tnet.mapping.w_avg.clone()
    try:
        with torch.no_grad():
            ws = tnet.mapping(_t(z), truncation_psi=0.5, truncation_cutoff=3,
                              update_w_avg=False)
            tnet.mapping.w_avg.copy_(before)
            img, stg1 = tnet(_t(x), _t(keep), _t(z), truncation_psi=0.5, noise_mode="const",
                             truncation_cutoff=3, update_w_avg=True, return_stg1=True)
            w_avg = tnet.mapping.w_avg.clone()
            tnet.mapping.w_avg.copy_(before)
            plain = tnet(_t(x), _t(keep), _t(z), noise_mode="const")
            again = tnet.synthesis(_t(x), _t(keep), tnet.mapping(_t(z)), noise_mode="const")
    finally:
        tnet.mapping.w_avg.copy_(before)
    _check(w_avg, w_avg_w, "w_avg")
    assert float((w_avg - before).abs().max()) > 1e-4  # the update moved it
    _check(img, img_w, "img")
    _check(stg1, stg1_w, "stg1")
    # the cutoff: ws past it are the mapping's own, before it truncated
    ws_w = np.asarray(ws_w)
    assert np.abs(ws_w[:, 3:] - ws_w[:, 3:4]).max() == 0.0
    assert float((ws[:, 3] - ws[:, 2]).abs().max()) > 1e-4
    assert torch.equal(plain, again)


def test_mapping_truncation_cutoff_and_update(generator):
    """MappingNet alone: psi 0.7 with and without a cutoff, w_avg updated in
    place as the JAX package's mutable "w_stats" is, twice in a row."""
    tnet, v, _, _, z = generator
    jmap = jbasic.MappingNet(512, 512, tnet.mapping.num_ws)
    mapping = tbasic.MappingNet(512, 512, tnet.mapping.num_ws)
    mat_from_jax({"params": v["params"]["mapping"], "w_stats": v["w_stats"]["mapping"]}, mapping)
    stats = v["w_stats"]["mapping"]
    for cutoff in (None, 5):
        ws_w, new = jmap.apply({"params": v["params"]["mapping"], "w_stats": stats}, z,
                               truncation_psi=0.7, truncation_cutoff=cutoff, update_w_avg=True,
                               mutable=["w_stats"])
        with torch.no_grad():
            ws = mapping(_t(z), truncation_psi=0.7, truncation_cutoff=cutoff, update_w_avg=True)
        _check(ws, ws_w, f"ws cutoff {cutoff}")
        stats = new["w_stats"]
        _check(mapping.w_avg, stats["w_avg"], f"w_avg cutoff {cutoff}")


@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_fully_connected_layer_without_bias(act):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 9, 24).astype(np.float32)
    jm = jbasic.FullyConnectedLayer(16, use_bias=False, activation=act, lr_multiplier=0.5)
    tm = tbasic.FullyConnectedLayer(24, 16, activation=act, lr_multiplier=0.5, use_bias=False)
    assert tm.bias is None and sorted(tm.state_dict()) == ["weight"]
    v, tm = _flax_and_port(jm, tm, x)
    assert sorted(v["params"]) == ["weight"]
    with torch.no_grad():
        _check(tm(_t(x)), jm.apply(v, jnp.asarray(x)), f"fc {act} without bias")


@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2)])
def test_conv2d_layer_without_bias(up, down):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 12, 10, 6).astype(np.float32)
    jm = jbasic.Conv2dLayer(8, 3, use_bias=False, activation="lrelu", up=up, down=down,
                            conv_clamp=0.9)
    tm = tbasic.Conv2dLayer(6, 8, 3, activation="lrelu", up=up, down=down, conv_clamp=0.9,
                            use_bias=False)
    v, tm = _flax_and_port(jm, tm, x)
    assert sorted(v["params"]) == ["weight"]
    with torch.no_grad():
        _check(tm(_t(x), gain=0.8), jm.apply(v, jnp.asarray(x), gain=0.8),
               f"conv up{up} down{down} without bias")


def test_converters_take_bias_free_layers():
    """A torch-style state dict of bias-free layers (no "bias" key, as the
    reference's layers built with bias=False save it) converts against the
    module's template and loads by mat_from_jax; a stray bias, and a
    layer's missing one, are refused by both."""
    mod = torch.nn.Module()
    mod.fc = tbasic.FullyConnectedLayer(5, 7, use_bias=False)
    mod.conv = tbasic.Conv2dLayer(3, 4, 3, use_bias=False)
    mod.fc_b = tbasic.FullyConnectedLayer(5, 2)
    init_module(mod, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in mod.state_dict().items() if "resample_filter" not in k}
    tree = convert_state_dict(sd, template=module_template(mod))
    other = torch.nn.Module()
    other.fc = tbasic.FullyConnectedLayer(5, 7, use_bias=False)
    other.conv = tbasic.Conv2dLayer(3, 4, 3, use_bias=False)
    other.fc_b = tbasic.FullyConnectedLayer(5, 2)
    mat_from_jax(tree, other)
    for k, t in mod.state_dict().items():
        assert torch.equal(t, other.state_dict()[k]), k
    with pytest.raises(ValueError, match="extra"):
        convert_state_dict({**sd, "fc.bias": np.zeros(7, np.float32)},
                           template=module_template(mod))
    with pytest.raises(ValueError, match="no port entry"):
        mat_from_jax({"params": {**tree["params"], "conv": {**tree["params"]["conv"],
                                                            "bias": np.zeros(4, np.float32)}}},
                     other)
    with pytest.raises(ValueError, match="no leaf fills"):
        mat_from_jax({"params": {**tree["params"], "fc_b": {"weight": tree["params"]["fc_b"]
                                                                      ["weight"]}}}, other)

"""The weight converters of the port against the JAX package's, on the CPU:
the reference's core-net checkpoints ({pe,pg,ii}_net_*.pth) and the MAT
persistence pickle. No reference checkpoint or pickle is in the repository,
so the fixtures are written here: a state dict under the rule tables' torch
names with random values (the layouts the rules expect) and the buffers the
JAX converter checks, and a persistence pickle written as the reference's
are (chip_smoke.write_mat_pickle). Every comparison is exact.
"""
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import waldo_tpu.models.convert as jconv
import waldo_tpu.models.mat.convert as jmat
from waldo_tpu.config import to_dict
from waldo_tpu.models import Synthesizer as JaxSynthesizer

import waldo_tpu_torch.models.convert as tconv
import waldo_tpu_torch.models.mat.convert as tmat
from waldo_tpu_torch.config import flagship_cfg, from_dict
from waldo_tpu_torch.convert import from_jax
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.models.mat import Generator

import chip_smoke
from test_torch_nets import tiny_cfg

NETS = ("pe", "pg", "ii")


def _torch_shape(shape, kind):
    """The torch layout's shape of a flax leaf of ``shape``."""
    if kind == "dense":
        return shape[::-1]
    if kind == "conv":
        return (shape[3], shape[2], shape[0], shape[1])
    if kind == "deconv":
        return (shape[2], shape[3], shape[0], shape[1])
    return shape


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_rule_tables_equal_jax(which):
    cfg = tiny_cfg() if which == "tiny" else flagship_cfg()
    tcfg = from_dict(to_dict(cfg)) if which == "tiny" else cfg
    for net in NETS:
        assert tconv._RULES[net](tcfg) == jconv._RULES[net](cfg), net


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """A reference run dir of the tiny config: {pe,pg,ii}_net_7.pth with
    random parameters under the rules' names, JAX's expected buffers, a
    warper grid buffer and DDP's "module." prefix on ii's keys."""
    cfg = tiny_cfg()
    template = jax.eval_shape(JaxSynthesizer(cfg).init_params, jax.random.PRNGKey(0))
    root = tmp_path_factory.mktemp("ref")
    rng = np.random.RandomState(0)
    sds = {}
    for net in NETS:
        leaves = {"/".join(str(p.key) for p in path[1:]): leaf.shape for path, leaf in
                  jax.tree_util.tree_flatten_with_path(template[net])[0]}
        sd = {tkey: rng.randn(*_torch_shape(leaves[fpath], kind)).astype(np.float32)
              for tkey, fpath, kind in jconv._RULES[net](cfg)}
        sd.update(jconv.expected_buffers(cfg, net))
        if net == "pe":
            sd["warper.src_grid"] = rng.rand(4, 8, 2).astype(np.float32)
        prefix = "module." if net == "ii" else ""
        torch.save({prefix + k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()}, root / f"{net}_net_7.pth")
        sds[net] = sd
    return cfg, str(root), sds


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_checkpoints_convert_equal_jax(reference_dir):
    cfg, root, _ = reference_dir
    want = jconv.convert_reference_checkpoints(root, 7, cfg)
    got = tconv.convert_reference_checkpoints(root, 7, from_dict(to_dict(cfg)))
    assert sorted(got) == sorted(want) == sorted(NETS)
    for net in NETS:
        g, w = _flat(got[net]), _flat(want[net])
        assert sorted(g) == sorted(w), net
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{net} {k}")


def test_load_reference_checkpoints_equal_jax_converter(reference_dir):
    """The port's loader fills a synthesizer with the parameters that JAX's
    convert_reference_net -> from_jax gives."""
    cfg, root, sds = reference_dir
    tcfg = from_dict(to_dict(cfg))
    want = Synthesizer(tcfg, device="cpu")
    from_jax({net: {"params": jconv.convert_reference_net(sds[net], cfg, net)}
              for net in NETS}, want)
    got = Synthesizer(tcfg, device="cpu", seed=5)
    tconv.load_reference_checkpoints(got, root, 7)
    for net, module in want.nets().items():
        theirs = dict(got.nets()[net].named_parameters())
        for k, p in module.named_parameters():
            assert torch.equal(theirs[k], p), (net, k)


def test_load_reference_checkpoints_is_strict(reference_dir, tmp_path):
    cfg, root, sds = reference_dir
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    with pytest.raises(FileNotFoundError):
        tconv.load_reference_checkpoints(syn, root, 8)
    for net in NETS:
        sd = dict(sds[net])
        if net == "pg":
            sd["decode.extra_head.weight"] = np.ones(3, np.float32)
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   tmp_path / f"{net}_net_1.pth")
    with pytest.raises(ValueError, match="decode.extra_head.weight"):
        tconv.load_reference_checkpoints(syn, str(tmp_path), 1)


@pytest.mark.parametrize("key", ["pose_estimator.bias", "decode.mul_obj"])
def test_verify_buffers_raises_on_the_same_tampered_key(reference_dir, key):
    cfg, _, sds = reference_dir
    net = "pe" if key.startswith("pose") else "pg"
    sd = dict(sds[net])
    sd[key] = sd[key] + 0.5
    with pytest.raises(ValueError, match=key):
        jconv.verify_buffers(sd, cfg, net)
    with pytest.raises(ValueError, match=key):
        tconv.verify_buffers(sd, from_dict(to_dict(cfg)), net)
    assert tconv.verify_buffers(sds["pe"], from_dict(to_dict(cfg)), "pe") == \
        jconv.verify_buffers(sds["pe"], cfg, "pe")


# ---------------------------------------------------------------------------
# MAT
# ---------------------------------------------------------------------------

MAT_CASES = {
    "mapping.fc0.weight": ("params", ("mapping", "fc0", "weight")),
    "mapping.w_avg": ("w_stats", ("mapping", "w_avg")),
    "synthesis.first_stage.conv_first.conv.weight":
        ("params", ("synthesis", "first_stage", "conv_first", "conv", "weight")),
    "synthesis.first_stage.enc_conv.0.conv.bias":
        ("params", ("synthesis", "first_stage", "enc_conv0", "conv", "bias")),
    "synthesis.first_stage.tran.1.downsample.conv.conv.weight":
        ("params", ("synthesis", "first_stage", "tran1", "downsample", "conv", "conv", "weight")),
    "synthesis.first_stage.tran.3.downsample.conv.conv.weight":
        ("params", ("synthesis", "first_stage", "tran3", "upsample", "conv", "conv", "weight")),
    "synthesis.first_stage.tran.0.blocks.1.mlp.fc1.weight":
        ("params", ("synthesis", "first_stage", "tran0", "block1", "mlp_fc1", "weight")),
    "synthesis.first_stage.dec_conv.0.conv0.conv.affine.weight":
        ("params", ("synthesis", "first_stage", "dec_conv0", "conv0", "conv", "affine",
                    "weight")),
    "synthesis.enc.EncConv_Block_128x128.conv0.weight":
        ("params", ("synthesis", "enc", "b7", "conv0", "weight")),
    "synthesis.to_style.conv.2.bias": ("params", ("synthesis", "to_style", "conv2", "bias")),
    "synthesis.dec.Dec_32x32.conv1.noise_const":
        ("noise_const", ("synthesis", "dec", "Dec_32x32", "conv1", "n")),
    "synthesis.dec.Dec_16x16.toRGB.conv.weight":
        ("params", ("synthesis", "dec", "Dec_16x16", "toRGB", "conv", "weight")),
    "synthesis.first_stage.conv_first.conv.resample_filter": None,
    "synthesis.first_stage.tran.0.blocks.1.attn_mask": None,
}


@pytest.mark.parametrize("key", sorted(MAT_CASES))
def test_mat_key_map_cases(key):
    """tests/test_converters.py::test_torch_key_to_flax_mapping's cases."""
    assert tmat.torch_key_to_flax(key) == jmat.torch_key_to_flax(key) == MAT_CASES[key]


@pytest.fixture(scope="module")
def mat_sd():
    """The reference's state dict of a seeded random port MAT Generator at
    128 (chip_smoke.mat_reference_state_dict), and the port module."""
    from waldo_tpu_torch.nn import init_module

    net = Generator(img_resolution=128)
    init_module(net, torch.Generator().manual_seed(0))
    return net, chip_smoke.mat_reference_state_dict(net)


def test_mat_key_map_on_every_key_of_a_flax_tree(mat_sd):
    """Every leaf of JAX's MAT Generator tree is reached from exactly one
    torch key, by both packages' maps, and the port's template has the
    tree's paths and shapes."""
    from waldo_tpu.models.mat.mat import Generator as JaxGenerator

    res = 128
    tree = jax.eval_shape(lambda: JaxGenerator(img_resolution=res).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, res, res, 3)), jnp.ones((1, res, res, 1)), jnp.zeros((1, 512)),
        noise_mode="const"))
    want = {tuple(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    _, sd = mat_sd
    mapped = {}
    for key in sd:
        t = tmat.torch_key_to_flax(key)
        assert t == jmat.torch_key_to_flax(key), key
        if t is not None:
            assert (t[0],) + t[1] not in mapped, key
            mapped[(t[0],) + t[1]] = key
    assert sorted(mapped) == sorted(want)
    assert tmat._flat_shapes(tmat.generator_template(res)) == want


def test_mat_convert_state_dict_equal_jax(mat_sd):
    _, sd = mat_sd
    sd_np = {k: v.numpy() for k, v in sd.items()}
    got, want = tmat.convert_state_dict(sd_np), jmat.convert_state_dict(sd_np)
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert any(v.ndim == 5 for v in sd_np.values())  # the modulated convs' layout


def test_mat_pickle_loads_and_converts_without_torch_utils(mat_sd, tmp_path):
    """A persistence pickle read without torch_utils: both readers give the
    source state dict; convert_mat_weights' npz loads into a MatInpainter
    whose Generator holds the source's weights."""
    from waldo_tpu_torch.models.mat import MatInpainter

    net, sd = mat_sd
    pkl = str(tmp_path / "fixture.pkl")
    chip_smoke.write_mat_pickle(sd, pkl)
    assert "torch_utils" not in sys.modules
    got, want = tmat.load_network_pkl(pkl), jmat.load_network_pkl(pkl)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(want[k], sd[k].numpy(), err_msg=k)
    assert sorted(tmat.load_network_pkl(pkl, key="G")) == sorted(sd)
    out = tmat.convert_mat_weights(pkl, str(tmp_path / "mat_128.npz"), img_resolution=128)
    inp = MatInpainter(weights_path=out, resolution=128, device="cpu")
    theirs = net.state_dict()
    for k, v in inp.net.state_dict().items():
        assert torch.equal(v, theirs[k]), k
    with pytest.raises(ValueError, match="mismatch"):
        tmat.convert_mat_weights(pkl, str(tmp_path / "x.npz"), img_resolution=256)

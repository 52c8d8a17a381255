"""FID and FVD of the port against the JAX package's, on the CPU: the
Frechet functions, the resize of jax.image.resize, the Inception and I3D
extractors on weights carried across from flax, the BN-folding converters,
and the metrics CLI's ``fid`` / ``fvd`` on a tiny results tree.

Tolerances:
  Frechet functions: equal to 1e-9 relative (the same numpy and scipy
           calls on the same activations); 1e-6 with fewer samples than
           dimensions, where the port takes the trace term from the samples
           (eval/frechet.py) and the JAX package from a D x D square root.
  resize: 1e-6 on images in [0, 1]; 1.5e-6 for test.sh's 512x1024 ->
           299x299 downscale, where XLA's fused float32 arithmetic rounds
           some sample positions of jax.image.resize one step off the
           formula's (the port's weights differ from XLA's by up to 6.6e-7
           there, and a pixel sums ~3.4 of them per axis).
  nets: 1e-4 relative (models/convert.py's rule for nets).
  converters: exact.
  the CLI with one weight file for both: 1e-4 relative (the nets' 1e-6
           differences, and the two routes to the trace term). The CLI's
           fallbacks without weights are in tests/test_torch_metrics.py.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import waldo_tpu.eval.frechet as jfr
import waldo_tpu.eval.i3d as ji3d
import waldo_tpu.eval.inception as jinc
import waldo_tpu.eval.metrics as jmetrics

import waldo_tpu_torch.eval.frechet as tfr
import waldo_tpu_torch.eval.i3d as ti3d
import waldo_tpu_torch.eval.inception as tinc
import waldo_tpu_torch.eval.metrics as tmetrics
from waldo_tpu_torch.convert import i3d_from_jax, inception_from_jax



def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-12))


def test_frechet_functions_equal_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(40, 6), rng.randn(30, 6) * 1.3 + 0.2
    assert tfr.frechet_distance_from_acts(a, b) == pytest.approx(
        jfr.frechet_distance_from_acts(a, b), rel=1e-9)
    # fewer samples than dimensions: the port's trace from the samples
    for n1, n2, d in ((3, 3, 40), (9, 7, 300), (20, 30, 64)):
        a, b = rng.randn(n1, d) * 0.3 + 1, rng.randn(n2, d) * 0.35 + 1.1
        assert tfr.frechet_distance_from_acts(a, b) == pytest.approx(
            jfr.frechet_distance_from_acts(a, b), rel=1e-6)
    s = np.cov(a, rowvar=False)
    assert tfr.frechet_distance(a.mean(0), s, b.mean(0), s) == pytest.approx(
        jfr.frechet_distance(a.mean(0), s, b.mean(0), s), rel=1e-9, abs=1e-12)
    feat = lambda x: np.asarray(x).reshape(len(x), -1)[:, :5] * 2.0
    ra, rb = [rng.rand(4, 3, 3, 3) for _ in range(3)], [rng.rand(4, 3, 3, 3) for _ in range(3)]
    assert tfr.fid(feat, ra, rb) == pytest.approx(jfr.fid(feat, ra, rb), rel=1e-9)
    assert tfr.fid_videos(feat, ra, rb, batch=5) == pytest.approx(
        jfr.fid_videos(feat, ra, rb, batch=5), rel=1e-9)
    assert tfr.fvd_proxy(feat, ra, rb, batch=3) == pytest.approx(  # 3 videos, 10 features
        jfr.fvd_proxy(feat, ra, rb, batch=3), rel=1e-6)


@pytest.mark.parametrize("shape,tol", [((40, 64, 299, 299), 1e-6),
                                       ((96, 80, 75, 120), 1e-6),
                                       ((200, 120, 75, 80), 1e-6),
                                       ((512, 1024, 299, 299), 1.5e-6)])
def test_resize_equals_jax_image_resize(shape, tol):
    h, w, oh, ow = shape
    x = np.random.RandomState(1).rand(1, h, w, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, oh, ow, 3), "bilinear"))
    got = tinc.resize_bilinear(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


def random_tree(shapes, seed):
    """Seeded random numpy leaves (variance 1/fan-in, biases 0.01) in the
    structure of ``jax.eval_shape``'s tree."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if str(path[-1].key) == "bias":
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def inception():
    """JAX's InceptionV3Features with seeded random weights, and the port's
    holding the same."""
    mod = jinc.InceptionV3Features()
    params = random_tree(jax.eval_shape(mod.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 75, 75, 3))), 0)
    port = tinc.InceptionV3Features()
    inception_from_jax(params, port)
    return mod, params, port.eval()


def test_inception_features_equal_jax(inception):
    mod, params, port = inception
    x = np.random.RandomState(2).uniform(-1, 1, (2, 83, 77, 3)).astype(np.float32)
    want = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want) <= 1e-4


@pytest.fixture(scope="module")
def i3d():
    net = ji3d.I3D()
    params = random_tree(jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 9, 64, 64, 3)))["params"], 1)
    port = ti3d.I3D()
    i3d_from_jax(params, port)
    return net, params, port.eval()


def test_i3d_equals_jax(i3d):
    """At JAX's init shape, whose odd frame count and stride-2 layers pad
    asymmetrically under "SAME"."""
    net, params, port = i3d
    v = np.random.RandomState(3).uniform(-1, 1, (1, 9, 64, 64, 3)).astype(np.float32)
    want = jax.jit(net.apply)({"params": params}, jnp.asarray(v))
    with torch.no_grad():
        got = port(torch.from_numpy(v))
    for k, d in (("features", 1024), ("logits", 400)):
        assert got[k].shape == (1, d)
        assert _rel(got[k].numpy(), want[k]) <= 1e-4, k


def _tree_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


def inception_fixture_state_dict(params, seed=0):
    """torchvision's names and layouts, random values, under the paths of a
    flax InceptionV3Features tree (He-scaled convolutions, so the features
    do not fade through the 94 layers)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(p.key) for p in path]
        if keys[-1] != "kernel":
            continue
        base = ".".join(keys[1:-2])
        kh, kw, i, o = leaf.shape
        sd[f"{base}.conv.weight"] = (rng.randn(o, i, kh, kw)
                                     * np.sqrt(2.0 / (i * kh * kw))).astype(np.float32)
        sd[f"{base}.bn.weight"] = (1 + rng.randn(o) * 0.1).astype(np.float32)
        sd[f"{base}.bn.bias"] = (rng.randn(o) * 0.01).astype(np.float32)
        sd[f"{base}.bn.running_mean"] = (rng.randn(o) * 0.1).astype(np.float32)
        sd[f"{base}.bn.running_var"] = (1 + rng.rand(o)).astype(np.float32)
    sd["fc.weight"] = np.zeros((10, 2048), np.float32)
    return sd


def i3d_fixture_state_dict(rng):
    """pytorch-i3d's names and layouts (tests/test_i3d.py's fixture) with
    He-scaled convolutions, so that the logits do not fade to ~0."""
    sd = {}

    def unit(prefix, cin, cout, k):
        fan_in = cin * int(np.prod(k))
        sd[f"{prefix}.conv3d.weight"] = (rng.randn(cout, cin, *k)
                                         * np.sqrt(2.0 / fan_in)).astype(np.float32)
        sd[f"{prefix}.bn.weight"] = (1 + rng.randn(cout) * 0.1).astype(np.float32)
        sd[f"{prefix}.bn.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
        sd[f"{prefix}.bn.running_mean"] = (rng.randn(cout) * 0.1).astype(np.float32)
        sd[f"{prefix}.bn.running_var"] = (1 + rng.rand(cout)).astype(np.float32)

    unit("Conv3d_1a_7x7", 3, 64, (7, 7, 7))
    unit("Conv3d_2b_1x1", 64, 64, (1, 1, 1))
    unit("Conv3d_2c_3x3", 64, 192, (3, 3, 3))
    cin = 192
    for name, s in ji3d._MIXED.items():
        unit(f"{name}.b0", cin, s[0], (1, 1, 1))
        unit(f"{name}.b1a", cin, s[1], (1, 1, 1))
        unit(f"{name}.b1b", s[1], s[2], (3, 3, 3))
        unit(f"{name}.b2a", cin, s[3], (1, 1, 1))
        unit(f"{name}.b2b", s[3], s[4], (3, 3, 3))
        unit(f"{name}.b3b", cin, s[5], (1, 1, 1))
        cin = s[0] + s[2] + s[4] + s[5]
    sd["logits.conv3d.weight"] = (rng.randn(400, 1024, 1, 1, 1) / 32).astype(np.float32)
    sd["logits.conv3d.bias"] = (rng.randn(400) * 0.02).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory, inception):
    """One Inception and one I3D weight file, written by JAX's converters
    from fixture state dicts."""
    _, params, _ = inception
    root = tmp_path_factory.mktemp("weights")
    inc_sd = inception_fixture_state_dict(params)
    i3d_sd = i3d_fixture_state_dict(np.random.RandomState(4))
    jinc.convert_inception_weights(str(root / "inception_v3_features.npz"), state_dict=inc_sd)
    tree = ji3d.convert_i3d_state_dict(i3d_sd)
    np.savez(str(root / "i3d_kinetics400.npz"), params=np.asarray(tree, dtype=object))
    return str(root), inc_sd, i3d_sd


def test_bn_fold_converters_equal_jax(weight_files):
    _, inc_sd, i3d_sd = weight_files
    _tree_equal(tinc.convert_inception_state_dict(inc_sd),
                jinc.convert_inception_state_dict(inc_sd))
    _tree_equal(ti3d.convert_i3d_state_dict(i3d_sd), ji3d.convert_i3d_state_dict(i3d_sd))
    with pytest.raises(ValueError, match="94"):
        tinc.convert_inception_state_dict({k: v for k, v in inc_sd.items()
                                           if not k.startswith("Mixed_7c")})


def test_extractors_load_the_jax_weight_files(weight_files, monkeypatch, tmp_path):
    root, _, i3d_sd = weight_files
    monkeypatch.setenv("WALDO_INCEPTION_WEIGHTS", str(tmp_path))
    monkeypatch.setenv("WALDO_I3D_WEIGHTS", str(tmp_path))
    assert tinc.InceptionExtractor.maybe_load(device="cpu") is None
    assert ti3d.I3DExtractor.maybe_load(device="cpu") is None
    monkeypatch.setenv("WALDO_INCEPTION_WEIGHTS", root)
    monkeypatch.setenv("WALDO_I3D_WEIGHTS", root)
    ex = tinc.InceptionExtractor.maybe_load(device="cpu")
    vex = ti3d.I3DExtractor.maybe_load(device="cpu")
    assert ex.name == "fid" and vex.name == "i3d" and vex.layer == "logits"
    ti3d.convert_i3d_weights(str(tmp_path / "i3d.npz"), i3d_sd)  # loads into an I3D: checked
    assert tinc.random_extractor(device="cpu").name == "rfid"
    assert ti3d.random_extractor(device="cpu").name == "rfvd"


def write_results_tree(root, tag, n_vids=3, t=3, h=32, w=48, seed=5):
    """results/<signature>/{real_vid,inp_pred_vid}/vid_<i>/<t>.png."""
    import PIL.Image

    rng = np.random.RandomState(seed)
    base = os.path.join(root, f"now-{tag}")
    for folder, shift in (("real_vid", 0.0), ("inp_pred_vid", 0.15)):
        for i in range(n_vids):
            d = os.path.join(base, folder, f"vid_{i:04d}")
            os.makedirs(d)
            frames = np.clip(rng.rand(t, h, w, 3) * 0.7 + shift, 0, 1)
            for k in range(t):
                PIL.Image.fromarray((frames[k] * 255).astype(np.uint8)).save(
                    os.path.join(d, f"{k:03d}.png"))
    return root


def test_metrics_cli_fid_fvd_equal_jax(weight_files, monkeypatch, tmp_path, capsys):
    """Both CLIs on one tree, reading one Inception and one I3D file: fvd
    (and ssim) with equal keys, values and printed lines. The port CLI's
    fid is the Frechet distance of its Inception's activations on the
    dumped frames; its parts are held to JAX's above (the resize, the
    features, the Frechet functions), since the JAX CLI's fid takes a 2048
    x 2048 matrix square root, ~20 s of CPU."""
    root, _, _ = weight_files
    monkeypatch.setenv("WALDO_INCEPTION_WEIGHTS", root)
    monkeypatch.setenv("WALDO_I3D_WEIGHTS", root)
    res = write_results_tree(str(tmp_path), "tiny")
    argv = ["tiny", "3", "1", "--results_root", res, "--metrics", "fvd", "ssim"]
    want = jmetrics.main(argv)
    want_out = capsys.readouterr().out
    got = tmetrics.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert sorted(got) == sorted(want) == ["cum_ssim", "fvd"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    lines = lambda out: [ln.split(":")[0] for ln in out.splitlines() if ln.startswith("[")]
    assert lines(got_out) == lines(want_out)
    assert want["fvd"] > 1e-3

    got = tmetrics.main(["tiny", "3", "1", "--results_root", res, "--metrics", "fid",
                         "--device", "cpu"])
    assert sorted(got) == ["fid"] and "[fid] :" in capsys.readouterr().out
    folder = os.path.join(res, "now-tiny")
    ex = tinc.InceptionExtractor.maybe_load("cpu")
    acts = [ex(np.concatenate([tmetrics.load_video(os.path.join(folder, name, v))
                               for v in sorted(os.listdir(os.path.join(folder, name)))]))
            for name in ("real_vid", "inp_pred_vid")]
    want_fid = tfr.frechet_distance_from_acts(*acts)
    assert want_fid > 1e-3 and got["fid"] == pytest.approx(want_fid, rel=1e-9)

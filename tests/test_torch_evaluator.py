"""The port's evaluator (waldo_tpu_torch/train/evaluator.py), its test CLI
and the metrics CLI on the CPU, against the JAX package's ``Evaluator``.

Both evaluate test_torch_nets.tiny_config (with load_dim 64, flows at 32x64,
float32 sampling, ``restrict_to_ctx`` as test.sh sets it) on the same
Cityscapes-format tree of two clips with layout and flow, with the same
perturbed parameters: the JAX evaluator holds them directly, the port's
restores them from its ``.npz`` slots (one run dir per net, as test.sh's
three tags name them). Tolerances, those of the float32-sampling predict
(tests/test_torch_predict.py): the videos before encoding within 1e-3, the
L1 and SSIM means within 1e-3 and PSNR within 1e-3 relative. One exemption:
pred_vid at near-holes, pixels whose fused context score (the sum of the
context alphas that the ghost mask leaves) lies in (0, 1e-4). There the
fusion's weights (score + 1e-6) / sum(score + 1e-6) turn the samplers'
~1e-7 differences into weights of order 1 (at this seed 4 of 122880
elements differ by up to 3.7e-3, all at scores near 2e-6); those elements
are held finite and in [-1, 1], near-holes stay under 1 % of a video, and
the near-hole elements beyond the tolerance under 5e-4 of it (10x this
seed's share). The dumps are the same files.
And test.sh's and test_mat.sh's flags through both packages' ``parse_cli``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldo_tpu.config as jconfig
import waldo_tpu.train.evaluator as jevaluator
from waldo_tpu.models import Synthesizer as JaxSynthesizer
from waldo_tpu.parallel import replicate
from waldo_tpu.train import Evaluator as JaxEvaluator

import waldo_tpu_torch.cli.test as cli_test
import waldo_tpu_torch.train.evaluator as tevaluator
from waldo_tpu_torch.config import from_dict, parse_cli, save_config, to_dict
from waldo_tpu_torch.convert import to_jax
from waldo_tpu_torch.data import create_dataset
from waldo_tpu_torch.eval import metrics as metrics_cli
from waldo_tpu_torch.train import CheckpointManager, Evaluator
from waldo_tpu_torch.train.checkpoint import _flatten

from chip_smoke import (TEST_MAT_SCRIPT, TEST_SCRIPT, eval_script_flags, train_lvd_flags,
                         write_cityscapes_tree)
from test_torch_nets import perturbed_params, tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

VID_TOL = 1e-3
NETS = {"pe": "load_path", "pg": "pg_load_path", "ii": "ii_load_path"}



def eval_cfg(data_root, save_path, datetime):
    cfg = tiny_cfg()
    cfg.data.dataset, cfg.data.dataroot, cfg.data.eval_phase = "cityscapes", data_root, "test"
    cfg.data.skip_first, cfg.data.num_workers = True, 2
    cfg.true_dim, cfg.flow_dim = 64, 32
    cfg.model.sample_precision, cfg.model.restrict_to_ctx = "float32", True
    cfg.save_path, cfg.name, cfg.datetime = save_path, "eval", datetime
    # one batch row: the JAX evaluator's batch axis over a mesh of 1 x 8 CPU devices
    cfg.mesh_shape, cfg.mesh_axes = [1, 8], ["data", "model"]
    return cfg


def port_cfg(cfg):
    """The port's copy of a JAX eval config: its mesh is the launcher's
    processes (one here), not the JAX evaluator's 1 x 8 CPU devices."""
    tcfg = from_dict(jconfig.to_dict(cfg))
    tcfg.mesh_shape, tcfg.mesh_axes = None, ["data"]
    return tcfg


def capturing(module, into):
    """``module.save_video_frames`` recording each video by (folder, file)."""
    orig = module.save_video_frames

    def save(vid, path, fps=4):
        into[os.path.basename(os.path.dirname(path)), os.path.basename(path)] = np.array(vid)
        return orig(vid, path, fps=fps)

    return save


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    data_root = str(root / "cityscapes")
    write_cityscapes_tree(data_root, 64, 32, 2, num_cls=6)
    cfg = eval_cfg(data_root, str(root), "jax")
    params = perturbed_params(JaxSynthesizer(cfg))
    jvids, tvids = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jevaluator, "save_video_frames", capturing(jevaluator, jvids))
        jev = JaxEvaluator(cfg)
        jev.params = replicate(jax.tree.map(jnp.asarray, params), jev.mesh)
        jmetrics = jev.run(dump=True)

    tcfg = port_cfg(cfg)
    tcfg.datetime = "torch"
    for net, field in NETS.items():
        run = str(root / "checkpoints" / f"{net}_run")
        CheckpointManager(run).save(net, params[net], 7, name="latest")
        setattr(tcfg.model, field, run)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevaluator, "save_video_frames", capturing(tevaluator, tvids))
        tev = Evaluator(tcfg, device="cpu")
        tmetrics = tev.run()
    return dict(root=root, data_root=data_root, params=params, jcfg=cfg, tcfg=tcfg,
                jmetrics=jmetrics, tmetrics=tmetrics, jvids=jvids, tvids=tvids, tev=tev,
                near_holes=[near_holes(tev, tcfg, i) for i in range(2)])


def near_holes(tev, cfg, i):
    """(T, H, W, 1) bool over clip i's predicted video: the pixels whose
    fused context score lies in (0, 1e-4)."""
    clip = create_dataset(cfg, phase="test")[i]
    with torch.no_grad():
        alpha_ctx = tev.syn.predict({k: torch.from_numpy(v[None]) for k, v in clip.items()
                                     if isinstance(v, np.ndarray)})["pred_alpha_ctx"]
    score = ((alpha_ctx.float() + 1) / 2).sum(-1).sum(1)[0]  # Tp H W
    near = ((score > 0) & (score < 1e-4)).numpy()
    ctx = np.zeros((cfg.model.ctx_len,) + near.shape[1:], bool)
    return np.concatenate([ctx, near])[..., None]


KEYS = [f"{m}_{k}" for m in ("l1", "psnr", "ssim") for k in ("pred", "rec", "inp_pred", "inp_rec")]


@pytest.mark.parametrize("key", KEYS)
def test_evaluator_metrics_match_jax(runs, key):
    got, want = runs["tmetrics"], runs["jmetrics"]
    assert sorted(got) == sorted(want) == sorted(KEYS)
    assert np.isfinite(got[key])
    scale = abs(want[key]) if key.startswith("psnr") else 1.0
    assert abs(got[key] - want[key]) <= 1e-3 * scale, (key, got[key], want[key])


@pytest.mark.parametrize("name", list(tevaluator.DUMPS))
def test_evaluator_videos_match_jax(runs, name):
    got = {k: v for k, v in runs["tvids"].items() if k[0] == name}
    want = {k: v for k, v in runs["jvids"].items() if k[0] == name}
    assert sorted(got) == sorted(want) == [(name, "vid_00000.mp4"), (name, "vid_00001.mp4")]
    for k in want:
        assert got[k].shape == want[k].shape == (5, 64, 128, 3)
        diff = np.abs(got[k] - want[k])
        if name == "pred_vid":
            near = np.broadcast_to(runs["near_holes"][int(k[1][4:9])], diff.shape)
            assert np.isfinite(got[k][near]).all() and np.abs(got[k][near]).max() <= 1
            assert near.mean() < 1e-2, near.mean()
            # the near-hole elements beyond the tolerance: at most 10x this seed's 4
            over = near & (diff > VID_TOL)
            assert over.mean() < 5e-4, int(over.sum())
            diff = np.where(near, 0, diff)
        err = float(diff.max())
        assert err <= VID_TOL, (k, err)
    if name in ("pred_vid", "inp_pred_vid"):
        ctx = runs["tcfg"].model.ctx_len
        for k in got:  # the context frames are the loader's, unchanged
            np.testing.assert_array_equal(got[k][:ctx], runs["tvids"]["real_vid", k[1]][:ctx])


def test_evaluator_dumps_the_jax_files(runs):
    """Five folders of one dump a clip, ids i * B + b, in the format both
    packages write here; the files listed alike in both result dirs."""
    tcfg, jcfg, tev = runs["tcfg"], runs["jcfg"], runs["tev"]
    ext = {"avi": ".avi", "mp4": ".mp4", "png": ""}[tev.dump_format]
    for name in tevaluator.DUMPS:
        got = sorted(os.listdir(os.path.join(tcfg.result_path, name)))
        assert got == [f"vid_00000{ext}", f"vid_00001{ext}"], got
        assert got == sorted(os.listdir(os.path.join(jcfg.result_path, name)))
    assert len(tev.iteration_times) == 2
    assert all(t["loader_s"] >= 0 and t["dump_s"] > 0 for t in tev.iteration_times)


def test_evaluator_restores_every_slot_equal(runs):
    trees = to_jax(runs["tev"].syn)
    assert sorted(trees) == sorted(NETS)
    for net in NETS:
        got, want = _flatten(trees[net]), _flatten(runs["params"][net])
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), net


def test_evaluator_missing_slot_raises(runs, tmp_path):
    cfg = eval_cfg(runs["data_root"], str(tmp_path), "x")
    tcfg = port_cfg(cfg)
    tcfg.model.pg_load_path = str(tmp_path / "no_run")
    with pytest.raises(FileNotFoundError):
        Evaluator(tcfg, device="cpu")


def test_cli_test_then_metrics_cli_on_cpu(runs, tmp_path, capsys, monkeypatch):
    """``python -m waldo_tpu_torch.cli.test`` on the CPU from a config file,
    then ``python -m waldo_tpu_torch.eval.metrics TAG 5 2`` on its dumps."""
    monkeypatch.setenv("WALDO_LPIPS_WEIGHTS", str(tmp_path / "no_lpips"))
    cfg_path = save_config(runs["tcfg"], str(tmp_path / "config.json"))
    metrics = cli_test.main(["--config", cfg_path, "--save_path", str(tmp_path), "--datetime",
                             "cli", "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(metrics) == sorted(KEYS)
    for k, v in runs["tmetrics"].items():
        assert f"{k}: {v:.4f}" in out and abs(metrics[k] - v) <= 1e-6 * max(1.0, abs(v))
    cum = metrics_cli.main(["cli-eval", "5", "2", "--results_root",
                            str(tmp_path / "results"), "--device", "cpu"])
    cap = capsys.readouterr()
    assert sorted(cum) == ["cum_msssim", "cum_ssim"] and all(np.isfinite(list(cum.values())))
    assert "falling back to ssim" in cap.err
    lines = cap.out.splitlines()
    assert sum(ln.startswith("[ssim:") for ln in lines) == 5
    assert sum(ln.startswith("[cum msssim:") for ln in lines) == 3


@pytest.mark.parametrize("script", [TEST_SCRIPT, TEST_MAT_SCRIPT], ids=["test.sh", "test_mat.sh"])
def test_parse_cli_test_scripts_match_jax(script):
    flags = eval_script_flags(script) + ["--datetime", "fixed"]
    got, want = to_dict(parse_cli(list(flags))), jconfig.to_dict(jconfig.parse_cli(list(flags)))
    assert got == want
    m, d = got["model"], got["data"]
    assert (got["batch_size_vid"], d["vid_len"], got["dim"], got["load_dim"], got["true_dim"],
            got["flow_dim"], d["dataset"], d["eval_phase"], d["num_workers"]) == (
        1, 14, 128, 512, 512, 128, "cityscapes", "test", 8)
    assert (m["load_path"], m["pg_load_path"], m["ii_load_path"]) == (
        "checkpoints/LVD_TAG", "checkpoints/FLP_TAG", "checkpoints/WIF_TAG")
    assert (m["embed_dim"], m["num_obj"], m["ctx_len"], m["restrict_to_ctx"],
            d["remap_lyt"]) == (512, 16, 4, True, [13, 19, 18, 19, 7, 6, 8, 6])
    mat = script == TEST_MAT_SCRIPT
    assert got["name"] == ("test_mat_cityscapes" if mat else "test_cityscapes")
    assert (m["use_mat_inpainter"], m["use_inpainter"], m["propagate_obj"]) == (mat, mat, mat)
    if mat:
        assert m["inpainter_path"] == "checkpoints/mat/mat_places512.npz"


@pytest.mark.parametrize("script", ["cityscapes/demo.sh", "kitti/test.sh", "kitti/test_mat.sh",
                                    "kitti/demo.sh", "kitti/train_lvd.sh", "kitti/train_flp.sh",
                                    "kitti/train_wif.sh"])
def test_parse_cli_other_scripts_match_jax(script):
    """The remaining launch scripts through both packages' parse_cli."""
    path = f"scripts/{script}"
    flags = (train_lvd_flags(path) if "/train_" in path else eval_script_flags(path))
    flags = flags + ["--datetime", "fixed"]
    got, want = to_dict(parse_cli(list(flags))), jconfig.to_dict(jconfig.parse_cli(list(flags)))
    assert got == want
    assert got["data"]["dataset"] == script.split("/")[0]

"""The trainer's FLP and WIF modes on the CPU (``Trainer(cfg,
device="cpu").run(3)`` at tests/test_torch_train.py's trainer size): the
frozen LVD teacher restored from an LVD run's "latest" slot, or from
scratch with the JAX package's line when the slot is missing; only the
trained net moves; an eval saves "best_vid"; every net is saved and the
slots restore equal. And
scripts/cityscapes/train_flp.sh's and train_wif.sh's flags through both
packages' ``parse_cli``.
"""
import os
import shlex

import numpy as np
import pytest
import torch

import waldo_tpu.config as jconfig

from waldo_tpu_torch.config import parse_cli, to_dict
from waldo_tpu_torch.convert import to_jax
from waldo_tpu_torch.train import Trainer
from waldo_tpu_torch.train.checkpoint import _flatten

from test_torch_train import ROOT, train_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODES = {"vid_pose_generator": ("pg", "flp"), "vid_inpainting": ("ii", "wif")}



@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """An LVD run's checkpoint dir and its "latest" LVD tree."""
    root = tmp_path_factory.mktemp("lvd")
    tr = Trainer(train_cfg(root, name="lvd", num_iter=2, save_latest_freq=0), device="cpu")
    tr.run()
    return tr.cfg.checkpoint_path, _flatten(to_jax(tr.syn)["pe"])


def mode_cfg(tmp, mode, load_path):
    cfg = train_cfg(tmp, name=mode, vid_modes=[mode], num_iter_eval=2, vid_metric="loss",
                    max_batch_eval_vid=1)
    m = cfg.model
    m.load_path, m.which_iter = load_path, "latest"
    if mode == "vid_pose_generator":
        m.use_pg, m.pg_num_timesteps = True, cfg.data.vid_len
        m.min_ctx_length_vid = m.max_ctx_length_vid = m.ctx_len
    else:
        m.use_ii, m.ii_depth, m.ii_embed_dim = True, 2, 16
        m.vid_inpainting_losses = ["sharp_vid"]
    return cfg


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trainer_mode_steps_only_its_net(tmp_path, capsys, teacher, mode):
    net, attr = MODES[mode]
    load_path, lvd_latest = teacher
    tr = Trainer(mode_cfg(tmp_path, mode, load_path), device="cpu")
    assert f"[ckpt] restored pe (latest) from {load_path}" in capsys.readouterr().out
    restored = _flatten(to_jax(tr.syn)["pe"])
    assert set(restored) == set(lvd_latest)
    assert all(np.array_equal(restored[k], lvd_latest[k]) for k in lvd_latest)
    assert list(tr.states) == [net]
    lvd = [p.detach().clone() for p in tr.syn.lvd.parameters()]
    module = getattr(tr.syn, attr)
    before = [p.detach().clone() for p in module.parameters()]
    tr.run(num_iter=3)
    out = capsys.readouterr().out
    assert "Iteration 00002/00003" in out and "new best_vid" in out
    assert tr.ckpt.exists(net, "best_vid")
    st = tr.states[net]
    assert int(st.count) == 3 and int(st.nancount) == 0
    assert all(torch.equal(a, b) for a, b in zip(lvd, tr.syn.lvd.parameters()))
    assert all(p.grad is None for p in tr.syn.lvd.parameters())
    unmoved = [n for (n, p), b in zip(module.named_parameters(), before) if torch.equal(p, b)]
    assert not unmoved
    for label in ("pe", net):  # every net is saved
        now = _flatten(to_jax(tr.syn)[label])
        back = _flatten(tr.ckpt.restore(label, to_jax(tr.syn)[label], "latest", strict=True))
        assert all(np.array_equal(now[k], back[k]) for k in now), label


def test_trainer_teacher_slot_missing_trains_from_scratch(tmp_path, capsys):
    """A --s_load_path without an LVD slot: the JAX package's line, then
    the run goes on from the initialized teacher."""
    tr = Trainer(mode_cfg(tmp_path, "vid_pose_generator", str(tmp_path / "empty")),
                 device="cpu")
    assert "[ckpt] no checkpoint for pe, training from scratch" in capsys.readouterr().out
    tr.run(num_iter=1)
    assert int(tr.states["pg"].count) == 1


def script_flags(name):
    with open(os.path.join(ROOT, "scripts", "cityscapes", name)) as fh:
        text = fh.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "cli.train" in ln)
    args = shlex.split(line.split("cli.train", 1)[1].replace("${LVD_TAG}", "lvd_run"))
    return [a for a in args if a != "${@:2}"]


@pytest.mark.parametrize("script", ["train_flp.sh", "train_wif.sh"])
def test_parse_cli_train_flp_wif_match_jax(script):
    """The scripts' flags through both parsers, with the settings the slice
    depends on."""
    flags = script_flags(script) + ["--datetime", "fixed"]
    got, want = to_dict(parse_cli(flags)), jconfig.to_dict(jconfig.parse_cli(flags))
    assert got == want
    m = got["model"]
    assert (m["load_path"], m["which_iter"], m["embed_dim"], m["num_obj"]) == (
        "checkpoints/lvd_run", "latest", 512, 16)
    if script == "train_flp.sh":
        assert (got["batch_size_vid"], got["data"]["vid_len"], got["dim"], got["load_dim"],
                got["data"]["num_workers"]) == (4, 14, 128, 0, 16)
        assert (m["use_pg"], m["pg_num_timesteps"], m["oe_num_timesteps"], m["ctx_len"],
                m["min_ctx_length_vid"], m["max_ctx_length_vid"],
                m["pe_estimator_init_mode"]) == (True, 14, 5, 4, 4, 4, "zero")
        assert got["vid_modes"] == ["vid_pose_generator"]
    else:
        assert (got["batch_size_vid"], got["data"]["vid_len"], got["dim"], got["load_dim"],
                got["flow_dim"], got["data"]["num_workers"]) == (8, 5, 128, 512, 128, 8)
        assert (m["use_ii"], m["ii_depth"], m["ii_score"], m["ii_ab"],
                m["vid_inpainting_losses"]) == (True, 6, True, True, ["sharp_vid", "lpips_vid"])
        assert got["vid_modes"] == ["vid_inpainting"]

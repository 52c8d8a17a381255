"""The step spans under torch.profiler on the CPU: one ``Trainer.step`` opens
``train/forward``, ``train/backward`` and ``train/optimizer`` once each, in
that order and apart, with the nets' and losses' spans inside the forward;
one ``Evaluator.step`` opens ``eval/copy_in``, ``eval/metrics`` and
``eval/copy_out`` once each, in that order, inside ``eval/predict``, with
the predict's spans between the copy in and the metrics. The tiny
configurations of tests/test_torch_train.py and
tests/test_torch_evaluator.py; nothing of the JAX package runs."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waldo_tpu_torch.data import create_dataset
from waldo_tpu_torch.train import Evaluator, Trainer

from chip_smoke import write_cityscapes_tree
from test_torch_evaluator import eval_cfg, port_cfg
from test_torch_train import train_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PREFIXES = ("train/", "eval/", "lvd/", "warper/", "loss/", "flp/", "wif/")


def spans(prof):
    """(name, start, end) of the program's spans on the host, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(PREFIXES)]
    return sorted(out, key=lambda s: s[1])


def one(rows, name):
    got = [r for r in rows if r[0] == name]
    assert len(got) == 1, (name, got)
    return got[0]


def inside(rows, prefix, outer):
    got = [r for r in rows if r[0].startswith(prefix)]
    assert got, prefix
    assert all(outer[1] <= s and e <= outer[2] for _, s, e in got), (prefix, got, outer)
    return got


def first_batch(cfg, phase):
    item = create_dataset(cfg, phase=phase)[0]
    return {k: np.stack([v] * cfg.batch_size_vid) for k, v in item.items()
            if isinstance(v, np.ndarray)}


def train_step(tmp_path):
    cfg = train_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    batch = tr._to_device(first_batch(cfg, "train"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step("vid_object_extractor", batch, 0)
    rows = spans(prof)
    fwd, bwd, opt = (one(rows, f"train/{p}") for p in ("forward", "backward", "optimizer"))
    assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    for prefix in ("lvd/", "loss/", "warper/"):
        inside(rows, prefix, fwd)


def eval_step(tmp_path):
    data_root = str(tmp_path / "cityscapes")
    write_cityscapes_tree(data_root, 64, 32, 1, num_cls=6)
    cfg = port_cfg(eval_cfg(data_root, str(tmp_path), "spans"))
    ev = Evaluator(cfg, device="cpu")
    metrics = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.step(0, first_batch(cfg, cfg.data.eval_phase), metrics, dump=False)
    assert metrics and all(np.isfinite(v[0]) for v in metrics.values())
    rows = spans(prof)
    pred = one(rows, "eval/predict")
    cin, met, cout = (inside(rows, f"eval/{p}", pred)
                      for p in ("copy_in", "metrics", "copy_out"))
    assert len(cin) == len(met) == len(cout) == 1
    assert cin[0][2] <= met[0][1] and met[0][2] <= cout[0][1]
    between = ("predict", cin[0][2], met[0][1])
    for prefix in ("lvd/", "warper/", "wif/"):
        inside(rows, prefix, between)


@pytest.mark.parametrize("step", [train_step, eval_step], ids=["train", "eval"])
def test_step_spans_once_in_order(step, tmp_path):
    torch.manual_seed(0)
    step(tmp_path)

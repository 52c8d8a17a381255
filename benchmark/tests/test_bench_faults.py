"""A run with the timed path broken underneath comes out not correct: the
harness's run (without its look for a card) at a tiny size on the CPU, with
the cell's own limits, once for each fault the cell can have, and once
sound. On the CPU the program runs its plain path, which the reference
copies, so a sound run reads 0."""
import time

import pytest
import torch
from tiny import tiny_cell

SEED = 2 ** 31 + 4242


def run(workload):
    import run as bench_run

    return bench_run.run_cell(tiny_cell(workload), SEED, 1.0, False, "cpu", time.time())


@pytest.mark.parametrize("workload", ["cityscapes.eval", "kitti.train_lvd"])
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"


def test_answer_altered_where_produced(monkeypatch):
    """The last predicted frame of each video mirrored left to right."""
    from waldo_tpu_torch.models import Synthesizer

    predict = Synthesizer.predict

    def broken(self, batch):
        out = predict(self, batch)
        for k in ("pred_vid", "inp_pred_vid"):
            out[k] = out[k].clone()
            out[k][:, -1] = out[k][:, -1].flip(-2)
        return out

    monkeypatch.setattr(Synthesizer, "predict", broken)
    res = run("cityscapes.eval")
    assert not res["correct"], res["compared"]


def test_step_returns_its_state_unchanged(monkeypatch):
    from waldo_tpu_torch.train.train_state import NetState

    monkeypatch.setattr(NetState, "apply", lambda self, loss: None)
    res = run("kitti.train_lvd")
    assert not res["correct"], res["compared"]


def test_update_applied_with_its_sign_flipped(monkeypatch):
    """Each step moves the parameters as far as Adam says, the other way: the
    loss and the gradient Adam holds are right, the direction is not."""
    from waldo_tpu_torch.train.train_state import NetState

    apply = NetState.apply

    def broken(self, loss):
        before = [p.detach().clone() for p in self.params]
        apply(self, loss)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(2 * b - p)

    monkeypatch.setattr(NetState, "apply", broken)
    res = run("kitti.train_lvd")
    assert not res["correct"], res["compared"]
    assert res["compared"]["step1_gap"]["value"] > res["compared"]["step1_gap"]["limit"]


def test_half_the_batch_left_out(monkeypatch):
    """The loss taken as the mean over the first half of the batch."""
    from waldo_tpu_torch.models import Synthesizer

    loss = Synthesizer.extract_object_loss

    def broken(self, batch, *args, **kw):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        kw.pop("shard", None)
        return loss(self, half, *args, **kw)

    monkeypatch.setattr(Synthesizer, "extract_object_loss", broken)
    res = run("kitti.train_lvd")
    assert not res["correct"], res["compared"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["cityscapes.eval", "kitti.train_lvd"])
def test_control_is_not_correct(card, workload):
    """The control on the card at the cell's own size (one clip a seed for
    evaluation): the reference in TF32 in the program's place fails one of
    the cell's limits, on three seeds."""
    import calibrate
    from wbench.spec import load_cell

    cell = load_cell(workload)
    cell.traffic["sample"] = 1
    for seed in (SEED, SEED + 1, SEED + 2):
        rows = calibrate.control_readings(cell, seed, card)
        ctl = [r for r in rows if r["kind"] == "control_tf32"][0]["numbers"]
        assert any(ctl[k] > lim for k, lim in cell.limits.items()), (seed, ctl)

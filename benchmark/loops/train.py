"""The ``train`` loop: a closed loop of ``Trainer.step(mode, batch, it)`` on
the pool's device batches, ``it`` counting up.

The traffic mix names what is trained: ``mode`` (the trainer's step),
``net`` (the key of the net it trains, as ``Synthesizer.nets`` gives it)
and ``loss`` (the reference's loss method for that step). Set-up takes the
trainer through its first ``followed`` steps on the pool, through the
window's own call, and keeps what the check reads of them; the window
continues the same trainer. After the window the reference follows those
steps from the same weights on the same batches.

A loop file gives ``Program``, ``check`` and ``readings``; ``run.py`` finds
it by the traffic mix's ``loop``.
"""
from __future__ import annotations

from typing import Dict

import torch


class Program:
    def __init__(self, cell, cfg, weights, pool, seed, device):
        from waldo_tpu_torch.train import Trainer
        from wbench.weights import load_into

        self.traffic = cell.traffic
        self.batch = cfg.batch_size_vid
        self.pool = pool
        self.mode = cell.traffic["mode"]
        self.net = cell.traffic["net"]
        self.tr = Trainer(cfg, device=device)
        nets = self.tr.syn.nets()
        load_into({k: v for k, v in nets.items() if k in weights}, weights)
        self.state = self.tr.states[self.net]
        self.names = [n for n, p in nets[self.net].named_parameters() if p.requires_grad]
        self.it = 0
        self.nonfinite = torch.zeros((), dtype=torch.int32, device=device)
        self.followed: dict = {}
        self.done = 0

    def warm(self) -> None:
        """The first ``followed`` steps, through the window's own call: each
        step's loss, the first gradient as Adam holds it after step 1 (its
        first moment over 1 - beta1), and the parameters after step 1 and
        after the last."""
        losses = []
        for k in range(self.traffic["followed"]):
            m = self._step()
            losses.append(m["loss"].detach().clone())
            if k == 0:
                s = self.state
                self.followed["grad1"] = [mu.detach() / (1 - s.b1) for mu in s.mu]
                self.followed["params1"] = [p.detach().clone() for p in s.params]
        self.followed["losses"] = [float(v) for v in losses]
        self.followed["params"] = [p.detach().clone() for p in self.state.params]
        self.followed["names"] = self.names

    def _step(self):
        batch = self.pool[self.it % len(self.pool)]
        m = self.tr.step(self.mode, batch, self.it)
        self.nonfinite += (~torch.isfinite(m["loss"])).int()
        self.it += 1
        return m

    def begin(self, traced: int = 0) -> None:
        self.nonfinite.zero_()

    def step(self) -> None:
        self._step()
        self.done += 1

    def sync(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @property
    def failed(self) -> int:
        return int(self.nonfinite)

    def work(self) -> Dict[str, float]:
        return {"clips": self.done * self.batch}

    def finish(self):
        """What the check reads; the program is freed."""
        held = self.followed
        del self.tr, self.state
        return held


def _steps(cell, cfg, start, pool, device, **kw):
    from wbench import check as ck

    t = cell.traffic
    return ck.reference_steps(cfg, start, pool, t["followed"], device, t["net"], t["loss"], **kw)


def check(cell, ref_cfg, start, pool, held, device, observer=None):
    """The reference's first steps against the program's: (numbers, the
    model FLOPs of a step, forward and backward, the steps the observer
    saw)."""
    from wbench import check as ck

    want = _steps(cell, ref_cfg, start, pool, device, observer=observer, count_flops=True)
    return ck.train_numbers(held, want, start[cell.traffic["net"]]), want["flops"], 1


def readings(cell, cfg, start, pool, device) -> list:
    """The control (the reference in TF32 in the program's place) and half of
    each batch left out (the loss the mean over the rest), each against the
    reference; a state left unchanged and an update applied with its sign
    flipped are worked out from the reference's own steps."""
    from wbench import check as ck

    net = cell.traffic["net"]
    want = _steps(cell, cfg, start, pool, device)
    rows = []
    for kind, kw in (("control_tf32", dict(tf32=True)),
                     ("fault_half_batch", dict(half_batch=True))):
        got = _steps(cell, cfg, start, pool, device, **kw)
        rows.append({"kind": kind, "numbers": ck.train_numbers(got, want, start[net])})
        del got
    p0 = [start[net][n] for n in want["names"]]
    flipped = [2 * a - b for a, b in zip(p0, want["params1"])]
    for kind, params1 in (("fault_state_unchanged", p0), ("fault_update_flipped", flipped)):
        gap = ck.train_numbers(dict(want, params1=params1), want, start[net])["step1_gap"]
        rows.append({"kind": kind, "numbers": {"step1_gap": gap},
                     "note": "worked out from the reference's first step"})
    return rows

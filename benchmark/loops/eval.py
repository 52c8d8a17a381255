"""The ``eval`` loop: a closed loop of one client through ``Evaluator.step``.

Each clip of the pool (host numpy in the loader's keys) goes through the
copy to the card, ``Synthesizer.predict``, the evaluator's L1 / PSNR / SSIM
and the copy back. The step's dumps are replaced by a recorder that keeps a
sample of the clips' outputs, drawn from the seed, for the check after the
window: the reference predicts the same clips and scores them.

A loop file gives ``Program`` (the system under test and its steps),
``check`` (what decides ``correct``) and ``readings`` (the control's and
the faults' numbers, for ``calibrate.py``); ``run.py`` finds it by the
traffic mix's ``loop``.
"""
from __future__ import annotations

import random
from typing import Dict

import numpy as np


class Recorder:
    """A uniform sample of ``k`` of the window's clips (reservoir sampling
    from the seed), standing in for the evaluator's dumps: it keeps the host
    outputs the step produced."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept: Dict[int, Dict[str, np.ndarray]] = {}
        self.active = False

    def __call__(self, out: Dict[str, np.ndarray], i: int) -> None:
        if not self.active:
            return
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[i] = out
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = out


class Program:
    def __init__(self, cell, cfg, weights, pool, seed, device):
        from waldo_tpu_torch.train import Evaluator
        from wbench.weights import load_into

        self.traffic = cell.traffic
        self.pool = pool
        self.ev = Evaluator(cfg, device=device)
        load_into(self.ev.syn.nets(), weights)
        self.recorder = Recorder(cell.traffic["sample"], seed)
        self.ev._dump = self.recorder
        self.metrics: Dict[str, list] = {}
        self.frames = cfg.batch_size_vid * (cfg.data.vid_len - cfg.model.ctx_len)
        self.failed = 0
        self.done = 0

    def warm(self) -> None:
        scratch: Dict[str, list] = {}
        for i in range(self.traffic["warmup"]):
            self.ev.step(i, self.pool[i % len(self.pool)], scratch, dump=False)

    def begin(self, traced: int = 0) -> None:
        """The window starts; a traced window of ``traced`` clips keeps them all."""
        self.recorder.active = True
        if traced:
            self.recorder.k = traced

    def step(self) -> None:
        i = self.done
        self.ev.step(i, self.pool[i % len(self.pool)], self.metrics, dump=True)
        if not all(np.isfinite(v[i]) for v in self.metrics.values()):
            self.failed += 1
        self.done += 1

    def sync(self) -> None:
        pass  # a step ends with its copy back to the host

    def work(self) -> Dict[str, float]:
        return {"frames": self.done * self.frames}

    def finish(self):
        """What the check reads; the program is freed."""
        held = (self.recorder.kept, self.metrics)
        del self.ev
        return held


def check(cell, ref_cfg, start, pool, held, device, observer=None):
    """The reference on each clip the recorder kept: (numbers, the model
    FLOPs of a clip, the clips the observer saw)."""
    from wbench import check as ck

    kept, got_metrics = held
    ref = ck.reference(ref_cfg, start, device)
    rows, flops = [], None
    for n, i in enumerate(sorted(kept)):
        videos, m_ref, fl = ck.reference_clip(ref, pool[i % len(pool)], device, observer,
                                              count_flops=(n == 0))
        flops = fl if n == 0 else flops
        rows.append(ck.eval_numbers(kept[i], {k: got_metrics[k][i] for k in m_ref}, videos,
                                    m_ref))
    return ck.worst(rows), flops, max(len(kept), 1)


def altered(videos: dict) -> dict:
    """The fault: each predicted video's last frame mirrored left to right
    (an answer computed wrongly where it is produced)."""
    out = dict(videos)
    for k in ("pred_vid", "inp_pred_vid"):
        if k in out:
            v = out[k].clone()
            v[:, -1] = v[:, -1].flip(-2)
            out[k] = v
    return out


def readings(cell, cfg, start, pool, device) -> list:
    """On the first ``sample`` clips of the pool: the control (the reference
    in TF32 in the program's place), an answer altered where it is produced,
    and a witness of the prediction's conditioning (the reference against
    itself on its input flow moved by 1e-7 of itself)."""
    from plainref.metrics import clip_metrics
    from wbench import check as ck

    ref = ck.reference(cfg, start, device)
    host = lambda vids: {k: v.cpu().numpy() for k, v in vids.items()}
    ctl, alt, wit = [], [], []
    for j in range(min(cell.traffic["sample"], len(pool))):
        want, m_want, _ = ck.reference_clip(ref, pool[j], device)
        with ck.precision(True):
            got, m_got, _ = ck.reference_clip(ref, pool[j], device)
        ctl.append(ck.eval_numbers(host(got), m_got, want, m_want))
        moved = dict(pool[j], flow=pool[j]["flow"] * (1 + 1e-7))
        w, m_w, _ = ck.reference_clip(ref, moved, device)
        wit.append(ck.eval_numbers(host(w), m_w, want, m_want))
        bad = altered(want)
        alt.append(ck.eval_numbers(host(bad), clip_metrics(bad, cfg.model.ctx_len), want,
                                   m_want))
        del want, got, w, bad
    return [{"kind": "control_tf32", "numbers": ck.worst(ctl)},
            {"kind": "fault_answer_altered", "numbers": ck.worst(alt)},
            {"kind": "witness_flow_1e-7", "numbers": ck.worst(wit),
             "note": "the reference against itself on the input flow moved by 1e-7 of itself: "
                     "how far rounding alone carries"}]

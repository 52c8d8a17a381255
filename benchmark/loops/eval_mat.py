"""The ``eval_mat`` loop: test_mat.sh's closed loop of one client through
``Evaluator.step``. Each clip of the pool goes through the ``eval`` loop's
path (the copy to the card, ``Synthesizer.predict``, the scores, the copy
back), with MAT's post-process between the predict and the scores:
``inpaint_with_mat`` runs WIF again frame by frame, K2's few-channel warps,
and the MAT generator on three 512x512 crops a frame (the reference frame,
each predicted frame, and each border an object leaves by).

The program, its recorder and the altered answer are the ``eval`` loop's
(``loops/eval.py``), and two things are added:

- MAT's state, parameters and buffers, made on the card from the
  configuration's seed (``wbench/weights_mat.py``) and loaded into
  ``Evaluator.inpainter.net``; the check's plain MAT loads the same state.
- z. Every ``MatInpainter`` call draws its z from the inpainter's own device
  generator, which runs on through the warm-up and the window. So the
  recorder keeps that generator's state as it stood at the start of each
  kept clip, and the check's plain inpainter starts the clip from that state
  and draws the clip's z call for call.

The check: for each kept clip the reference predicts, runs its plain
``inpaint_with_mat`` and scores; ``wbench/check.eval_numbers`` compares every
video (``inp_pred_vid`` MAT's) and the metrics. The model FLOPs of a clip
are the mean over the pool's clips, since the number of MAT forwards
differs from clip to clip. A traced run's observer is told of K3's launches
only, with their bounds (``wbench/bounds_mat.py``).
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path
from typing import Dict

from wbench.spec import _module

base = _module(Path(__file__).with_name("eval.py"), "loop")
altered = base.altered


class Recorder(base.Recorder):
    """The ``eval`` loop's sample of the window's clips, each kept with the
    inpainter generator's state at the clip's start (``z_state``, set by
    the program before each step)."""

    z_state = None

    def __call__(self, out, i: int) -> None:
        super().__call__(dict(out, z_state=self.z_state), i)


def evaluation_pool(cell, cfg, pool, seed, device) -> list:
    """``pool`` remade in place at the evaluation geometry (clips at
    ``load_dim``, flows at ``flow_dim``), from the same seed and scenes:
    ``wbench/traffic.batches`` loads there only for the mix whose loop is
    ``eval``, and makes this mix's clips at ``dim``. The list is the one
    ``run.py`` hands the check, so the check reads the same clips."""
    from wbench import traffic

    pool[:] = traffic.batches(cfg, dict(cell.traffic, loop="eval"), seed, device,
                              host=(cell.traffic["pool_on"] == "host"))
    return pool


class Program(base.Program):
    def __init__(self, cell, cfg, weights, pool, seed, device):
        from wbench import weights_mat

        evaluation_pool(cell, cfg, pool, seed, device)
        super().__init__(cell, cfg, weights, pool, seed, device)
        self.mat_state = weights_mat.make(cfg.seed, device, self.ev.inpainter.res)
        self.ev.inpainter.net.load_state_dict(self.mat_state)
        self.recorder = Recorder(cell.traffic["sample"], seed)
        self.ev._dump = self.recorder
        self.calls_at_begin = 0

    def begin(self, traced: int = 0) -> None:
        super().begin(traced)
        self.calls_at_begin = self.ev.inpainter.calls

    def step(self) -> None:
        self.recorder.z_state = self.ev.inpainter.generator.get_state()
        super().step()

    def finish(self):
        calls = self.ev.inpainter.calls - self.calls_at_begin
        print(f"[eval_mat] MatInpainter.calls {calls} in the window's {self.done} clips "
              f"({calls / max(self.done, 1):.4f} a clip)", file=sys.stderr, flush=True)
        kept, metrics = super().finish()
        return kept, metrics, self.mat_state


def plain_inpainter(state, device):
    """The plain MAT with ``state``, at the resolution the state was made for
    (its largest noise plane's)."""
    from plainref.models.mat_pipeline import MatInpainter

    inp = MatInpainter(device, max(v.shape[0] for k, v in state.items()
                                   if k.endswith("noise_const")))
    inp.load(state)
    return inp


def reference_clip(ref, inp, batch, device, observer=None, count_flops=False):
    """The reference's videos (float32) and metrics of one batch, MAT's
    post-process included, its z drawn from ``inp.generator`` as it stands;
    the clip's model FLOPs when asked. ``observer`` (a ``KernelBounds``) is
    told of K3's launches."""
    from plainref.metrics import clip_metrics
    from plainref.models.mat_pipeline import inpaint_with_mat
    from plainref.ops.bias_act import observe
    from wbench import check as ck
    from wbench.bounds_mat import k3_observer
    from wbench.flops import ModelFlops

    m = ref.cfg.model
    with contextlib.ExitStack() as stack:
        if observer is not None:
            stack.enter_context(observe(k3_observer(observer)))
        if count_flops:
            counter = stack.enter_context(ModelFlops())
        b = ck.to_device(batch, device)
        out = ref.predict(b)
        out["inp_pred_vid"] = inpaint_with_mat(
            ref.cfg, ref.warper, ref.wif, inp, out["pred_raw_output"], out["pred_alpha"],
            out["pred_alpha_ctx"], b["vid"], out["pred_flow"], m.ctx_len, out["pred_grids"])
    videos = {k: out[k].float() for k in ck.VIDEO_KEYS if k in out}
    return videos, clip_metrics(out, m.ctx_len), (counter.total if count_flops else None)


def check(cell, ref_cfg, start, pool, held, device, observer=None):
    """The reference on each clip the recorder kept, from its z state:
    (numbers, the mean model FLOPs of the pool's clips, the clips the
    observer saw). The FLOPs are counted in runs of their own."""
    from wbench import check as ck

    kept, got_metrics, mat_state = held
    ref = ck.reference(ref_cfg, start, device)
    inp = plain_inpainter(mat_state, device)
    rows = []
    for i in sorted(kept):
        got = dict(kept[i])
        inp.generator.set_state(got.pop("z_state"))
        videos, m_ref, _ = reference_clip(ref, inp, pool[i % len(pool)], device, observer)
        rows.append(ck.eval_numbers(got, {k: got_metrics[k][i] for k in m_ref}, videos, m_ref))
        del videos
    # counted apart: the counter decomposes composite operators, which rounds otherwise
    flops = [reference_clip(ref, inp, batch, device, count_flops=True)[2] for batch in pool]
    return ck.worst(rows), sum(flops) / len(flops), max(len(kept), 1)


@contextlib.contextmanager
def keys_unmasked():
    """The fault: MAT's window attention with its key mask left out, so every
    key is attended (the mask is still carried from block to block)."""
    from plainref.models.mat import WindowAttention

    WindowAttention.mask_keys = False
    try:
        yield
    finally:
        WindowAttention.mask_keys = True


def readings(cell, cfg, start, pool, device) -> list:
    """On the first ``sample`` clips of the pool, each chain's z drawn from
    one state: the control (the reference in TF32 in the program's place),
    an answer altered where it is produced, MAT with its key mask left out,
    and a witness of the chain's conditioning (the reference against itself
    on its input flow moved by 1e-7 of itself)."""
    import torch
    from plainref.metrics import clip_metrics
    from wbench import check as ck
    from wbench import weights_mat

    evaluation_pool(cell, cfg, pool, cfg.seed, device)
    ref = ck.reference(cfg, start, device)
    inp = plain_inpainter(weights_mat.make(cfg.seed, device), device)
    host = lambda vids: {k: v.cpu().numpy() for k, v in vids.items()}
    rows: Dict[str, list] = {"ctl": [], "alt": [], "keys": [], "wit": []}
    for j in range(min(cell.traffic["sample"], len(pool))):
        z = torch.Generator(device=device).manual_seed(cfg.seed + j).get_state()

        def run(batch=pool[j]):
            inp.generator.set_state(z)
            return reference_clip(ref, inp, batch, device)[:2]

        want, m_want = run()
        with ck.precision(True):
            got, m_got = run()
        rows["ctl"].append(ck.eval_numbers(host(got), m_got, want, m_want))
        with keys_unmasked():
            got, m_got = run()
        rows["keys"].append(ck.eval_numbers(host(got), m_got, want, m_want))
        got, m_got = run(dict(pool[j], flow=pool[j]["flow"] * (1 + 1e-7)))
        rows["wit"].append(ck.eval_numbers(host(got), m_got, want, m_want))
        bad = altered(want)
        rows["alt"].append(ck.eval_numbers(host(bad), clip_metrics(bad, cfg.model.ctx_len),
                                           want, m_want))
        del want, got, bad
    return [{"kind": "control_tf32", "numbers": ck.worst(rows["ctl"])},
            {"kind": "fault_answer_altered", "numbers": ck.worst(rows["alt"])},
            {"kind": "fault_keys_unmasked", "numbers": ck.worst(rows["keys"])},
            {"kind": "witness_flow_1e-7", "numbers": ck.worst(rows["wit"]),
             "note": "the reference against itself on the input flow moved by 1e-7 of itself: "
                     "how far rounding alone carries"}]

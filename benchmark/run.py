#!/usr/bin/env python3
"""The benchmark of waldo_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (it fails without them; it never falls back to the CPU).

A run makes its inputs and weights from ``--seed`` on the card, builds the
program through the loop its traffic mix names (``loops/<loop>.py``: the
port's Evaluator or Trainer at the configuration's script flags, TF32 off),
warms up every shape the cell's traffic uses, then runs the loop for
``--seconds``. With ``--trace 0`` it reports the cell's end-to-end metrics
(host clock); with ``--trace 1`` it traces a few steps with torch.profiler
and reports the cell's per-layer metrics. Each metric is read by its reader
under ``benchmark/metrics/``. After the window the loop's check runs the
plain reference (``benchmark/plainref``) on what the timed path produced
and compares (``wbench/check.py``) against the cell's limits
(``limits/<cell>.json``).
The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs), compared.

The run exits with 1 and prints no result if the process loaded JAX or the
JAX package ``waldo_tpu`` (compared by whole top-level module names).
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "waldo_tpu")


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``waldo_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def check_imports(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"{when}: the process loaded {found}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class RunContext:
    """What a metric's reader reads. Every run: the window (its seconds, its
    clips or steps, the work they completed by unit), the set-up's seconds
    and the reference's model FLOPs of a step. A traced run adds the trace's
    spans, kernels and copies, the peak, and the reference's bounds and
    launches for the traced steps."""

    def __init__(self, win, setup_s, flops_per_step, summary=None, peak_bytes=0,
                 bound_ms_per_step=0.0, bound_launches_per_step=None, program_launches=None):
        self.window_s = win["window_s"]
        self.steps = win["steps"]
        self.work = win["work"]
        self.setup_s = setup_s
        self.flops_per_step = flops_per_step
        self.summary = summary
        self.peak_bytes = peak_bytes
        self.bound_ms_per_step = bound_ms_per_step
        self.bound_launches_per_step = bound_launches_per_step or {}
        self.program_launches = program_launches or {}

    @property
    def busy_s(self):
        return self.summary["busy_s"] if self.summary else None

    def span_device_s(self, prefix: str) -> float:
        """Device seconds of the spans whose names start with ``prefix``: the
        union of their device ranges, so nested spans count once."""
        ivals = sorted((s, e) for name, s, e in self.summary["span_ranges"]
                       if name.startswith(prefix))
        total, end = 0.0, -float("inf")
        for s0, s1 in ivals:
            if s1 > end:
                total += s1 - max(s0, end)
                end = s1
        return total / 1e6

    def kernel_device_s(self, match) -> float:
        return sum(s for s, _, name in self.summary["kernels"] if match(name))


def window(prog, seconds: float) -> dict:
    """Steps until ``seconds`` have passed, then waits for the device: the
    window runs from the first step's start to the end of the last one's
    work."""
    prog.sync()
    prog.begin()
    t0 = time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds:
        prog.step()
        marks.append(time.perf_counter())
    prog.sync()
    return {"window_s": time.perf_counter() - t0, "steps": prog.done, "work": prog.work(),
            "step_s": [b - a for a, b in zip(marks, marks[1:])]}


def traced_window(prog, steps: int, device: str):
    """``steps`` steps under torch.profiler: the window, the trace's summary,
    the program's launches of each hand kernel, and the profile."""
    from torch.profiler import ProfilerActivity, profile
    from waldo_tpu_torch.ops.kernels import KERNELS

    from wbench import trace as tr

    before = {k: v.launches for k, v in KERNELS.items()}
    prog.sync()
    prog.begin(traced=steps)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            prog.step()
        prog.sync()
        wall = time.perf_counter() - t0
    launches = {k: v.launches - before[k] for k, v in KERNELS.items()}
    win = {"window_s": wall, "steps": prog.done, "work": prog.work()}
    return win, tr.spans_and_kernels(prof, wall), launches, prof


def read_metrics(cell, metrics: list, ctx: RunContext, required: bool) -> dict:
    out = {}
    for m in metrics:
        v = cell.reader(m["name"])(ctx)
        if v is None and required:
            raise ValueError(f"{cell.name}: no value for the end-to-end metric {m['name']!r}")
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch
    from waldo_tpu_torch.config import parse_cli

    from plainref.config import parse_cli as ref_parse_cli
    from plainref.synthesizer import Reference
    from wbench import traffic, weights
    from wbench import trace as tr
    from wbench.bounds import KernelBounds
    from wbench.spec import run_flags

    loop = cell.loop()
    seed = int(seed) % (2 ** 63)
    marks = {"imports": time.time() - t_start}
    save_path = tempfile.mkdtemp(prefix="wbench-")
    try:
        flags = run_flags(cell, save_path, seed)
        cfg, ref_cfg = parse_cli(list(flags)), ref_parse_cli(list(flags))
        torch.backends.cuda.matmul.allow_tf32 = False  # the configuration's precision
        torch.backends.cudnn.allow_tf32 = False
        skeleton = Reference(ref_cfg, device, meta=True).nets()
        made = weights.make(skeleton, seed, device, cell.traffic["weights"])
        pool = traffic.batches(cfg, cell.traffic, seed, device,
                               host=(cell.traffic["pool_on"] == "host"))
        marks["inputs_and_weights"] = time.time() - t_start
        prog = loop.Program(cell, cfg, made, pool, seed, device)
        del made
        marks["program_built"] = time.time() - t_start
        prog.warm()
        prog.sync()
        check_imports("after set-up")
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_start
        log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s ("
            + ", ".join(f"{k} by {v:.3f} s" for k, v in marks.items()) + ")")

        if trace:
            win, summary, launches, prof = traced_window(prog, cell.traffic["trace_steps"],
                                                         device)
        else:
            win = window(prog, seconds)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        attempted, failed = prog.done, prog.failed
        log(f"[bench] window {win['window_s']:.3f} s, {attempted} steps, {failed} failed, "
            f"peak {peak / 1e9:.3f} GB")
        if len(win.get("step_s", ())) > 3:
            q = statistics.quantiles(win["step_s"], n=4)
            log(f"[bench] host s a step (a training step's enqueue): quartiles "
                f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, first {win['step_s'][0]:.4f}, "
                f"last {win['step_s'][-1]:.4f}")
        held = prog.finish()
        del prog
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        # the check, on the timed path's outputs
        t_check = time.perf_counter()
        observer = KernelBounds() if trace else None
        start = weights.make(skeleton, seed, device, cell.traffic["weights"])
        numbers, flops, observed = loop.check(cell, ref_cfg, start, pool, held, device, observer)
        log(f"[bench] check {time.perf_counter() - t_check:.3f} s; model FLOPs a step {flops}")

        if not trace:
            metrics = read_metrics(cell, cell.end_to_end, RunContext(win, setup_s, flops), True)
        else:
            ctx = RunContext(win, setup_s, flops, summary, peak, observer.ms / observed,
                             {k: v / observed for k, v in observer.launches.items()}, launches)
            metrics = read_metrics(cell, cell.per_layer, ctx, False)
        limits = cell.limits or {}
        compared = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
        correct = bool(limits) and all(c["value"] <= c["limit"] for c in compared.values())
        dev = {"platform": "gpu" if device != "cpu" else "cpu",
               "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
               "count": cell.chips, "memory_peak_bytes": peak}
        result = {"correct": correct, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace:
            dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
            result["breakdown"] = tr.breakdown(prof, summary)
        result["numbers"] = numbers
        result["compared"] = compared
        return result
    finally:
        shutil.rmtree(save_path, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from wbench.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
        check_imports("after the window")
    except ForbiddenModules as e:
        log(str(e))
        return 1
    from wbench.bounds import FP32_FLOPS, HBM_BPS

    log(f"[bench] card: {card_line()}; the peaks read against: float32 {FP32_FLOPS:.3g} "
        f"flop/s, HBM {HBM_BPS:.3g} B/s (H100 SXM data sheet)")
    for name, c in result["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

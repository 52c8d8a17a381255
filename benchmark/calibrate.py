#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card, in
one process (the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... \\
        [--seconds 5] [--controls 3] [--out <file.jsonl>]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a window
of ``--seconds``, the check) gives the program's numbers. For the first
``--controls`` seeds it also gives the control's and the faults' numbers,
as the cell's loop defines them (``readings`` in ``loops/<loop>.py``): the
reference put in the program's place in the nearest precision below the
configuration's (TF32 for float32 with TF32 off), and with the faults the
cell can have. Each reading is one JSON line on standard output (and in
``--out``).
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control_readings(cell, seed: int, device: str) -> list:
    """The control's and the faults' numbers on seed's inputs and weights,
    as the cell's loop gives them (``readings`` of ``loops/<loop>.py``)."""
    import torch

    from plainref.config import parse_cli as ref_parse_cli
    from plainref.synthesizer import Reference
    from wbench import traffic, weights
    from wbench.spec import run_flags

    cfg = ref_parse_cli(run_flags(cell, "/nonexistent", seed))
    start = weights.make(Reference(cfg, device, meta=True).nets(), seed, device,
                         cell.traffic["weights"])
    pool = traffic.batches(cfg, cell.traffic, seed, device,
                           host=(cell.traffic["pool_on"] == "host"))
    rows = cell.loop().readings(cell, cfg, start, pool, device)
    del pool, start
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import run
    from wbench.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate.py reads the card: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    cell.limits = None  # readings, not a verdict
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for n, seed in enumerate(seeds):
        t0 = time.time()
        res = run.run_cell(cell, seed, args.seconds, False, "cuda", t0)
        emit({"seed": seed, "kind": "program", "numbers": res["numbers"],
              "attempted": res["attempted"], "failed": res["failed"],
              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
              "peak_bytes": res["device"]["memory_peak_bytes"],
              "seconds": time.time() - t0})
        gc.collect()
        torch.cuda.empty_cache()
        if n < args.controls:
            torch.cuda.reset_peak_memory_stats()
            for row in control_readings(cell, seed, "cuda"):
                emit({"seed": seed, **row})
            print(f"reference peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  file=sys.stderr, flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

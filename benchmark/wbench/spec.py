"""A cell of the benchmark, found by name: its entry in BENCHMARK.json, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the loop that mix runs (``loops/<loop>.py``),
the limits of its correctness check (``limits/<workload>.json``) and the
readers of its metrics (``metrics/<metric>.py``, or, where there is none,
``metrics/<the metric's name up to its first dot>.py``, so that
``idle_share.eval`` and ``idle_share.train`` share ``idle_share.py``).
Nothing here names a cell: a new configuration, mix, loop or metric is a
new file and a new entry."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[Dict[str, float]]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    @property
    def flags(self) -> List[str]:
        """The script's flags as the configuration runs them: the script's
        own, then the configuration's changes."""
        script = self.traffic["script"]
        if script not in self.config["scripts"]:
            raise KeyError(f"configuration {self.config_name!r} has no flags of the script "
                           f"{script!r} that traffic {self.traffic_name!r} runs")
        return list(self.config["scripts"][script]) + list(self.config.get("changed", []))

    def reader(self, metric: str) -> Callable:
        """The ``read(ctx)`` function of a metric's reader."""
        return _module(reader_path(metric, self.bench_dir), "metric").read

    def loop(self):
        """The module of the loop the cell's traffic mix runs."""
        return _module(self.bench_dir / "loops" / f"{self.traffic['loop']}.py", "loop")


def reader_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    own = bench_dir / "metrics" / f"{metric}.py"
    return own if own.exists() else bench_dir / "metrics" / f"{metric.split('.')[0]}.py"


def _module(path: Path, kind: str):
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"wbench_{kind}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _in_cell(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_json: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench_json = bench_json or bench_dir.parent / "BENCHMARK.json"
    spec = json.loads(Path(bench_json).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((bench_dir.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())["limits"] if limits_path.exists() else None
    return Cell(name=workload, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _in_cell(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _in_cell(m, workload)],
                bench_dir=bench_dir)


def run_flags(cell: Cell, save_path: str, seed: int) -> List[str]:
    """The flags a run parses: the cell's, with the run's directory and a
    seed for the program's own draws."""
    return cell.flags + ["--save_path", save_path, "--datetime", "bench",
                         "--seed", str(seed % (2 ** 31 - 16))]

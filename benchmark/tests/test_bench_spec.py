"""BENCHMARK.json is data: every configuration, traffic mix, limit file and
per-layer reader is found by name, and the file keeps its agreed
shape."""
import json
import re

import pytest
from wbench.spec import BENCH_DIR, ROOT, load_cell, reader_path

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]] + WORKLOADS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = load_cell(workload)
    assert cell.traffic["script"] in cell.config["scripts"]
    assert cell.limits, f"{workload} has no limits file"
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    loop = cell.loop()
    assert all(hasattr(loop, k) for k in ("Program", "check", "readings"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_flags_parse_alike(workload):
    """The program's parser and the reference's copy read the cell's flags
    into the same configuration."""
    from plainref.config import parse_cli as ref_parse, to_dict as ref_dict
    from waldo_tpu_torch.config import parse_cli, to_dict
    from wbench.spec import run_flags

    cell = load_cell(workload)
    flags = run_flags(cell, "/nonexistent", 2 ** 31 + 7)
    assert to_dict(parse_cli(list(flags))) == ref_dict(ref_parse(list(flags)))


def test_every_file_belongs_to_a_name():
    """No stray configuration, mix, loop, limit or reader: each file under
    those folders is named by an entry of BENCHMARK.json."""
    configs = {c["file"].split("/")[-1] for c in SPEC["configs"]}
    assert {p.name for p in (BENCH_DIR / "configs").glob("*.json")} == configs
    traffic = {w["traffic"] for w in SPEC["workloads"]}
    assert {p.stem for p in (BENCH_DIR / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (BENCH_DIR / "limits").glob("*.json")} <= set(WORKLOADS)
    loops = {load_cell(w).traffic["loop"] for w in WORKLOADS}
    assert {p.stem for p in (BENCH_DIR / "loops").glob("*.py")} == loops
    readers = {reader_path(m["name"]) for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert set((BENCH_DIR / "metrics").glob("*.py")) == readers

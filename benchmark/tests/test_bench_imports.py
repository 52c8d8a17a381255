"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import subprocess
import sys

from wbench.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "waldo_tpu"}


def test_a_run_loads_no_jax():
    """Import everything a run imports, then look at sys.modules by whole
    top-level names (``waldo_tpu_torch`` is not ``waldo_tpu``)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, calibrate\n"
        "from wbench import check, traffic, weights, bounds, trace, spec\n"
        "for w in ('cityscapes.eval', 'kitti.train_lvd'): spec.load_cell(w).loop()\n"
        "from plainref.synthesizer import Reference\n"
        "from plainref import adam, metrics\n"
        "import waldo_tpu_torch.train, waldo_tpu_torch.ops.kernels\n"
        "print(run.forbidden_modules())\n" % (str(ROOT), str(BENCH_DIR)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_check_compares_whole_top_level_names(monkeypatch):
    import types

    import run

    monkeypatch.setitem(sys.modules, "waldo_tpu_torch_fake", types.ModuleType("x"))
    assert run.forbidden_modules() == [] or "waldo_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "waldo_tpu", types.ModuleType("waldo_tpu"))
    assert "waldo_tpu" in run.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "plainref").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"waldo_tpu_torch", "wbench"}, f"{path}: {n}"

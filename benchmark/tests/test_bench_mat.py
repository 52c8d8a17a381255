"""The MAT cell's pieces with no card: K3's bound arithmetic, the five
readers on hand-made trace summaries, the cell found by name; and on the
card, the control and the key-mask fault against the cell's limits."""
import pytest
import torch
from run import RunContext
from wbench.bounds import KernelBounds, bound_ms
from wbench.spec import _module, load_cell, reader_path

CELL = "cityscapes_mat.eval"
SEED = 2 ** 31 + 2121


def test_k3_bound_by_hand():
    from plainref.ops.bias_act import bias_act, observe
    from wbench.bounds_mat import k3_launch, k3_observer

    x, b = torch.zeros(2, 8, 8, 180), torch.zeros(180)
    # x and the bias read, the output written, float32; lrelu's 4 operations an element
    assert k3_launch(x, b, "lrelu") == {"name": "bias_act", "nbytes": 4 * (2 * x.numel() + 180),
                                        "nops": 4 * x.numel()}
    assert k3_launch(x, None, "linear", clamp=256.0)["nops"] == 4 * x.numel()
    assert k3_launch(x, None, "linear", clamp=None)["nbytes"] == 8 * x.numel()
    # MAT's largest launch is bound by its bytes: 378 MB at 3.35 TB/s, 0.113 ms
    big = k3_launch(torch.empty(1, 512, 512, 180, device="meta"), torch.empty(180), "lrelu")
    assert bound_ms(big["nbytes"], big["nops"]) == pytest.approx(0.11269, rel=1e-3)
    kb = KernelBounds()
    kb("add", **k3_launch(x, b, "lrelu"))
    assert kb.launches == {"bias_act": 1}
    # the plain bias_act tells an observer of CUDA launches only, as the program
    # launches K3 on CUDA tensors only
    kb = KernelBounds()
    with observe(k3_observer(kb)):
        bias_act(x, b, act="lrelu")
    assert kb.launches == {}


def read(metric, span_ranges=(), kernels=(), steps=2, bounds=None, program=None, bound_ms=0.0):
    ctx = RunContext({"window_s": 1.0, "steps": steps, "work": {}}, 0.0, 0.0,
                     summary={"busy_s": 0.5, "kernels": list(kernels), "intervals": [],
                              "span_ranges": list(span_ranges)},
                     bound_ms_per_step=bound_ms, bound_launches_per_step=bounds,
                     program_launches=program)
    return _module(reader_path(metric), "metric").read(ctx)


def two_forwards():
    """Two clips' generator forwards (us): each a generator row that holds the
    mapping's kernels alone (the trace gives a kernel to the innermost span),
    then a transformer row and a decoder row."""
    rows = []
    for s in (0, 1000):
        rows += [("mat/generator", s, s + 10), ("mat/transformer", s + 10, s + 110),
                 ("mat/decoder", s + 110, s + 300)]
    return rows + [("mat/propagate_frame", 900, 2000), ("eval/predict", 0, 5000)]


def test_mat_span_readers():
    rows = two_forwards()
    assert read("mat_ms.eval", rows) == pytest.approx(600 / 1e3 / 2)
    # the parent's program: one generator row a forward over all its kernels
    assert read("mat_ms.eval", [("mat/generator", 0, 300), ("mat/generator", 1000, 1300)]) \
        == pytest.approx(600 / 1e3 / 2)
    assert read("mat_transformer_ms.eval", rows) == pytest.approx(200 / 1e3 / 2)
    assert read("mat_decoder_ms.eval", rows) == pytest.approx(380 / 1e3 / 2)
    assert read("mat_forwards.eval", rows) == pytest.approx(1.0)
    # the parent's program has the generator's span but not the inner two
    outer = [r for r in rows if r[0] not in ("mat/transformer", "mat/decoder")]
    assert read("mat_transformer_ms.eval", outer) is None
    assert read("mat_decoder_ms.eval", outer) is None
    for metric in ("mat_ms.eval", "mat_forwards.eval"):
        assert read(metric, [("eval/predict", 0, 5000)]) is None


def test_k3_roofline_reader():
    kernels = [(0.002, 300, "void (anonymous namespace)::bias_act_vec4_kernel<2>(float4 const*)"),
               (0.001, 40, "void (anonymous namespace)::bias_act_scalar_kernel<0>(float const*)"),
               (0.050, 9, "void cudnn::conv_kernel")]
    want = dict(kernels=kernels, steps=2, bounds={"bias_act": 170.0}, bound_ms=0.9)
    got = read("k3_roofline.eval", program={"bias_act": 340, "grid_sample": 12}, **want)
    assert got == pytest.approx(100 * 0.9 * 2 / 1e3 / 0.003)
    # the program's launches differ from the bounds': no reading
    assert read("k3_roofline.eval", program={"bias_act": 339}, **want) is None
    assert read("k3_roofline.eval", program={}, **want) is None
    # bounds of other kernels too (another cell's observer): no reading
    other = dict(want, bounds={"bias_act": 170.0, "grid_sample": 1.0})
    assert read("k3_roofline.eval", program={"bias_act": 340}, **other) is None
    # no K3 row in the trace
    assert read("k3_roofline.eval", program={"bias_act": 340},
                **dict(want, kernels=kernels[2:])) is None


def test_cell_found_by_name():
    cell = load_cell(CELL)
    assert cell.config_name == "cityscapes_mat" and cell.traffic_name == "eval_mat"
    assert cell.chips == 1 and cell.traffic["loop"] == "eval_mat"
    assert set(cell.limits) >= {"vid_gap_mean", "metric_gap"}
    flags = cell.flags
    for flag in ("--s_loop_ii", "--s_inpaint_obj", "--s_propagate_unique", "--s_use_shadows",
                 "--s_use_expansion", "--s_soft_shadow", "--s_propagate_obj",
                 "--s_use_inpainter", "--s_use_mat_inpainter"):
        assert flags[flags.index(flag) + 1] == "true", flag
    assert flags[-2:] == ["--s_inpainter_path", ""]
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"pred_frames_per_s", "mfu.eval", "setup_s", "mat_ms.eval", "mat_transformer_ms.eval",
            "mat_decoder_ms.eval", "mat_forwards.eval", "k3_roofline.eval"} <= names
    assert "kernel_roofline.eval" not in names
    for name in names:
        assert callable(cell.reader(name))
    loop = cell.loop()
    assert all(hasattr(loop, k) for k in ("Program", "check", "readings", "altered"))


def test_mat_state_follows_the_seed_and_the_laws():
    from plainref.models.mat_pipeline import MatInpainter
    from waldo_tpu_torch.models.mat.mat import Generator
    from wbench import weights_mat

    state = weights_mat.make(SEED, "cpu", 128)
    assert set(state) == set(Generator(img_resolution=128).state_dict())
    MatInpainter("cpu", 128).load(state)
    conv = state["synthesis.enc.b7.conv1.weight"]
    rgb = state["synthesis.dec.Dec_128x128.toRGB.conv.weight"]
    assert 0.094 < float(rgb.std()) < 0.098 and float(rgb.abs().max()) <= 0.2 + 1e-6
    assert 0.94 < float(conv.std()) < 0.98 and float(conv.abs().max()) <= 2.0  # N(0, 1) clamped at 2
    assert 94 < float(state["mapping.fc0.weight"].std()) < 98  # lr 0.01: N(0, 100) clamped
    affine = state["synthesis.dec.Dec_16x16.conv1.conv.affine.bias"]
    assert torch.equal(affine, torch.ones_like(affine))
    assert float(state["synthesis.dec.Dec_16x16.conv1.noise_strength"]) == 0.0
    again, other = weights_mat.make(SEED, "cpu", 128), weights_mat.make(SEED + 1, "cpu", 128)
    assert torch.equal(again["synthesis.enc.b7.conv1.weight"], conv)
    assert not torch.equal(other["synthesis.enc.b7.conv1.weight"], conv)


def test_the_cell_loads_no_jax():
    """The cell's loop, the plain MAT and K3's bounds, imported in a fresh
    process, load neither JAX nor the JAX package."""
    import subprocess
    import sys

    from wbench.spec import BENCH_DIR, ROOT

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run\n"
            "from wbench import spec, weights_mat, bounds_mat\n"
            "spec.load_cell(%r).loop()\n"
            "from plainref.models import mat, mat_pipeline\n"
            "import waldo_tpu_torch.models.mat\n"
            "print(run.forbidden_modules())\n" % (str(ROOT), str(BENCH_DIR), CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_control_and_key_mask_fault_are_not_correct(card):
    """On the card at the cell's own size, one clip a seed: the reference in
    TF32, and MAT with its key mask left out, each fail one of the cell's
    limits, on three seeds."""
    import calibrate

    cell = load_cell(CELL)
    cell.traffic["sample"] = 1
    for seed in (SEED, SEED + 1, SEED + 2):
        rows = {r["kind"]: r["numbers"] for r in calibrate.control_readings(cell, seed, card)}
        for kind in ("control_tf32", "fault_keys_unmasked", "fault_answer_altered"):
            assert any(rows[kind][k] > lim for k, lim in cell.limits.items()), (seed, kind, rows)

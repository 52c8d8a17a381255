"""The readers of the step spans and the launch count on hand-made trace
summaries, with no card: span rows are (name, start us, end us) device
ranges, kernel rows (device s, count, name)."""
import pytest
from run import RunContext
from wbench.spec import _module, reader_path


def read(metric, span_ranges=(), kernels=(), steps=2):
    ctx = RunContext({"window_s": 1.0, "steps": steps, "work": {}}, 0.0, 0.0,
                     summary={"busy_s": 0.5, "kernels": list(kernels), "intervals": [],
                              "span_ranges": list(span_ranges)})
    return _module(reader_path(metric), "metric").read(ctx)


def two_steps(backward):
    """Two training steps: forward 0-100 and 300-390 us, optimizer from 180
    and 470 us, so 80 + 80 us from each forward's end to its optimizer; the
    backward rows as given."""
    rows = [("train/forward", 0, 100), ("train/optimizer", 180, 200),
            ("train/forward", 300, 390), ("train/optimizer", 470, 480)]
    return rows + [("train/backward", s, e) for s, e in backward]


def test_bwd_ms_between_forward_and_optimizer():
    # the backward's rows cover 10 of 160 us (the engine's thread launched the rest)
    got = read("bwd_ms.train", two_steps([(100, 105), (390, 395)]))
    assert got == pytest.approx(160 / 1e3 / 2)
    # no backward row at all: the same interval
    assert read("bwd_ms.train", two_steps([])) == pytest.approx(160 / 1e3 / 2)


def test_bwd_ms_from_its_own_rows():
    # rows over 77 + 78 of the 160 us (>= 95 %) are read themselves
    got = read("bwd_ms.train", two_steps([(102, 179), (391, 469)]))
    assert got == pytest.approx(155 / 1e3 / 2)


def test_bwd_ms_without_the_step_spans():
    assert read("bwd_ms.train", [("lvd/encode_input", 0, 10)]) is None


def test_launches_sum_the_per_op_counts():
    kernels = [(0.010, 300, "void at::native::vectorized_elementwise_kernel<4>"),
               (0.004, 6, "Memcpy HtoD (Pageable -> Device)"),
               (0.001, 2, "Memset (Device)")]
    assert read("launches.train", kernels=kernels, steps=2) == pytest.approx(154)
    assert read("launches.eval", kernels=kernels, steps=4) == pytest.approx(77)
    assert read("launches.eval", kernels=[]) is None


def test_copy_phase_ms_counts_nested_and_overlapping_rows_once():
    rows = [("eval/copy_in", 0, 100), ("eval/copy_in", 20, 60),  # nested
            ("eval/copy_out", 500, 600), ("eval/copy_out", 550, 700),  # overlapping
            ("eval/metrics", 300, 400), ("eval/predict", 0, 700)]
    assert read("copy_phase_ms.eval", rows, steps=2) == pytest.approx(300 / 1e3 / 2)
    assert read("metrics_ms.eval", rows, steps=2) == pytest.approx(100 / 1e3 / 2)
    assert read("copy_phase_ms.eval", [("eval/predict", 0, 700)]) is None


@pytest.mark.parametrize("metric,prefix", [("fwd_ms.train", "train/forward"),
                                           ("optim_ms.train", "train/optimizer"),
                                           ("loss_ms.train", "loss/")])
def test_span_readers_read_their_rows(metric, prefix):
    name = prefix + ("reconstruction" if prefix.endswith("/") else "")
    rows = [(name, 0, 40), (name, 1000, 1060), ("train/backward", 40, 1000)]
    assert read(metric, rows, steps=2) == pytest.approx(100 / 1e3 / 2)
    assert read(metric, [("lvd/encode_input", 0, 10)]) is None

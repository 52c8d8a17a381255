"""The ``pinned_share`` reader on hand-made trace summaries, with no card:
kernel rows are (device s, count, name)."""
import pytest
from run import RunContext
from wbench.spec import _module, reader_path

PAGEABLE = [(0.030, 9, "Memcpy HtoD (Pageable -> Device)"),
            (0.010, 5, "Memcpy DtoH (Device -> Pageable)")]
PINNED = [(0.006, 22, "Memcpy HtoD (Pinned -> Device)"),
          (0.004, 5, "Memcpy DtoH (Device -> Pinned)")]
OTHER = [(0.200, 300, "void at::native::vectorized_elementwise_kernel<4>"),
         (0.050, 4, "Memcpy DtoD (Device -> Device)")]


def read(kernels):
    ctx = RunContext({"window_s": 1.0, "steps": 3, "work": {}}, 0.0, 0.0,
                     summary={"busy_s": 0.5, "kernels": list(kernels), "intervals": [],
                              "span_ranges": []})
    return _module(reader_path("pinned_share.eval"), "metric").read(ctx)


@pytest.mark.parametrize("kernels,want", [
    (PAGEABLE + OTHER, 0.0),
    (PINNED + OTHER, 100.0),
    (PAGEABLE + PINNED + OTHER, 100 * 0.010 / 0.050),  # weighted by device time
    (OTHER, None),
    ([], None),
])
def test_pinned_share(kernels, want):
    got = read(kernels)
    assert got == (None if want is None else pytest.approx(want))

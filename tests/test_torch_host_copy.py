"""The evaluator's host copies (waldo_tpu_torch/utils/host_copy.py) on the
CPU: the chunked staging path, with CPU tensors standing in for the
page-locked slots and a chunk of a few bytes, moves every byte of arrays
whose sizes are no multiple of the chunk, and two calls reuse the same two
slots."""
import numpy as np
import pytest
import torch

from waldo_tpu_torch.utils.host_copy import Staging, to_host

CHUNK = 40  # bytes


def arrays(kind: str, rng):
    if kind == "float32":
        return {"vid": rng.standard_normal((2, 3, 5, 7)).astype(np.float32),  # 840 B
                "small": rng.standard_normal(3).astype(np.float32)}  # under a chunk
    if kind == "int64":
        return {"ids": rng.integers(-2 ** 62, 2 ** 62, size=(3, 7))}  # 168 B
    if kind == "strided":
        full = rng.standard_normal((6, 9, 4)).astype(np.float32)
        return {"view": full[::2, 1:8, ::-1], "t": full.transpose(2, 0, 1)}
    return {"empty": np.zeros((0, 5), np.float32), "scalar": np.array(3.5, np.float64)}


@pytest.mark.parametrize("kind", ["float32", "int64", "strided", "empty"])
def test_chunked_staging_moves_every_byte_and_reuses_its_slots(kind):
    rng = np.random.default_rng(7)
    staging = Staging()
    for call in range(2):
        src = arrays(kind, rng)
        got = staging._to_device(src, torch.device("cpu"), CHUNK)
        assert got.keys() == src.keys()
        for k, a in src.items():
            assert got[k].dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
            assert got[k].shape == a.shape
            assert got[k].numpy().tobytes() == np.ascontiguousarray(a).tobytes()
        slots = [s.data_ptr() for s in staging.slots]
        if call == 0:
            first = slots
        assert staging.allocations == 2 and slots == first
    assert all(s.numel() == CHUNK for s in staging.slots)


def test_cpu_entries_are_the_plain_copies():
    rng = np.random.default_rng(3)
    src = arrays("float32", rng)
    staging = Staging()
    got = staging.to_device(src, "cpu")
    assert staging.allocations == 0  # no slot on the CPU
    assert all(np.array_equal(got[k].numpy(), v) for k, v in src.items())
    half = {"x": torch.arange(6, dtype=torch.float16).reshape(2, 3)[:, 1:]}
    out = to_host(half, "cpu")
    assert out["x"].dtype == np.float32 and np.array_equal(out["x"], [[1, 2], [4, 5]])

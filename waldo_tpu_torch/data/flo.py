"""Middlebury .flo optical-flow files (PIEH header): the port's copy of
waldo_tpu/data/flo.py.
"""
from __future__ import annotations

import numpy as np


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32 (raw pixel displacements)."""
    with open(path, "rb") as f:
        header = f.read(4)
        assert header.decode("utf-8") == "PIEH", f"bad .flo header in {path}"
        width = int(np.fromfile(f, np.int32, 1)[0])
        height = int(np.fromfile(f, np.int32, 1)[0])
        flow = np.fromfile(f, np.float32, width * height * 2).reshape(height, width, 2)
    return flow


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        f.write(b"PIEH")
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)

"""The C++ data-path library (``csrc/waldo_native.cpp`` at the repository
root) bound with ctypes: the port's counterpart of waldo_tpu/data/native.py.

The source is compiled with ``g++`` on first use into
``build/waldo_tpu_torch/libwaldo_native_<digest>.so`` (the digest covers the
source and the flags) and used on every call the library covers; a failed
build raises, there is no silent switch to numpy. ctypes releases the GIL
during a call, so the loader's clip threads transform frames in parallel.

The ``*_plain`` functions are numpy versions of the same arithmetic
(crop, bilinear resize with half-pixel centres and edge clamp, flips), kept
for the tests to hold the library to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "waldo_native.cpp"
BUILD_DIR = _ROOT / "build" / "waldo_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libwaldo_native_{digest}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} with g++ failed:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent builder never sees half a file


def load() -> ctypes.CDLL:
    """The library, built first if its file is missing."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            i32 = ctypes.c_int32
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.layout_onehot_resize.argtypes = [i32p, i32, i32, i32, i32p, i32, i32, i32, i32,
                                                 i32, i32, i32, i32, i32, f32p]
            lib.flow_normalize_resize.argtypes = [f32p, i32, i32, ctypes.c_float, i32, i32, i32,
                                                  i32, i32, i32, i32, i32, f32p]
            lib.rgb_transform.argtypes = [u8p, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                                          f32p]
            for fn in (lib.layout_onehot_resize, lib.flow_normalize_resize, lib.rgb_transform):
                fn.restype = None
            _LIB = lib
        return _LIB


def _check_crop(shape, top, left, ch, cw):
    h, w = shape[:2]
    if not (0 <= top and 0 <= left and ch > 0 and cw > 0 and top + ch <= h and left + cw <= w):
        raise ValueError(f"crop ({top}, {left}, {ch}, {cw}) outside a {h}x{w} frame")


def layout_onehot_resize(lyt: np.ndarray, num_lyt: int, remap, top, left, ch, cw,
                         out_h, out_w, flip_x=False, flip_y=False) -> np.ndarray:
    """Class ids (H, W) -> remapped, one-hot, cropped, resized, flipped,
    scaled 5*(2x-1): (out_h, out_w, num_lyt) float32."""
    lib = load()
    lyt = np.ascontiguousarray(lyt, np.int32)
    _check_crop(lyt.shape, top, left, ch, cw)
    remap = np.ascontiguousarray(np.asarray(remap, np.int32).reshape(-1))
    out = np.empty((out_h, out_w, num_lyt), np.float32)
    lib.layout_onehot_resize(lyt, lyt.shape[0], lyt.shape[1], num_lyt, remap, len(remap) // 2,
                             top, left, ch, cw, out_h, out_w, int(flip_x), int(flip_y), out)
    return out


def flow_normalize_resize(flow: np.ndarray, zoom, flip_x, flip_y, top, left, ch, cw,
                          out_h, out_w) -> np.ndarray:
    """Raw pixel flow (H, W, 2) -> zoomed, sign-flipped, normalized 2*px/size,
    cropped, resized, flipped: (out_h, out_w, 2) float32."""
    lib = load()
    flow = np.ascontiguousarray(flow, np.float32)
    _check_crop(flow.shape, top, left, ch, cw)
    out = np.empty((out_h, out_w, 2), np.float32)
    lib.flow_normalize_resize(flow, flow.shape[0], flow.shape[1], float(zoom), int(flip_x),
                              int(flip_y), top, left, ch, cw, out_h, out_w, out)
    return out


def rgb_transform(img: np.ndarray, top, left, ch, cw, out_h, out_w,
                  flip_x=False, flip_y=False) -> np.ndarray:
    """uint8 (H, W, 3) -> cropped, resized, flipped, in [-1, 1]:
    (out_h, out_w, 3) float32."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    _check_crop(img.shape, top, left, ch, cw)
    out = np.empty((out_h, out_w, 3), np.float32)
    lib.rgb_transform(img, img.shape[0], img.shape[1], top, left, ch, cw, out_h, out_w,
                      int(flip_x), int(flip_y), out)
    return out


# ---------------------------------------------------------------------------
# plain versions (numpy, float32, the library's order of operations)
# ---------------------------------------------------------------------------


def _taps(n_src, n_dst):
    scale = np.float32(n_src) / np.float32(n_dst)
    f = (np.arange(n_dst, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    fl = np.floor(f)
    i0 = np.clip(fl.astype(np.int64), 0, n_src - 1)
    i1 = np.minimum(i0 + 1, n_src - 1)
    t = np.clip(f - fl, np.float32(0), np.float32(1))
    t[f < 0] = 0
    return i0, i1, t


def resize_bilinear_plain(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) float32 -> (out_h, out_w, C): half-pixel centres, edge
    clamp, no antialiasing (torch's bilinear with align_corners=False)."""
    src = np.asarray(src, np.float32)
    y0, y1, ty = _taps(src.shape[0], out_h)
    x0, x1, tx = _taps(src.shape[1], out_w)
    ty, tx = ty[:, None, None], tx[None, :, None]
    one = np.float32(1)
    top = src[y0][:, x0] * (one - tx) + src[y0][:, x1] * tx
    bot = src[y1][:, x0] * (one - tx) + src[y1][:, x1] * tx
    return top * (one - ty) + bot * ty


def _flips(a, flip_x, flip_y):
    if flip_x:
        a = a[:, ::-1]
    if flip_y:
        a = a[::-1]
    return np.ascontiguousarray(a)


def layout_onehot_resize_plain(lyt, num_lyt, remap, top, left, ch, cw, out_h, out_w,
                               flip_x=False, flip_y=False) -> np.ndarray:
    v = np.asarray(lyt, np.int64)[top: top + ch, left: left + cw]
    pairs = np.asarray(remap, np.int64).reshape(-1, 2)
    out_v = v.copy()
    done = np.zeros(v.shape, bool)
    for src, tgt in pairs:  # the first matching pair wins, as in the library
        hit = (v == src) & ~done
        out_v[hit] = tgt
        done |= hit
    valid = (out_v >= 0) & (out_v < num_lyt)
    hot = np.zeros(v.shape + (num_lyt,), np.float32)
    np.put_along_axis(hot, np.clip(out_v, 0, num_lyt - 1)[..., None],
                      valid[..., None].astype(np.float32), axis=-1)
    out = _flips(resize_bilinear_plain(hot, out_h, out_w), flip_x, flip_y)
    return np.float32(5) * (out * np.float32(2) - np.float32(1))


def flow_normalize_resize_plain(flow, zoom, flip_x, flip_y, top, left, ch, cw,
                                out_h, out_w) -> np.ndarray:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    f = flow[top: top + ch, left: left + cw] * np.float32(zoom)
    if flip_x:
        f[..., 0] = -f[..., 0]
    if flip_y:
        f[..., 1] = -f[..., 1]
    f[..., 0] = np.float32(2) * f[..., 0] / np.float32(w)
    f[..., 1] = np.float32(2) * f[..., 1] / np.float32(h)
    return _flips(resize_bilinear_plain(f, out_h, out_w), flip_x, flip_y)


def rgb_transform_plain(img, top, left, ch, cw, out_h, out_w,
                        flip_x=False, flip_y=False) -> np.ndarray:
    tmp = np.asarray(img, np.uint8)[top: top + ch, left: left + cw].astype(np.float32) \
        / np.float32(255)
    out = _flips(resize_bilinear_plain(tmp, out_h, out_w), flip_x, flip_y)
    return out * np.float32(2) - np.float32(1)

"""TensorBoard logging (counterpart of waldo_tpu/train/logger.py).

Scalars with NaN zeroing, image grids and video frame strips (predicted
frames framed in red) in [-1, 1], layouts coloured by the dataset palette,
flows as HSV, through ``torch.utils.tensorboard.SummaryWriter`` as the JAX
package writes them, so both packages' event files decode to the same
pixels. The renderers are numpy, the JAX package's own arithmetic.

The control-point renders (``get_pts``, ``get_mot``, ``get_delta_mot``)
draw with a small numpy rasterizer instead of matplotlib, which the card's
machine lacks: a disk per point and a line segment per motion vector, at the
positions and in the ``jet`` colours of the JAX package's matplotlib
figures (64 dpi, axes [-1, 1] inset by tight_layout's 9.6 px pad, y up).
"""
from __future__ import annotations

import colorsys
import math
import os
import sys
import types
from typing import Optional

import numpy as np


def flow_to_rgb(flow: np.ndarray, max_norm: Optional[float] = None) -> np.ndarray:
    """flow (..., H, W, 2) -> rgb (..., H, W, 3) in [0, 1] via HSV angle/mag."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx ** 2 + fy ** 2)
    ang = (np.arctan2(fy, fx) + math.pi) / (2 * math.pi)
    if max_norm is None:
        max_norm = max(mag.max(), 1e-6)
    val = np.clip(mag / max_norm, 0, 1)
    h6 = ang * 6.0
    i = np.floor(h6) % 6
    f = h6 - np.floor(h6)
    p = np.zeros_like(val)
    q = val * (1 - f)
    t = val * f
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4], [val, q, p, p, t], val)
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4], [t, val, val, q, p], p)
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4], [p, p, t, val, val], q)
    return np.stack([r, g, b], axis=-1)


def colorize_layout(lyt: np.ndarray, palette: Optional[list] = None) -> np.ndarray:
    """lyt (..., H, W, C) channel scores -> rgb (..., H, W, 3) in [0, 1]."""
    idx = np.argmax(lyt, axis=-1)
    n = lyt.shape[-1]
    if palette is not None:
        pal = np.asarray(palette, np.float32).reshape(-1, 3) / 255.0
        pal = pal[:n] if len(pal) >= n else np.concatenate(
            [pal, np.random.RandomState(0).rand(n - len(pal), 3)])
    else:
        pal = np.asarray(
            [colorsys.hsv_to_rgb(i / max(n, 1), 0.75, 0.9) for i in range(n)], np.float32)
    return pal[idx]


class Logger:
    def __init__(self, log_path: str, fps: int = 4):
        os.makedirs(log_path, exist_ok=True)
        # event files need no TensorFlow: an importable tensorboard.compat.notf
        # is TensorBoard's "no_tensorflow" switch, which makes its tf the
        # bundled stub (as on a machine without TensorFlow, the card's) and
        # spares importing TensorFlow, ~13 s, where it is installed
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_path)
        self.fps = fps

    def log_scalar(self, name, value, step):
        v = float(value)
        if not np.isfinite(v):
            v = 0.0  # NaN zeroing, as the reference logger does
        self.writer.add_scalar(name, v, step)

    def log_scalars(self, prefix, scalars, step):
        for k, v in scalars.items():
            try:
                self.log_scalar(f"{prefix}/{k}", v, step)
            except (TypeError, ValueError):
                pass

    @staticmethod
    def _to01(x, span=(-1, 1)):
        x = np.clip(np.asarray(x, np.float32), span[0], span[1])
        return (x - span[0]) / (span[1] - span[0])

    @staticmethod
    def alpha_checkerboard(img, alpha, cell=8):
        """Compose rgb (.., H, W, 3) in [0,1] over a checkerboard using
        alpha (.., H, W, 1) in [0,1]."""
        h, w = img.shape[-3], img.shape[-2]
        yy, xx = np.mgrid[0:h, 0:w]
        board = (((yy // cell) + (xx // cell)) % 2 * 0.2 + 0.6)[..., None]
        return img * alpha + board * (1 - alpha)

    def log_img(self, name, img, step, span=(-1, 1)):
        """img (B, H, W, 3) in span -> grid."""
        img = self._to01(img, span)
        self.writer.add_images(name, img, step, dataformats="NHWC")

    def log_vid(self, name, vid, step, span=(-1, 1), ctx_mask=None):
        """vid (B, T, H, W, 3) in span, logged as a strip of its frames side
        by side (T along the width); a predicted frame (ctx_mask False) gets
        a red border."""
        vid = self._to01(np.asarray(vid), span)
        if ctx_mask is not None:
            border = 2
            pred = ~np.asarray(ctx_mask)
            for b in range(vid.shape[0]):
                for t in range(vid.shape[1]):
                    if t < pred.shape[1] and pred[b, t]:
                        vid[b, t, :border] = [1, 0, 0]
                        vid[b, t, -border:] = [1, 0, 0]
                        vid[b, t, :, :border] = [1, 0, 0]
                        vid[b, t, :, -border:] = [1, 0, 0]
        b, t, h, w, c = vid.shape
        strip = vid.transpose(0, 2, 1, 3, 4).reshape(b, h, t * w, c)
        self.writer.add_images(name, strip, step, dataformats="NHWC")

    def log_flow(self, name, flow, step):
        rgb = flow_to_rgb(np.asarray(flow))
        if rgb.ndim == 5:
            self.log_vid(name, rgb * 2 - 1, step)
        else:
            self.log_img(name, rgb * 2 - 1, step)

    def log_lyt(self, name, lyt, step, palette=None):
        rgb = colorize_layout(np.asarray(lyt), palette)
        if rgb.ndim == 5:
            self.log_vid(name, rgb * 2 - 1, step)
        else:
            self.log_img(name, rgb * 2 - 1, step)

    def log_visuals(self, prefix, arrays, pts, step, palette=None, max_items=2,
                    pts_geometry=None, ctx_len=None):
        """Render a ``Synthesizer.visuals`` payload (numpy arrays): videos,
        HSV flows, layer and semantic layouts, and the control points of the
        first item as points and motion. A payload item that fails to render
        prints a line and is skipped: rendering never stops training."""
        for key, arr in arrays.items():
            kind, name = key.split("/", 1)
            a = np.asarray(arr)[:max_items]
            if a.ndim == 5 and a.shape[-1] == 1 and kind == "vid":
                a = np.repeat(a, 3, axis=-1)  # grayscale map
            ctx_mask = None
            if ctx_len is not None and kind == "vid" and a.ndim == 5:
                ctx_mask = np.arange(a.shape[1])[None, :] < ctx_len
                ctx_mask = np.broadcast_to(ctx_mask, a.shape[:2])
            try:
                if kind == "vid":
                    self.log_vid(f"{prefix}/{name}", a, step, ctx_mask=ctx_mask)
                elif kind == "img":
                    self.log_img(f"{prefix}/{name}", a, step)
                elif kind == "flow":
                    self.log_flow(f"{prefix}/{name}", a, step)
                elif kind == "obj_lyt":
                    self.log_lyt(f"{prefix}/{name}", a, step, palette=None)
                elif kind == "sem_lyt":
                    self.log_lyt(f"{prefix}/{name}", a, step, palette=palette)
            except Exception as e:  # rendering must never kill training
                print(f"[logger] could not render {prefix}/{name}: {e}")
        if pts and pts_geometry is not None:
            h, w = pts_geometry
            n = 1  # the control points of the first item only
            try:
                for src in ("", "pred_"):
                    if f"{src}obj_pts" not in pts:
                        continue
                    op = np.asarray(pts[f"{src}obj_pts"])[:n]
                    bp = np.asarray(pts.get(f"{src}bg_pts", pts["bg_pts"]))[:n]
                    self.log_vid(f"{prefix}/{src}pts", get_pts(op, bp, h, w, mul=2), step)
                    self.log_vid(f"{prefix}/{src}mot", get_mot(op, bp, h, w, mul=2), step)
            except Exception as e:
                print(f"[logger] could not render {prefix} pts: {e}")

    def close(self):
        self.writer.close()


# ---------------------------------------------------------------------------
# control-point renders
# ---------------------------------------------------------------------------

# matplotlib's "jet" (its segment data) and tight_layout's pad: 1.08 x the
# 10 pt font, in points
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_PAD_PT = 1.08 * 10


def _jet_lut(n=256):
    """The 256-entry table matplotlib builds from ``_JET``, with its
    arithmetic (``colors._create_lookup_table``), RGBA."""
    cols = []
    for c in ("red", "green", "blue"):
        a = np.asarray(_JET[c], float)
        x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                              [y0[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.stack(cols + [np.ones(n)], axis=-1)


def _colormap(num):
    """num + 1 colours: grey for the background's points, then the objects'
    from the jet table (matplotlib's sampling of it: index int(x * 256))."""
    x = np.linspace(0, 1, num + 2)[: num + 1]
    idx = np.clip((x * 256).astype(int), 0, 255)
    colors = _jet_lut()[idx]
    colors[0, :3] = 0.5
    return colors


class _Canvas:
    """A white (H, W, 3) uint8 frame with the JAX package's figure
    geometry: data x, y in [-1, 1] (y up) onto the axes box that
    tight_layout leaves at ``dpi``; marks are clipped to that box."""

    def __init__(self, height, width, dpi):
        self.h, self.w, self.dpi = height, width, dpi
        self.pad = _PAD_PT * dpi / 72
        self.img = np.full((height, width, 3), 255, np.uint8)

    def to_pixels(self, x, y):
        """(column, row) in pixel units of data points, y plotted upwards."""
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        col = self.pad + (x + 1) / 2 * (self.w - 2 * self.pad)
        row = self.h - (self.pad + (y + 1) / 2 * (self.h - 2 * self.pad))
        return col, row

    def _window(self, c_lo, c_hi, r_lo, r_hi):
        """Pixel centres (yy, xx) of the box's pixels inside the axes box,
        and the slices they index; None if none."""
        lo_c = max(int(np.floor(max(c_lo, self.pad) - 0.5)), 0)
        hi_c = min(int(np.ceil(min(c_hi, self.w - self.pad) - 0.5)) + 1, self.w)
        lo_r = max(int(np.floor(max(r_lo, self.pad) - 0.5)), 0)
        hi_r = min(int(np.ceil(min(r_hi, self.h - self.pad) - 0.5)) + 1, self.h)
        if lo_c >= hi_c or lo_r >= hi_r:
            return None
        yy, xx = np.mgrid[lo_r:hi_r, lo_c:hi_c] + 0.5
        inside = ((xx >= self.pad) & (xx <= self.w - self.pad)
                  & (yy >= self.pad) & (yy <= self.h - self.pad))
        return yy, xx, inside, (slice(lo_r, hi_r), slice(lo_c, hi_c))

    def _paint(self, win, mask, color):
        yy, xx, inside, sl = win
        # Agg's rounding of a colour to 8 bits: half up
        self.img[sl][mask & inside] = np.floor(np.asarray(color[:3]) * 255 + 0.5).astype(np.uint8)

    def disks(self, x, y, radius, color):
        for c, r in zip(*self.to_pixels(x, y)):
            win = self._window(c - radius, c + radius, r - radius, r + radius)
            if win is not None:
                yy, xx = win[0], win[1]
                self._paint(win, (xx - c) ** 2 + (yy - r) ** 2 <= radius ** 2, color)

    def segments(self, x, y, u, v, half_width, color):
        c0, r0 = self.to_pixels(x, y)
        c1, r1 = self.to_pixels(np.asarray(x) + u, np.asarray(y) + v)
        for a, b, c, d in zip(c0, r0, c1, r1):
            win = self._window(min(a, c) - half_width, max(a, c) + half_width,
                               min(b, d) - half_width, max(b, d) + half_width)
            if win is None:
                continue
            yy, xx = win[0], win[1]
            dx, dy = c - a, d - b
            t = np.clip(((xx - a) * dx + (yy - b) * dy) / max(dx * dx + dy * dy, 1e-12), 0, 1)
            self._paint(win, (xx - a - t * dx) ** 2 + (yy - b - t * dy) ** 2 <= half_width ** 2,
                        color)

    def frame(self):
        return self.img.astype(np.float32) / 255 * 2 - 1


def _marker_radius(mul, dpi):
    """Half the extent of the figures' "x" markers (size 10 mul pt^2,
    line width mul pt), in pixels."""
    return (math.sqrt(10 * mul) + mul) / 2 * dpi / 72


def _quiver_half_width(canvas):
    """Half of quiver's shaft width 0.005 of the axes' width, in pixels."""
    return max(0.5, 0.0025 * (canvas.w - 2 * canvas.pad))


def get_pts(obj_pts, bg_pts, height, width, mul=4, dpi=64):
    """Control points as coloured disks, the background's grey.

    obj_pts (B[,T],No,Lo,2), bg_pts (B[,T],1,L,2) -> (B[,T],H,W,3) in [-1,1]."""
    obj_pts = np.asarray(obj_pts)
    bg_pts = np.asarray(bg_pts)
    vid = obj_pts.ndim == 5
    if vid:
        bt = obj_pts.shape[:2]
        obj_pts = obj_pts.reshape((-1,) + obj_pts.shape[2:])
        bg_pts = bg_pts.reshape((-1,) + bg_pts.shape[2:])
    b, no = obj_pts.shape[:2]
    colors = _colormap(no)
    h, w = height * mul, width * mul
    radius = _marker_radius(mul, dpi)
    frames = []
    for i in range(b):
        cv = _Canvas(h, w, dpi)
        cv.disks(bg_pts[i, 0, :, 0], -bg_pts[i, 0, :, 1], radius, colors[0])
        for j in range(no):
            cv.disks(obj_pts[i, j, :, 0], -obj_pts[i, j, :, 1], radius, colors[1 + j])
        frames.append(cv.frame())
    out = np.stack(frames)
    return out.reshape(bt + out.shape[1:]) if vid else out


def _motion(cv, pts, s, e, color):
    """Segments from each point of pts[s] to the same point of pts[e]."""
    x, y = pts[s, :, 0], -pts[s, :, 1]
    u, v = pts[e, :, 0] - pts[s, :, 0], -pts[e, :, 1] + pts[s, :, 1]
    cv.segments(x, y, u, v, _quiver_half_width(cv), color)


def get_mot(obj_pts, bg_pts, height, width, mul=4, dpi=64, forward=True):
    """Control-point motion from each frame to the next as segments.

    obj_pts (B,T,No,Lo,2), bg_pts (B,T,1,L,2) -> (B,T-1,H,W,3)."""
    obj_pts = np.asarray(obj_pts)
    bg_pts = np.asarray(bg_pts)
    b, t, no = obj_pts.shape[:3]
    colors = _colormap(no)
    h, w = height * mul, width * mul
    vid = np.zeros((b, t - 1, h, w, 3), np.float32)
    for i in range(b):
        for k in range(t - 1):
            s, e = (k, k + 1) if forward else (k + 1, k)
            cv = _Canvas(h, w, dpi)
            _motion(cv, bg_pts[i, :, 0], s, e, colors[0])
            for j in range(no):
                _motion(cv, obj_pts[i, :, j], s, e, colors[1 + j])
            vid[i, k] = cv.frame()
    return vid


def get_delta_mot(obj_pts, bg_pts, ref_obj_pts, ref_bg_pts, height, width, mul=4, dpi=64):
    """Displacement of each frame's control points from a reference pose:
    the reference points as disks, a segment from each to its point in the
    frame."""
    obj_pts, bg_pts = np.asarray(obj_pts), np.asarray(bg_pts)
    ref_obj_pts, ref_bg_pts = np.asarray(ref_obj_pts), np.asarray(ref_bg_pts)
    b, t, no = obj_pts.shape[:3]
    colors = _colormap(no)
    h, w = height * mul, width * mul
    radius = _marker_radius(mul, dpi)
    vid = np.zeros((b, t, h, w, 3), np.float32)
    for i in range(b):
        for k in range(t):
            cv = _Canvas(h, w, dpi)
            pairs = [(ref_bg_pts[i, 0], bg_pts[i, k, 0], colors[0])]
            pairs += [(ref_obj_pts[i, j], obj_pts[i, k, j], colors[1 + j]) for j in range(no)]
            for ref, now, color in pairs:
                cv.disks(ref[:, 0], -ref[:, 1], radius, color)
                _motion(cv, np.stack([ref, now]), 0, 1, color)
            vid[i, k] = cv.frame()
    return vid

"""The training logger and the profiling helpers of the port against the
JAX package's, on the CPU.

The numpy renderers (HSV flow, layout colours, the checkerboard, the frame
strip with red borders) are held exactly. Both Loggers write one
``log_visuals`` payload and scalars with a NaN; tensorboard's
EventAccumulator reads both back: the same tags, steps, scalars and decoded
images. The control-point renders are the one route that differs: the JAX
package draws them with matplotlib, the port with a numpy rasterizer (the
card's machine has no matplotlib), so they are held by the points'
positions and colours, not pixel by pixel: the jet table exactly, each
point's pixel position within 0.5 px of matplotlib's data transform, and
the colour at each mark's centre within 1/255 of the matplotlib figure's.
"""
import os

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

import waldo_tpu.train.logger as jlog
import waldo_tpu_torch.train.logger as tlog
from waldo_tpu_torch.utils import profiling


class _Recorder:
    def __init__(self):
        self.calls = []

    def add_images(self, name, img, step, dataformats):
        self.calls.append((name, np.array(img), step, dataformats))


def _recording(logger_cls):
    lg = logger_cls.__new__(logger_cls)
    lg.writer, lg.fps = _Recorder(), 4
    return lg


def test_renderers_equal_jax():
    rng = np.random.RandomState(0)
    flow = rng.randn(2, 3, 8, 12, 2).astype(np.float32)
    np.testing.assert_array_equal(tlog.flow_to_rgb(flow), jlog.flow_to_rgb(flow))
    np.testing.assert_array_equal(tlog.flow_to_rgb(flow, 0.5), jlog.flow_to_rgb(flow, 0.5))
    lyt = rng.randn(2, 8, 12, 7).astype(np.float32)
    for pal in (None, [[10, 20, 30]] * 3, [[1, 2, 3]] * 9):
        np.testing.assert_array_equal(tlog.colorize_layout(lyt, pal),
                                      jlog.colorize_layout(lyt, pal))
    img, alpha = rng.rand(2, 20, 30, 3), rng.rand(2, 20, 30, 1)
    np.testing.assert_array_equal(tlog.Logger.alpha_checkerboard(img, alpha, 4),
                                  jlog.Logger.alpha_checkerboard(img, alpha, 4))


def test_frame_strip_and_borders_equal_jax():
    rng = np.random.RandomState(1)
    vid = rng.uniform(-1.5, 1.5, (2, 5, 6, 7, 3)).astype(np.float32)
    ctx = np.broadcast_to(np.arange(5)[None] < 2, (2, 5))
    flow, lyt = rng.randn(2, 5, 6, 7, 2), rng.randn(2, 6, 7, 4)
    got, want = _recording(tlog.Logger), _recording(jlog.Logger)
    for lg in (got, want):
        lg.log_vid("v", vid, 3, ctx_mask=ctx)
        lg.log_img("i", vid[:, 0], 3)
        lg.log_flow("f", flow, 3)
        lg.log_lyt("l", lyt, 3)
    assert len(got.writer.calls) == len(want.writer.calls) == 4
    for (n1, a1, s1, d1), (n2, a2, s2, d2) in zip(got.writer.calls, want.writer.calls):
        assert (n1, s1, d1) == (n2, s2, d2)
        np.testing.assert_array_equal(a1, a2)
    strip = got.writer.calls[0][1]
    assert strip.shape == (2, 6, 5 * 7, 3)
    np.testing.assert_array_equal(strip[:, 0, 2 * 7:], np.broadcast_to([1, 0, 0], (2, 3 * 7, 3)))


def _payload(rng, b=2, t=4, h=8, w=16):
    arrays = {
        "vid/real_vid": rng.uniform(-1, 1, (b, t, h, w, 3)).astype(np.float32),
        "sem_lyt/sem_lyt": rng.randn(b, t, h, w, 6).astype(np.float32),
        "vid/rec_vid": rng.uniform(-1, 1, (b, t, h, w, 3)).astype(np.float32),
        "flow/real_flow": rng.randn(b, t, h, w, 2).astype(np.float32),
        "flow/rec_flow": rng.randn(b, t - 1, h, w, 2).astype(np.float32),
        "obj_lyt/rec_obj_lyt": rng.uniform(-1, 1, (b, t, h, w, 5)).astype(np.float32),
        "vid/coverage": rng.uniform(-1, 1, (b, t, h, w, 1)).astype(np.float32),
    }
    pts = {"obj_pts": rng.uniform(-1, 1, (b, t, 4, 4, 2)).astype(np.float32),
           "bg_pts": rng.uniform(-1, 1, (b, t, 1, 8, 2)).astype(np.float32)}
    return arrays, pts


def _read(path):
    acc = EventAccumulator(path, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    return acc


def test_event_files_equal_jax(tmp_path):
    """Both Loggers write the same payload and scalars; the event files
    read back with equal tags, steps, scalars (NaN and inf -> 0) and decoded
    images (all but the control-point renders, whose route differs)."""
    import io

    from PIL import Image

    arrays, pts = _payload(np.random.RandomState(2))
    palette = [[128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156]]
    accs = []
    for pkg, name in ((jlog, "jax"), (tlog, "port")):
        lg = pkg.Logger(str(tmp_path / name))
        lg.log_scalars("m/train", {"a": 1.5, "b": float("nan"), "c": np.float32(np.inf),
                                   "d": "skipped"}, 7)
        lg.log_visuals("m/train", arrays, pts, 7, palette=palette, pts_geometry=(8, 16),
                       ctx_len=2)
        lg.close()
        accs.append(_read(str(tmp_path / name)))
    ja, ta = accs
    assert ta.Tags()["images"] == ja.Tags()["images"]
    assert ta.Tags()["scalars"] == ja.Tags()["scalars"] == ["m/train/a", "m/train/b",
                                                            "m/train/c"]
    for tag in ja.Tags()["scalars"]:
        assert [(e.step, e.value) for e in ta.Scalars(tag)] == \
            [(e.step, e.value) for e in ja.Scalars(tag)]
    assert [e.value for e in ta.Scalars("m/train/b")] == [0.0]
    for tag in ja.Tags()["images"]:
        (je,), (te,) = ja.Images(tag), ta.Images(tag)
        assert (te.step, te.width, te.height) == (je.step, je.width, je.height), tag
        if tag.endswith(("/pts", "/mot")):
            continue
        jimg = np.asarray(Image.open(io.BytesIO(je.encoded_image_string)))
        timg = np.asarray(Image.open(io.BytesIO(te.encoded_image_string)))
        np.testing.assert_array_equal(timg, jimg, err_msg=tag)
    assert {"m/train/pts", "m/train/mot", "m/train/coverage"} <= set(ta.Tags()["images"])


def test_jet_table_equals_matplotlib():
    for n in (1, 4, 16, 40):
        np.testing.assert_array_equal(tlog._colormap(n), jlog._colormap(n))


def _mpl_transform(h, w, dpi=64):
    """matplotlib's data -> pixel (column, row) map of the JAX package's
    figure (its _render_figure's settings)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(w / dpi, h / dpi), dpi=dpi)
    plt.scatter([0], [0])
    plt.xlim([-1, 1])
    plt.ylim([-1, 1])
    plt.axis("off")
    plt.tight_layout()
    fig.canvas.draw()
    tr = plt.gca().transData
    plt.close(fig)

    def to_pixels(x, y):
        xy = tr.transform(np.stack([x, y], -1))
        return xy[:, 0], h - xy[:, 1]

    return to_pixels


@pytest.mark.parametrize("h,w", [(16, 32), (32, 32), (128, 256)])
def test_point_positions_equal_matplotlib(h, w):
    mul = 2
    xy = np.random.RandomState(3).uniform(-1, 1, (50, 2))
    want_c, want_r = _mpl_transform(h * mul, w * mul)(xy[:, 0], xy[:, 1])
    got_c, got_r = tlog._Canvas(h * mul, w * mul, 64).to_pixels(xy[:, 0], xy[:, 1])
    assert np.abs(got_c - want_c).max() < 0.5 and np.abs(got_r - want_r).max() < 0.5


def test_point_and_motion_colours_equal_matplotlib():
    """Well separated points: at each mark's centre the port's frame has
    the colour matplotlib's figure has there, for get_pts and get_mot."""
    h, w, mul = 32, 64, 2
    obj = np.array([[[[-0.5, -0.5], [0.5, 0.3]], [[0.0, 0.6], [-0.7, 0.2]]]])  # (1,2,2,2)
    bg = np.array([[[[0.8, -0.8], [-0.9, 0.9]]]])
    jp, tp = jlog.get_pts(obj, bg, h, w, mul=mul), tlog.get_pts(obj, bg, h, w, mul=mul)
    assert tp.shape == jp.shape == (1, h * mul, w * mul, 3)
    cv = tlog._Canvas(h * mul, w * mul, 64)
    colors = tlog._colormap(2)
    for pts, k in ((bg[0, 0], 0), (obj[0, 0], 1), (obj[0, 1], 2)):
        cols, rows = cv.to_pixels(pts[:, 0], -pts[:, 1])
        for c, r in zip(cols.astype(int), rows.astype(int)):
            want = np.floor(colors[k, :3] * 255 + 0.5) / 255 * 2 - 1
            np.testing.assert_allclose(tp[0, r, c], want, atol=1e-6)
            np.testing.assert_allclose(tp[0, r, c], jp[0, r, c], atol=2 / 255 + 1e-6)
    # motion: the midpoint of each segment carries its object's colour
    seq = np.stack([obj, obj + 0.15])[:, 0][None]  # (1, 2, No, Lo, 2)
    bgs = np.stack([bg, bg - 0.1])[:, 0][None]
    jm, tm = jlog.get_mot(seq, bgs, h, w, mul=mul), tlog.get_mot(seq, bgs, h, w, mul=mul)
    assert tm.shape == jm.shape == (1, 1, h * mul, w * mul, 3)
    mid = (obj[0] + obj[0] + 0.15) / 2
    for j in range(2):
        cols, rows = cv.to_pixels(mid[j, :, 0], -mid[j, :, 1])
        for c, r in zip(cols.astype(int), rows.astype(int)):
            want = np.floor(colors[1 + j, :3] * 255 + 0.5) / 255 * 2 - 1
            np.testing.assert_allclose(tm[0, 0, r, c], want, atol=1e-6)
    d = tlog.get_delta_mot(seq, bgs, obj, bg, h, w, mul=mul)
    assert d.shape == (1, 2, h * mul, w * mul, 3) and np.isfinite(d).all()


def test_trace_and_memory_reports(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("span"):
            torch.ones(8).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "prof" / files[0]) > 0
    if not torch.cuda.is_available():
        assert profiling.memory_stats() == {}
    stamp = profiling.provenance(run="x")
    assert {"git_rev", "timestamp", "backend", "device", "run"} <= set(stamp)
    assert stamp["backend"] in ("cuda", "cpu") and stamp["run"] == "x"
    assert profiling.log_memory() == profiling.memory_stats()

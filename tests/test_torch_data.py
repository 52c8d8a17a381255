"""The port's data path (waldo_tpu_torch/data/) against the JAX package's on
the CPU: the .flo codec, the C++ data library (built by the port with g++)
against its numpy plain versions and through the JAX package's own ctypes
binding, and the Cityscapes, KITTI and video-folder datasets' items in the
test phase and in the train phase (zoom, flips, colour jitter) from the same
``random.Random`` seed, with the serialized clip-index cache, the folds and
the loader.

Fixture trees are written under tmp_path at small sizes, once per module.
Tolerances: the library against its plain versions 1e-6 (the same float32
operations in the same order; they agree exactly here); every item against
the JAX package's: equal. Both packages read the same files with the same
Pillow and run the same arithmetic: the JAX package is pointed at the port's
library (``WALDO_NATIVE_LIB``, under monkeypatch), so neither falls back to
another resize.
"""
import os
import pickle
import random

import numpy as np
import PIL.Image
import pytest

import waldo_tpu.config as jconfig
import waldo_tpu.data as jdata
from waldo_tpu.data import native as jnative

import waldo_tpu_torch.config as tconfig
import waldo_tpu_torch.data as tdata
from waldo_tpu_torch.data import native

from chip_smoke import write_cityscapes_tree

NATIVE_TOL = 1e-6
REMAP = [13, 19, 18, 19, 7, 6, 8, 6]  # test.sh's --data.remap_lyt


@pytest.fixture
def jax_on_port_library(monkeypatch):
    """The JAX package's binding loads the port's library for this test."""
    monkeypatch.setenv("WALDO_NATIVE_LIB", str(native.library_path()))
    native.load()
    monkeypatch.setattr(jnative, "_LIB", None)
    assert jnative.available()
    yield
    monkeypatch.setattr(jnative, "_LIB", None)  # forget the port's library


# ---------------------------------------------------------------------------
# .flo and the native library
# ---------------------------------------------------------------------------


def test_flo_roundtrip_across_packages(tmp_path):
    flow = np.random.RandomState(0).randn(7, 9, 2).astype(np.float32)
    tdata.write_flo(str(tmp_path / "t.flo"), flow)
    jdata.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tdata.read_flo(str(tmp_path / "j.flo")), flow)
    np.testing.assert_array_equal(jdata.read_flo(str(tmp_path / "t.flo")), flow)


# (top, left, crop h, crop w, out h, out w, flip_x, flip_y) on a 40x70 frame
CASES = [(0, 0, 40, 70, 40, 70, False, False), (3, 5, 30, 50, 17, 33, True, False),
         (2, 1, 37, 66, 80, 140, False, True), (0, 9, 40, 60, 20, 30, True, True)]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (40, 70, 3)).astype(np.uint8),
            rng.randint(0, 25, (40, 70)).astype(np.int32),
            (rng.randn(40, 70, 2) * 5).astype(np.float32))


def _three(mod, case, rgb, lyt, flow, plain=False):
    top, left, ch, cw, oh, ow, fx, fy = case
    sfx = "_plain" if plain else ""
    return (getattr(mod, "rgb_transform" + sfx)(rgb, top, left, ch, cw, oh, ow, flip_x=fx,
                                                flip_y=fy),
            getattr(mod, "layout_onehot_resize" + sfx)(lyt, 20, REMAP, top, left, ch, cw, oh,
                                                       ow, flip_x=fx, flip_y=fy),
            getattr(mod, "flow_normalize_resize" + sfx)(flow, 1.3, fx, fy, top, left, ch, cw,
                                                        oh, ow))


@pytest.mark.parametrize("case", CASES)
def test_native_library_against_plain(case):
    got = _three(native, case, *_inputs())
    want = _three(native, case, *_inputs(), plain=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert float(np.abs(g - w).max()) <= NATIVE_TOL


@pytest.mark.parametrize("case", CASES)
def test_native_library_through_jax_binding(case, jax_on_port_library):
    for g, w in zip(_three(native, case, *_inputs(1)), _three(jnative, case, *_inputs(1))):
        np.testing.assert_array_equal(g, w)


def test_native_identity_equals_jax_numpy_path():
    """At test.sh's geometry the crop is the frame and nothing resizes: the
    library equals the JAX package's numpy path (one-hot, 5*(2x-1), /255)."""
    rgb, lyt, flow = _inputs(2)
    ref = np.zeros((40, 70, 20), np.float32)
    mapped = lyt.copy()
    for src, tgt in zip(REMAP[::2], REMAP[1::2]):
        mapped = np.where(lyt == src, tgt, mapped)
    valid = mapped < 20
    np.put_along_axis(ref, np.clip(mapped, 0, 19)[..., None], valid[..., None].astype(np.float32),
                      -1)
    got = native.layout_onehot_resize(lyt, 20, REMAP, 0, 0, 40, 70, 40, 70)
    np.testing.assert_array_equal(got, 5.0 * (ref * 2.0 - 1.0))
    np.testing.assert_array_equal(native.rgb_transform(rgb, 0, 0, 40, 70, 40, 70),
                                  rgb.astype(np.float32) / 255.0 * 2.0 - 1.0)
    want = flow.copy()
    want[..., 0] = 2.0 * want[..., 0] / 70
    want[..., 1] = 2.0 * want[..., 1] / 40
    np.testing.assert_allclose(native.flow_normalize_resize(flow, 1.0, False, False, 0, 0, 40,
                                                            70, 40, 70), want, rtol=0, atol=1e-7)


def test_native_refuses_a_crop_outside_the_frame():
    rgb, lyt, _ = _inputs()
    with pytest.raises(ValueError, match="outside"):
        native.rgb_transform(rgb, 10, 0, 40, 70, 20, 35)
    with pytest.raises(ValueError, match="outside"):
        native.layout_onehot_resize(lyt, 20, REMAP, 0, 5, 40, 70, 20, 35)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to numpy."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.layout_onehot_resize(np.zeros((4, 4), np.int32), 3, [], 0, 0, 4, 4, 4, 4)
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# fixture trees
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cityscapes_root(tmp_path_factory):
    """train: 3 sequences, the second without its frames 12 and 20, so the
    dataset splits it where its numbers jump; val: 2 sequences."""
    root = str(tmp_path_factory.mktemp("cityscapes"))
    write_cityscapes_tree(root, 64, 32, 3, split="train", num_cls=6, seed=10)
    write_cityscapes_tree(root, 64, 32, 2, split="val", num_cls=6, seed=20)
    for sub in ("leftImg8bit_sequence_64", "leftImg8bit_sequence_deeplabv3_64",
                "leftImg8bit_sequence_raft_32"):
        d = os.path.join(root, sub, "train", "smoke")
        for f in os.listdir(d):
            if f.startswith(("smoke_000001_000012", "smoke_000001_000020")):
                os.remove(os.path.join(d, f))
    return root


def _cs_args(root, *extra):
    return ["--dataset", "cityscapes", "--data.dataroot", root, "--dim", "32", "--load_dim",
            "64", "--true_dim", "64", "--flow_dim", "32", "--data.vid_len", "5",
            "--data.skip_first", "true", "--data.num_lyt", "6", "--data.remap_lyt", "3 5 4 5",
            "--datetime", "x", "--data.num_workers", "2", *extra]


TRAIN_AUG = ("--data.no_v_flip", "false", "--data.no_h_flip", "false", "--data.max_zoom", "1.6")
JITTER = ("--data.colorjitter", "0.3")


def _both(args, phase, seed=3, **kw):
    return (jdata.create_dataset(jconfig.parse_cli(list(args)), phase=phase,
                                 rng=random.Random(seed), **kw),
            tdata.create_dataset(tconfig.parse_cli(list(args)), phase=phase,
                                 rng=random.Random(seed), **kw))


def _assert_items_equal(jd, td, n=None):
    assert len(jd) == len(td) > 0
    for i in range(len(jd) if n is None else min(n, len(jd))):
        want, got = jd[i], td[i]
        assert sorted(want) == sorted(got) and want["path"] == got["path"]
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"item {i} {k}")


@pytest.mark.parametrize("phase,extra", [("test", ()), ("valid", ()), ("train", TRAIN_AUG),
                                         ("train", TRAIN_AUG + JITTER),
                                         ("train", TRAIN_AUG + ("--load_dim", "0"))],
                         ids=["test", "valid", "train", "train_jitter", "train_downscale"])
def test_cityscapes_items_equal_jax(cityscapes_root, jax_on_port_library, phase, extra):
    jd, td = _both(_cs_args(cityscapes_root, *extra), phase)
    assert td.data == jd.data
    assert (td.frame_folder, td.layout_folder, td.flow_folder) == (
        jd.frame_folder, jd.layout_folder, jd.flow_folder)
    _assert_items_equal(jd, td)
    _assert_items_equal(jd, td)  # the streams go on in step


def test_cityscapes_splits_runs_and_cuts(cityscapes_root):
    td = tdata.create_dataset(tconfig.parse_cli(_cs_args(cityscapes_root)), phase="train")
    runs = sorted(len(v) for v in td.data["vid_frame_paths"])
    valid = tdata.create_dataset(tconfig.parse_cli(_cs_args(cityscapes_root)), phase="valid")
    # sequence 1 (28 frames) splits at its gaps into runs of 12 and 7 frames
    # (its last run is dropped, as in the JAX package); of the 4 clips
    # int(0.9 * 4) = 3 train, 1 is valid
    assert runs == [7, 12, 30] and len(valid) == 1


def test_cityscapes_clip_index_cache_and_folds(tmp_path, cityscapes_root):
    args = _cs_args(cityscapes_root, "--data.data_specs", f"s{os.getpid()}")
    saved = tdata.create_dataset(tconfig.parse_cli(args + ["--data.save_data", "true"]), "test")
    path = saved.serialized_path("data", "test")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["data"] == saved.data and blob["frame_folder"] == saved.frame_folder
    # the reload reads the cache, not the tree: a poisoned cache shows through
    blob["data"]["vid_frame_paths"] = blob["data"]["vid_frame_paths"][:1]
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    loaded = tdata.create_dataset(tconfig.parse_cli(args + ["--data.load_data", "true"]), "test")
    assert len(loaded) == 1 and loaded.frame_folder == saved.frame_folder
    os.remove(path)
    jd, td = _both(_cs_args(cityscapes_root), "train", num_folds=2, fold=1)
    assert td.data["vid_frame_paths"] == jd.data["vid_frame_paths"] and len(td) == 1
    td.set_fold(2)
    jd.set_fold(2)
    assert td.fold == jd.fold == 0
    assert td.data["vid_frame_paths"] == jd.data["vid_frame_paths"]


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_cityscapes_batches_equal_jax_items(cityscapes_root, jax_on_port_library,
                                                   workers):
    """Training clips draw their augmentation and frames from the dataset's
    stream; the loader draws them on its producer in batch order, so any
    number of workers gives the JAX items taken one by one."""
    args = _cs_args(cityscapes_root, *TRAIN_AUG, *JITTER)
    jd, td = _both(args, "train")
    it = iter(tdata.DataLoader(td, 2, shuffle=False, num_workers=workers))
    try:
        batch = next(it)
    finally:
        it.close()
    want = jdata.collate([jd[0], jd[1]])
    for k in ("vid", "lyt", "flow"):
        np.testing.assert_array_equal(batch[k], want[k])


def _write_kitti(root, true_dim, seqs=2, frames=20, seed=0):
    """KITTI-format frames, labels and flows: vid_<td>/<split>/<seq>/image_02/
    data/<i>.png (the sequence is the path's fourth part from the end)."""
    rng = np.random.RandomState(seed)
    h, w = true_dim, int(true_dim * 3.25)
    for split in ("train", "test"):
        for s in range(seqs):
            for kind, ext in (("vid", ".png"), ("vid_deeplabv3", ".png"), ("vid_raft", ".flo")):
                d = os.path.join(root, f"{kind}_{true_dim}", split, f"seq{s}", "image_02", "data")
                os.makedirs(d, exist_ok=True)
                for i in range(frames):
                    p = os.path.join(d, f"{i:06d}{ext}")
                    if kind == "vid":
                        PIL.Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(p)
                    elif kind == "vid_deeplabv3":
                        PIL.Image.fromarray(rng.randint(0, 19, (h, w), np.uint8)).save(p)
                    else:
                        tdata.write_flo(p, (rng.randn(h, w, 2) * 3).astype(np.float32))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    _write_kitti(root, 32)
    return root


@pytest.mark.parametrize("phase,extra", [("test", ()), ("train", TRAIN_AUG + JITTER)])
def test_kitti_items_equal_jax(kitti_root, jax_on_port_library, phase, extra):
    args = ["--dataset", "kitti", "--data.dataroot", kitti_root, "--dim", "16", "--true_dim",
            "32", "--data.vid_len", "5", "--datetime", "x", *extra]
    jd, td = _both(args, phase)
    assert td.data == jd.data
    assert len(td) == (2 * (20 - 1 - 5) if phase == "test" else 2)
    _assert_items_equal(jd, td, n=3)


def _write_avis(root, n_vids=2, frames=10, h=32, w=48):
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    for i in range(n_vids):
        vid = (rng.randint(0, 255, (frames, h, w, 3)) * 0.2 + 100).astype(np.uint8)
        tdata.write_mjpeg_avi(os.path.join(root, "train", f"clip{i}.avi"), vid, fps=8)


def test_mjpeg_avi_writer_and_reader_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    vid = (rng.rand(4, 16, 24, 3) * 255).astype(np.uint8)
    tdata.write_mjpeg_avi(str(tmp_path / "t.avi"), vid, fps=4)
    jdata.write_mjpeg_avi(str(tmp_path / "j.avi"), vid, fps=4)
    assert (tmp_path / "t.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()
    got = tdata.open_video(str(tmp_path / "j.avi"))
    want = jdata.open_video(str(tmp_path / "t.avi"))
    assert got.num_frames == want.num_frames == 4
    np.testing.assert_array_equal(got.read(1, 3), want.read(1, 3))
    with pytest.raises(IndexError):
        got.read(2, 3)


@pytest.mark.parametrize("extra", [(), ("--data.load_vid_len", "8", *TRAIN_AUG, *JITTER)],
                         ids=["plain", "load_vid_len_jitter"])
def test_video_folder_items_equal_jax(tmp_path, extra):
    _write_avis(str(tmp_path))
    args = ["--data.dataset", "video_folder", "--data.dataroot", str(tmp_path), "--dim", "16",
            "--true_dim", "32", "--data.vid_len", "5", "--data.load_lyt", "false",
            "--data.load_flow", "false", "--data.vid_skip", "3", "--datetime", "x", *extra]
    jd, td = _both(args, "train")
    assert td.vid_clips.clips == jd.vid_clips.clips
    _assert_items_equal(jd, td)
    assert os.path.exists(str(tmp_path / "train_metadata.pkl"))


def test_video_clip_index_metadata_cache(tmp_path):
    from waldo_tpu_torch.data.video import load_or_build_clip_index

    _write_avis(str(tmp_path))
    paths = sorted(str(p) for p in (tmp_path / "train").glob("*.avi"))
    cache = str(tmp_path / "meta.pkl")
    idx = load_or_build_clip_index(paths, clip_len=4, frames_between_clips=2, cache_path=cache)
    assert idx.num_clips() == 8 and idx.get_clip(0).shape == (4, 32, 48, 3)
    with open(cache, "rb") as f:
        meta = pickle.load(f)
    meta["num_frames"] = [6, 6]
    with open(cache, "wb") as f:
        pickle.dump(meta, f)
    assert load_or_build_clip_index(paths, 4, 2, cache).num_clips() == 4  # the cache is trusted
    idx3 = load_or_build_clip_index(paths[:1], 4, 2, cache)  # another path list: recomputed
    assert idx3.metadata == {"video_paths": paths[:1], "num_frames": [10]}


def test_video_folder_refuses_layout_and_flow(tmp_path):
    _write_avis(str(tmp_path))
    cfg = tconfig.parse_cli(["--data.dataset", "video_folder", "--data.dataroot",
                             str(tmp_path), "--datetime", "x"])
    with pytest.raises(ValueError, match="RGB only"):
        tdata.create_dataset(cfg, phase="train")


def test_raw_frame_cache_realpath_and_budget(tmp_path):
    from waldo_tpu_torch.data.base import _RawFrameCache

    c = _RawFrameCache()
    c.limit = 3 * 8
    calls = []

    def loader(p):
        calls.append(p)
        return np.zeros(2, np.float32)

    real = tmp_path / "real.png"
    real.write_bytes(b"x")
    link = tmp_path / "link.png"
    link.symlink_to(real)
    assert c.get(str(real), loader) is c.get(str(link), loader) and len(calls) == 1
    for i in range(3):
        c.get(str(tmp_path / f"f{i}.png"), loader)
    assert c.bytes <= c.limit and os.path.realpath(str(real)) not in c.store


def test_raw_frame_cache_under_threads():
    """Many threads inserting into a small cache at once, switching every
    microsecond: its byte count stays the sum of what it holds, within its
    budget."""
    import sys
    import threading

    from waldo_tpu_torch.data.base import _RawFrameCache

    c = _RawFrameCache()
    c.limit = 64 * 40
    errors = []

    def work(k):
        try:
            for i in range(300):
                c.get(f"/nonexistent/{(k * 7 + i) % 97}.png",
                      lambda p: np.zeros(8 + len(p) % 5, np.float32))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert c.bytes == sum(a.nbytes for a in c.store.values()) <= c.limit


def test_registry_has_every_dataset():
    assert sorted(tdata._REGISTRY) == sorted(jdata._REGISTRY)

"""Video files: readers, the MJPG AVI writer and the clip index (the port's
copy of waldo_tpu/data/video.py).

Two readers, with no video library:

* ``MJPEGAviReader``: a RIFF/AVI parser for MJPG-coded files; Pillow decodes
  each frame's JPEG. ``write_mjpeg_avi`` is the matching writer, used by the
  evaluator's video dumps and the tests.
* ``FFmpegReader``: any codec, through ``ffmpeg``/``ffprobe`` subprocess
  pipes, taken only where those binaries exist.

``VideoClipIndex`` cuts clips of ``clip_len`` frames starting every
``frames_between_clips`` frames; its metadata (the path list and each
file's frame count) is cached in a pickle and recomputed when the path list
changes.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import struct
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import PIL.Image

VIDEO_EXTENSIONS = (".avi", ".mp4", ".mov", ".mkv", ".webm")


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


class MJPEGAviReader:
    """Pure-Python AVI (RIFF) parser for MJPG video streams.

    Scans the top-level RIFF tree for the ``movi`` LIST and records the file
    offset of every ``..dc``/``..db`` chunk; frames decode lazily via PIL."""

    def __init__(self, path: str):
        self.path = path
        self._offsets: List[Tuple[int, int]] = []  # (offset, size) per frame
        with open(path, "rb") as f:
            riff, _size, ftype = struct.unpack("<4sI4s", f.read(12))
            if riff != b"RIFF" or ftype != b"AVI ":
                raise ValueError(f"{path}: not an AVI file")
            self._scan(f, os.path.getsize(path))

    def _scan(self, f, file_end):
        while f.tell() + 8 <= file_end:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            fourcc, size = struct.unpack("<4sI", hdr)
            if fourcc == b"LIST":
                ltype = f.read(4)
                if ltype == b"movi":
                    self._scan_movi(f, f.tell() + size - 4)
                else:
                    f.seek(size - 4, 1)
            else:
                f.seek(size + (size & 1), 1)

    def _scan_movi(self, f, end):
        while f.tell() + 8 <= end:
            fourcc, size = struct.unpack("<4sI", f.read(8))
            if fourcc[2:] in (b"dc", b"db"):
                self._offsets.append((f.tell(), size))
            f.seek(size + (size & 1), 1)

    @property
    def num_frames(self) -> int:
        return len(self._offsets)

    def read(self, start: int, count: int) -> np.ndarray:
        """Decode frames [start, start+count) -> (count, H, W, 3) uint8."""
        frames = []
        with open(self.path, "rb") as f:
            for off, size in self._offsets[start: start + count]:
                f.seek(off)
                img = PIL.Image.open(io.BytesIO(f.read(size))).convert("RGB")
                frames.append(np.asarray(img))
        if len(frames) != count:
            raise IndexError(f"{self.path}: frames [{start}, {start + count})"
                             f" out of range ({self.num_frames} total)")
        return np.stack(frames)


class FFmpegReader:
    """ffmpeg/ffprobe subprocess reader (any codec)."""

    def __init__(self, path: str):
        self.path = path
        probe = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-count_packets", "-show_entries",
             "stream=width,height,nb_read_packets", "-of", "json", path],
            capture_output=True, check=True)
        info = json.loads(probe.stdout)["streams"][0]
        self.width = int(info["width"])
        self.height = int(info["height"])
        self.num_frames = int(info["nb_read_packets"])

    def read(self, start: int, count: int) -> np.ndarray:
        out = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", self.path,
             "-vf", f"select=gte(n\\,{start})", "-vframes", str(count),
             "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
            capture_output=True, check=True).stdout
        n = len(out) // (self.width * self.height * 3)
        if n < count:
            raise IndexError(f"{self.path}: frames [{start}, {start + count})")
        arr = np.frombuffer(out, np.uint8)[: count * self.height * self.width * 3]
        return arr.reshape(count, self.height, self.width, 3).copy()


def open_video(path: str):
    """Pick a reader: pure-Python for AVI/MJPG, ffmpeg for everything else."""
    if path.lower().endswith(".avi"):
        try:
            return MJPEGAviReader(path)
        except Exception:
            pass
    if shutil.which("ffmpeg") and shutil.which("ffprobe"):
        return FFmpegReader(path)
    raise RuntimeError(
        f"no video backend for {path!r}: only MJPG .avi files are readable "
        f"without an ffmpeg binary on this machine")


def write_mjpeg_avi(path: str, frames: np.ndarray, fps: int = 8,
                    quality: int = 92) -> str:
    """Write (T, H, W, 3) uint8 (or [-1,1]/[0,1] float) frames as MJPG AVI."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        f = frames.astype(np.float32)
        if f.min() < -0.01:  # [-1, 1]
            f = (f + 1.0) / 2.0
        frames = (np.clip(f, 0, 1) * 255).astype(np.uint8)
    t, h, w, _ = frames.shape

    jpegs = []
    for fr in frames:
        buf = io.BytesIO()
        PIL.Image.fromarray(fr).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        jpegs.append(data + (b"\x00" if len(data) & 1 else b""))

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload + (
            b"\x00" if len(payload) & 1 else b"")

    def lst(ltype: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", ltype + payload)

    # headers: avih (56 bytes) + one video strl (strh + strf/BITMAPINFOHEADER)
    us_per_frame = int(1e6 / fps)
    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", us_per_frame, max_bytes * fps, 0, 0x10, t, 0,
                       1, max_bytes, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1,
                                            fps, 0, t, max_bytes, 0xFFFFFFFF, 0)
            + struct.pack("<4H", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", j) for j in jpegs))
    body = b"AVI " + hdrl + movi
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


# ---------------------------------------------------------------------------
# clip index + metadata cache (VideoClips equivalent)
# ---------------------------------------------------------------------------


class VideoClipIndex:
    """Map a list of video files to fixed-length clips.

    metadata = {"video_paths": [...], "num_frames": [...]}; a supplied or
    cached metadata dict is trusted only if its path list matches, otherwise
    it is recomputed."""

    def __init__(self, video_paths: Sequence[str], clip_len: int,
                 frames_between_clips: int = 1,
                 metadata: Optional[Dict] = None):
        video_paths = list(video_paths)
        if metadata is not None and metadata.get("video_paths") != video_paths:
            metadata = None
        if metadata is None:
            nums = [open_video(p).num_frames for p in video_paths]
            metadata = {"video_paths": video_paths, "num_frames": nums}
        self.metadata = metadata
        self.clip_len = clip_len
        self.clips: List[Tuple[int, int]] = []
        for vi, n in enumerate(metadata["num_frames"]):
            for start in range(0, n - clip_len + 1, max(frames_between_clips, 1)):
                self.clips.append((vi, start))

    def num_clips(self) -> int:
        return len(self.clips)

    def get_clip(self, idx: int) -> np.ndarray:
        vi, start = self.clips[idx]
        reader = open_video(self.metadata["video_paths"][vi])
        return reader.read(start, self.clip_len)


def load_or_build_clip_index(video_paths: Sequence[str], clip_len: int,
                             frames_between_clips: int,
                             cache_path: Optional[str],
                             force: bool = False) -> "VideoClipIndex":
    """VideoClipIndex behind its metadata pickle cache."""
    metadata = None
    if cache_path and os.path.exists(cache_path) and not force:
        with open(cache_path, "rb") as f:
            metadata = pickle.load(f)
    index = VideoClipIndex(video_paths, clip_len, frames_between_clips,
                           metadata=metadata)
    if cache_path and index.metadata is not metadata:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(index.metadata, f)
    return index

"""The port's video metrics (waldo_tpu_torch/eval/metrics.py) against the JAX
package's on the CPU: PSNR, SSIM and MS-SSIM on the same seeded float32
images (rtol 1e-5), MS-SSIM also under 176 px, where both take fewer scales;
the video loader; and the ``TAG LEN CTX`` CLI on one results tree returning
the JAX CLI's dict (rtol 1e-5), with the same LPIPS fallback when no weights
exist and the AlexNet LPIPS when seeded random weights do.
"""
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from waldo_tpu.eval import metrics as jmetrics

from waldo_tpu_torch.eval import metrics as tmetrics
from waldo_tpu_torch.train import save_video_frames

from test_torch_lpips import write_random_lpips

RTOL = 1e-5


def _pair(shape, seed, noise):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    return a, np.clip(a + noise * rng.randn(*shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("metric", ["ssim", "psnr", "msssim"])
@pytest.mark.parametrize("shape,noise", [((2, 64, 80, 3), 0.05), ((1, 180, 200, 3), 0.2),
                                         ((3, 40, 60, 3), 0.1), ((1, 24, 24, 1), 0.02)],
                         ids=["64x80", "180x200", "40x60", "24x24"])
def test_metric_matches_jax(metric, shape, noise):
    a, b = _pair(shape, 0, noise)
    want = np.asarray(jmetrics.METRICS[metric](jnp.asarray(a), jnp.asarray(b)))
    got = tmetrics.METRICS[metric](torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_identical_images():
    a, _ = _pair((1, 48, 64, 3), 1, 0.0)
    x = torch.from_numpy(a)
    assert abs(float(tmetrics.ssim(x, x)[0]) - 1.0) < 1e-5
    assert abs(float(tmetrics.ms_ssim(x, x)[0]) - 1.0) < 1e-5
    assert float(tmetrics.psnr(x, x)[0]) == float("inf")


def _results_tree(root, n=3, t=6, seed=0):
    """results/<run>/{real_vid,inp_pred_vid}/vid_<i> dumps of n smooth clips."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
    folders = {}
    for name in ("real_vid", "inp_pred_vid"):
        d = root / "results" / "2026-now-run" / name
        d.mkdir(parents=True, exist_ok=True)
        folders[name] = d
    for i in range(n):
        ph = rng.rand(3) * 6
        vid = np.stack([np.sin(0.2 * xx + 0.1 * yy + ph[c] + 0.3 * k)
                        for k in range(t) for c in range(3)]).reshape(t, 3, 32, 48)
        vid = vid.transpose(0, 2, 3, 1) * 0.8
        fake = np.clip(vid + 0.15 * rng.randn(*vid.shape), -1, 1)
        save_video_frames(vid, str(folders["real_vid"] / f"vid_{i:05d}.mp4"))
        save_video_frames(fake, str(folders["inp_pred_vid"] / f"vid_{i:05d}.mp4"))
    return str(root / "results")


@pytest.mark.parametrize("metrics", [["ssim", "psnr", "msssim"], None, ["lpips", "psnr"]],
                         ids=["explicit", "default_no_lpips", "lpips_alex"])
def test_metrics_cli_matches_jax(tmp_path, monkeypatch, capsys, metrics):
    results = _results_tree(tmp_path)
    weights = tmp_path / "lpips"
    weights.mkdir()
    if metrics == ["lpips", "psnr"]:
        write_random_lpips(str(weights / "lpips_alex.npz"), "alex", seed=0)
    monkeypatch.setenv("WALDO_LPIPS_WEIGHTS", str(weights))
    args = ["now-run", "6", "2", "--results_root", results]
    if metrics is not None:
        args += ["--metrics", *metrics]
    want = jmetrics.main(list(args))
    jax_out = capsys.readouterr()
    got = tmetrics.main(args + ["--device", "cpu"])
    out = capsys.readouterr()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    lines = [ln for ln in out.out.splitlines() if ln.startswith("[")]
    assert len(lines) == len([ln for ln in jax_out.out.splitlines() if ln.startswith("[")])
    assert sum(ln.startswith("[cum ") for ln in lines) == 4 * len(got)
    if metrics is None:
        assert sorted(got) == ["cum_msssim", "cum_ssim"]
        assert "falling back to ssim" in out.err and "falling back to ssim" in jax_out.err
    if metrics == ["lpips", "psnr"]:
        assert sorted(got) == ["cum_lpips", "cum_psnr"] and "falling back" not in out.err


@pytest.mark.parametrize("dist", ["fid", "fvd"])
def test_metrics_cli_refuses_distribution_metrics(tmp_path, dist):
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tmetrics.main(["x", "6", "2", "--results_root", str(tmp_path), "--metrics", "ssim", dist,
                       "--device", "cpu"])


@pytest.mark.parametrize("fmt", ["avi", "png"])
def test_load_video_matches_jax(tmp_path, monkeypatch, fmt):
    rng = np.random.RandomState(2)
    vid = rng.rand(4, 16, 24, 3).astype(np.float32) * 2 - 1
    monkeypatch.setitem(sys.modules, "imageio.v2", None)  # no mp4 writer
    if fmt == "png":  # the last resort: no imageio, no AVI writer
        import waldo_tpu_torch.data.video as tvideo

        def no_avi(*a, **k):
            raise OSError("no AVI writer")

        monkeypatch.setattr(tvideo, "write_mjpeg_avi", no_avi)
    wrote = save_video_frames(vid, str(tmp_path / "v.mp4"))
    assert wrote == fmt
    path = str(tmp_path / ("v.avi" if fmt == "avi" else "v"))
    got, want = tmetrics.load_video(path), jmetrics.load_video(path)
    assert got.shape == (4, 16, 24, 3)
    np.testing.assert_array_equal(got, want)
    if fmt == "png":
        np.testing.assert_array_equal(
            np.rint(got * 255), ((np.clip(vid, -1, 1) + 1) / 2 * 255).astype(np.uint8))

"""Frechet distances for FID and FVD (counterpart of
waldo_tpu/eval/frechet.py).

The distance math in numpy and scipy, and the protocols over videos: FID
over every frame's Inception activations, and a proxy of FVD over each
video's temporal statistics of them. An extractor is any callable from
images (B,H,W,3) in [0, 1] to activations (B,D): eval/inception.py's runs
on the card and hands back numpy arrays.
"""
from __future__ import annotations

import numpy as np
from scipy import linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) (Dougal Sutherland's
    numerically stable form)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def frechet_distance_from_acts(acts1, acts2):
    """The Frechet distance of two sets of activations (N, D).

    With fewer samples than dimensions (a video set's frames or videos
    against Inception's 2048 or the proxy's 4096 features) the trace term
    comes from the samples: with A_i the centred activations over
    sqrt(N_i - 1), C_i = A_i^T A_i, the nonzero eigenvalues of C1 C2 are
    the squared singular values of A1 A2^T, so Tr sqrt(C1 C2) is the sum of
    those singular values. That is the covariance route's value (which the
    JAX package takes, a D x D matrix square root: ~20 s at D = 2048 on a
    CPU) from an N1 x N2 matrix."""
    acts1, acts2 = np.asarray(acts1, np.float64), np.asarray(acts2, np.float64)
    (n1, d), n2 = acts1.shape, len(acts2)
    m1, m2 = acts1.mean(0), acts2.mean(0)
    if n1 * n2 > d * d:
        return frechet_distance(m1, np.cov(acts1, rowvar=False), m2, np.cov(acts2, rowvar=False))
    a1 = (acts1 - m1) / np.sqrt(n1 - 1)
    a2 = (acts2 - m2) / np.sqrt(n2 - 1)
    tr_covmean = np.linalg.svd(a1 @ a2.T, compute_uv=False).sum()
    diff = m1 - m2
    return float(diff @ diff + (a1 * a1).sum() + (a2 * a2).sum() - 2 * tr_covmean)


def fid(feature_fn, real_batches, fake_batches):
    """feature_fn: images (B,H,W,3) -> activations (B,D)."""
    acts_r = np.concatenate([np.asarray(feature_fn(b)) for b in real_batches])
    acts_f = np.concatenate([np.asarray(feature_fn(b)) for b in fake_batches])
    return frechet_distance_from_acts(acts_r, acts_f)


def _frame_acts(extractor, vids, batch=16):
    """vids: list of (T,H,W,3) in [0,1] -> stacked frame activations (N,D)."""
    frames = np.concatenate([np.asarray(v) for v in vids])
    acts = []
    for i in range(0, len(frames), batch):
        acts.append(np.asarray(extractor(frames[i: i + batch])))
    return np.concatenate(acts)


def fid_videos(extractor, real_vids, fake_vids, batch=16):
    """FID over all frames of two video sets (pool3 Inception activations;
    see eval/inception.py)."""
    return frechet_distance_from_acts(
        _frame_acts(extractor, real_vids, batch),
        _frame_acts(extractor, fake_vids, batch),
    )


def fvd_proxy(extractor, real_vids, fake_vids, batch=16):
    """Frechet distance over per-video temporal feature statistics.

    True FVD uses I3D spatiotemporal features (eval/i3d.py); this proxy uses
    [mean_t, std_t] of per-frame Inception features per video, which is
    distributional and motion-sensitive but NOT comparable to published FVD
    numbers. Callers label it 'fvd_proxy'."""
    def per_video(vids):
        feats = []
        for v in vids:
            a = _frame_acts(extractor, [v], batch)
            feats.append(np.concatenate([a.mean(0), a.std(0)]))
        return np.stack(feats)

    return frechet_distance_from_acts(per_video(real_vids), per_video(fake_vids))

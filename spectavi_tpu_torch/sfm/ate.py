"""Absolute trajectory / cloud error with similarity alignment.

The port's own copy of ``spectavi_tpu/sfm/ate.py`` (numpy and scipy;
camera centres through the port's ``rodrigues``).  Evaluation harness for the north-star metric (BASELINE.json: clouds
"within ATE bound of reference"): aligns two point sets with the
closed-form Umeyama similarity (scale + rotation + translation — SfM
reconstructions are defined only up to a similarity) and reports RMSE.
"""

from __future__ import annotations

import numpy as np


def umeyama(src, dst, with_scale=True):
    """Closed-form similarity transform aligning ``src`` to ``dst``.

    Returns ``(s, R, t)`` with ``dst ~ s * R @ src + t``.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(src, dst, with_scale=True):
    """RMSE between point sets after optimal similarity alignment."""
    s, R, t = umeyama(src, dst, with_scale)
    aligned = (s * (R @ np.asarray(src).T)).T + t
    return float(np.sqrt(((aligned - dst) ** 2).sum(axis=1).mean()))


def camera_centers(cams):
    """Camera centres ``C = -R^T t`` from ``(V, 6)`` axis-angle poses."""
    import torch

    from spectavi_tpu_torch.sfm.bundle_adjust import rodrigues

    cams = np.array(cams, np.float64)
    R = rodrigues(torch.as_tensor(cams[:, :3])).numpy()
    t = cams[:, 3:]
    return -np.einsum("vij,vi->vj", R, t)


def nn_distances(src, dst):
    """For each ``src`` point, distance to its nearest ``dst`` point."""
    from scipy.spatial import cKDTree

    return cKDTree(np.asarray(dst)).query(np.asarray(src), k=1)[0]


def align_clouds_icp(src, dst, iters=3, inlier_quantile=0.8, with_scale=True):
    """Similarity-align two clouds WITHOUT known correspondences.

    A few ICP rounds: nearest-neighbour pairing (trimmed to the best
    ``inlier_quantile``), then the closed-form Umeyama update.  Used to
    compare reconstructions whose inlier sets differ (e.g. across
    rounds/code versions) — both clouds share the calibrated camera-0
    frame, so the initial identity guess is already close.

    Returns the aligned ``src`` and the final trimmed-pair RMSE.
    """
    from scipy.spatial import cKDTree

    src = np.asarray(src, dtype=np.float64).copy()
    dst = np.asarray(dst, dtype=np.float64)
    tree = cKDTree(dst)
    rmse = np.inf
    for _ in range(iters):
        d, j = tree.query(src, k=1)
        keep = d <= np.quantile(d, inlier_quantile)
        s, R, t = umeyama(src[keep], dst[j[keep]], with_scale)
        src = (s * (R @ src.T)).T + t
        d2, j2 = tree.query(src, k=1)
        keep2 = d2 <= np.quantile(d2, inlier_quantile)
        rmse = float(np.sqrt((d2[keep2] ** 2).mean()))
    return src, rmse

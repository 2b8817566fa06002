"""The numbers that decide ``correct``, each from the reference's own
arithmetic.

Front end: the reference's SIFT (:mod:`.sift`, plain orientation and
descriptor versions) and exact top-2 matching with the ratio test give
keypoints, quantized descriptors and matches that the program's are
compared with, row by row.  RANSAC: the reference's replay
(:mod:`.ransac`) of ex01's step 3 with the job's generator seed gives
the consensus; ex02's pair step is judged by its survivors and, under
the program's camera of each pair, the reference's inliers among them,
which :mod:`.tracks` unions into the track table.  Geometry: the
program's camera is judged by the reference's float32 inlier criterion
over the program's matches, its points by the reference's float64 DLT
of its inliers, its rectified pair by the reference's rectification
under its camera, and its pose and trajectory by the rendered truth.
Bundle adjustment: the reference's LM loop from the state the program
handed its final BA.

:func:`lowered` is the control's switch for float32 matrix products:
TF32, the precision below the float32 with TF32 off that the
configurations state.  The front end's float32 is elementwise, so its
control is the scale space in bfloat16 (``LOW_FRONT_END``), and the
float64 stages' is float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sfmbench.reference import bundle_adjust as ref_ba
from sfmbench.reference import geometry, ops, ransac, sift, tracks

LOW_FRONT_END = torch.bfloat16

# a keypoint angle is the same within this many radians: the program's
# orientation kernel and the plain histograms agree to 2e-5 of a bin
# height, which moves a refined peak by far less
ANGLE_TOL = 1e-3


@contextlib.contextmanager
def lowered(enabled=True):
    """TF32 for every float32 matrix product and convolution inside the
    block (the control's precision); the reference's own precision
    (TF32 off) outside it."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def quantized(desc):
    """The matcher's quantized uint8 table of descriptors ``(n, 128)``
    (the port's descriptor-only quantization before the pair step)."""
    if desc.shape[0] == 0:
        return torch.zeros((0, 128), dtype=torch.uint8, device=desc.device)
    return ops.normalize_to_ubyte_device(desc.to(torch.float32))


def calibrated(meta, K):
    """Calibrated euclidean keypoints ``(n, 2)`` float64."""
    h = np.hstack([meta[:, :2], np.ones((meta.shape[0], 1))]) @ np.linalg.inv(K).T
    return h[:, :2] / h[:, 2:3]


def sift_views(grays, device, dtype=torch.float32):
    """The reference's SIFT of same-shape views, its scale space in
    ``dtype``: per view ``(meta (n, 4) float32 [x, y, sigma, angle],
    desc (n, 128) uint8 tensor)``."""
    outs = sift.sift_filter_batch_device(grays, device=device, dtype=dtype)
    return [(o["meta"], o["desc"]) for o in outs]


def match_rows(view0, view1, min_ratio):
    """Exact squared-L2 top-2 of view 1's quantized 132-column rows
    among view 0's, and the ratio test ``d2 >= min_ratio^2 d1``: the
    matched keypoint rows ``(xd, yd)`` of the two views."""
    (m0, d0), (m1, d1) = view0, view1
    dev = d0.device
    rows = [torch.cat([torch.as_tensor(m, device=dev), d.to(torch.float32)], dim=1)
            for m, d in ((m0, d0), (m1, d1))]
    x, y = (ops.normalize_to_ubyte_device(r) for r in rows)
    idx, dist = (t.cpu().numpy() for t in ops.l2_topk_mxu(x, y, k=2))
    ratio = dist[:, 1] / np.maximum(dist[:, 0].astype("float64"), 1e-12)
    keep = ratio >= min_ratio ** 2
    return m0[idx[keep, 0].astype(np.int64)], m1[keep]


def _keyed(rows, key_cols):
    """``{exact bytes of key_cols: [other columns]}`` of a row table."""
    out = {}
    rest = [c for c in range(rows.shape[1]) if c not in key_cols]
    keys = np.ascontiguousarray(rows[:, key_cols])
    for k, r in zip(keys, rows[:, rest]):
        out.setdefault(k.tobytes(), []).append(r)
    return out


def row_diff(prog, ref, key_cols, tol=ANGLE_TOL):
    """Share of rows that the two tables do not hold in common, over the
    reference's row count: rows pair up when ``key_cols`` are equal to
    the bit and every other column (an angle) within ``tol``."""
    prog = np.asarray(prog, np.float32)
    ref = np.asarray(ref, np.float32)
    if ref.shape[0] == 0:
        return float(prog.shape[0] > 0)
    table = _keyed(ref, key_cols)
    rest = [c for c in range(prog.shape[1]) if c not in key_cols]
    unmatched = 0
    for row in prog:
        cands = table.get(np.ascontiguousarray(row[key_cols]).tobytes())
        if cands:
            d = [float(np.max(np.abs(c - row[rest]))) if rest else 0.0 for c in cands]
            j = int(np.argmin(d))
            if d[j] <= tol:
                cands.pop(j)
                continue
        unmatched += 1
    left = sum(len(v) for v in table.values())
    return (unmatched + left) / ref.shape[0]


def match_diff(prog_xd, prog_yd, ref_xd, ref_yd):
    """Matches held by one side only, over the reference's count; a
    match is its two keypoints ``[x, y, sigma, angle]``."""
    prog = np.hstack([prog_xd[:, :4], prog_yd[:, :4]])
    ref = np.hstack([ref_xd[:, :4], ref_yd[:, :4]])
    return row_diff(prog, ref, key_cols=[0, 1, 2, 4, 5, 6])


def _feature_rows(meta, desc):
    """``[x, y, sigma, angle, descriptor bytes...]`` float32 rows."""
    meta = np.asarray(meta, np.float32)[:, :4]
    desc = np.asarray(desc.cpu() if torch.is_tensor(desc) else desc)
    return np.hstack([meta, desc.astype(np.float32).reshape(meta.shape[0], -1)])


def feature_diff(prog_metas, prog_descs, ref_metas, ref_descs):
    """Keypoints held by one side only, summed over views, over the
    reference's count: a keypoint is its row ``[x, y, sigma, angle]``
    and its quantized descriptor's bytes, every column but the angle
    equal to the bit."""
    n_ref = sum(m.shape[0] for m in ref_metas)
    if len(prog_metas) != len(ref_metas) or len(prog_descs) != len(ref_descs):
        return float("inf")
    odd = 0.0
    for pm, pd, rm, rd in zip(prog_metas, prog_descs, ref_metas, ref_descs):
        p, r = _feature_rows(pm, pd), _feature_rows(rm, rd)
        key = [0, 1, 2] + list(range(4, r.shape[1]))
        if p.shape == r.shape and np.array_equal(p[:, key], r[:, key]) and (
                r.shape[0] == 0 or float(np.max(np.abs(p[:, 3] - r[:, 3]))) <= ANGLE_TOL):
            continue  # the same rows in the same order
        if p.shape[1] != r.shape[1]:
            odd += r.shape[0]
            continue
        odd += row_diff(p, r, key_cols=key) * max(r.shape[0], 1)
    return odd / max(n_ref, 1)


def correspondences(meta_i, meta_j, idx_i, idx_j):
    """Matched keypoint pairs as rows ``[x_i, y_i, sigma_i, x_j, y_j,
    sigma_j]``."""
    mi, mj = np.asarray(meta_i, np.float32), np.asarray(meta_j, np.float32)
    return np.hstack([mi[np.asarray(idx_i, np.int64), :3], mj[np.asarray(idx_j, np.int64), :3]])


def set_diff(prog_rows, ref_rows):
    """Rows held by one side only, over the reference's count (rows
    compared to the bit)."""
    prog_rows, ref_rows = np.asarray(prog_rows, np.float32), np.asarray(ref_rows, np.float32)
    return row_diff(prog_rows, ref_rows, key_cols=list(range(ref_rows.shape[1])))


def pair_diffs(prog_pairs, prog_metas, ref_pairs, ref_metas):
    """The pair step against the reference's, the worst pair of each:
    ``(match_diff, inlier_diff)``, the ratio-test survivors' count off
    the reference's over it, and the inlier correspondences held by one
    side only over the reference's.  A pair the program did not answer
    reads 1 in both."""
    worst_m = worst_i = 0.0
    for pair, ref in ref_pairs.items():
        prog = (prog_pairs or {}).get(pair)
        if prog is None:
            worst_m = worst_i = max(worst_m, worst_i, 1.0)
            continue
        i, j = pair
        worst_m = max(worst_m, abs(prog["n_matches"] - ref["n_matches"]) / max(ref["n_matches"], 1))
        worst_i = max(worst_i, set_diff(
            correspondences(prog_metas[i], prog_metas[j], prog["idx_i"], prog["idx_j"]),
            correspondences(ref_metas[i], ref_metas[j], ref["idx_i"], ref["idx_j"])))
    return worst_m, worst_i


def _track_keys(tracks, metas):
    out = set()
    for row in np.asarray(tracks):
        out.add(frozenset((v, np.asarray(metas[v], np.float32)[k, :3].tobytes())
                          for v, k in enumerate(row) if k >= 0))
    return out


def track_diff(prog_tracks, prog_metas, ref_tracks, ref_metas):
    """Tracks held by one side only, over the reference's count: a
    track is the set of its views' keypoints ``[x, y, sigma]``."""
    p, r = _track_keys(prog_tracks, prog_metas), _track_keys(ref_tracks, ref_metas)
    return len(p ^ r) / max(len(r), 1)


def inlier_mask(xd, yd, K, camera, reproj_allowed, device):
    """The RANSAC inlier criterion (DLT reprojection within
    ``reproj_allowed`` and in front of both cameras) of ``camera`` over
    the matches, in float32 as the program states it."""
    f32 = dict(dtype=torch.float32, device=device)
    x0 = torch.as_tensor(geometry.homogeneous_calibrated(xd, K), **f32)
    x1 = torch.as_tensor(geometry.homogeneous_calibrated(yd, K), **f32)
    P0 = torch.cat([torch.eye(3, **f32), torch.zeros((3, 1), **f32)], dim=1)
    P1 = torch.as_tensor(np.asarray(camera, np.float32), **f32)
    _, reproj, in_front = geometry.triangulate_fast_full(P0, P1, x0, x1)
    return ((reproj <= reproj_allowed) & in_front).cpu().numpy()


def inlier_diff(prog_idx, mask):
    """Matches whose inlier flag differs, over the match count."""
    prog = np.zeros(mask.shape[0], bool)
    prog[np.asarray(prog_idx, np.int64)] = True
    return float(np.mean(prog != mask)) if mask.shape[0] else 0.0


def triangulate(xd, yd, K, camera, idx, device, dtype=torch.float64):
    """DLT points ``(n, 4)``, ``w = 1``, of the inliers ``idx`` under
    ``[I | 0]`` and ``camera``, in ``dtype``."""
    kw = dict(dtype=dtype, device=device)
    idx = np.asarray(idx, np.int64)
    x0 = torch.as_tensor(geometry.homogeneous_calibrated(xd[idx], K), **kw)
    x1 = torch.as_tensor(geometry.homogeneous_calibrated(yd[idx], K), **kw)
    P0 = torch.cat([torch.eye(3, **kw), torch.zeros((3, 1), **kw)], dim=1)
    P1 = torch.as_tensor(np.asarray(camera, np.float64), **kw)
    X = geometry.triangulate(P0, P1, x0, x1)
    X = X / X[..., 3:]
    return X.to(torch.float64).cpu().numpy()


def point_err(prog, ref):
    """Largest distance between corresponding points over the median
    distance of the reference's points from the first camera."""
    prog = np.asarray(prog, np.float64)[:, :3]
    ref = np.asarray(ref, np.float64)[:, :3]
    if prog.shape != ref.shape:
        return float("inf")
    if ref.shape[0] == 0:
        return 0.0
    scale = max(float(np.median(np.linalg.norm(ref, axis=1))), 1e-300)
    return float(np.max(np.linalg.norm(prog - ref, axis=1)) / scale)


def rectify(K, camera, colors, rsf, device):
    """The reference's rectification of the pair under ``[I | 0]`` and
    ``camera`` (both through ``K``)."""
    P1 = K @ np.asarray(camera, np.float64)
    P0 = K @ np.hstack((np.eye(3), np.zeros((3, 1))))
    return geometry.rectify_pair_quantized(P0, P1, colors[0], colors[1], rsf, device)


def rect_diff(prog, ref):
    """Largest share of differing entries over the two rectified images
    and the two index maps (1 where a shape differs)."""
    worst = 0.0
    for p, r in zip(prog, ref):
        p, r = np.asarray(p), np.asarray(r)
        if p.shape != r.shape:
            return 1.0
        if r.size:
            worst = max(worst, float(np.mean(p != r)))
    return worst


def bundle_adjust(start, device, dtype=torch.float64):
    """The reference's final BA from the state the program handed its
    own: ``start = (args, kwargs)`` of that call."""
    args, kwargs = start
    kw = {k: v for k, v in kwargs.items() if k != "device"}
    cams, pts, _ = ref_ba.bundle_adjust_device(*args, device=device, dtype=dtype, **kw)
    return np.asarray(cams, np.float64), np.asarray(pts, np.float64)


def ba_diff(prog, ref):
    """Largest difference of the BA's cameras and points, each array
    over the median magnitude of the reference's."""
    worst = 0.0
    for p, r in zip(prog, ref):
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        if p.shape != r.shape:
            return float("inf")
        scale = max(float(np.median(np.abs(r))), 1e-300)
        worst = max(worst, float(np.max(np.abs(p - r))) / scale)
    return worst

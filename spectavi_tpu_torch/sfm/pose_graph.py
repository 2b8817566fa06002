"""Pose graph construction: tracks, pose chaining, N-view triangulation.

Port of ``spectavi_tpu/sfm/pose_graph.py``.  The graph logic stays on
the host: tracks are the connected components of the matches, labelled
with whole-array numpy operations over integer keypoint ids, in the row
order of the JAX package's union-find, so the track table comes out
identical; poses are chained over a spanning tree with depth-ratio scale
resolution.  The masked N-view DLT triangulation is one batched tensor
program on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device
from spectavi_tpu_torch.sfm.bundle_adjust import rodrigues, rotation_to_rvec
from spectavi_tpu_torch.utils.profiling import count


def build_tracks(pair_matches, n_views):
    """Union keypoint matches into multi-view tracks.

    ``pair_matches``: dict ``(i, j) -> (idx_i, idx_j)`` of matched
    keypoint indices per image pair (any integer dtype).  Returns
    ``(T, n_views)`` int32, the keypoint index per view or -1; tracks
    that hold two keypoints of one view are dropped.

    Keypoint ``k`` of view ``v`` is node ``offset[v] + k``; components
    are labelled by hooking each root to the smallest root it is matched
    to, then pointer jumping, until every match joins one root (the
    smallest node id of its component).  Tracks come in the order of
    their first match in ``pair_matches``' order, as a union-find that
    walks the matches in turn lists them.  Counts the matches as
    ``track_edges``."""
    pairs = [(i, j, np.asarray(a, np.int64), np.asarray(b, np.int64))
             for (i, j), (a, b) in pair_matches.items()]
    n_edges = sum(len(a) for _, _, a, _ in pairs)
    count("track_edges", n_edges)
    if not n_edges:
        return np.zeros((0, n_views), dtype=np.int32)
    span = np.zeros(n_views + 1, np.int64)
    for i, j, a, b in pairs:
        if len(a):
            span[i + 1] = max(span[i + 1], a.max() + 1)
            span[j + 1] = max(span[j + 1], b.max() + 1)
    offset = np.cumsum(span)
    u = np.concatenate([offset[i] + a for i, _, a, _ in pairs])
    w = np.concatenate([offset[j] + b for _, j, _, b in pairs])
    n_nodes = int(offset[-1])
    root = np.arange(n_nodes)
    eu, ew = u, w
    while True:
        ru, rw = root[eu], root[ew]
        apart = ru != rw
        if not apart.any():
            break
        eu, ew, ru, rw = eu[apart], ew[apart], ru[apart], rw[apart]
        np.minimum.at(root, np.maximum(ru, rw), np.minimum(ru, rw))
        while True:
            jumped = root[root]
            if np.array_equal(jumped, root):
                break
            root = jumped
    first = np.full(n_nodes, n_edges)
    np.minimum.at(first, root[u], np.arange(n_edges))
    seen = np.zeros(n_nodes, bool)
    seen[u] = True
    seen[w] = True
    size = np.bincount(root[seen], minlength=n_nodes)
    clash = np.zeros(n_nodes, bool)
    for v in range(n_views):
        view = slice(offset[v], offset[v + 1])
        clash |= np.bincount(root[view][seen[view]], minlength=n_nodes) > 1
    keep = np.flatnonzero((size >= 2) & ~clash)
    keep = keep[np.argsort(first[keep])]
    row = np.full(n_nodes, -1)
    row[keep] = np.arange(len(keep))
    tracks = np.full((len(keep), n_views), -1, dtype=np.int32)
    for v in range(n_views):
        view = slice(offset[v], offset[v + 1])
        k = np.flatnonzero(seen[view])
        t = row[root[view][k]]
        tracks[t[t >= 0], v] = k[t >= 0]
    return tracks


# cuSOLVER's batched Jacobi SVD takes matrices of at most 32 rows; a
# taller DLT system is reduced in row blocks first
_SVD_ROWS = 32


def _right_singular(A):
    """``Vt (..., n, n)`` of ``A (..., m, n)`` with ``n <= 8``.

    Systems taller than 32 rows are first reduced block by block:
    ``[B; rest] -> [diag(s) Vt of B; rest]`` keeps ``A^T A`` and so the
    right singular vectors, with orthogonal transforms only."""
    n = A.shape[-1]
    while A.shape[-2] > _SVD_ROWS:
        _, s, Vt = torch.linalg.svd(A[..., :_SVD_ROWS, :], full_matrices=False)
        A = torch.cat([s[..., :, None] * Vt, A[..., _SVD_ROWS:, :]], dim=-2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < n)
    return Vt


def triangulate_nview(P, uv, mask):
    """Masked N-view DLT triangulation.

    ``P (V, 3, 4)`` cameras, ``uv (T, V, 2)`` calibrated observations,
    ``mask (T, V)`` validity (tensors on one device).  Returns
    homogeneous points ``(T, 4)``, the DLT system's null vector (its
    sign is arbitrary; callers divide by the last coordinate).  Rows
    of unobserved views are zeroed."""
    A0 = uv[..., 0:1] * P[None, :, 2, :] - P[None, :, 0, :]  # (T, V, 4)
    A1 = uv[..., 1:2] * P[None, :, 2, :] - P[None, :, 1, :]
    A = torch.cat([A0, A1], dim=1)  # (T, 2V, 4)
    m = torch.cat([mask, mask], dim=1)[..., None]
    A = torch.where(m, A, torch.zeros_like(A))
    return _right_singular(A)[..., 3, :]


def pose_matrix(rvec, tvec):
    R = rodrigues(torch.as_tensor(np.asarray(rvec, np.float64))).numpy()
    return np.hstack([R, np.asarray(tvec)[:, None]])


def compose_relative(pose_i, rel_ij):
    """World->cam_j from world->cam_i and cam_i->cam_j transforms, each
    an ``(R, t)`` numpy tuple."""
    Ri, ti = pose_i
    Rij, tij = rel_ij
    return Rij @ Ri, Rij @ ti + tij


def chain_poses(edges, n_views, keypoints, ref_view=0, device="cuda"):
    """Initialize global poses from pairwise relative poses.

    ``edges``: dict ``(i, j) -> {"R", "t", "idx_i", "idx_j"}`` (cam_i ->
    cam_j, unit translation, inlier keypoint indices); ``keypoints``:
    per-view ``(n_kp, 2)`` calibrated points.  Walks a BFS spanning tree
    from ``ref_view``; each new edge's scale is the median ratio of the
    depths its matches get in the shared view against the depths the
    already-placed edges gave them.  The pair triangulations run in
    float64 on ``device``.  Returns ``(n_views, 6)`` axis-angle poses."""
    from spectavi_tpu_torch.mvg.triangulate import triangulate

    dev = resolve_device(device)
    adj = {}
    for (i, j) in edges:
        adj.setdefault(i, []).append(j)
        adj.setdefault(j, []).append(i)

    poses = {ref_view: (np.eye(3), np.zeros(3))}
    # per view: keypoint index -> depth in that view's frame
    depth_maps = {v: {} for v in range(n_views)}

    def edge_rel(a, b):
        if (a, b) in edges:
            e = edges[(a, b)]
            return e["R"], e["t"], np.asarray(e["idx_i"]), np.asarray(e["idx_j"])
        e = edges[(b, a)]
        R = e["R"].T
        t = -R @ e["t"]
        return R, t, np.asarray(e["idx_j"]), np.asarray(e["idx_i"])

    def pair_depths(a, b, R, t, idx_a, idx_b):
        """Depths in views a and b of the pair's matches triangulated in
        cam_a's frame."""
        P0 = np.hstack([np.eye(3), np.zeros((3, 1))])
        P1 = np.hstack([R, t[:, None]])
        f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
        X = triangulate(f64(P0), f64(P1), f64(keypoints[a][idx_a]),
                        f64(keypoints[b][idx_b])).cpu().numpy()
        X = X / np.where(np.abs(X[:, 3:]) > 1e-12, X[:, 3:], 1e-12)
        da = X[:, 2]
        db = (R @ X[:, :3].T + t[:, None])[2]
        return da, db

    visited = {ref_view}
    queue = [ref_view]
    order = []
    while queue:
        v = queue.pop(0)
        for w in adj.get(v, []):
            if w not in visited:
                visited.add(w)
                order.append((v, w))
                queue.append(w)

    first_edge = True
    for (a, b) in order:
        R, t, idx_a, idx_b = edge_rel(a, b)
        da, db = pair_depths(a, b, R, t, idx_a, idx_b)
        scale = 1.0
        if not first_edge:
            known = depth_maps[a]
            common = [
                (known[int(k)], da[n])
                for n, k in enumerate(idx_a)
                if int(k) in known and da[n] > 1e-9
            ]
            if len(common) >= 3:
                ratios = np.asarray([kd / dd for kd, dd in common])
                ratios = ratios[np.isfinite(ratios) & (ratios > 0)]
                if len(ratios) >= 3:
                    scale = float(np.median(ratios))
        first_edge = False
        t = t * scale
        poses[b] = compose_relative(poses[a], (R, t))
        for n, k in enumerate(idx_a):
            depth_maps[a].setdefault(int(k), da[n] * scale)
        for n, k in enumerate(idx_b):
            depth_maps[b].setdefault(int(k), db[n] * scale)

    cams = np.zeros((n_views, 6))
    for v, (R, t) in poses.items():
        cams[v, :3] = rotation_to_rvec(R)
        cams[v, 3:] = t
    return cams


def tracks_to_observations(tracks, keypoints):
    """Flatten a track table into BA observation arrays ``(cam_idx,
    pt_idx, uv)`` over all (track, view) entries, track-major."""
    tracks = np.asarray(tracks)
    pt_idx, cam_idx = np.nonzero(tracks >= 0)
    uv = np.zeros((len(pt_idx), 2))
    for v in np.unique(cam_idx):
        sel = cam_idx == v
        uv[sel] = np.asarray(keypoints[v])[tracks[pt_idx[sel], v]]
    return cam_idx.astype(np.int32), pt_idx.astype(np.int32), uv

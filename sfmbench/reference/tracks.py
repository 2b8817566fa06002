"""Multi-view tracks of the plain reference: a frozen copy of the
port's union of pair inliers into tracks
(``spectavi_tpu_torch/sfm/pose_graph.py::build_tracks``)."""

from __future__ import annotations

import numpy as np


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, a):
        p = self.parent.setdefault(a, a)
        while p != a:
            self.parent[a] = p = self.parent.setdefault(p, p)
            a, p = p, self.parent[p]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_tracks(pair_matches, n_views):
    """Union keypoint matches into multi-view tracks.

    ``pair_matches``: dict ``(i, j) -> (idx_i, idx_j)`` of matched
    keypoint indices per image pair.  Returns ``(T, n_views)`` int32,
    the keypoint index per view or -1; tracks that hold two keypoints
    of one view are dropped."""
    uf = _UnionFind()
    for (i, j), (idx_i, idx_j) in pair_matches.items():
        for a, b in zip(np.asarray(idx_i), np.asarray(idx_j)):
            uf.union((i, int(a)), (j, int(b)))
    groups = {}
    for key in list(uf.parent):
        groups.setdefault(uf.find(key), []).append(key)
    tracks = []
    for members in groups.values():
        if len(members) < 2:
            continue
        row = -np.ones(n_views, dtype=np.int32)
        ok = True
        for v, k in members:
            if row[v] != -1 and row[v] != k:
                ok = False
                break
            row[v] = k
        if ok and (row != -1).sum() >= 2:
            tracks.append(row)
    return np.stack(tracks) if tracks else np.zeros((0, n_views), dtype=np.int32)

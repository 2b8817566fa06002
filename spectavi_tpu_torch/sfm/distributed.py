"""Distributed bundle adjustment over a process mesh.

Port of ``spectavi_tpu/sfm/distributed.py``.  The observations
(``cam_idx, pt_idx, uv, w``) are split over a mesh axis; cameras and
points are the same on every rank.  Every reduction of the
single-device solver (:mod:`spectavi_tpu_torch.sfm.bundle_adjust`) is a
segment sum over observations, so the distributed step is the same code
with local segment sums followed by an ``all_reduce`` over the axis's
process group: the ``reduce`` hooks of ``_ba_quantities`` and
``_solve_schur``.  The CG on the reduced camera system runs on every
rank with the reductions inside its matvec and always for all its
iterations, so the ranks make the same collectives and step in lockstep
without a broadcast.
"""

from __future__ import annotations

import numpy as np

from spectavi_tpu_torch.parallel.mesh import all_reduce_sum
from spectavi_tpu_torch.sfm.bundle_adjust import Incidence, _ba_quantities, _solve_schur


def make_sharded_ba_step(mesh, axis="pairs", cg_iters=100, point_aligned=False):
    """Build an LM step with the observations split over the mesh axis
    ``axis``.

    Returns ``step(cams, pts, cam_idx, pt_idx, uv, w, lam, fixed, k) ->
    (new_cams, new_pts, cost)``, tensors on ``mesh.device``:
    ``cams (C, 6)``, ``pts (M, 3)``, ``lam``, ``fixed (C,)`` and the
    shared radial ``k (2,)`` (zeros for a pure pinhole) are the same on
    every rank; ``cam_idx, pt_idx, uv, w`` are this rank's shard, rows
    ``[r * per, (r + 1) * per)`` of arrays whose length divides the
    axis size (:func:`pad_observations` pads them with ``w = 0`` rows;
    :func:`spectavi_tpu_torch.parallel.mesh.local_shard` cuts them).
    The outputs are the same on every rank.

    ``point_aligned=True`` declares the landmark partition
    (:func:`shard_observations_by_point`): every observation of a point
    lives on one shard, so the point-space sum inside each CG iteration
    is complete locally and its ``all_reduce`` is skipped; each
    iteration then reduces only the ``(C, 6)`` camera vector."""
    reduce = all_reduce_sum(mesh.groups[axis])
    reduce_point = None if point_aligned else "same"

    def step(cams, pts, cam_idx, pt_idx, uv, w, lam, fixed, k):
        inc = Incidence(cam_idx, pt_idx, cams.shape[0], pts.shape[0])
        U, Vinv, Wblk, bc, bp, cost = _ba_quantities(cams, pts, inc, uv, w, lam, k=k,
                                                     reduce=reduce)
        dc, dp = _solve_schur(U, Vinv, Wblk, bc, bp, inc, fixed, cg_iters=cg_iters,
                              reduce=reduce, reduce_point=reduce_point)
        return cams + dc, pts + dp, cost

    return step


def shard_observations_by_point(n_shards, cam_idx, pt_idx, uv, w):
    """Partition observations so every observation of a given point
    lands on one shard (the landmark partition of distributed BA), the
    contract behind ``make_sharded_ba_step(point_aligned=True)``.

    Points go to shards greedily by descending observation count
    (longest-processing-time balancing), then each shard's block is
    padded with zero-weight observations to the common length.  Returns
    numpy ``(cam_idx, pt_idx, uv, w)`` of length ``n_shards *
    per_shard``, shard-major (shard i's rows are ``[i * per_shard, (i +
    1) * per_shard)``)."""
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    w = np.asarray(w)
    pts, counts = np.unique(pt_idx, return_counts=True)
    order = np.argsort(-counts)
    load = np.zeros(n_shards, np.int64)
    shard_of_pt = {}
    for j in order:
        s = int(np.argmin(load))
        shard_of_pt[int(pts[j])] = s
        load[s] += counts[j]
    per_shard = int(load.max())
    O_out = n_shards * per_shard
    ci = np.zeros(O_out, cam_idx.dtype)
    pi = np.zeros(O_out, pt_idx.dtype)
    uvo = np.zeros((O_out, uv.shape[1]), uv.dtype)
    wo = np.zeros(O_out, w.dtype)
    cursor = np.arange(n_shards) * per_shard
    for o in range(len(cam_idx)):
        s = shard_of_pt[int(pt_idx[o])]
        at = cursor[s]
        ci[at] = cam_idx[o]
        pi[at] = pt_idx[o]
        uvo[at] = uv[o]
        wo[at] = w[o]
        cursor[s] += 1
    return ci, pi, uvo, wo


def pad_observations(cam_idx, pt_idx, uv, w, multiple):
    """Pad numpy observation arrays with zero-weight entries so their
    length divides ``multiple`` (the mesh axis size)."""
    O = len(cam_idx)
    pad = (-O) % multiple
    if pad == 0:
        return cam_idx, pt_idx, uv, w
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, cam_idx.dtype)])
    pt_idx = np.concatenate([pt_idx, np.zeros(pad, pt_idx.dtype)])
    uv = np.concatenate([uv, np.zeros((pad, 2), uv.dtype)])
    w = np.concatenate([w, np.zeros(pad, w.dtype)])
    return cam_idx, pt_idx, uv, w

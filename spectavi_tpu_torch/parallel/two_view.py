"""Sharded matching and the two-view step for a batch of image pairs.

Port of ``spectavi_tpu/parallel/two_view.py``.  Image pairs are
data-parallel over the ``pairs`` mesh axis, and within a pair the
descriptor database is split over the ``blocks`` axis: each rank
computes exact top-2 neighbours against its block
(:func:`spectavi_tpu_torch.ops.l2nn.l2_topk2`, the CUDA kernel on the
card), then the partial top-2 lists are merged with an all-gather over
the ``blocks`` group (:func:`_merge_block_topk`).

On one card without a mesh the pairs are a batch dimension and the
database is not split, so there is no merge.  Per pair: exact L2 top-2
(one kernel launch a pair, or a block of a pair on a mesh), the
inverted-Lowe ratio test on squared distances, compaction of the
survivors into a static bucket, then
:func:`spectavi_tpu_torch.mvg.ransac.ransac_essential_core` over all
pairs at once.
"""

from __future__ import annotations

import torch

from spectavi_tpu_torch.match.bruteforce import l1_topk2_xla, topk_lowest
from spectavi_tpu_torch.mvg.ransac import ransac_essential_core
from spectavi_tpu_torch.ops.l2nn import l2_topk2
from spectavi_tpu_torch.parallel.mesh import BLOCKS, PAIRS, all_gather, local_shard
from spectavi_tpu_torch.utils.profiling import annotate, count


def _merge_block_topk(idx, dist, group, block_rank, block_rows):
    """Merge each block's local top-2 (local indices) into the global
    top-2 on every rank of the ``blocks`` ``group``.

    ``block_rank`` is this rank's ``blocks`` coordinate (not its global
    rank) and ``block_rows`` the rows of a block.  The candidates are
    laid out block-major, ``(Y, n_blocks * 2)``, so among equal
    distances the lower position is the lower global index, and the
    top 2 with ties to the lower position is ``lax.top_k``'s answer."""
    gidx = idx + block_rank * block_rows
    all_idx = all_gather(gidx, group)  # (nb, Y, 2)
    all_dist = all_gather(dist, group)
    nb, Y = all_idx.shape[:2]
    idx2 = all_idx.transpose(0, 1).reshape(Y, nb * 2)
    d2 = all_dist.transpose(0, 1).reshape(Y, nb * 2)
    sel, top = topk_lowest(d2.clone(), 2)
    return idx2.gather(1, sel), top


def _sharded_topk2(mesh, x_block, y, kernel):
    """The merged top-2 of ``y`` given this rank's block ``x_block`` of
    the database: the kernel on the block, then the all-gather merge."""
    if x_block.shape[0] < 2:
        raise ValueError(f"a block needs at least 2 database rows, got {x_block.shape[0]}")
    idx, dist = kernel(x_block, y)
    return _merge_block_topk(idx, dist, mesh.groups[BLOCKS], mesh.coords[BLOCKS],
                             x_block.shape[0])


def _device_block(mesh, x):
    """This rank's block of the whole database ``x``, and only that
    block, on the mesh's device."""
    return torch.as_tensor(local_shard(mesh, x, BLOCKS)).to(mesh.device)


def sharded_l1_topk2(mesh, x, y):
    """Exact top-2 L1 matching with the database split over ``blocks``.

    ``x (X, D)``: the whole integer database, the same on every rank of
    the ``blocks`` group (X divisible by the ``blocks`` size, 2 rows a
    block at least), as JAX's call takes it.  JAX's ``x`` is one global
    array sharded over the devices; here each rank's process holds the
    whole ``x``, so pass it on the host (a CPU tensor or a numpy
    array): each rank cuts its block
    (:func:`spectavi_tpu_torch.parallel.mesh.local_shard`) and moves
    only that block to ``mesh.device``, so no card holds more than its
    share.  ``y (Y, D)``: the queries, the same on every rank of the
    group.  Returns ``(idx (Y, 2) int32 rows of x, dist (Y, 2) int32)``
    on every rank of the group, on ``mesh.device``."""
    return _sharded_topk2(mesh, _device_block(mesh, x), torch.as_tensor(y).to(mesh.device),
                          lambda a, b: l1_topk2_xla(a, b, device=mesh.device))


def sharded_l2_topk2(mesh, x, y):
    """Exact top-2 squared-L2 matching of byte descriptors with the
    database split over ``blocks``: the CUDA kernel on each block of
    CUDA tensors, its plain version on the CPU.  Same contract as
    :func:`sharded_l1_topk2`."""
    return _sharded_topk2(mesh, _device_block(mesh, x), torch.as_tensor(y).to(mesh.device),
                          l2_topk2)


def gather_pairs(mesh, outs):
    """The whole batch of a mesh step's per-rank outputs: each tensor of
    ``outs`` all-gathered over the ``pairs`` group and laid out in pair
    order."""
    return tuple(all_gather(t, mesh.groups[PAIRS]).flatten(0, 1) for t in outs)


# a sized compaction bucket grows in steps of this many rows
BUCKET_MULTIPLE = 256


def bucket_rows(survivors, floor, rows):
    """Rows of a sized compaction bucket: the largest survivor count of
    a batch's pairs, ``survivors``, rounded up to a multiple of
    :data:`BUCKET_MULTIPLE`, never below ``min(floor, rows)`` and never
    above the ``rows`` queries, so every survivor competes."""
    need = -(-int(survivors) // BUCKET_MULTIPLE) * BUCKET_MULTIPLE
    return min(int(rows), max(min(int(floor), int(rows)), need))


def make_two_view_step(mesh=None, trials=512, reproj_allowed=1e-3, svr_allowed=3e-2,
                       min_ratio=1.75, masked=False, compact_to=4096, *, sized=False):
    """Build the two-view step for a batch of pairs.

    The step takes ``desc0 (B, X, D)`` uint8 descriptors of image 0
    (the database), ``desc1 (B, Y, D)`` of image 1 (the queries), their
    calibrated euclidean keypoints ``pts0 (B, X, 2)``, ``pts1 (B, Y,
    2)``, then a ``torch.Generator`` (``generator``, where the JAX step
    takes its keys; seed 0 when None) or, by keyword, the ``(B, trials,
    7)`` sample table (``sample``, row indices into the compacted
    survivors).  It returns per pair ``(essential (B, 3, 3), camera (B,
    3, 4), count (B,), inlier_mask (B, Y))``.

    ``masked=True`` builds the ragged-batch variant that ``run_sfm``'s
    batched backend uses: the step also takes ``nx, ny (B,)``, the valid
    database and query row counts, drops matches into padding and padded
    queries from the ratio mask, and returns two more outputs, the
    nearest database row ``(B, Y)`` and the ratio mask ``(B, Y)``.  Pad
    the database by replicating a real row: a query whose neighbour is
    that row then sees ``d2 == d1`` (ties go to the lower index) and
    fails the ratio test.  ``masked=False`` refuses ``nx, ny``: every
    row is real.

    ``compact_to``: the ratio survivors are compacted into a
    ``min(compact_to, Y)``-row bucket by a stable descending sort of the
    ratio margin (ties to the lower query index, as ``lax.top_k``), so
    only the strongest ``compact_to`` survivors compete in RANSAC and
    can appear in the inlier mask.  ``sized=True`` makes ``compact_to``
    the bucket's floor instead: the bucket has
    :func:`bucket_rows` of the batch's (on a mesh, the rank's pairs')
    largest survivor count, read to the host once a call, so every
    survivor competes; where no pair has more than ``compact_to``
    survivors the bucket, the sample tables drawn over it and every
    output are the fixed step's.

    ``mesh``: a :class:`spectavi_tpu_torch.parallel.mesh.Mesh` makes
    this the ``(pairs, blocks)`` step; None runs it on one device with
    the pairs as a batch dimension.  Every rank passes the whole batch
    (``B`` divisible by the ``pairs`` size, ``X`` by the ``blocks``
    size); a rank takes its ``B / n_pairs`` pairs, matches its block of
    their database rows, and runs the ratio test, compaction and RANSAC
    of its pairs, as every rank of its ``blocks`` group does on the same
    inputs.  A ``sample`` table is cut the same way; with a
    ``generator`` instead, the ranks of a ``blocks`` group agree when
    their generators carry the same seed, and each draws its own pairs'
    tables only, so the draws differ from one card's.  The step returns
    the rank's own pairs; :func:`gather_pairs` gathers the batch."""

    def match(d0, d1):
        if mesh is None:
            return l2_topk2(d0, d1)
        return _sharded_topk2(mesh, d0, d1, l2_topk2)

    def step(desc0, desc1, pts0, pts1, generator=None, nx=None, ny=None, *, sample=None):
        if masked and (nx is None or ny is None):
            raise ValueError("a masked step takes the row counts nx and ny")
        if not masked and (nx is not None or ny is not None):
            raise ValueError("an unmasked step takes no row counts; build it with masked=True")
        dev = pts0.device
        if not masked:
            nx, ny = (torch.full((desc0.shape[0],), desc0.shape[1]),
                      torch.full((desc1.shape[0],), desc1.shape[1]))
        nx_t = torch.as_tensor(nx, device=dev)
        ny_t = torch.as_tensor(ny, device=dev)
        if mesh is not None:
            desc0 = local_shard(mesh, local_shard(mesh, desc0, PAIRS), BLOCKS, dim=1)
            desc1, pts0, pts1, nx_t, ny_t = (local_shard(mesh, a, PAIRS)
                                             for a in (desc1, pts0, pts1, nx_t, ny_t))
            if sample is not None:
                sample = local_shard(mesh, sample, PAIRS)
        B, Y = desc1.shape[:2]
        with annotate("pairs.match"):
            idx, dist = (torch.stack(t) for t in zip(*(match(desc0[b], desc1[b])
                                                      for b in range(B))))
            idx = idx.long()
            # inverted-Lowe ratio test on squared L2 distances
            d1 = torch.clamp(dist[..., 0].to(pts0.dtype), min=1e-12)
            d2 = dist[..., 1].to(pts0.dtype)
            qi = torch.arange(Y, device=dev)
            ratio_ok = ((d2 >= (min_ratio**2) * d1) & (idx[..., 0] < nx_t[:, None])
                        & (qi[None] < ny_t[:, None]))
            if sized:
                C = bucket_rows(int(ratio_ok.sum(1).max()), compact_to, Y)
            else:
                C = min(compact_to, Y)
            margin = torch.where(ratio_ok, d2 / d1, torch.full_like(d1, -1.0))
            topq = torch.sort(margin, dim=1, descending=True, stable=True).indices[:, :C]
            cmask = torch.gather(ratio_ok, 1, topq)
            src = torch.gather(idx[..., 0], 1, topq)
            x0 = torch.take_along_dim(pts0, src[..., None], dim=1)
            x1 = torch.take_along_dim(pts1, topq[..., None], dim=1)
        with annotate("pairs.ransac"):
            if sample is not None:
                sample = torch.as_tensor(sample, dtype=torch.long, device=dev)
            out = ransac_essential_core(generator, x0, x1, trials,
                                        reproj_allowed, svr_allowed, cmask, sample=sample)
            count("ransac_trials", int(trials) * B)
            inlier_full = torch.zeros((B, Y), dtype=torch.bool, device=dev)
            inlier_full.scatter_(1, topq, out["inlier_mask"])
        outs = (out["essential"], out["camera"], out["count"], inlier_full)
        return outs + (idx[..., 0], ratio_ok) if masked else outs

    return step

"""The batched two-view step: matching, ratio test and RANSAC for a
batch of image pairs.

Port of ``spectavi_tpu/parallel/two_view.py::make_two_view_step`` for
one card: the pairs are a batch dimension and the database is not split
over blocks, so there is no merge across devices.  Per pair: exact L2
top-2 (:func:`spectavi_tpu_torch.ops.l2nn.l2_topk2`, the CUDA kernel on
the card, one launch a pair), the inverted-Lowe ratio test on squared
distances, compaction of the survivors into a static bucket, then
:func:`spectavi_tpu_torch.mvg.ransac.ransac_essential_core` over all
pairs at once.
"""

from __future__ import annotations

import torch

from spectavi_tpu_torch import seeded_generator
from spectavi_tpu_torch.mvg.ransac import ransac_essential_core, sample_subsets
from spectavi_tpu_torch.ops.l2nn import l2_topk2


def make_two_view_step(trials=512, reproj_allowed=1e-3, svr_allowed=3e-2, min_ratio=1.75,
                       compact_to=4096):
    """Build the two-view step for a batch of pairs.

    The step takes ``desc0 (B, X, D)`` uint8 descriptors of image 0
    (the database), ``desc1 (B, Y, D)`` of image 1 (the queries), their
    calibrated euclidean keypoints ``pts0 (B, X, 2)``, ``pts1 (B, Y,
    2)``, the valid database and query row counts ``nx, ny (B,)``, and
    either a ``torch.Generator`` (``generator``) or the ``(B, trials,
    7)`` sample table (``sample``, row indices into the compacted
    survivors).  Matches into padding and padded queries are dropped
    from the ratio mask.  It returns per pair ``(essential (B, 3, 3),
    camera (B, 3, 4), count (B,), inlier_mask (B, Y), nearest database
    row (B, Y), ratio mask (B, Y))``.  This is the JAX step's
    ``masked=True`` variant, the one ``run_sfm`` uses.  Pad the database
    by replicating a real row: a query whose neighbour is that row then
    sees ``d2 == d1`` (ties go to the lower index) and fails the ratio
    test.

    ``compact_to``: the ratio survivors are compacted into a
    ``min(compact_to, Y)``-row bucket by a stable descending sort of the
    ratio margin (ties to the lower query index, as ``lax.top_k``), so
    only the strongest ``compact_to`` survivors compete in RANSAC and
    can appear in the inlier mask."""

    def step(desc0, desc1, pts0, pts1, nx, ny, sample=None, generator=None):
        B, Y = desc1.shape[:2]
        dev = pts0.device
        idx, dist = (torch.stack(t) for t in zip(*(l2_topk2(desc0[b], desc1[b])
                                                  for b in range(B))))
        idx = idx.long()
        # inverted-Lowe ratio test on squared L2 distances
        d1 = torch.clamp(dist[..., 0].to(pts0.dtype), min=1e-12)
        d2 = dist[..., 1].to(pts0.dtype)
        qi = torch.arange(Y, device=dev)
        nx_t = torch.as_tensor(nx, device=dev)[:, None]
        ny_t = torch.as_tensor(ny, device=dev)[:, None]
        ratio_ok = (d2 >= (min_ratio**2) * d1) & (idx[..., 0] < nx_t) & (qi[None] < ny_t)
        C = min(compact_to, Y)
        margin = torch.where(ratio_ok, d2 / d1, torch.full_like(d1, -1.0))
        topq = torch.sort(margin, dim=1, descending=True, stable=True).indices[:, :C]
        cmask = torch.gather(ratio_ok, 1, topq)
        src = torch.gather(idx[..., 0], 1, topq)
        x0 = torch.take_along_dim(pts0, src[..., None], dim=1)
        x1 = torch.take_along_dim(pts1, topq[..., None], dim=1)
        if sample is None:
            generator = seeded_generator(generator, dev)
            sample = torch.stack([sample_subsets(C, trials, cmask[b], generator)
                                  for b in range(B)])
        else:
            sample = torch.as_tensor(sample, dtype=torch.long, device=dev)
        out = ransac_essential_core(sample, x0, x1, reproj_allowed, svr_allowed,
                                    point_mask=cmask)
        inlier_full = torch.zeros((B, Y), dtype=torch.bool, device=dev)
        inlier_full.scatter_(1, topq, out["inlier_mask"])
        return (out["essential"], out["camera"], out["count"], inlier_full, idx[..., 0],
                ratio_ok)

    return step

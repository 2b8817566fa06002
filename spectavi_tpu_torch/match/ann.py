"""Approximate(-interface) nearest neighbours via sharded exact L2 top-k
(port of ``spectavi_tpu/match/ann.py``).

Capability parity with the reference's hnswlib wrapper: the database is
cut into shards, each shard's exact squared L2 comes from the identity
``||x - y||^2 = ||x||^2 - 2 x.y + ||y||^2`` (one matmul), and the
shard-local top-k lists are merged.  Same output contract, exact
results.  Plain PyTorch on an explicit device.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device
from spectavi_tpu_torch.match.bruteforce import check_rows, topk_lowest


def _l2_topk_shard(x, y, base, k):
    """Exact L2 top-k of ``y`` against database shard ``x``; global
    indices offset by ``base``."""
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    d2 = yy[:, None] - 2.0 * (y @ x.T) + xx[None, :]
    idx, d = topk_lowest(d2, k)
    return idx + base, d


def _merge_topk(idx_a, d_a, idx_b, d_b, k):
    sel, d = topk_lowest(torch.cat([d_a, d_b], dim=1), k)
    return torch.cat([idx_a, idx_b], dim=1).gather(1, sel), d


def ann(x, y, k=2, shard_size=5000, device="cuda"):
    """Sharded exact L2 k-NN; drop-in for ``ann_hnswlib``.  Returns the
    ``(yrows, k) uint64`` index array (ascending distance)."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype="float32")
    y = np.asarray(y, dtype="float32")
    check_rows(x, y)
    yt = torch.as_tensor(y, device=dev)
    best_idx = best_d = None
    for base in range(0, x.shape[0], shard_size):
        shard = torch.as_tensor(x[base : base + shard_size], device=dev)
        idx, d = _l2_topk_shard(shard, yt, base, int(k))
        if best_idx is None:
            best_idx, best_d = idx, d
        else:
            best_idx, best_d = _merge_topk(best_idx, best_d, idx, d, int(k))
    return best_idx.cpu().numpy().astype(np.uint64)


# API-parity alias for users migrating from the reference
ann_hnswlib = ann

"""Cascade-of-hashes nearest neighbours (port of
``spectavi_tpu/match/cascade_hash.py``).

Same program as the JAX package's, stage by stage, in plain PyTorch on
an explicit device (the JAX package has no kernel here either):

* hyperplane hashing is a batched matmul (``proj = (x - mean) @ W``)
  followed by a sign-bit pack;
* per query, the ``g`` lowest-|projection| bits are flipped through all
  ``2^g`` assignments to produce candidate codes;
* per table, bucket member lists are padded to a static per-bucket cap
  ``L`` (stable sort, rank within the bucket, indexed write of the
  ranks that fit); every query gathers the members of its ``n * 2^g``
  candidate buckets into a fixed-width candidate set, and the exact L1
  re-rank runs over only those ``n * 2^g * L`` candidates.  Bucket
  overflow beyond the cap bounds the approximation; request it with
  ``with_stats=True``.

The hyperplanes come from an explicit ``torch.Generator`` or are handed
in as an array (``planes``), so that a caller can reproduce another
implementation's draw.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device, seeded_generator
from spectavi_tpu_torch.match.bruteforce import check_rows, topk_lowest

_I32_MAX = int(np.iinfo(np.int32).max)


def _pack_codes(proj):
    """Sign-bit pack ``(..., m)`` projections into integer codes."""
    m = proj.shape[-1]
    weights = 1 << torch.arange(m, dtype=torch.int64, device=proj.device)
    return ((proj >= 0).to(torch.int64) * weights).sum(-1)


def _hash_stage(planes, x, y, g):
    """Database codes per table ``(n, X)`` and the ``2^g`` candidate
    codes per (table, query) ``(n, Y, 2^g)`` from hyperplanes
    ``planes (n, D, m)``."""
    n, _, m = planes.shape
    # hyperplanes through the database column mean: zero-offset planes
    # through uncentred data put most rows into a few buckets
    mu = x.mean(dim=0)
    codes_x = _pack_codes(torch.einsum("xd,ndm->nxm", x - mu, planes))
    proj_y = torch.einsum("yd,ndm->nym", y - mu, planes)
    base_y = _pack_codes(proj_y)

    # positions of the g least-confident bits per (table, query)
    flip_pos, _ = topk_lowest(proj_y.abs().reshape(-1, m), g)
    flip_pos = flip_pos.reshape(n, -1, g)
    cleared = base_y & ~(1 << flip_pos).sum(-1)

    # all 2^g assignments of the flipped bits
    combos = torch.arange(1 << g, dtype=torch.int64, device=x.device)
    combo_bits = (combos[:, None] >> torch.arange(g, device=x.device)[None, :]) & 1
    set_bits = (combo_bits[None, None] * (1 << flip_pos[:, :, None, :])).sum(-1)
    return codes_x, cleared[:, :, None] | set_bits


def _bucket_stage(codes_x, m, L):
    """Static-shape inverted bucket tables: ``members (n, 2^m, L)``
    int64 row ids, ``valid (n, 2^m, L)`` bool, and the count of member
    slots dropped per table.  Per table: stable-sort the codes, rank
    each row within its bucket, and write the rows whose rank fits the
    cap; overflowing ranks are masked out before the indexed write."""
    n, X = codes_x.shape
    B = 1 << m
    dev = codes_x.device
    members = torch.zeros((n, B, L), dtype=torch.int64, device=dev)
    valid = torch.zeros((n, B, L), dtype=torch.bool, device=dev)
    dropped = []
    for t in range(n):
        sorted_codes, order = torch.sort(codes_x[t], stable=True)
        starts = torch.searchsorted(sorted_codes, torch.arange(B, device=dev))
        ranks = torch.arange(X, device=dev) - starts[sorted_codes]
        fits = ranks < L
        members[t, sorted_codes[fits], ranks[fits]] = order[fits]
        valid[t, sorted_codes[fits], ranks[fits]] = True
        dropped.append(int((~fits).sum()))
    return members, valid, dropped


def _rerank_topk(xb, yb, member_ids, member_valid, k):
    """Exact L1 top-k over each query's gathered candidate set.

    ``xb (X, D)`` uint8 (+128-shifted), ``yb (Yc, D)``, ``member_ids
    (Yc, K)`` database rows (+valid).  A row reachable through several
    tables or codes can occupy only one of the k output slots.  Returns
    ``(idx (Yc, k) int64, -1 for an empty slot; dist (Yc, k) int64)``."""
    cand = xb[member_ids].to(torch.int16)
    dist = (cand - yb.to(torch.int16)[:, None, :]).abs().sum(-1, dtype=torch.int64)
    dist = dist.masked_fill(~member_valid, _I32_MAX)
    idxs, dists = [], []
    for _ in range(k):
        i = torch.argmin(dist, dim=1, keepdim=True)
        d = dist.gather(1, i)
        gid = member_ids.gather(1, i).masked_fill(d == _I32_MAX, -1)
        idxs.append(gid)
        dists.append(d)
        # mask every slot holding this database row, not just slot i
        dist = dist.masked_fill(member_ids == gid, _I32_MAX)
    return torch.cat(idxs, 1), torch.cat(dists, 1)


def nn_cascading_hash(x, y, k=2, m=None, n=2, g=2, generator=None, chunk=512, cap_factor=6.0,
                      with_stats=False, *, planes=None, device="cuda"):
    """Cascade-hash k-NN of de-meaned byte-range descriptors ``y`` among
    ``x`` under L1, with the auto bit rate ``m = floor(log2(max_rows /
    6))`` and the brute-force fallback when ``m < 4``.  Returns ``(idx
    uint64, dist float32)``; a query slot with no candidate has index 0
    and distance ``2^31-1`` (detect it by the distance).
    ``with_stats=True`` appends a dict with the per-table count of
    member slots dropped by the static bucket cap (``cap_factor``).

    ``planes (n, D, m)``: the hyperplanes; drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, seed 0 when None) if not given."""
    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    check_rows(x, y)
    if m is None:
        mrows = max(x.shape[0], y.shape[0])
        m = int(np.floor(np.log2(mrows / 6.0)))
        if m < 4:
            from spectavi_tpu_torch.match.bruteforce import nn_bruteforcel1k2

            out = nn_bruteforcel1k2((x + 128).astype("uint8"), (y + 128).astype("uint8"),
                                    device=dev)
            return out + ({"dropped_member_slots": [0]},) if with_stats else out
    m, n, g, k = int(m), int(n), int(g), int(k)
    X, D = x.shape
    Y = y.shape[0]
    if planes is None:
        planes = torch.randn((n, D, m), generator=seeded_generator(generator, dev), device=dev,
                             dtype=torch.float32)
    else:
        planes = torch.as_tensor(np.array(planes, dtype=np.float32), device=dev)
        if planes.shape != (n, D, m):
            raise ValueError(f"planes must have shape {(n, D, m)}, got {tuple(planes.shape)}")
    # static per-bucket cap from the data-independent fill ratio
    L = int(min(X, max(8, np.ceil(cap_factor * max(1.0, X / (1 << m))))))
    chunk = int(min(chunk, 1 << max(3, (Y - 1).bit_length())))

    xf = torch.as_tensor(x.astype("float32"), device=dev)
    yf = torch.as_tensor(y.astype("float32"), device=dev)
    xb = torch.as_tensor((np.round(x) + 128).astype(np.uint8), device=dev)
    yb = torch.as_tensor((np.round(y) + 128).astype(np.uint8), device=dev)

    codes_x, cand = _hash_stage(planes, xf, yf, g)
    members, valid, dropped = _bucket_stage(codes_x, m, L)
    tables = torch.arange(n, device=dev)[None, :, None]
    idx_out, dist_out = [], []
    for s in range(0, Y, chunk):
        cand_c = cand[:, s : s + chunk].permute(1, 0, 2)  # (chunk, n, C)
        rows = cand_c.shape[0]
        ids = members[tables, cand_c].reshape(rows, -1)  # (chunk, n * C * L)
        ok = valid[tables, cand_c].reshape(rows, -1)
        idx, dist = _rerank_topk(xb, yb[s : s + chunk], ids, ok, k)
        idx_out.append(idx)
        dist_out.append(dist)
    nn_idx = torch.cat(idx_out).cpu().numpy()
    nn_dist = torch.cat(dist_out).cpu().numpy()
    # empty-candidate slots go to index 0 before the unsigned cast (-1
    # would wrap to 2^64-1); callers detect them by the distance
    nn_idx[nn_idx < 0] = 0
    out = nn_idx.astype(np.uint64), nn_dist.astype(np.float32)
    if with_stats:
        return out + ({"dropped_member_slots": dropped},)
    return out

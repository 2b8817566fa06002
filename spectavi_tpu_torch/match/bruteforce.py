"""Exact brute-force nearest neighbours (port of
``spectavi_tpu/match/bruteforce.py``).

The whole ``(queries, database)`` distance matrix is computed in tiles
and reduced with a top-k whose ties go to the lower database index, as
``jax.lax.top_k`` gives them.  With ``mu = 0`` results are exact;
``mu > 0`` is the JAX package's two-stage approximate pruning program
(:func:`_lp_topk_chunk_mu`).  Everything here is plain PyTorch on an
explicit device: the JAX package has no kernel for these functions
either (only :func:`nn_l2k2` reaches one).  Eager PyTorch would
materialize the ``(queries, database, D)`` difference that XLA fuses
away, so distances are built a database block at a time with every
intermediate under ``_BLOCK_ELEMS`` elements.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device

# elements of the largest intermediate (256 MB of int32 or float32)
_BLOCK_ELEMS = 1 << 26
# up to this k the top-k is k masked argmins, above it one stable sort
_ARGMIN_K = 8


def check_rows(x, y):
    """Raise unless ``x`` and ``y`` are two-dimensional with one width."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"expected (X, D) and (Y, D) rows, got {x.shape} and {y.shape}")


def _big(dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def topk_lowest(dist, k):
    """The ``k`` smallest entries of each row of ``dist (R, N)``,
    ascending, ties to the lower index (``torch.topk`` promises no order
    among equal values).  Returns ``(idx (R, k) int64, values (R, k))``;
    ``dist`` is overwritten."""
    if k > _ARGMIN_K:
        vals, idx = torch.sort(dist, dim=1, stable=True)
        return idx[:, :k], vals[:, :k]
    big = _big(dist.dtype)
    idxs, vals = [], []
    for _ in range(k):
        i = torch.argmin(dist, dim=1, keepdim=True)  # first minimal value
        idxs.append(i)
        vals.append(dist.gather(1, i))
        dist.scatter_(1, i, big)
    return torch.cat(idxs, 1), torch.cat(vals, 1)


def _pow_accum(diff, p, use_int):
    """The reference's accumulated ``|diff|^p`` term: the integer path
    truncates each per-element power to an integer before it is summed."""
    if use_int:
        if p == 1.0:
            return diff.abs()
        if p == 2.0:
            return diff * diff
        return torch.sqrt(diff.abs().to(torch.float64)).to(diff.dtype)
    if p == 2.0:
        return diff * diff
    ad = diff.abs()
    if p == 1.0:
        return ad
    if p == 0.5:
        return torch.sqrt(ad)
    return torch.pow(ad, p)


def _lp_dist(x, yc, p, use_int):
    """``(Yc, X)`` accumulated-``|diff|^p`` "distances" (no 1/p root) of
    query rows ``yc`` to database rows ``x``, a database block at a
    time."""
    Yc, D = yc.shape
    X = x.shape[0]
    out = torch.empty((Yc, X), dtype=x.dtype, device=x.device)
    step = max(1, _BLOCK_ELEMS // max(Yc * D, 1))
    for s in range(0, X, step):
        diff = yc[:, None, :] - x[None, s : s + step, :]
        out[:, s : s + step] = _pow_accum(diff, p, use_int).sum(-1, dtype=x.dtype)
    return out


def _rows_dist(x, yc, rows, p, use_int):
    """Distances of each query row to its own database rows ``rows
    (Yc, R)``: ``(Yc, R)``."""
    return _pow_accum(yc[:, None, :] - x[rows], p, use_int).sum(-1, dtype=x.dtype)


def _lp_topk_chunk_mu(x, yc, mu, p, k, use_int, d0, m):
    """The ``mu`` approximate-pruning path, the JAX package's two-stage
    batch program:

    1. partial distances over the first ``d0`` dims for all candidates;
    2. a seed set, the top-k by partial distance, whose full distances
       give ``worst_dist``;
    3. the reference's prune test ``partial + mu * (D - d0) > worst``;
    4. exact re-rank of the ``m`` best-bounded survivors, merged with
       the seeds, which are always kept."""
    D = x.shape[1]
    partial_d = _lp_dist(x[:, :d0].contiguous(), yc[:, :d0].contiguous(), p, use_int)
    seed, _ = topk_lowest(partial_d.clone(), k)
    seed_dist = _rows_dist(x, yc, seed, p, use_int)
    worst = seed_dist.amax(dim=1, keepdim=True)
    pruned = partial_d + mu * (D - d0) > worst
    big = _big(partial_d.dtype)
    cand, _ = topk_lowest(partial_d.masked_fill(pruned, big), m)
    cand_dist = _rows_dist(x, yc, cand, p, use_int)
    cand_pruned = pruned.gather(1, cand)
    # a candidate that is also a seed must not fill two slots
    cand_is_seed = (cand[:, :, None] == seed[:, None, :]).any(-1)
    cand_dist = cand_dist.masked_fill(cand_pruned | cand_is_seed, big)
    all_idx = torch.cat([seed, cand], dim=1)
    j, dist = topk_lowest(torch.cat([seed_dist, cand_dist], dim=1), k)
    return all_idx.gather(1, j), dist


def nn_bruteforce(x, y, p=0.5, mu=0.0, k=2, use_int=False, chunk=1024,
                  prune_dims=None, prune_candidates=None, device="cuda"):
    """k-NN under any p-norm accumulation; exact unless ``mu > 0``.

    Returns ``(nn_idx uint64, nn_dist)`` with distances float32, or
    int32 when ``use_int`` (inputs then scaled by 100 and rounded).
    ``mu > 0`` enables the approximate extrapolation pruning: partial
    distances over ``prune_dims`` prefix dims (default ``D // 4``), the
    prune test against a fully scored seed heap, exact re-rank over at
    most ``prune_candidates`` survivors (default ``max(8k, X // 8)``).
    Higher ``mu`` prunes harder and may drop true neighbours."""
    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    check_rows(x, y)
    if use_int:
        xt = torch.as_tensor(np.round(100 * x).astype("int32"), device=dev)
        yt = torch.as_tensor(np.round(100 * y).astype("int32"), device=dev)
    else:
        xt = torch.as_tensor(x.astype("float32"), device=dev)
        yt = torch.as_tensor(y.astype("float32"), device=dev)
    p, k, chunk = float(p), int(k), int(chunk)
    if mu > 0.0:
        X, D = x.shape
        if prune_dims is not None and int(prune_dims) < 1:
            raise ValueError(f"prune_dims must be >= 1, got {prune_dims}")
        if prune_candidates is not None and int(prune_candidates) < k:
            raise ValueError(f"prune_candidates must be >= k ({k}), got {prune_candidates}")
        d0 = int(prune_dims) if prune_dims is not None else max(1, D // 4)
        d0 = min(d0, D)
        m = int(prune_candidates) if prune_candidates is not None else max(8 * k, X // 8)
        m = min(m, X)
        # mu is in distance units (the x100 scale for use_int)
        mu_val = torch.tensor(round(float(mu)) if use_int else float(mu), dtype=xt.dtype,
                              device=dev)
        # the re-rank gathers (rows, m, D) database values
        chunk = max(1, min(chunk, _BLOCK_ELEMS // max(m * D, 1)))
    idx_out, dist_out = [], []
    for i in range(0, yt.shape[0], chunk):
        yc = yt[i : i + chunk]
        if mu > 0.0:
            idx, dist = _lp_topk_chunk_mu(xt, yc, mu_val, p, k, bool(use_int), d0, m)
        else:
            idx, dist = topk_lowest(_lp_dist(xt, yc, p, bool(use_int)), k)
        idx_out.append(idx)
        dist_out.append(dist)
    nn_idx = torch.cat(idx_out).cpu().numpy().astype(np.uint64)
    nn_dist = torch.cat(dist_out).cpu().numpy()
    return nn_idx, nn_dist.astype(np.int32 if use_int else np.float32)


def l1_topk2_xla(x, y, device="cuda"):
    """Exact top-2 L1 neighbours with int32 distances, ties to the lower
    index.  The name is the JAX package's; here it is plain PyTorch.

    ``x (X, D)`` database, ``y (Y, D)`` queries, arrays or tensors of an
    integer dtype that widens to int32.  Returns tensors on ``device``:
    ``(idx (Y, 2) int32, dist (Y, 2) int32)``.

    Byte inputs go through ``torch.cdist(p=1)`` in float32, which is
    exact for them: every partial sum is an integer below 2^24 whatever
    the order.  Wider integers are accumulated in int32."""
    dev = resolve_device(device)

    def widen(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        a = np.asarray(a)
        # torch has few operations on uint16: widen on the host
        return torch.as_tensor(a if a.dtype in (np.uint8, np.int8) else a.astype(np.int32),
                               device=dev)

    x, y = widen(x), widen(y)
    Y, D = y.shape
    X = x.shape[0]
    byte = x.dtype in (torch.uint8, torch.int8) and y.dtype in (torch.uint8, torch.int8)
    if byte and D * 255 < (1 << 24):
        xf, yf = x.to(torch.float32), y.to(torch.float32)
        rows = max(1, _BLOCK_ELEMS // max(X, 1))
    else:
        xf, yf = x.to(torch.int32), y.to(torch.int32)
        rows = 256
    idxs, dists = [], []
    for s in range(0, Y, rows):
        if byte:
            dist = torch.cdist(yf[s : s + rows], xf, p=1.0)
        else:
            dist = _lp_dist(xf, yf[s : s + rows], 1.0, True)
        i, d = topk_lowest(dist, 2)
        idxs.append(i)
        dists.append(d)
    if not idxs:
        empty = torch.zeros((0, 2), dtype=torch.int32, device=dev)
        return empty, empty.clone()
    return torch.cat(idxs).to(torch.int32), torch.cat(dists).to(torch.int32)


def nn_bruteforcel1k2(x, y, nthreads=None, device="cuda"):
    """Exact L1 top-2 matcher for byte descriptors: ``(idx (Y, 2)
    uint64, dist (Y, 2) int32)``.  ``nthreads`` is accepted and ignored.
    The inner dimension must be a multiple of 16 (the reference's SSE
    contract)."""
    del nthreads
    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    check_rows(x, y)
    if x.shape[1] % 16 != 0:
        raise ValueError("Input matrix inner dimensions must be 16-byte aligned.")
    if x.dtype not in (np.uint8, np.int8, np.int16, np.int32, np.uint16):
        raise TypeError(f"integer descriptors expected, got {x.dtype}")
    idx, dist = l1_topk2_xla(x, y, device=dev)
    return idx.cpu().numpy().astype(np.uint64), dist.cpu().numpy().astype(np.int32)


def nn_l2k2(x, y, device="cuda"):
    """Exact top-2 squared-L2 matcher on byte descriptors: numpy
    ``(X, D)``, ``(Y, D)`` uint8/int8 in, ``(idx (Y, 2) uint64,
    dist2 (Y, 2) int32)`` numpy out (the CUDA kernel on ``cuda``)."""
    from spectavi_tpu_torch.ops.l2nn import l2_topk2

    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    check_rows(x, y)
    idx, dist = l2_topk2(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
    return idx.cpu().numpy().astype(np.uint64), dist.cpu().numpy().astype(np.int32)

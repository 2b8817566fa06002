"""K-medians clustering and cluster-filtered nearest neighbours (port
of ``spectavi_tpu/match/kmedians.py``).

Lloyd-style k-medians from a round-robin split of a random permutation:
assignment is the argmin over an L1 distance matrix, taken in row
chunks; the median update is an exact grouped median from two stable
sorts per dimension (sort values, stable-sort that order by cluster id,
then read each cluster's middle element(s) from its contiguous run), so
that everything is ``(N, D)``-shaped.

Cross-set NN: cluster both sets, match medians, then run the exact L1
NN masked to the union of the ``c`` nearest opposite clusters, in query
chunks that bound the ``(chunk, X, D)`` difference and the ``(chunk, c,
X)`` mask.  Plain PyTorch on an explicit device.  The permutations come
from an explicit ``torch.Generator`` or are handed in as arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device, seeded_generator
from spectavi_tpu_torch.match.bruteforce import _BLOCK_ELEMS, _lp_dist, check_rows, topk_lowest

_F32_MAX = float(np.finfo(np.float32).max)


def _l1(a, b):
    """``(A, D), (B, D) -> (A, B)`` L1 distances."""
    return _lp_dist(b, a, 1.0, False)


def _update_medians(x, assign, k):
    """Exact per-cluster, per-dimension medians ``(k, D)``."""
    N = x.shape[0]
    # lexicographic (cluster, value) order via two stable sorts
    order1 = torch.argsort(x, dim=0, stable=True)  # (N, D) value order
    order2 = torch.argsort(assign[order1], dim=0, stable=True)
    final = order1.gather(0, order2)
    sorted_vals = x.gather(0, final)
    counts = torch.bincount(assign, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    # middle element(s) of each run; an empty cluster's run is no run,
    # its indices are clamped and its row replaced below
    lo = (starts + torch.div(counts - 1, 2, rounding_mode="floor")).clamp(0, N - 1)
    hi = (starts + torch.div(counts, 2, rounding_mode="floor")).clamp(0, N - 1)
    med = (sorted_vals[lo] + sorted_vals[hi]) / 2.0
    return torch.where((counts > 0)[:, None], med, x[:1])


def _assign_points(x, med):
    N, D = x.shape
    k = med.shape[0]
    chunk = max(1, min(N, int(64e6) // max(k * D * 4, 1)))
    out = [
        torch.argmin((x[s : s + chunk, None, :] - med[None, :, :]).abs().sum(-1), dim=1)
        for s in range(0, N, chunk)
    ]
    return torch.cat(out)


def _kmedians(x, k, niter, perm):
    """``x (N, D)`` float32 tensor, ``perm (N,)`` int64: ``(medians
    (k, D), assign (N,) int64)``."""
    N = x.shape[0]
    # round-robin initial grouping: point perm[i] goes to cluster i % k
    assign = torch.zeros(N, dtype=torch.int64, device=x.device)
    assign[perm] = torch.arange(N, device=x.device) % k
    for _ in range(niter):
        assign = _assign_points(x, _update_medians(x, assign, k))
    return _update_medians(x, assign, k), assign


def _perm(n, generator, perm, dev):
    if perm is not None:
        perm = torch.as_tensor(np.array(perm, dtype=np.int64), device=dev)
        if perm.shape != (n,):
            raise ValueError(f"the permutation must have shape ({n},), got {tuple(perm.shape)}")
        return perm
    return torch.randperm(n, generator=generator, device=dev)


def kmedians(generator, x, k, niter=8, *, perm=None, device="cuda"):
    """Cluster ``x (N, D)`` into ``k`` L1 medians.  Returns ``(medians
    (k, D) float32, assign (N,) int32)``.  ``perm``: the permutation of
    the rows behind the initial round-robin split, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``, where the JAX
    function takes its key; seed 0 when None) if not given."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, dtype="float32"), device=dev)
    perm = _perm(xt.shape[0], seeded_generator(generator, dev), perm, dev)
    med, assign = _kmedians(xt, int(k), int(niter), perm)
    return med.cpu().numpy(), assign.cpu().numpy().astype(np.int32)


def _nn_kmedians_match(x, y, permx, permy, nmx, nmy, c, k):
    medx, ax = _kmedians(x, nmx, 8, permx)
    medy, ay = _kmedians(y, nmy, 8, permy)
    # c nearest x-clusters for each y-cluster (L1 on medians)
    near, _ = topk_lowest(_l1(medy, medx), c)  # (nmy, c)
    allowed = near[ay]  # (Y, c) of x-cluster ids
    X, D = x.shape
    rows = max(1, _BLOCK_ELEMS // max(X * max(D, c), 1))
    idxs, dists = [], []
    for s in range(0, y.shape[0], rows):
        mask = (allowed[s : s + rows, :, None] == ax[None, None, :]).any(1)  # (rows, X)
        dist = _l1(y[s : s + rows], x).masked_fill(~mask, _F32_MAX)
        i, d = topk_lowest(dist, k)
        idxs.append(i)
        dists.append(d)
    return torch.cat(idxs), torch.cat(dists)


def nn_kmedians(x, y, k, c=5, generator=None, perms=None, device="cuda"):
    """k-NN of ``y`` rows among ``x`` rows restricted to the ``c``
    nearest opposite clusters; cluster counts auto-tuned as ``nm =
    round(sqrt(rows / c) * c)``.  Returns ``(idx uint64, dist
    float32)``.  ``perms``: the two row permutations ``(of x, of y)``,
    drawn from ``generator`` if not given."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype="float32")
    y = np.asarray(y, dtype="float32")
    check_rows(x, y)
    nmx = int(np.round(np.sqrt(x.shape[0] / c) * c))
    nmy = int(np.round(np.sqrt(y.shape[0] / c) * c))
    generator = seeded_generator(generator, dev)
    px, py = perms if perms is not None else (None, None)
    permx = _perm(x.shape[0], generator, px, dev)
    permy = _perm(y.shape[0], generator, py, dev)
    idx, dist = _nn_kmedians_match(
        torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev), permx, permy,
        nmx, nmy, int(c), int(k),
    )
    return idx.cpu().numpy().astype(np.uint64), dist.cpu().numpy().astype(np.float32)

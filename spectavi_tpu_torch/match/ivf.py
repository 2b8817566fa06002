"""Sub-quadratic descriptor matching: IVF (inverted-file) search (port
of ``spectavi_tpu/match/ivf.py``).

1. k-means over the database (assignment = one matmul + argmin; update
   = one one-hot matmul), a few Lloyd iterations;
2. every query probes its ``n_probe`` nearest cells (one ``(Y, C)``
   matmul);
3. traversal is inverted: for each cell, the queries that probe it are
   bucketed (host-side numpy, ``O(Y p)``) and matched densely against
   the cell's members, one batched ``(Q_max, L) x (L, D)`` matmul per
   cell, a group of cells at a time;
4. each query's per-cell top-2 lists are merged into a global top-2.

Exact within the probed cells; a true neighbour is missed only when it
lives in an unprobed cell.  Plain PyTorch on an explicit device.  The
initial centroids come from an explicit ``torch.Generator`` or are
handed in as row indices (``init``).
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device, seeded_generator
from spectavi_tpu_torch.match.bruteforce import _BLOCK_ELEMS, check_rows, topk_lowest


def _cell_d2(x, cent):
    """``(X, C)`` squared distances up to the constant ``||x||^2``."""
    return (cent**2).sum(dim=1)[None, :] - 2.0 * x @ cent.T


def _kmeans_cells(x, init, iters):
    """``x (X, D)`` float32 tensor, ``init (C,)`` rows of the first
    centroids: ``(centroids (C, D), assign (X,) int64)``."""
    cent = x[init]
    n_cells = cent.shape[0]
    for _ in range(iters):
        assign = torch.argmin(_cell_d2(x, cent), dim=1)
        onehot = torch.nn.functional.one_hot(assign, n_cells).to(x.dtype)  # (X, C)
        sums = onehot.T @ x
        counts = onehot.sum(dim=0)[:, None]
        cent = torch.where(counts > 0, sums / counts.clamp(min=1.0), cent)
    return cent, torch.argmin(_cell_d2(x, cent), dim=1)


def _init_rows(X, n_cells, generator, init, dev):
    if init is not None:
        init = torch.as_tensor(np.array(init, dtype=np.int64), device=dev)
        if init.shape != (n_cells,):
            raise ValueError(f"init must have shape ({n_cells},), got {tuple(init.shape)}")
        return init
    return torch.randperm(X, generator=seeded_generator(generator, dev), device=dev)[:n_cells]


def kmeans_cells(x, generator, n_cells, iters=5, *, init=None, device="cuda"):
    """K-means over database rows ``x (X, D)``.  Returns ``(centroids
    (C, D) float32, assign (X,) int32)``.  ``init``: the ``n_cells``
    distinct rows that are the first centroids, drawn from ``generator``
    (a ``torch.Generator`` on ``device``, where the JAX function takes
    its key; seed 0 when None) if not given."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)
    init = _init_rows(xt.shape[0], int(n_cells), generator, init, dev)
    cent, assign = _kmeans_cells(xt, init, int(iters))
    return cent.cpu().numpy(), assign.cpu().numpy().astype(np.int32)


def _probe_cells(y, cent, n_probe):
    probes, _ = topk_lowest(_cell_d2(y, cent), n_probe)
    return probes


def probe_cells(y, cent, n_probe, device="cuda"):
    """``n_probe`` nearest cells per query: ``(Y, P)`` int32, nearest
    first, ties to the lower cell."""
    dev = resolve_device(device)
    yt = torch.as_tensor(np.asarray(y, dtype=np.float32), device=dev)
    ct = torch.as_tensor(np.array(cent, dtype=np.float32), device=dev)
    return _probe_cells(yt, ct, int(n_probe)).cpu().numpy().astype(np.int32)


def _cells_pass(members, member_valid, qrows, x, y):
    """Dense exact top-2 inside each cell for its bucketed queries.

    ``members (C, L)`` database row ids (+valid mask), ``qrows (C, Q)``
    query row ids, ``x`` the database and ``y`` the queries.  Returns
    per (cell, slot) ``(idx (C, Q, 2)`` global database rows, ``dist
    (C, Q, 2))``, a group of cells at a time so that the ``(cells, Q,
    L)`` block stays bounded."""
    C, L = members.shape
    Q = qrows.shape[1]
    D = x.shape[1]
    step = max(1, _BLOCK_ELEMS // max(Q * max(L, D), 1))
    gis, gds = [], []
    for s in range(0, C, step):
        mrow = members[s : s + step]
        md = x[mrow]  # (c, L, D)
        qd = y[qrows[s : s + step]]  # (c, Q, D)
        d2 = ((md**2).sum(-1)[:, None, :] - 2.0 * torch.bmm(qd, md.transpose(1, 2))
              + (qd**2).sum(-1)[:, :, None])  # (c, Q, L)
        d2 = d2.masked_fill(~member_valid[s : s + step, None, :], float("inf"))
        i, d = topk_lowest(d2.reshape(-1, L), 2)
        i = i.reshape(-1, Q, 2)
        gis.append(mrow[:, None, :].expand(-1, Q, -1).gather(2, i))
        gds.append(d.reshape(-1, Q, 2))
    return torch.cat(gis), torch.cat(gds)


def _pad_lists(owner, item, n_lists, min_width):
    """Items grouped by their owner list in a stable order and padded to
    one width: ``(table (n_lists, width), valid (n_lists, width))``."""
    counts = np.bincount(owner, minlength=n_lists)
    width = int(max(min_width, min(len(item), counts.max())))
    order = np.argsort(owner, kind="stable")
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    table = np.zeros((n_lists, width), np.int64)
    valid = np.zeros((n_lists, width), bool)
    for c in range(n_lists):
        rows = item[order[starts[c] : starts[c + 1]]][:width]
        table[c, : len(rows)] = rows
        valid[c, : len(rows)] = True
    return table, valid


def nn_ivf(x, y, k=2, n_cells=None, n_probe=16, kmeans_iters=5, generator=None, init=None,
           device="cuda"):
    """Approximate k-NN (k <= 2) of ``y`` rows among ``x`` rows via IVF.

    Same output contract as the exact matchers: ``(nn_idx (Y, k)
    uint64, nn_dist (Y, k) float32)`` with squared L2 distances.
    ``n_cells`` defaults to ``~4 sqrt(X)`` (clamped); ``n_probe`` cells
    are searched per query.  A query whose every probed cell was empty
    has index 0 and distance ``inf``.  Deterministic given ``generator``
    or ``init`` (see :func:`kmeans_cells`)."""
    if k > 2:
        raise ValueError(f"the IVF path serves the pipeline's top-2 contract, got k = {k}")
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    check_rows(x, y)
    X = x.shape[0]
    Y = y.shape[0]
    if n_cells is None:
        n_cells = int(min(max(16, 4.0 * np.sqrt(X)), X // 8 + 1))
    n_cells = max(2, min(n_cells, X))
    n_probe = min(n_probe, n_cells)

    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    cent, assign = _kmeans_cells(xt, _init_rows(X, n_cells, generator, init, dev),
                                 int(kmeans_iters))
    assign = assign.cpu().numpy()
    probes = _probe_cells(yt, cent, n_probe).cpu().numpy()  # (Y, P) query -> cells

    # host bucketing (O(X + Y p) numpy): member lists and query buckets
    # per cell, padded to a static width
    members, member_valid = _pad_lists(assign, np.arange(X, dtype=np.int64), n_cells, 8)
    flat_query = np.repeat(np.arange(Y, dtype=np.int64), n_probe)
    qrows, qvalid = _pad_lists(probes.reshape(-1), flat_query, n_cells, 8)

    gi, gd = _cells_pass(
        torch.as_tensor(members, device=dev), torch.as_tensor(member_valid, device=dev),
        torch.as_tensor(qrows, device=dev), xt, yt,
    )
    gi = gi.cpu().numpy()  # (C, Qmax, 2)
    gd = gd.cpu().numpy()
    gd[~qvalid] = np.inf

    # merge each query's per-cell candidates (2 per probed cell)
    cand_idx = np.full((Y, n_probe, 2), -1, np.int64)
    cand_dist = np.full((Y, n_probe, 2), np.inf, np.float32)
    slot = np.zeros(Y, np.int32)
    for c in range(n_cells):
        take = qvalid[c]
        qs = qrows[c][take]
        s = slot[qs]
        cand_idx[qs, s] = gi[c][take]
        cand_dist[qs, s] = gd[c][take]
        slot[qs] += 1
    cand_idx = cand_idx.reshape(Y, -1)
    cand_dist = cand_dist.reshape(Y, -1)
    sel = np.argsort(cand_dist, axis=1, kind="stable")[:, :k]
    nn_idx = np.take_along_axis(cand_idx, sel, axis=1)
    nn_dist = np.take_along_axis(cand_dist, sel, axis=1)
    # a query with no candidate keeps distance inf; its index goes to 0,
    # not -1, which the unsigned cast would wrap to 2^64-1
    nn_idx[~np.isfinite(nn_dist)] = 0
    return nn_idx.astype(np.uint64), nn_dist.astype(np.float32)

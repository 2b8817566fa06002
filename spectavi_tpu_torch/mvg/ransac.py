"""RANSAC essential-matrix estimation as batched hypothesis scoring.

Port of ``spectavi_tpu/mvg/ransac.py``.  One block of ``batch_trials``
7-point samples is scored at once: a Sampson prescreen ranks all
``trials x 3`` roots, the top-16 seeds are re-scored under the exact
reference criterion (DLT reprojection + cheirality) and polished by
three LO-RANSAC 8-point refits, and the best polished model wins.  The
host loop around the blocks keeps the JAX package's termination rules
and return dict.

The block takes its ``(trials, 7)`` sample table as an argument instead
of a PRNG key, so a test can hand it the JAX package's own table and
expect the same winner; :func:`ransac_fitter` draws the table itself
with a ``torch.Generator`` by the same "uniform keys + 7 masked
argmins" scheme.  The JAX seed shortlist uses ``lax.top_k``, whose ties
go to the lower index; ``torch.topk`` promises no order among ties, so
the shortlist here is a stable descending sort.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device
from spectavi_tpu_torch.mvg.core import (
    cameras_from_svd,
    identity_camera,
    svd3x3,
)
from spectavi_tpu_torch.mvg.sevenpoint import seven_point
from spectavi_tpu_torch.mvg.triangulate import triangulate_fast_full

DEFAULT_OPTIONS = {
    "required_percent_inliers": 0.9,
    "reprojection_error_allowed": 0.5,
    "maximum_tries": 500,
    "find_best_even_in_failure": True,
    "singular_value_ratio_allowed": 3e-2,
    "progressbar": False,
}

_PROGRESS_BAR_LENGTH = 50


def sample_subsets(n, trials, point_mask, generator=None):
    """``(trials, 7)`` index samples without replacement from the rows
    where ``point_mask`` is set: uniform keys, then 7 masked argmins."""
    device = point_mask.device
    u = torch.rand((trials, n), generator=generator, device=device)
    u = torch.where(point_mask[None, :], u, torch.full_like(u, float("inf")))
    rows = torch.arange(trials, device=device)
    idxs = []
    for _ in range(7):
        i = torch.argmin(u, dim=1)
        idxs.append(i)
        u[rows, i] = float("inf")
    return torch.stack(idxs, dim=1)


def _diag110(like):
    return torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=like.dtype, device=like.device))


def _sampson_counts(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed, chunk=1024):
    """Sampson inlier counts for ranking hypotheses.

    ``F (..., T, 3, 3, 3)``, ``valid (..., T, 3)`` over correspondences
    ``x0, x1 (..., N, 2)`` -> ``(counts (..., T, 3), gate (..., T, 3))``:
    counts of every valid root (-1 where the 7-point solve failed) and
    the reference's singular-value-ratio + validity gate.  Trials are
    scored at most ``chunk`` at a time, fewer when the leading batch is
    wide, to bound memory; each trial's count is independent of the
    chunking."""
    thr2 = (0.5 * reproj_allowed) ** 2
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    D = _diag110(F)
    pm = point_mask[..., None, None, :]
    lead = int(np.prod(F.shape[:-4]))
    chunk = max(1, min(chunk, (1 << 27) // max(1, lead * 9 * x0.shape[-2])))
    counts, gates = [], []
    for s in range(0, F.shape[-4], chunk):
        Ft, validt = F[..., s : s + chunk, :, :, :], valid[..., s : s + chunk, :]
        U, S, Vt = svd3x3(Ft)
        ratio = torch.abs(S[..., 0] - S[..., 1]) / (torch.abs(S[..., 0] + S[..., 1]) / 2.0)
        gate = (ratio <= svr_allowed) & validt
        E = U @ D @ Vt
        Ex0 = torch.einsum("...trij,...nj->...trni", E, x0h)
        Etx1 = torch.einsum("...trji,...nj->...trni", E, x1h)
        xEx = torch.einsum("...ni,...trni->...trn", x1h, Ex0)
        denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
        sampson2 = (xEx * xEx) / torch.clamp(denom, min=1e-30)
        inlier = (sampson2 <= thr2) & pm
        c = inlier.sum(-1).to(torch.int32)
        counts.append(torch.where(validt, c, torch.full_like(c, -1)))
        gates.append(gate)
    return torch.cat(counts, dim=-2), torch.cat(gates, dim=-2)


def _rescore_best(F, x0, x1, point_mask, reproj_allowed):
    """Re-score ``F (..., K, 3, 3)``: best of each one's 4 cameras under
    the exact criterion, over ``x0, x1 (..., N, 2)``.  Returns ``(cams
    (..., K, 3, 4), counts (..., K), masks (..., K, N))``."""
    P0 = identity_camera(x0.dtype, x0.device)
    U, S, Vt = svd3x3(F)
    P1s = cameras_from_svd(U, Vt)  # (..., K, 4, 3, 4)
    _, reproj, infront = triangulate_fast_full(
        P0, P1s[..., None, :, :], x0[..., None, None, :, :], x1[..., None, None, :, :]
    )
    inlier = (reproj <= reproj_allowed) & infront & point_mask[..., None, None, :]  # (..., K, 4, N)
    counts = inlier.sum(-1).to(torch.int32)
    ic = torch.argmax(counts, dim=-1)  # (..., K)
    cams = torch.take_along_dim(P1s, ic[..., None, None, None], dim=-3)[..., 0, :, :]
    cnt = torch.take_along_dim(counts, ic[..., None], dim=-1)[..., 0]
    msk = torch.take_along_dim(inlier, ic[..., None, None], dim=-2)[..., 0, :]
    return cams, cnt, msk


def _cg_solve9(G, b, iters=16):
    """Solve ``G x = b`` for batched 9x9 SPD ``G`` by unrolled CG."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(iters):
        Ap = torch.einsum("bij,bj->bi", G, p)
        alpha = rs / torch.clamp(torch.sum(p * Ap, dim=-1, keepdim=True), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


def _lo_refine_step(x0, x1, weights, reproj_allowed, weight_allowed, point_mask, F_init):
    """One LO-RANSAC step for a batch of seeds: weighted 8-point refit
    (ridged inverse iteration with a CG inner solve, warm-started from
    ``F_init (B, 3, 3)``), projection to an essential matrix, camera
    re-selection and full re-score.  ``weights (B, N)``."""
    u, v = x0[:, 0], x0[:, 1]
    up, vp = x1[:, 0], x1[:, 1]
    one = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, one], dim=-1)
    A = A[None] * weights[:, :, None]  # (B, N, 9)
    G = A.transpose(1, 2) @ A
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    G = G / torch.clamp(tr, min=1e-30)[:, None, None]
    G = G + (100.0 * torch.finfo(x0.dtype).eps) * torch.eye(9, dtype=x0.dtype, device=x0.device)
    f = F_init.reshape(-1, 9)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-30)
    for _ in range(2):
        f = _cg_solve9(G, f)
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-30)
    F = f.reshape(-1, 3, 3)
    U3, S3, Vt3 = svd3x3(F)
    E = U3 @ _diag110(F) @ Vt3
    P1 = cameras_from_svd(U3, Vt3)  # (B, 4, 3, 4)
    P0 = identity_camera(x0.dtype, x0.device)
    _, reproj, infront = triangulate_fast_full(P0, P1[:, :, None], x0, x1)
    inlier = (reproj <= reproj_allowed) & infront & point_mask  # (B, 4, N)
    loose = (reproj <= weight_allowed) & infront & point_mask
    counts = inlier.sum(-1).to(torch.int32)
    ic = torch.argmax(counts, dim=1)
    b = torch.arange(F.shape[0], device=F.device)
    return E, P1[b, ic], counts[b, ic], inlier[b, ic], loose[b, ic]


def ransac_fit_block(sample, x0, x1, point_mask, reproj_allowed, svr_allowed,
                     live_trials, lo_iters=3):
    """One block of RANSAC trials + shortlist re-score + LO refinement.

    ``sample (T, 7)`` int indices into the ``(N, 2)`` correspondences
    ``x0, x1``; ``point_mask (N,)`` marks real rows; only the first
    ``live_trials`` trials may win.  Returns ``(essential, camera,
    count, inlier_mask)`` (tensors); ``count`` is -1 when no root
    passed the reference gate and no LO seed produced a model.
    """
    N = x0.shape[0]
    T = sample.shape[0]
    F, valid = seven_point(x0[sample], x1[sample], nullspace="mgs")
    live = torch.arange(T, device=x0.device) < live_trials
    counts, gate = _sampson_counts(
        F, valid & live[:, None], x0, x1, point_mask, reproj_allowed, svr_allowed
    )
    flat_counts = counts.reshape(-1)
    flat_gate = gate.reshape(-1)

    k_seeds = 16
    seed_key = flat_counts + torch.where(flat_gate, N + 2, 0).to(flat_counts.dtype)
    # lax.top_k order: descending, ties to the lower index
    top_i = torch.sort(seed_key, descending=True, stable=True)[1][:k_seeds]
    it, ir = top_i // 3, top_i % 3
    okb = flat_gate[top_i]
    validb = flat_counts[top_i] >= 0
    muls = (2.0, 1.4, 1.0)

    Fb = F[it, ir]  # (k, 3, 3)
    cam0, cnt0, msk0 = _rescore_best(Fb, x0, x1, point_mask, reproj_allowed)
    best_E, best_cam = Fb, cam0
    best_cnt = torch.where(okb, cnt0, torch.full_like(cnt0, -1))
    best_msk = msk0 & okb[:, None]
    Fcur = Fb
    wsel = msk0 & validb[:, None]
    enough = validb & (cnt0 >= 8)
    for m in muls[:lo_iters]:
        E2, P2, c2, m2, loose2 = _lo_refine_step(
            x0, x1, wsel.to(x0.dtype), reproj_allowed, reproj_allowed * m,
            point_mask, Fcur,
        )
        c2 = torch.where(enough, c2, torch.full_like(c2, -1))
        better = c2 > best_cnt
        best_E = torch.where(better[:, None, None], E2, best_E)
        best_cam = torch.where(better[:, None, None], P2, best_cam)
        best_cnt = torch.maximum(best_cnt, c2)
        best_msk = torch.where(better[:, None], m2, best_msk)
        Fcur = torch.where(enough[:, None, None], E2, Fcur)
        wsel = torch.where(enough[:, None], loose2, wsel)
    bi = torch.argmax(best_cnt)
    return best_E[bi], best_cam[bi], best_cnt[bi], best_msk[bi]


def _gather_rows(x, idx):
    """``x (..., N, d)`` rows at ``idx (..., m)`` -> ``(..., m, d)``."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def ransac_essential_core(sample, x0, x1, reproj_allowed, svr_allowed, point_mask=None):
    """One batch of RANSAC trials; the batch winner.

    ``sample (..., T, 7)`` row indices into the euclidean
    correspondences ``x0, x1 (..., N, 2)``; ``point_mask (..., N)``
    marks real rows.  Leading dimensions are independent problems (the
    pair step's pairs).  The 7-point roots are ranked by their Sampson
    counts under the reference gate, the top 8 (stable: ties to the
    lower index, as ``lax.top_k``) are re-scored under the exact
    criterion, and the best wins.  Returns a dict of ``essential (...,
    3, 3)``, ``camera (..., 3, 4)``, ``count (...)`` (-1 when every
    hypothesis failed the gate) and ``inlier_mask (..., N)``."""
    N = x0.shape[-2]
    if point_mask is None:
        point_mask = torch.ones(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    lead, T = sample.shape[:-2], sample.shape[-2]
    flat_s = sample.reshape(*lead, T * 7)
    xs0 = _gather_rows(x0, flat_s).reshape(*lead, T, 7, 2)
    xs1 = _gather_rows(x1, flat_s).reshape(*lead, T, 7, 2)
    F, valid = seven_point(xs0, xs1, nullspace="mgs")
    counts, gate = _sampson_counts(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed)
    counts = torch.where(gate, counts, torch.full_like(counts, -1))
    flat = counts.reshape(*lead, T * 3)
    k_rank = min(8, T * 3)
    topv, top_i = torch.sort(flat, dim=-1, descending=True, stable=True)
    topv, top_i = topv[..., :k_rank], top_i[..., :k_rank]
    Fk = torch.take_along_dim(F.reshape(*lead, T * 3, 3, 3), top_i[..., None, None], dim=-3)
    cams, cnts, msks = _rescore_best(Fk, x0, x1, point_mask, reproj_allowed)
    cnts = torch.where(topv >= 0, cnts, torch.full_like(cnts, -1))
    bi = torch.argmax(cnts, dim=-1, keepdim=True)  # (..., 1)
    best = torch.take_along_dim(cnts, bi, dim=-1)[..., 0]
    best_ok = best >= 0
    return {
        "essential": torch.take_along_dim(Fk, bi[..., None, None], dim=-3)[..., 0, :, :],
        "camera": torch.take_along_dim(cams, bi[..., None, None], dim=-3)[..., 0, :, :],
        "count": torch.where(best_ok, best, torch.full_like(best, -1)),
        "inlier_mask": torch.take_along_dim(msks, bi[..., None], dim=-2)[..., 0, :]
        & best_ok[..., None],
    }


def ransac_fitter(x0, x1, options=None, generator=None, batch_trials=8192,
                  confidence=0.999, device="cuda"):
    """Fit a two-view essential matrix to tentative correspondences.

    Same options and return dict as the JAX package's ``ransac_fitter``
    (``success``, ``essential``, ``camera``, ``inlier_percent``,
    ``inlier_idx``, numpy values).  ``generator`` (a ``torch.Generator``
    on ``device``) draws the sample tables; ``None`` seeds one with 0.
    The geometry runs in float32 on CUDA (the accelerator's working
    type) and in the input's float type on the CPU.  Blocks run one at
    a time; the loop stops on the required count, on ``maximum_tries``
    or on the ``confidence`` rule, exactly as the JAX fitter does.
    """
    dev = resolve_device(device)
    opts = dict(DEFAULT_OPTIONS)
    if options:
        opts.update(options)
    x0 = np.asarray(x0)
    x1 = np.asarray(x1)
    if x0.shape[0] != x1.shape[0]:
        raise ValueError("Supplied incorrect point matches, numbers do not match.")
    if x0.shape[0] < 10:
        raise ValueError("Supplied less than 10 point matches, unsupported.")
    if x0.shape[1] == 3:
        x0 = x0[:, :2] / x0[:, 2:]
    if x1.shape[1] == 3:
        x1 = x1[:, :2] / x1[:, 2:]
    on_cpu64 = dev.type == "cpu" and x0.dtype == np.float64
    dtype = torch.float64 if on_cpu64 else torch.float32
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    N = x0.shape[0]
    required = opts["required_percent_inliers"]
    max_tries = int(opts["maximum_tries"])
    batch_trials = min(
        batch_trials, max(512, 1 << int(np.ceil(np.log2(max(max_tries, 2)))))
    )
    Np = max(16, 1 << (N - 1).bit_length())
    pmask = torch.zeros(Np, dtype=torch.bool, device=dev)
    pmask[:N] = True
    x0t = torch.zeros((Np, 2), dtype=dtype, device=dev)
    x1t = torch.zeros((Np, 2), dtype=dtype, device=dev)
    x0t[:N] = torch.as_tensor(x0, dtype=dtype, device=dev)
    x1t[:N] = torch.as_tensor(x1, dtype=dtype, device=dev)
    reproj = float(opts["reprojection_error_allowed"])
    svr = float(opts["singular_value_ratio_allowed"])
    lo_iters = 3 if opts.get("local_optimization", True) else 0
    required_count = int(np.ceil(required * N))

    best = None
    best_count = -1
    tries = 0
    stalled = 0
    progressbar = bool(opts.get("progressbar"))
    while tries < max_tries:
        live = min(batch_trials, max_tries - tries)
        sample = sample_subsets(Np, batch_trials, pmask, generator)
        out = ransac_fit_block(
            sample, x0t, x1t, pmask, reproj, svr, live, lo_iters=lo_iters
        )
        count = int(out[2])
        if progressbar:
            frac = min((tries + live) / max_tries, 1.0)
            n = int(_PROGRESS_BAR_LENGTH * frac)
            print(
                "\r[" + "=" * n + " " * (_PROGRESS_BAR_LENGTH - n)
                + f"] {tries + live}/{max_tries} trials, best {max(count, best_count, 0)}",
                end="", flush=True,
            )
        if count > best_count + max(2, int(0.005 * N)):
            stalled = 0
        else:
            stalled += 1
        if count > best_count:
            best_count = count
            best = out
        tries += live
        if best_count >= required_count:
            break
        w = max(best_count, 0) / N
        if w > 0 and (stalled >= 2 or tries >= 8 * batch_trials):
            needed = math.log(1.0 - confidence) / math.log1p(-min(w**7, 1.0 - 1e-12))
            if tries >= needed:
                break
    if progressbar:
        print(flush=True)
    if best is None or best_count < 0:
        return {
            "success": False,
            "essential": np.zeros((3, 3)),
            "camera": np.zeros((3, 4)),
            "inlier_percent": 0.0,
            "inlier_idx": np.zeros((0,), np.int32),
        }
    essential, camera, _, mask = best
    success = best_count / N >= required
    if not success and not opts["find_best_even_in_failure"]:
        return {
            "success": False,
            "essential": np.zeros((3, 3)),
            "camera": np.zeros((3, 4)),
            "inlier_percent": best_count / N,
            "inlier_idx": np.zeros((0,), np.int32),
        }
    mask = mask.cpu().numpy()
    return {
        "success": bool(success),
        "essential": essential.cpu().numpy(),
        "camera": camera.cpu().numpy(),
        "inlier_percent": best_count / N,
        "inlier_idx": np.where(mask[:N])[0].astype(np.int32),
    }

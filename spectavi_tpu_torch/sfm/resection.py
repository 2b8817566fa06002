"""Camera resectioning (PnP) and incremental pose registration.

Port of ``spectavi_tpu/sfm/resection.py``.  RANSAC-PnP scores every
hypothesis of every problem in one batched program: per trial a 6-point
DLT (SVD of the 12x12 system, nearest rotation from a 3x3 SVD), six
Gauss-Newton steps on the sample's own points, and an inlier count over
all correspondences; the winner is polished on its inliers by masked
Gauss-Newton with a CG solve.  :func:`incremental_poses` registers the
views round by round against triangulated tracks, with a periodic local
bundle adjustment (:func:`~spectavi_tpu_torch.sfm.bundle_adjust.ba_device_loop`).

Random draws: every entry point takes ``generator`` (a
``torch.Generator`` on the device) where the JAX package takes ``key``,
and the PnP functions also accept the ``(B, trials, sample_size)``
sample table itself (``sample``), which is how the tests hand the port
the JAX package's own draws.  Geometry is float64 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device, seeded_generator
from spectavi_tpu_torch.sfm.bundle_adjust import (
    _outer,
    _residual_c,
    cg,
    jac_cam,
    rodrigues,
    rotation_to_rvec,
)
from spectavi_tpu_torch.sfm.pose_graph import triangulate_nview


def _diag(vals, like):
    return torch.diag(torch.tensor(vals, dtype=like.dtype, device=like.device))


def _pnp_dlt(X, uv):
    """Linear 6-point resection of every sample ``X (..., S, 3)``, ``uv
    (..., S, 2)``: the SVD null vector of the stacked ``2S x 12`` DLT
    system, then the nearest rotation of its 3x3 block.  The null
    vector's sign is arbitrary, so both signs are decomposed and the one
    that puts more sample points in front of the camera is kept."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., S, 4)
    zeros4 = torch.zeros_like(Xh)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    rows_u = torch.cat([Xh, zeros4, -u * Xh], dim=-1)  # (..., S, 12)
    rows_v = torch.cat([zeros4, Xh, -v * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2S, 12)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    P = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 4)
    D110 = _diag([1.0, 1.0, 0.0], X)
    D001 = _diag([0.0, 0.0, 1.0], X)

    def decompose(Pc):
        Um, Sm, Vmt = torch.linalg.svd(Pc[..., :3])
        d = torch.linalg.det(Um @ Vmt)
        R = Um @ (D110 + d[..., None, None] * D001) @ Vmt
        s = Sm.mean(-1, keepdim=True)
        t = Pc[..., 3] / torch.where(s > 1e-30, s, torch.full_like(s, 1e-30))
        n_front = ((X * R[..., None, 2, :]).sum(-1) + t[..., None, 2] > 0).sum(-1)
        return R, t, n_front

    R1, t1, n1 = decompose(P)
    R2, t2, n2 = decompose(-P)
    pick = n1 >= n2
    return torch.where(pick[..., None, None], R1, R2), torch.where(pick[..., None], t1, t2)


def _rotation_to_rvec(R):
    """Branch-free rotation -> axis-angle of ``(..., 3, 3)`` matrices."""
    tr = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(tr)
    s = 2.0 * torch.sin(theta)
    axis_raw = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    axis = axis_raw / torch.where(torch.abs(s) > 1e-12, s, torch.ones_like(s))[..., None]
    return torch.where(theta[..., None] < 1e-8, torch.zeros_like(axis), axis * theta[..., None])


def _cg_solve6(G, b, iters=10):
    """Unrolled conjugate gradient for batched 6x6 SPD systems."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(iters):
        Ap = (G * p[..., None, :]).sum(-1)
        alpha = rs / torch.clamp(torch.sum(p * Ap, dim=-1, keepdim=True), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


def _cam_residual_jac(c, X, uv):
    """Residuals ``(..., N, 2)`` and camera Jacobians ``(..., N, 2, 6)``
    of poses ``c (..., 6)`` over points ``X (..., N, 3)``, pinhole."""
    lead = X.shape[:-1]
    cN = c[..., None, :].expand(*lead, 6)
    k = torch.zeros(2, dtype=X.dtype, device=X.device)
    r = _residual_c(cN, X, uv, k)
    J = jac_cam(cN.reshape(-1, 6), X.reshape(-1, 3), uv.reshape(-1, 2), k)
    return r, J.reshape(*lead, 2, 6)


def _gn_polish_sample(rvec, tvec, Xs, uvs, iters=6, lam=1e-9):
    """Gauss-Newton polish of each trial's pose on its own sample points
    (what turns the projective 6-point DLT into a calibrated solver)."""
    c = torch.cat([rvec, tvec], dim=-1)
    eye = torch.eye(6, dtype=Xs.dtype, device=Xs.device)
    S = Xs.shape[-2]
    for _ in range(iters):
        r, J = _cam_residual_jac(c, Xs, uvs)
        r = r.reshape(*r.shape[:-2], 2 * S)
        J = J.reshape(*J.shape[:-3], 2 * S, 6)
        H = _outer(J, J) + lam * eye
        g = (J * r[..., None]).sum(-2)
        c = c + _cg_solve6(H, -g)
    return c[..., :3], c[..., 3:]


def _pnp_refine(rvec, tvec, X, uv, w, iters=10, lam=1e-6):
    """Masked Gauss-Newton polish of one pose per problem (fixed
    structure): ``rvec, tvec (B, 3)``, ``X (B, N, 3)``, ``w (B, N)``."""
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        c = torch.cat([rvec, tvec], dim=-1)
        r, J = _cam_residual_jac(c, X, uv)
        r = r * w[..., None]
        J = J * w[..., None, None]
        H = _outer(J, J).sum(-3) + lam * eye  # (B, 6, 6)
        g = (J * r[..., None]).sum((-3, -2))  # (B, 6)
        (dc,) = cg(lambda p: ((H * p[0][:, None, :]).sum(-1),), (-g,), maxiter=24, batch_dims=1)
        rvec, tvec = rvec + dc[:, :3], tvec + dc[:, 3:]
    return rvec, tvec


def _score(R, t, X, uv, valid, thresh):
    """Inlier counts and masks of poses ``R (B, ..., 3, 3)``, ``t (B,
    ..., 3)`` over each problem's ``X (B, N, 3)``."""
    extra = R.dim() - 3
    Xe = X.reshape(X.shape[0], *(1,) * extra, *X.shape[1:])
    Xc = Xe @ R.transpose(-1, -2) + t[..., None, :]
    depth = Xc[..., 2:3]
    proj = Xc[..., :2] / torch.where(torch.abs(depth) > 1e-30, depth, torch.full_like(depth, 1e-30))
    uve = uv.reshape(uv.shape[0], *(1,) * extra, *uv.shape[1:])
    err = torch.linalg.vector_norm(proj - uve, dim=-1)
    ve = valid.reshape(valid.shape[0], *(1,) * extra, valid.shape[1])
    ok = (err <= thresh) & (depth[..., 0] > 0) & ve
    return ok.sum(-1), ok


def _pnp_full(X, uv, valid, sample, thresh, refine_iters):
    """The whole PnP-RANSAC of ``B`` bucket-padded problems: ``X (B, N,
    3)``, ``uv (B, N, 2)``, ``valid (B, N)``, ``sample (B, T, S)`` row
    indices.  Hypotheses, winner (first maximum), masked polish, final
    re-score.  Returns ``(rvec (B, 3), tvec (B, 3), n (B,), mask (B,
    N))``."""
    B = X.shape[0]
    bi = torch.arange(B, device=X.device)[:, None, None]
    Xs, uvs = X[bi, sample], uv[bi, sample]  # (B, T, S, .)
    R, t = _pnp_dlt(Xs, uvs)
    rv, tv = _gn_polish_sample(_rotation_to_rvec(R), t, Xs, uvs)
    counts, _ = _score(rodrigues(rv), tv, X, uv, valid, thresh)  # (B, T)
    best = torch.argmax(counts, dim=1)
    b = torch.arange(B, device=X.device)
    rvec, tvec = rv[b, best], tv[b, best]
    _, mask = _score(rodrigues(rvec), tvec, X, uv, valid, thresh)
    rvec, tvec = _pnp_refine(rvec, tvec, X, uv, mask.to(X.dtype), iters=refine_iters)
    n_fin, mask = _score(rodrigues(rvec), tvec, X, uv, valid, thresh)
    return rvec, tvec, n_fin, mask


def draw_samples(valid, trials, sample_size, generator):
    """``(B, trials, sample_size)`` row samples without replacement from
    the rows where ``valid (B, N)`` is set: uniform keys, the smallest
    ``sample_size`` of each trial's row."""
    u = torch.rand((valid.shape[0], trials, valid.shape[1]), generator=generator,
                   device=valid.device)
    u = torch.where(valid[:, None, :], u, torch.full_like(u, float("inf")))
    return torch.topk(u, sample_size, dim=-1, largest=False).indices


def _bucket(n):
    """Power-of-two correspondence bucket, at least 256."""
    return max(256, 1 << int(np.ceil(np.log2(n))))


def pnp_ransac(X, uv, generator=None, sample=None, trials=512, sample_size=6,
               reproj_thresh=1e-3, refine_iters=10, device="cuda"):
    """Robust camera resection from 2D-3D correspondences.

    ``X (N, 3)`` world points, ``uv (N, 2)`` calibrated observations,
    ``N >= 6``.  ``sample (trials, sample_size)`` row indices replace the
    generator's draw.  Returns ``dict(rvec, tvec, n_inliers,
    inlier_mask, success)``."""
    N = np.asarray(X).shape[0]
    if N < 6:
        raise ValueError(f"pnp_ransac needs >= 6 correspondences, got {N}")
    return pnp_ransac_batch(
        [(X, uv)], generator=generator, sample=None if sample is None else np.asarray(sample)[None],
        trials=trials, sample_size=sample_size, reproj_thresh=reproj_thresh,
        refine_iters=refine_iters, device=device,
    )[0]


def pnp_ransac_batch(problems, generator=None, sample=None, trials=512, sample_size=6,
                     reproj_thresh=1e-3, refine_iters=10, max_rows=32768, device="cuda"):
    """:func:`pnp_ransac` over a list of ``(X, uv)`` problems in one
    batched program.

    Problems are padded to a shared power-of-two correspondence bucket
    ``Npad`` (padding rows replicate row 0 and are never sampled or
    scored).  At most ``max(1, max_rows // Npad)`` problems run at once;
    larger batches run as consecutive chunks.  Problems are independent,
    so given a sample table the chunking changes no answer; without one,
    each chunk draws its tables from ``generator`` in turn.  The default
    is the JAX package's cap, which bounded a TPU worker's memory; on
    the card one dispatch at the cap peaks near 1 GiB.  ``sample (B,
    trials, sample_size)`` row indices per problem replace the
    generator's draws (extra rows are ignored).  Returns a list of
    result dicts."""
    if not problems:
        return []
    dev = resolve_device(device)
    generator = seeded_generator(generator, dev)
    ns = []
    for X, _ in problems:
        n = np.asarray(X).shape[0]
        if n < 6:
            raise ValueError(f"pnp_ransac needs >= 6 correspondences, got {n}")
        ns.append(n)
    B = len(problems)
    chunk_B = max(1, max_rows // _bucket(max(ns)))
    if B > chunk_B:
        out = []
        for s in range(0, B, chunk_B):
            out.extend(pnp_ransac_batch(
                problems[s : s + chunk_B], generator=generator,
                sample=None if sample is None else sample[s : s + chunk_B],
                trials=trials, sample_size=sample_size, reproj_thresh=reproj_thresh,
                refine_iters=refine_iters, max_rows=max_rows, device=dev,
            ))
        return out
    Npad = _bucket(max(ns))
    Xb = np.zeros((B, Npad, 3))
    uvb = np.zeros((B, Npad, 2))
    validb = np.zeros((B, Npad), bool)
    for b, (X, uv) in enumerate(problems):
        X = np.asarray(X, np.float64)
        uv = np.asarray(uv, np.float64)
        n = ns[b]
        Xb[b, :n], uvb[b, :n] = X, uv
        Xb[b, n:], uvb[b, n:] = X[0], uv[0]
        validb[b, :n] = True
    f64 = dict(dtype=torch.float64, device=dev)
    valid = torch.as_tensor(validb, device=dev)
    if sample is None:
        sel = draw_samples(valid, trials, sample_size, generator)
    else:
        sel = torch.as_tensor(np.array(sample[:B]), dtype=torch.long, device=dev)
    rvecs, tvecs, n_fins, masks = (
        t.cpu().numpy()
        for t in _pnp_full(torch.as_tensor(Xb, **f64), torch.as_tensor(uvb, **f64), valid,
                           sel, float(reproj_thresh), int(refine_iters))
    )
    out = []
    for b in range(B):
        n_fin = int(n_fins[b])
        out.append({
            "rvec": rvecs[b],
            "tvec": tvecs[b],
            "n_inliers": n_fin,
            "inlier_mask": masks[b, : ns[b]],
            "success": bool(n_fin >= max(6, int(0.3 * ns[b]))),
        })
    return out


def _structure_from_registered(cams, reg, uv_all, obs_mask, thresh):
    """Triangulate and validate every track against the registered
    views: structure from >= 2 registered observations, in front of
    every observing registered camera, with its largest reprojection
    error under 3x the PnP threshold.  Returns ``(Xw (T, 3), good
    (T,))``; shapes do not depend on how many views are registered."""
    R = rodrigues(cams[:, :3])  # (V, 3, 3)
    P = torch.cat([R, cams[:, 3:, None]], dim=2)  # (V, 3, 4)
    m = obs_mask & reg[None, :]
    usable = m.sum(1) >= 2
    Xh = triangulate_nview(P, uv_all, m)
    wc = torch.where(torch.abs(Xh[:, 3:]) > 1e-12, Xh[:, 3:], torch.full_like(Xh[:, 3:], 1e-12))
    Xw = Xh[:, :3] / wc
    Xc = (R[None] * Xw[:, None, None, :]).sum(-1) + cams[None, :, 3:]  # (T, V, 3)
    depth = Xc[..., 2]
    safe = torch.where(torch.abs(depth) > 1e-30, depth, torch.full_like(depth, 1e-30))
    proj = Xc[..., :2] / safe[..., None]
    err = torch.linalg.vector_norm(proj - uv_all, dim=-1)  # (T, V)
    ok = (~m) | ((depth > 1e-9) & (err < 3.0 * thresh))
    return Xw, usable & ok.all(dim=1)


def incremental_poses(edges, n_views, keypoints, tracks, ref_view=0, reproj_thresh=2e-3,
                      generator=None, min_corr=8, ba_every=3, ba_iters=8, device="cuda"):
    """Incremental pose registration: seed pair, then batched PnP rounds,
    with a local Huber bundle adjustment every ``ba_every``
    registrations.

    Parameters as :func:`~spectavi_tpu_torch.sfm.pose_graph.chain_poses`
    plus ``tracks`` (:func:`~spectavi_tpu_torch.sfm.pose_graph.build_tracks`).
    A view with fewer than ``min_corr`` anchored tracks is chained from
    an edge to a registered view instead.  Returns ``(cams (n_views, 6),
    registered (n_views,) bool)``."""
    from spectavi_tpu_torch.sfm.bundle_adjust import Incidence, ba_device_loop

    dev = resolve_device(device)
    generator = seeded_generator(generator, dev)
    tracks = np.asarray(tracks)
    T = tracks.shape[0]

    # seed: the edge with the most inlier matches that touches ref_view
    # if one does, else the global best
    def edge_score(e):
        return len(edges[e]["idx_i"])

    touching = [e for e in edges if ref_view in e]
    seed = max(touching or edges.keys(), key=edge_score)
    a, b = seed
    e = edges[seed]
    poses = {a: (np.eye(3), np.zeros(3)), b: (np.asarray(e["R"]), np.asarray(e["t"]))}

    uv_all = np.zeros((T, n_views, 2))
    obs_mask = tracks >= 0
    for v in range(n_views):
        kv = tracks[:, v]
        sel = kv >= 0
        uv_all[sel, v] = np.asarray(keypoints[v])[kv[sel]]

    cams = np.zeros((n_views, 6))
    registered = np.zeros(n_views, bool)
    for v, (R, t) in poses.items():
        cams[v, :3] = rotation_to_rvec(R)
        cams[v, 3:] = t
        registered[v] = True

    f64 = dict(dtype=torch.float64, device=dev)
    uv_all_t = torch.as_tensor(uv_all, **f64)
    obs_mask_t = torch.as_tensor(obs_mask, device=dev)

    def triangulate_registered():
        Xw, good = _structure_from_registered(
            torch.as_tensor(cams, **f64), torch.as_tensor(registered, device=dev),
            uv_all_t, obs_mask_t, float(reproj_thresh),
        )
        return Xw.cpu().numpy(), good.cpu().numpy()

    def local_ba():
        """Consolidate the registered sub-problem: a fixed-scale Huber
        LM run with accept/reject on the device."""
        Xw, good = triangulate_registered()
        t_sel = np.nonzero(good)[0]
        if len(t_sel) < 12:
            return
        remap = -np.ones(T, np.int64)
        remap[t_sel] = np.arange(len(t_sel))
        ci, pi, uvo = [], [], []
        for v in np.nonzero(registered)[0]:
            rows = t_sel[obs_mask[t_sel, v]]
            ci.append(np.full(len(rows), v))
            pi.append(remap[rows])
            uvo.append(uv_all[rows, v])
        ci = torch.as_tensor(np.concatenate(ci), dtype=torch.long, device=dev)
        pi = torch.as_tensor(np.concatenate(pi), dtype=torch.long, device=dev)
        uvo = torch.as_tensor(np.concatenate(uvo), **f64)
        fixed = torch.zeros(n_views, dtype=torch.bool, device=dev)
        fixed[int(np.nonzero(registered)[0][0])] = True
        # unregistered cameras have no observations: their U blocks are
        # pure LM ridge and their update is exactly 0
        new_cams, _, _, _ = ba_device_loop(
            torch.as_tensor(cams, **f64), torch.as_tensor(Xw[t_sel], **f64),
            Incidence(ci, pi, n_views, len(t_sel)), None, uvo,
            torch.ones(uvo.shape[0], **f64), torch.tensor(3.0 * reproj_thresh, **f64),
            1e-3, fixed, iters=ba_iters, robust=True,
        )
        new_cams = new_cams.cpu().numpy()
        for v in np.nonzero(registered)[0]:
            cams[v] = new_cams[v]

    n_since_ba = 0
    while not registered.all():
        Xw, good = triangulate_registered()
        # every sufficiently anchored unregistered view registers this
        # round, in one batched PnP
        cand = [
            (int((obs_mask[:, v] & good).sum()), v)
            for v in range(n_views)
            if not registered[v]
        ]
        ready = [(n, v) for n, v in cand if n >= min_corr]
        if not ready:
            # a disconnected or starved view: chain it from an edge to a
            # registered view (keeps the API total)
            n_corr, v = max(cand)
            fell_back = False
            for (i, j), e in edges.items():
                if {registered[i], registered[j]} == {True, False}:
                    src, dst = (i, j) if registered[i] else (j, i)
                    if dst != v:
                        continue
                    R0 = rodrigues(torch.as_tensor(cams[src, :3])).numpy()
                    t0 = cams[src, 3:]
                    Re, te = np.asarray(e["R"]), np.asarray(e["t"])
                    if src == j:  # invert the stored direction
                        Re, te = Re.T, -Re.T @ te
                    cams[v, :3] = rotation_to_rvec(Re @ R0)
                    cams[v, 3:] = Re @ t0 + te
                    registered[v] = True
                    fell_back = True
                    break
            if fell_back:
                continue
            raise RuntimeError(
                f"view {v} has {n_corr} < {min_corr} correspondences and "
                "no edge to a registered view"
            )

        views = [v for _, v in ready]
        sels = [obs_mask[:, v] & good for v in views]
        results = pnp_ransac_batch(
            [(Xw[s], uv_all[s, v]) for s, v in zip(sels, views)],
            generator=generator, reproj_thresh=reproj_thresh, device=dev,
        )
        for v, res in zip(views, results):
            cams[v, :3] = res["rvec"]
            cams[v, 3:] = res["tvec"]
            registered[v] = True
        n_since_ba += len(views)
        if ba_every and (n_since_ba >= ba_every or registered.all()):
            local_ba()
            n_since_ba = 0

    return cams, registered

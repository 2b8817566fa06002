"""Bundle adjustment with a matrix-free Schur complement.

Port of ``spectavi_tpu/sfm/bundle_adjust.py``: cameras are ``(rvec,
tvec)`` axis-angle blocks (6 parameters), points 3-vectors, and the
per-observation 2x6, 2x3 (and 2x2 radial) Jacobians come from
``torch.func.vmap(jacfwd(...))`` of the same residual.  The normal
equations stay as per-entity blocks ``U`` (cameras), ``V`` (points)
and the per-observation cross term ``W``; the reduced camera system
``S = U - W V^-1 W^T`` is solved by conjugate gradients, each matvec two
segment sums and a batched 3x3 product.

Two choices differ from a line-by-line translation:

* segment sums go through :class:`Segments`, a gather into a
  ``(segments, widest segment)`` table summed along its rows.  Every
  segment is then reduced in one fixed order, on the card as on the
  CPU, where ``index_add_`` would use float atomics and an LM
  accept/reject near a tie could flip from run to run;
* :func:`cg` is ``jax.scipy.sparse.linalg.cg``'s recurrence run for
  exactly ``maxiter`` iterations, with each problem's state frozen by
  ``torch.where`` once its residual meets the tolerance.  The answer is
  the JAX solver's, and the loop never waits on the card.

Everything is float64: the card has native double precision, so the
port matches the JAX package's x64 CPU results (the JAX package runs
float32 on its TPU only because double-precision linear algebra does
not compile there).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from spectavi_tpu_torch import resolve_device
from spectavi_tpu_torch.mvg.core import inv3x3


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def rodrigues(rvec):
    """Axis-angle ``(..., 3)`` -> rotation matrix ``(..., 3, 3)``.

    Differentiable at the identity: the small-angle branch uses the
    unnormalized 2nd-order expansion and both branches see sanitized
    operands, so neither value nor derivative is NaN at ``rvec = 0``."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    small = theta2 < 1e-16
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    k = rvec / theta
    K = _skew(k)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    K0 = _skew(rvec)
    R_small = eye + K0 + 0.5 * (K0 @ K0)
    return torch.where(small[..., None], R_small, R)


def rotation_to_rvec(R):
    """Rotation matrix -> axis-angle (numpy helper for initialization)."""
    R = np.asarray(R)
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-8:
        return np.zeros(3)
    axis = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(theta))
    )
    return axis * theta


def _project(rvec, tvec, X, k):
    """Pinhole projection of ``X (..., 3)`` with the radial model
    ``(1 + k1 r^2 + k2 r^4)`` on calibrated coordinates."""
    R = rodrigues(rvec)
    Xc = (R @ X[..., None])[..., 0] + tvec
    p = Xc[..., :2] / Xc[..., 2:3]
    r2 = torch.sum(p * p, dim=-1, keepdim=True)
    return p * (1.0 + k[..., 0:1] * r2 + k[..., 1:2] * r2 * r2)


def _residual(rvec, tvec, X, uv, k):
    return _project(rvec, tvec, X, k) - uv


def _residual_c(c, X, uv, k):
    return _residual(c[..., :3], c[..., 3:], X, uv, k)


# per-observation Jacobians of the residual: camera and point, plus the
# shared radial block for the joint (cameras, points, k) step
_jac_cp = vmap(jacfwd(_residual_c, argnums=(0, 1)), in_dims=(0, 0, 0, None))
_jac_cpk = vmap(jacfwd(_residual_c, argnums=(0, 1, 3)), in_dims=(0, 0, 0, None))
jac_cam = vmap(jacfwd(_residual_c, argnums=0), in_dims=(0, 0, 0, None))


def _zero_k(like):
    return torch.zeros(2, dtype=like.dtype, device=like.device)


class Segments:
    """Deterministic segment sums over a fixed index ``idx (O,)`` into
    ``num`` segments.

    Rows are grouped by segment once (stable sort, so each segment keeps
    the observation order) into a ``(num, widest)`` gather table padded
    with a zero row; a sum is one gather and one reduction along the
    table's rows.  Building the table reads the widest segment's size
    back to the host once."""

    def __init__(self, idx, num):
        idx = idx.to(torch.long)
        O = idx.shape[0]
        dev = idx.device
        order = torch.argsort(idx, stable=True)
        counts = torch.bincount(idx, minlength=num)[:num]
        width = max(int(counts.max()) if O else 0, 1)
        start = torch.cumsum(counts, 0) - counts
        sidx = idx[order]
        pos = torch.arange(O, device=dev) - start[sidx]
        table = torch.full((num, width), O, dtype=torch.long, device=dev)
        table[sidx, pos] = order
        self.idx = idx
        self.num = num
        self.table = table

    def __call__(self, vals):
        pad = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
        return pad[self.table].sum(1)


class Incidence:
    """The observation incidence of one problem: ``cam (O,)`` and
    ``pt (O,)`` indices with their segment-sum tables."""

    def __init__(self, cam_idx, pt_idx, n_cams, n_pts):
        self.cam = Segments(cam_idx, n_cams)
        self.pt = Segments(pt_idx, n_pts)
        self.cam_idx = self.cam.idx
        self.pt_idx = self.pt.idx


def _incidence(cam_idx, pt_idx, cams, pts):
    if isinstance(cam_idx, Incidence):
        return cam_idx
    return Incidence(cam_idx, pt_idx, cams.shape[0], pts.shape[0])


def _outer(A, B):
    """``einsum("oki,okj->oij")`` as products and one sum over ``k``."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(-3)


def _tdot(J, r):
    """``einsum("oki,ok->oi")``."""
    return (J * r[..., None]).sum(-2)


def _mv(M, v):
    """``einsum("...ij,...j->...i")``."""
    return (M * v[..., None, :]).sum(-1)


def _mtv(M, v):
    """``einsum("...ji,...j->...i")``."""
    return (M * v[..., :, None]).sum(-2)


def _trace(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _damp(A, lam):
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return A + lam * eye * torch.clamp(_trace(A) / float(n), min=1e-12)[..., None, None]


def _residuals(cams, pts, inc, uv, k):
    return _residual_c(cams[inc.cam_idx], pts[inc.pt_idx], uv, k)


def _build_blocks(cams, pts, inc, uv, w, k, with_k=False):
    """Weighted residuals ``(O, 2)`` and Jacobians ``(O, 2, 6)``,
    ``(O, 2, 3)`` (and ``(O, 2, 2)`` with ``with_k``)."""
    c = cams[inc.cam_idx]
    X = pts[inc.pt_idx]
    r = _residual_c(c, X, uv, k) * w[:, None]
    jac = _jac_cpk if with_k else _jac_cp
    Js = jac(c, X, uv, k)
    return (r,) + tuple(J * w[:, None, None] for J in Js)


def fit_distortion(cams, pts, cam_idx, pt_idx, uv, w):
    """Closed-form least-squares ``(k1, k2)`` given fixed geometry: the
    distorted projection is linear in ``(k1, k2)``."""
    c = cams[cam_idx]
    X = pts[pt_idx]
    Xc = (rodrigues(c[:, :3]) @ X[..., None])[..., 0] + c[:, 3:]
    p = Xc[:, :2] / Xc[:, 2:3]
    r2 = torch.sum(p * p, dim=1, keepdim=True)
    b1 = p * r2 * w[:, None]
    b2 = p * r2 * r2 * w[:, None]
    d = (uv - p) * w[:, None]
    a11 = torch.sum(b1 * b1)
    a12 = torch.sum(b1 * b2)
    a22 = torch.sum(b2 * b2)
    c1 = torch.sum(b1 * d)
    c2 = torch.sum(b2 * d)
    det = a11 * a22 - a12 * a12
    safe = torch.abs(det) > 1e-30
    det = torch.where(safe, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    k1 = torch.where(safe, (c1 * a22 - c2 * a12) / det, zero)
    k2 = torch.where(safe, (c2 * a11 - c1 * a12) / det, zero)
    return torch.stack([k1, k2])


def _dot(xs, ys, batch_dims):
    """``sum`` over every leaf of ``<x, y>``, reducing all but the first
    ``batch_dims`` dimensions (JAX's ``_vdot_real_tree``)."""
    tot = 0.0
    for x, y in zip(xs, ys):
        tot = tot + torch.sum((x * y).flatten(batch_dims), dim=-1)
    return tot


def cg(matvec, b, maxiter, tol=1e-5, atol=0.0, batch_dims=0):
    """Conjugate gradients on a tuple of tensors ``b``: the recurrence of
    ``jax.scipy.sparse.linalg.cg`` (``x0 = 0``, stop once ``r.r <=
    max(tol^2 b.b, atol^2)`` or after ``maxiter`` iterations), run for
    ``maxiter`` iterations with each problem frozen by selection once it
    stops, so no iteration reads a value back to the host.  The first
    ``batch_dims`` dimensions of every leaf index independent problems
    (JAX's ``vmap`` of ``cg``).  ``b = 0`` stops before the first
    iteration and returns 0, as JAX does."""
    b = tuple(b)
    atol2 = torch.clamp((tol * tol) * _dot(b, b, batch_dims), min=atol * atol)
    x = tuple(torch.zeros_like(v) for v in b)
    r = b
    p = r
    gamma = _dot(r, r, batch_dims)

    def per_leaf(s, leaf):
        """A per-problem scalar shaped to broadcast against ``leaf``."""
        return s.reshape(s.shape + (1,) * (leaf.dim() - batch_dims))

    for _ in range(maxiter):
        on = gamma > atol2
        Ap = tuple(matvec(p))
        alpha = gamma / _dot(p, Ap, batch_dims)
        x_ = tuple(xi + per_leaf(alpha, pi) * pi for xi, pi in zip(x, p))
        r_ = tuple(ri - per_leaf(alpha, api) * api for ri, api in zip(r, Ap))
        gamma_ = _dot(r_, r_, batch_dims)
        beta = gamma_ / gamma
        p_ = tuple(ri + per_leaf(beta, pi) * pi for ri, pi in zip(r_, p))
        x = tuple(torch.where(per_leaf(on, n), n, o) for n, o in zip(x_, x))
        r = tuple(torch.where(per_leaf(on, n), n, o) for n, o in zip(r_, r))
        p = tuple(torch.where(per_leaf(on, n), n, o) for n, o in zip(p_, p))
        gamma = torch.where(on, gamma_, gamma)
    return x


def _ba_quantities(cams, pts, inc, uv, w, lam, k=None):
    """U, V^-1, per-observation W, the gradient blocks and the cost."""
    if k is None:
        k = _zero_k(cams)
    r, Jc, Jp = _build_blocks(cams, pts, inc, uv, w, k)
    U = inc.cam(_outer(Jc, Jc))  # (C, 6, 6)
    V = inc.pt(_outer(Jp, Jp))  # (M, 3, 3)
    bc = inc.cam(_tdot(Jc, r))  # (C, 6)
    bp = inc.pt(_tdot(Jp, r))  # (M, 3)
    cost = torch.sum(r * r)
    U = _damp(U, lam)
    V = _damp(V, lam)
    Vinv = inv3x3(V)
    Wblk = _outer(Jc, Jp)  # (O, 6, 3)
    return U, Vinv, Wblk, bc, bp, cost


def _schur_matvec(v, U, Vinv, Wblk, inc):
    """``S v`` with ``S = U - W V^-1 W^T``, matrix-free over observations."""
    y = inc.pt(_mtv(Wblk, v[inc.cam_idx]))  # (M, 3)
    z = _mv(Vinv, y)
    back = inc.cam(_mv(Wblk, z[inc.pt_idx]))  # (C, 6)
    return _mv(U, v) - back


def _solve_schur(U, Vinv, Wblk, bc, bp, inc, fixed_cam_mask, cg_iters=100):
    """Solve the reduced camera system with CG, then back-substitute the
    point updates.  ``fixed_cam_mask (C,)`` gauge-fixes cameras."""
    z0 = _mv(Vinv, bp)
    rhs = -(bc - inc.cam(_mv(Wblk, z0[inc.pt_idx])))
    free = (~fixed_cam_mask)[:, None]
    # select, never multiply: a NaN in a fixed block survives `nan * 0`
    rhs = torch.where(free, rhs, torch.zeros_like(rhs))

    def matvec(p):
        (v,) = p
        v = torch.where(free, v, torch.zeros_like(v))
        out = _schur_matvec(v, U, Vinv, Wblk, inc)
        return (torch.where(free, out, v),)

    (dc,) = cg(matvec, (rhs,), maxiter=cg_iters)
    dc = dc * free
    acc = inc.pt(_mtv(Wblk, dc[inc.cam_idx]))
    dp = -_mv(Vinv, bp + acc)
    return dc, dp


def _ba_quantities_joint(cams, pts, inc, uv, w, lam, k):
    r, Jc, Jp, Jk = _build_blocks(cams, pts, inc, uv, w, k, with_k=True)
    U = inc.cam(_outer(Jc, Jc))
    V = inc.pt(_outer(Jp, Jp))
    Uck = inc.cam(_outer(Jc, Jk))  # (C, 6, 2)
    Ukk = _outer(Jk, Jk).sum(0)  # (2, 2)
    bc = inc.cam(_tdot(Jc, r))
    bp = inc.pt(_tdot(Jp, r))
    bk = _tdot(Jk, r).sum(0)  # (2,)
    cost = torch.sum(r * r)
    U = _damp(U, lam)
    V = _damp(V, lam)
    Ukk = _damp(Ukk, lam)
    Vinv = inv3x3(V)
    Wc = _outer(Jc, Jp)  # (O, 6, 3)
    Wk = _outer(Jk, Jp)  # (O, 2, 3)
    return U, Uck, Ukk, Vinv, Wc, Wk, bc, bp, bk, cost


def _solve_schur_joint(U, Uck, Ukk, Vinv, Wc, Wk, bc, bp, bk, inc, fixed_cam_mask,
                       cg_iters=100):
    free = (~fixed_cam_mask)[:, None]
    z0 = _mv(Vinv, bp)[inc.pt_idx]
    rhs_c = -(bc - inc.cam(_mv(Wc, z0)))
    rhs_k = -(bk - _mv(Wk, z0).sum(0))
    rhs_c = torch.where(free, rhs_c, torch.zeros_like(rhs_c))

    def matvec(p):
        vc, vk = p
        vc = torch.where(free, vc, torch.zeros_like(vc))
        y = inc.pt(_mtv(Wc, vc[inc.cam_idx]) + _mtv(Wk, vk))
        z = _mv(Vinv, y)[inc.pt_idx]
        a_c = _mv(U, vc) + _mv(Uck, vk) - inc.cam(_mv(Wc, z))
        a_k = _mtv(Uck, vc).sum(0) + _mv(Ukk, vk) - _mv(Wk, z).sum(0)
        return torch.where(free, a_c, vc), a_k

    dc, dk = cg(matvec, (rhs_c, rhs_k), maxiter=cg_iters)
    dc = dc * free
    acc = inc.pt(_mtv(Wc, dc[inc.cam_idx]) + _mtv(Wk, dk))
    dp = -_mv(Vinv, bp + acc)
    return dc, dp, dk


def ba_step_joint(cams, pts, cam_idx, pt_idx, uv, w, lam, fixed_cam_mask, k, cg_iters=100):
    """One damped LM step over cameras, points AND the shared ``(k1,
    k2)`` radial block.  Returns ``(new_cams, new_pts, new_k,
    cost_before)``.  ``cam_idx`` may be an :class:`Incidence`."""
    inc = _incidence(cam_idx, pt_idx, cams, pts)
    U, Uck, Ukk, Vinv, Wc, Wk, bc, bp, bk, cost = _ba_quantities_joint(
        cams, pts, inc, uv, w, lam, k
    )
    dc, dp, dk = _solve_schur_joint(
        U, Uck, Ukk, Vinv, Wc, Wk, bc, bp, bk, inc, fixed_cam_mask, cg_iters=cg_iters
    )
    return cams + dc, pts + dp, k + dk, cost


def _residual_norms(cams, pts, inc, uv, k):
    r = _residuals(cams, pts, inc, uv, k)
    return torch.sqrt(torch.sum(r * r, dim=1))


def huber_weights(norms, delta):
    """IRLS weights of the Huber loss: 1 in the quadratic zone,
    ``delta/|r|`` beyond (multiply into ``w`` as a square root)."""
    return torch.clamp(delta / torch.clamp(norms, min=1e-30), max=1.0)


def huber_cost(norms, w, delta):
    """The Huber objective ``sum w^2 rho(|r|)``, ``rho(n) = n^2`` up to
    ``delta`` and ``2 delta n - delta^2`` beyond."""
    rho = torch.where(norms <= delta, norms**2, 2.0 * delta * norms - delta**2)
    return torch.sum(w**2 * rho)


def ba_step(cams, pts, cam_idx, pt_idx, uv, w, lam, fixed_cam_mask, k=None, cg_iters=100):
    """One damped Gauss-Newton (LM) step.  Returns ``(new_cams,
    new_pts, cost_before)``; the caller accepts or rejects.
    ``cam_idx`` may be an :class:`Incidence` (``pt_idx`` is then
    ignored)."""
    inc = _incidence(cam_idx, pt_idx, cams, pts)
    U, Vinv, Wblk, bc, bp, cost = _ba_quantities(cams, pts, inc, uv, w, lam, k=k)
    dc, dp = _solve_schur(U, Vinv, Wblk, bc, bp, inc, fixed_cam_mask, cg_iters=cg_iters)
    return cams + dc, pts + dp, cost


def ba_cost(cams, pts, cam_idx, pt_idx, uv, w, k=None):
    """Weighted squared reprojection cost."""
    if k is None:
        k = _zero_k(cams)
    c = cams[torch.as_tensor(cam_idx, device=cams.device).long()]
    X = pts[torch.as_tensor(pt_idx, device=cams.device).long()]
    r = _residual_c(c, X, uv, k) * w[:, None]
    return torch.sum(r * r)


def _objective(cams, pts, k, inc, uv, w, delta, robust):
    if robust:
        return huber_cost(_residual_norms(cams, pts, inc, uv, k), w, delta)
    r = _residuals(cams, pts, inc, uv, k) * w[:, None]
    return torch.sum(r * r)


def _lm_iteration(cams, pts, k, inc, uv, w, delta, lam, fixed_cam_mask, cg_iters, robust,
                  joint):
    """One complete LM iteration: IRLS reweighting at the current state,
    the damped Gauss-Newton step, and the candidate's (robust)
    objective."""
    if robust:
        n = _residual_norms(cams, pts, inc, uv, k)
        w_eff = w * torch.sqrt(huber_weights(n, delta))
    else:
        w_eff = w
    if joint:
        new_cams, new_pts, new_k, _ = ba_step_joint(
            cams, pts, inc, None, uv, w_eff, lam, fixed_cam_mask, k, cg_iters=cg_iters
        )
    else:
        new_cams, new_pts, _ = ba_step(
            cams, pts, inc, None, uv, w_eff, lam, fixed_cam_mask, k=k, cg_iters=cg_iters
        )
        new_k = k
    new_cost = _objective(new_cams, new_pts, new_k, inc, uv, w, delta, robust)
    return new_cams, new_pts, new_k, new_cost


def ba_device_loop(cams, pts, cam_idx, pt_idx, uv, w, delta, lam0, fixed_cam_mask, iters,
                   cg_iters=100, robust=True):
    """A fixed-round LM bundle adjustment with accept/reject and damping
    updates on the device (``torch.where`` on ``new_cost < cost``): no
    value is read back to the host inside the loop.  Takes tensors on
    one device; a FIXED robust scale ``delta``; no distortion.  Returns
    ``(cams, pts, cost0, cost)`` under the (robust) objective.
    ``cam_idx`` may be an :class:`Incidence`."""
    inc = _incidence(cam_idx, pt_idx, cams, pts)
    k = _zero_k(cams)
    lam = torch.as_tensor(lam0, dtype=cams.dtype, device=cams.device)
    cost0 = _objective(cams, pts, k, inc, uv, w, delta, robust)
    cost = cost0
    for _ in range(int(iters)):
        new_cams, new_pts, _, new_cost = _lm_iteration(
            cams, pts, k, inc, uv, w, delta, lam, fixed_cam_mask, cg_iters, robust, False
        )
        accept = new_cost < cost
        cams = torch.where(accept, new_cams, cams)
        pts = torch.where(accept, new_pts, pts)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-12), lam * 10.0)
    return cams, pts, cost0, cost


def _problem(cams, pts, cam_idx, pt_idx, uv, weights, dev):
    f64 = dict(dtype=torch.float64, device=dev)
    cams = torch.as_tensor(np.asarray(cams), **f64)
    pts = torch.as_tensor(np.asarray(pts), **f64)
    uv = torch.as_tensor(np.asarray(uv), **f64)
    w = (
        torch.ones(uv.shape[0], **f64)
        if weights is None
        else torch.as_tensor(np.asarray(weights), **f64)
    )
    inc = Incidence(
        torch.as_tensor(np.asarray(cam_idx), dtype=torch.long, device=dev),
        torch.as_tensor(np.asarray(pt_idx), dtype=torch.long, device=dev),
        cams.shape[0], pts.shape[0],
    )
    return cams, pts, inc, uv, w


def _fixed_mask(n, fixed_cameras, dev):
    fixed = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in fixed_cameras:
        fixed[i] = True
    return fixed


def _mad_scale(norms, w):
    """Robust scale of the active residual norms: ``3 * 1.4826 * MAD``,
    floored by the median."""
    n = norms.cpu().numpy()
    active = n[w.cpu().numpy() > 0]
    if not len(active):
        return 1.0
    med = float(np.median(active))
    mad = float(np.median(np.abs(active - med)))
    return max(3.0 * 1.4826 * mad, med, 1e-12)


def bundle_adjust_device(cams, pts, cam_idx, pt_idx, uv, weights=None, fixed_cameras=(0,),
                         max_iters=20, lam0=1e-3, cg_iters=100, loss="huber",
                         huber_delta=None, device="cuda"):
    """:func:`bundle_adjust` with the LM loop on the device
    (:func:`ba_device_loop`): a FIXED Huber scale (MAD of the initial
    residuals when not given, one pull), always ``max_iters`` LM
    iterations, no distortion.  Numpy in, ``(cams, pts, [cost_initial,
    cost_final])`` numpy out, computed in float64 on ``device``."""
    if loss not in ("linear", "huber"):
        raise ValueError(f"unknown loss {loss!r} (use 'linear' or 'huber')")
    dev = resolve_device(device)
    cams, pts, inc, uv, w = _problem(cams, pts, cam_idx, pt_idx, uv, weights, dev)
    fixed = _fixed_mask(cams.shape[0], fixed_cameras, dev)
    robust = loss == "huber"
    if robust and huber_delta is None:
        huber_delta = _mad_scale(_residual_norms(cams, pts, inc, uv, _zero_k(cams)), w)
    delta = torch.tensor(huber_delta if robust else 1.0, dtype=torch.float64, device=dev)
    new_cams, new_pts, cost0, cost = ba_device_loop(
        cams, pts, inc, None, uv, w, delta, lam0, fixed, iters=int(max_iters),
        cg_iters=cg_iters, robust=robust,
    )
    return new_cams.cpu().numpy(), new_pts.cpu().numpy(), [float(cost0), float(cost)]


def bundle_adjust(cams, pts, cam_idx, pt_idx, uv, weights=None, fixed_cameras=(0,),
                  max_iters=20, lam0=1e-3, cg_iters=100, tol=1e-12, verbose=False,
                  estimate_distortion=False, loss="linear", huber_delta=None,
                  huber_rescale=False, device="cuda"):
    """Levenberg-Marquardt bundle adjustment, host loop around device
    steps (one float read back per iteration).

    Same parameters and outputs as the JAX package's ``bundle_adjust``:
    ``cams (C, 6)``, ``pts (M, 3)``, ``cam_idx``/``pt_idx (O,)``, ``uv
    (O, 2)`` calibrated observations, ``weights (O,)`` (0 masks one);
    ``estimate_distortion`` adds the shared radial ``(k1, k2)`` block
    (closed-form init, then joint Schur steps) and a fourth output;
    ``loss="huber"`` reweights by IRLS and accepts on the true robust
    objective, with the scale ``huber_delta`` (MAD of the initial
    residuals by default) shrunk after accepted steps when
    ``huber_rescale``.  Returns numpy ``(cams, pts, history[, k])``.
    """
    if loss not in ("linear", "huber"):
        raise ValueError(f"unknown loss {loss!r} (use 'linear' or 'huber')")
    dev = resolve_device(device)
    cams, pts, inc, uv, w = _problem(cams, pts, cam_idx, pt_idx, uv, weights, dev)
    fixed = _fixed_mask(cams.shape[0], fixed_cameras, dev)

    k = _zero_k(cams)
    if estimate_distortion:
        # closed-form init against the initial geometry; the joint steps
        # then refine it with the cameras and points
        k0 = fit_distortion(cams, pts, inc.cam_idx, inc.pt_idx, uv, w)
        if float(_objective(cams, pts, k0, inc, uv, w, None, False)) < float(
            _objective(cams, pts, k, inc, uv, w, None, False)
        ):
            k = k0

    robust = loss == "huber"
    delta = None

    def mad(cams_, pts_, k_):
        return _mad_scale(_residual_norms(cams_, pts_, inc, uv, k_), w)

    if robust:
        if huber_delta is None:
            huber_delta = mad(cams, pts, k)
        delta = torch.tensor(max(huber_delta, 1e-12), dtype=torch.float64, device=dev)

    def objective(cams_, pts_, k_):
        return float(_objective(cams_, pts_, k_, inc, uv, w, delta, robust))

    one = torch.tensor(1.0, dtype=torch.float64, device=dev)
    lam = lam0
    cost = objective(cams, pts, k)
    history = [cost]
    for it in range(max_iters):
        new_cams, new_pts, new_k, new_cost_d = _lm_iteration(
            cams, pts, k, inc, uv, w, delta if robust else one,
            torch.tensor(lam, dtype=torch.float64, device=dev), fixed,
            cg_iters, robust, estimate_distortion,
        )
        new_cost = float(new_cost_d)
        if verbose:
            print(f"BA iter {it}: cost {cost:.6e} -> {new_cost:.6e} (lam={lam:.1e})")
        if new_cost < cost:
            improvement = (cost - new_cost) / max(cost, 1e-30)
            cams, pts, k, cost = new_cams, new_pts, new_k, new_cost
            lam = max(lam * 0.3, 1e-12)
            delta_shrunk = False
            if robust and huber_rescale:
                new_delta = min(float(delta), mad(cams, pts, k))
                if new_delta < float(delta):
                    delta_shrunk = new_delta < 0.99 * float(delta)
                    delta = torch.tensor(new_delta, dtype=torch.float64, device=dev)
                    # the objective changed definition: re-anchor the
                    # LM reference cost under the new scale
                    cost = objective(cams, pts, k)
            history.append(cost)
            # a still-shrinking scale redefines the objective, so a
            # stalled cost is not convergence yet
            if improvement < tol and not delta_shrunk:
                break
        else:
            lam *= 10.0
            if lam > 1e8:
                break
    out = (cams.cpu().numpy(), pts.cpu().numpy(), history)
    if estimate_distortion:
        return out + (k.cpu().numpy(),)
    return out

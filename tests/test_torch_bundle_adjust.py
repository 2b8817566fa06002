"""Port parity: ``spectavi_tpu_torch.sfm.bundle_adjust`` against
``spectavi_tpu.sfm.bundle_adjust`` in float64 on the same numpy inputs.

Rotations, residuals and Jacobians (``torch.func`` forward mode against
``jax.jacobian``) agree to 1e-12, also at ``rvec = 0`` where the
small-angle branch decides the value; the normal-equation blocks to
1e-10 and one LM step to 1e-9 of their scale.  Whole runs (host loop
with each loss, the device loop) agree to 1e-8.

The CG without a preconditioner amplifies summation-order differences
on some scenes, in JAX as in the port: on a narrow field of view the
radial block is nearly unobservable, and on the joint system a 1e-17
difference grew about 1e4-fold per iteration (2e-6 at iteration 5),
while the port perturbed by 1e-15 in its input moved by 1e-7 against
itself.  So the scenes here are chosen where the reference is stable:
a wide field of view with real radial distortion, two fixed cameras
(no free gauge), LM damping from 1.0 (0.1 for the joint step) and three
iterations a run.  The CG itself is JAX's recurrence with frozen
problems: it returns 0 for ``b = 0`` and stops where JAX stops.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectavi_tpu_torch.utils import profiling

torch.set_num_threads(2)

jba = importlib.import_module("spectavi_tpu.sfm.bundle_adjust")
tba = importlib.import_module("spectavi_tpu_torch.sfm.bundle_adjust")

T = lambda a: torch.as_tensor(np.array(a))
J = jnp.asarray

# the LM damping every step and run starts from (see the module doc)
LAM = 1.0


def _close(a, b, tol):
    """Elementwise within ``tol`` relative to the array's largest entry."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1e-300))


def _scene(seed=1, C=5, M=60, noise=1e-3, spread=2.5, k=(-0.08, 0.02)):
    """Cameras on an arc around a point cloud (``spread`` scales it, and
    so the field of view), observations through the radial model ``k``
    with noise and a few gross outliers, and a perturbed start (all but
    cameras 0 and 1)."""
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(C):
        ang = 0.25 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        Cc = np.array([3.0 * np.sin(ang), 0.3 * i, -8.0 + 0.5 * i])
        cams.append(np.concatenate([jba.rotation_to_rvec(R), -R @ Cc]))
    cams = np.asarray(cams)
    pts = spread * rng.standard_normal((M, 3))
    ci, pi = np.meshgrid(np.arange(C), np.arange(M), indexing="ij")
    ci, pi = ci.ravel(), pi.ravel()
    R = np.asarray(jba.rodrigues(J(cams[:, :3])))
    Xc = np.einsum("oij,oj->oi", R[ci], pts[pi]) + cams[ci, 3:]
    p = Xc[:, :2] / Xc[:, 2:]
    r2 = np.sum(p * p, axis=1, keepdims=True)
    uv = p * (1.0 + k[0] * r2 + k[1] * r2 * r2) + noise * rng.standard_normal((len(ci), 2))
    uv[:4] += 0.05
    cams_n = cams.copy()
    cams_n[2:] += 0.01 * rng.standard_normal(cams[2:].shape)
    pts_n = pts + 0.05 * spread * rng.standard_normal(pts.shape)
    return cams_n, pts_n, ci, pi, uv


def test_rodrigues_and_rotation_to_rvec(rng):
    r = rng.standard_normal((20, 3))
    r[0] = 0.0
    r[1] = 1e-9
    _close(tba.rodrigues(T(r)), jba.rodrigues(J(r)), 1e-12)
    for ri in r:
        R = np.asarray(jba.rodrigues(J(ri)))
        np.testing.assert_array_equal(tba.rotation_to_rvec(R), jba.rotation_to_rvec(R))


def test_residuals_and_jacobians(rng):
    c = rng.standard_normal((8, 6)) * 0.3
    c[:3, :3] = 0.0  # the gauge camera: rvec = 0
    c[3, :3] = 1e-9
    c[:, 5] += 6.0
    X = rng.standard_normal((8, 3))
    uv = 0.1 * rng.standard_normal((8, 2))
    k = np.array([0.1, -0.05])
    rt = tba._residual_c(T(c), T(X), T(uv), T(k))
    rj = jax.vmap(lambda ci, Xi, ui: jba._residual(ci[:3], ci[3:], Xi, ui, J(k)))(J(c), J(X), J(uv))
    _close(rt, rj, 1e-12)
    Jc, Jp, Jk = tba._jac_cpk(T(c), T(X), T(uv), T(k))
    for Jt, jac in ((Jc, jba._jac_cam), (Jp, jba._jac_pt), (Jk, jba._jac_k)):
        Jj = jax.vmap(jac, in_axes=(0, 0, 0, None))(J(c), J(X), J(uv), J(k))
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0, atol=1e-12)


def _args(cams, pts, ci, pi, uv):
    w = np.ones(len(ci))
    w[5] = 0.0
    fixed = np.zeros(cams.shape[0], bool)
    fixed[:2] = True
    inc = tba.Incidence(T(ci), T(pi), cams.shape[0], pts.shape[0])
    return w, fixed, inc


def test_ba_quantities():
    cams, pts, ci, pi, uv = _scene()
    w, _, inc = _args(cams, pts, ci, pi, uv)
    qt = tba._ba_quantities(T(cams), T(pts), inc, T(uv), T(w), LAM)
    qj = jba._ba_quantities(J(cams), J(pts), J(ci), J(pi), J(uv), J(w), LAM)
    for a, b in zip(qt, qj):
        _close(a, b, 1e-10)
    k = J([0.02, -0.01])
    qt = tba._ba_quantities_joint(T(cams), T(pts), inc, T(uv), T(w), LAM, T(k))
    qj = jba._ba_quantities_joint(J(cams), J(pts), J(ci), J(pi), J(uv), J(w), LAM, k)
    for a, b in zip(qt, qj):
        _close(a, b, 1e-10)


def test_ba_step_and_joint_step():
    cams, pts, ci, pi, uv = _scene()
    w, fixed, _ = _args(cams, pts, ci, pi, uv)
    st = tba.ba_step(T(cams), T(pts), T(ci), T(pi), T(uv), T(w), LAM, T(fixed))
    sj = jba.ba_step(J(cams), J(pts), J(ci), J(pi), J(uv), J(w), LAM, J(fixed))
    for a, b in zip(st, sj):
        _close(a, b, 1e-9)
    cams, pts, ci, pi, uv = _scene(seed=2)
    w, fixed, _ = _args(cams, pts, ci, pi, uv)
    k = np.array([-0.05, 0.0])
    st = tba.ba_step_joint(T(cams), T(pts), T(ci), T(pi), T(uv), T(w), 0.1, T(fixed), T(k))
    sj = jba.ba_step_joint(J(cams), J(pts), J(ci), J(pi), J(uv), J(w), 0.1, J(fixed), J(k))
    for a, b in zip(st, sj):
        _close(a, b, 1e-9)


@pytest.mark.parametrize("loss,kw", [
    ("linear", {}),
    ("huber", {}),
    ("huber", {"huber_rescale": True}),
    ("linear", {"estimate_distortion": True}),
])
def test_bundle_adjust_vs_jax(loss, kw):
    cams, pts, ci, pi, uv = _scene()
    w, _, _ = _args(cams, pts, ci, pi, uv)
    args = (cams, pts, ci, pi, uv)
    common = dict(weights=w, fixed_cameras=(0, 1), max_iters=3, lam0=LAM, loss=loss, **kw)
    ot = tba.bundle_adjust(*args, device="cpu", **common)
    oj = jba.bundle_adjust(*args, **common)
    assert len(ot) == len(oj) and len(ot[2]) == len(oj[2])
    np.testing.assert_allclose(ot[2], oj[2], rtol=1e-8)
    for a, b in zip(ot[:2] + ot[3:], oj[:2] + oj[3:]):
        _close(a, b, 1e-8)


def test_device_loop_and_bundle_adjust_device():
    cams, pts, ci, pi, uv = _scene()
    w, fixed, inc = _args(cams, pts, ci, pi, uv)
    ot = tba.ba_device_loop(T(cams), T(pts), inc, None, T(uv), T(w), T(0.01), LAM, T(fixed),
                            iters=5)
    oj = jba.ba_device_loop(J(cams), J(pts), J(ci), J(pi), J(uv), J(w), J(0.01), J(LAM),
                            J(fixed), iters=5)
    for a, b in zip(ot, oj):
        _close(a, b, 1e-8)
    ot = tba.bundle_adjust_device(cams, pts, ci, pi, uv, fixed_cameras=(0, 1), max_iters=5,
                                  lam0=LAM, device="cpu")
    oj = jba.bundle_adjust_device(cams, pts, ci, pi, uv, fixed_cameras=(0, 1), max_iters=5,
                                  lam0=LAM)
    np.testing.assert_allclose(ot[2], oj[2], rtol=1e-8)
    for a, b in zip(ot[:2], oj[:2]):
        _close(a, b, 1e-8)
    with pytest.raises(ValueError):
        tba.bundle_adjust_device(cams, pts, ci, pi, uv, loss="cauchy", device="cpu")


def _functional_loop(cams, pts, inc, uv, w, delta, lam0, fixed, iters, robust):
    """The device loop as a chain of new tensors, each iteration's state
    rebound (no ``copy_``): the bytes the in-place body must keep."""
    k = tba._zero_k(cams)
    lam = torch.as_tensor(lam0, dtype=cams.dtype)
    cost0 = cost = tba._objective(cams, pts, k, inc, uv, w, delta, robust)
    for _ in range(iters):
        new_cams, new_pts, _, new_cost = tba._lm_iteration(
            cams, pts, k, inc, uv, w, delta, lam, fixed, 100, robust, False)
        accept = new_cost < cost
        cams = torch.where(accept, new_cams, cams)
        pts = torch.where(accept, new_pts, pts)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-12), lam * 10.0)
    return cams, pts, cost0, cost


@pytest.mark.parametrize("iters", [0, 1, 5])
@pytest.mark.parametrize("robust", [True, False])
def test_device_loop_is_its_in_place_body(robust, iters):
    """On the CPU the loop runs its in-place body eagerly: stepped by
    hand it gives the same bytes, as does the loop of rebound tensors;
    the inputs stay as they were, and no iteration counts as a graph
    replay."""
    cams, pts, ci, pi, uv = _scene()
    w, fixed, inc = _args(cams, pts, ci, pi, uv)
    cams_t, pts_t, uv_t, w_t, delta, fixed_t = (T(a) for a in (cams, pts, uv, w, 0.01, fixed))
    was = profiling.enable()
    profiling.take()
    try:
        got = tba.ba_device_loop(cams_t, pts_t, inc, None, uv_t, w_t, delta, LAM, fixed_t,
                                 iters=iters, robust=robust)
        counters = profiling.take()["counters"]
    finally:
        profiling.enable(was)
    assert counters.get("ba_graph_iters", 0) == 0
    assert torch.equal(cams_t, T(cams)) and torch.equal(pts_t, T(pts))

    k = tba._zero_k(cams_t)
    cost0 = tba._objective(cams_t, pts_t, k, inc, uv_t, w_t, delta, robust)
    state = (cams_t.clone(), pts_t.clone(), cost0.clone(), torch.tensor(LAM, dtype=torch.float64))
    for _ in range(iters):
        tba._lm_update(state, k, inc, uv_t, w_t, delta, fixed_t, 100, robust)
    by_hand = (state[0], state[1], cost0, state[2])
    rebound = _functional_loop(cams_t, pts_t, inc, uv_t, w_t, delta, LAM, fixed_t, iters, robust)
    for a, b, c in zip(got, by_hand, rebound):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_cg_zero_rhs_and_early_stop(rng):
    A = rng.standard_normal((6, 6))
    A = A @ A.T + 6.0 * np.eye(6)
    At = T(A)
    mv = lambda p: (At @ p[0],)
    # b = 0: JAX does no iteration and returns 0
    (x0,) = tba.cg(mv, (torch.zeros(6, dtype=torch.float64),), maxiter=10)
    assert torch.equal(x0, torch.zeros(6, dtype=torch.float64))
    b = rng.standard_normal(6)
    xj, _ = jax.scipy.sparse.linalg.cg(lambda v: J(A) @ v, J(b), maxiter=100)
    (xt,) = tba.cg(mv, (T(b),), maxiter=100)
    _close(xt, xj, 1e-12)
    # converged problems are frozen: more iterations change no bit
    (xt2,) = tba.cg(mv, (T(b),), maxiter=300)
    assert torch.equal(xt, xt2)
    # independent problems of a batch stop on their own
    Ab = T(np.stack([A, 2.0 * A]))
    bb = T(np.stack([b, np.zeros(6)]))
    (xb,) = tba.cg(lambda p: ((Ab * p[0][:, None, :]).sum(-1),), (bb,), maxiter=100, batch_dims=1)
    _close(xb[0], xj, 1e-12)
    assert torch.equal(xb[1], torch.zeros(6, dtype=torch.float64))


def test_segment_sums(rng):
    idx = rng.integers(0, 7, 200)
    idx[idx == 3] = 4  # an empty segment
    vals = rng.standard_normal((200, 2, 3))
    seg = tba.Segments(T(idx), 7)
    want = np.zeros((7, 2, 3))
    np.add.at(want, idx, vals)
    np.testing.assert_allclose(seg(T(vals)).numpy(), want, atol=1e-13)
    assert torch.equal(seg(T(vals)), seg(T(vals)))


@pytest.mark.parametrize("name", ["huber_weights", "huber_cost"])
def test_huber_vs_jax(rng, name):
    # residual norms on both sides of delta, and exact zeros
    norms = np.abs(rng.standard_normal(200)) * 3e-3
    norms[:5] = 0.0
    w = rng.uniform(0.2, 1.0, 200)
    delta = 2e-3
    if name == "huber_weights":
        got, ref = tba.huber_weights(T(norms), delta), jba.huber_weights(J(norms), delta)
        assert (np.asarray(ref) < 1).any() and (np.asarray(ref) == 1).any()
    else:
        got, ref = tba.huber_cost(T(norms), T(w), delta), jba.huber_cost(J(norms), J(w), delta)
    _close(got, ref, 1e-14)

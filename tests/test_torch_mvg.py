"""Port parity: geometry core, 7-point and triangulation of
``spectavi_tpu_torch.mvg`` against ``spectavi_tpu.mvg`` in float64 on
the same numpy inputs (RANSAC: ``test_torch_ransac.py``).

The closed forms are ported operation for operation, so they agree to a
few ulps, well inside the tolerances ``tests/test_mvg.py`` pins (7-point
epipolar residual < 1e-10).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectavi_tpu import mvg as jmvg
from spectavi_tpu_torch import mvg as tmvg

torch.set_num_threads(2)

jcore, jsev, jtri = (
    importlib.import_module(f"spectavi_tpu.mvg.{m}") for m in ("core", "sevenpoint", "triangulate")
)
tcore, tsev, ttri = (
    importlib.import_module(f"spectavi_tpu_torch.mvg.{m}")
    for m in ("core", "sevenpoint", "triangulate")
)

T = torch.as_tensor
J = jnp.asarray


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_core_closed_forms(rng):
    F = rng.standard_normal((64, 3, 3))
    U, s, Vt = tcore.svd3x3(T(F))
    Uj, sj, Vtj = jcore.svd3x3(J(F))
    _close(U, Uj, 1e-12)
    _close(s, sj, 1e-12)
    _close(Vt, Vtj, 1e-12)
    G = F @ np.swapaxes(F, 1, 2)
    w, V = tcore.eigh3x3_descending(T(G))
    wj, Vj = jcore.eigh3x3_descending(J(G))
    _close(w, wj, 1e-11)
    _close(V, Vj, 1e-12)
    _close(tcore.inv3x3(T(F)), jcore.inv3x3(J(F)), 1e-12)
    _close(tcore.cameras_from_svd(U, Vt), jcore.cameras_from_svd(Uj, Vtj), 1e-12)
    v = rng.standard_normal((10, 3))
    _close(tcore.skew_symmetric(T(v)), jcore.skew_symmetric(J(v)), 0)
    _close(tcore.hnormalize(T(v)), jcore.hnormalize(J(v)), 0)
    _close(tcore.homogeneous(T(v)), jcore.homogeneous(J(v)), 0)
    P0, P1 = rng.standard_normal((2, 3, 4))
    Ft = tcore.fundamental_from_cameras(T(P0), T(P1)).numpy()
    Fj = np.asarray(jcore.fundamental_from_cameras(J(P0), J(P1)))
    # F is defined up to the sign of the SVD null vector of P0
    sgn = np.sign((Ft * Fj).sum())
    np.testing.assert_allclose(sgn * Ft, Fj, atol=1e-10 * np.abs(Fj).max())


def test_essential_to_cameras_proper_rotations(rng):
    P = tcore.essential_to_cameras(T(rng.standard_normal((5, 3, 3)))).numpy()
    assert P.shape == (5, 4, 3, 4)
    R = P[..., :3]
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape), atol=1e-8)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-8)


def test_seven_point_roots_agree(rng):
    x = rng.standard_normal((40, 7, 2))
    xp = rng.standard_normal((40, 7, 2))
    Ft, vt = tsev.seven_point(T(x), T(xp), nullspace="mgs")
    Fj, vj = jsev.seven_point(J(x), J(xp), nullspace="mgs")
    vt = vt.numpy()
    np.testing.assert_array_equal(vt, np.asarray(vj))
    np.testing.assert_allclose(
        np.where(vt[..., None, None], Ft.numpy(), 0),
        np.where(vt[..., None, None], np.asarray(Fj), 0),
        atol=1e-9,
    )
    x1h = np.concatenate([xp, np.ones((40, 7, 1))], -1)
    x0h = np.concatenate([x, np.ones((40, 7, 1))], -1)
    resid = np.einsum("bni,brij,bnj->brn", x1h, Ft.numpy(), x0h)
    assert np.abs(resid[vt]).max() < 1e-10
    coeffs_t = tsev._det_cubic_coeffs(Ft[:, 0], Ft[:, 1])
    coeffs_j = jsev._det_cubic_coeffs(Fj[:, 0], Fj[:, 1])
    for a, b in zip(coeffs_t, coeffs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_seven_point_algorithm_wrapper(rng):
    for _ in range(20):
        x0 = rng.standard_normal((7, 3))
        x1 = rng.standard_normal((7, 3))
        FF = tmvg.seven_point_algorithm(x0, x1)
        FFj = jmvg.seven_point_algorithm(x0, x1)
        assert FF.shape == FFj.shape and FF.shape[0] % 3 == 0
        for i in range(FF.shape[0] // 3):
            F = FF[3 * i : 3 * (i + 1)]
            assert np.max(np.abs(np.sum((x1 @ F) * x0, axis=1))) < 1e-10
            # the same root, up to scale
            Fn = F / np.linalg.norm(F)
            assert min(
                np.abs(Fn - s * G / np.linalg.norm(G)).max()
                for G in FFj.reshape(-1, 3, 3) for s in (1, -1)
            ) < 1e-7
    with pytest.raises(TypeError):
        tmvg.seven_point_algorithm(np.zeros((6, 2)), np.zeros((6, 2)))


def _scene(rng, n=300, outliers=0.25, noise=2e-5):
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(3, 6, n)], 1)
    a = 0.2
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-1.0, 0.1, 0.2])
    Y = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:] + noise * rng.standard_normal((n, 2))
    x1 = Y[:, :2] / Y[:, 2:] + noise * rng.standard_normal((n, 2))
    bad = rng.random(n) < outliers
    x1[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return x0, x1


def test_triangulation_paths(rng):
    x0, x1 = _scene(rng, 80, outliers=0.0)
    P0 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = np.hstack([np.eye(3), np.array([[-1.0], [0.1], [0.2]])])
    Xt, et, ft = ttri.triangulate_full(T(P0), T(P1), T(x0), T(x1))
    Xj, ej, fj = jtri.triangulate_full(J(P0), J(P1), J(x0), J(x1))
    _close(Xt / Xt[:, 3:], np.asarray(Xj) / np.asarray(Xj)[:, 3:], 1e-9)
    _close(et, ej, 1e-12)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    Xt, et, ft = ttri.triangulate_fast_full(T(P0), T(P1), T(x0), T(x1))
    Xj, ej, fj = jtri.triangulate_fast_full(J(P0), J(P1), J(x0), J(x1))
    _close(Xt, Xj, 1e-9)
    _close(et, ej, 1e-12)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    h = lambda a: np.hstack([a, np.ones((a.shape[0], 1))])
    Xd = tmvg.dlt_triangulate(P0, P1, h(x0), h(x1))
    Xdj = jmvg.dlt_triangulate(P0, P1, h(x0), h(x1))
    np.testing.assert_allclose(Xd / Xd[:, 3:], Xdj / Xdj[:, 3:], atol=1e-9)
    np.testing.assert_allclose(
        tmvg.dlt_reprojection_error(P0, P1, h(x0), h(x1)),
        jmvg.dlt_reprojection_error(P0, P1, h(x0), h(x1)), atol=1e-12,
    )
    with pytest.raises(TypeError):
        tmvg.dlt_triangulate(P0[:, :3], P1, h(x0), h(x1))
    with pytest.raises(TypeError):
        tmvg.dlt_triangulate(P0, P1, x0, x1)
    with pytest.raises(TypeError):
        tmvg.dlt_triangulate(P0, P1, h(x0), h(x1)[:-1])

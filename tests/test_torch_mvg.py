"""Port parity: geometry core, 7-point and triangulation of
``spectavi_tpu_torch.mvg`` against ``spectavi_tpu.mvg`` in float64 on
the same numpy inputs (RANSAC: ``test_torch_ransac.py``).

The reference-API entry points (``seven_point_algorithm``,
``dlt_triangulate``, ``dlt_reprojection_error``,
``image_pair_rectification``, and step 4 of the pipeline) take
``device``: on ``"cpu"`` they agree with their JAX twins, and with no
``device`` and no CUDA they raise instead of running on the CPU.

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
from spectavi_tpu.pipeline.two_view import step4_triangulate as jax_step4
from spectavi_tpu_torch import mvg as tmvg
from spectavi_tpu_torch.pipeline.two_view import step4_triangulate

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
        FF = tmvg.seven_point_algorithm(x0, x1, device="cpu")
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
        tmvg.seven_point_algorithm(np.zeros((6, 2)), np.zeros((6, 2)), device="cpu")


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
    Xd = tmvg.dlt_triangulate(P0, P1, h(x0), h(x1), device="cpu")
    Xdj = jmvg.dlt_triangulate(P0, P1, h(x0), h(x1))
    np.testing.assert_allclose(Xd / Xd[:, 3:], Xdj / Xdj[:, 3:], atol=1e-9)
    np.testing.assert_allclose(
        tmvg.dlt_reprojection_error(P0, P1, h(x0), h(x1), device="cpu"),
        jmvg.dlt_reprojection_error(P0, P1, h(x0), h(x1)), atol=1e-12,
    )
    with pytest.raises(TypeError):
        tmvg.dlt_triangulate(P0[:, :3], P1, h(x0), h(x1), device="cpu")
    with pytest.raises(TypeError):
        tmvg.dlt_triangulate(P0, P1, x0, x1, device="cpu")
    with pytest.raises(TypeError):
        tmvg.dlt_triangulate(P0, P1, h(x0), h(x1)[:-1], device="cpu")


def _entry_point_case(name, rng):
    """``(port call taking device=..., JAX twin's result, compare)`` of
    one reference-API entry point on seeded inputs."""
    x0, x1 = _scene(rng, 60, outliers=0.0)
    h = lambda a: np.hstack([a, np.ones((a.shape[0], 1))])
    P0 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = np.hstack([np.eye(3), np.array([[-1.0], [0.1], [0.2]])])

    def close(atol):
        return lambda got, want: np.testing.assert_allclose(got, want, rtol=0, atol=atol)

    if name == "seven_point_algorithm":
        def roots(got, want):
            # the same real roots up to scale and sign, as in the wrapper test
            assert got.shape == want.shape
            for F in got.reshape(-1, 3, 3):
                Fn = F / np.linalg.norm(F)
                assert min(np.abs(Fn - s * G / np.linalg.norm(G)).max()
                           for G in want.reshape(-1, 3, 3) for s in (1, -1)) < 1e-7

        a, b = x0[:7], x1[:7]
        return (lambda **kw: tmvg.seven_point_algorithm(a, b, **kw),
                jmvg.seven_point_algorithm(a, b), roots)
    if name == "dlt_triangulate":
        def points(got, want):
            np.testing.assert_allclose(got / got[:, 3:], want / want[:, 3:], atol=1e-9)

        return (lambda **kw: tmvg.dlt_triangulate(P0, P1, h(x0), h(x1), **kw),
                jmvg.dlt_triangulate(P0, P1, h(x0), h(x1)), points)
    if name == "dlt_reprojection_error":
        return (lambda **kw: tmvg.dlt_reprojection_error(P0, P1, h(x0), h(x1), **kw),
                jmvg.dlt_reprojection_error(P0, P1, h(x0), h(x1)), close(1e-12))
    if name == "image_pair_rectification":
        K = np.array([[176.0, 0, 80], [0, 176.0, 60], [0, 0, 1]])
        a = 0.15
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        Q0 = K @ P0
        Q1 = K @ np.hstack([R, np.array([[-1.0], [0.05], [0.1]])])
        im0, im1 = rng.random((2, 120, 160, 3))

        def rect(got, want):
            # float64 geometry on both sides; F comes from each side's
            # own SVD, so a sample on an integer boundary may move: the
            # crops agree and at most 0.5% of the index map differs
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == w.dtype
            for g, w in zip(got[2:], want[2:]):
                assert (g != w).mean() <= 0.005

        return (lambda **kw: tmvg.image_pair_rectification(Q0, Q1, im0, im1, **kw),
                jmvg.image_pair_rectification(Q0, Q1, im0, im1), rect)
    if name == "step4_triangulate":
        n = x0.shape[0]
        ransac = {"inlier_idx": np.arange(0, n, 2), "camera": P1}
        step3 = (ransac, h(x0), h(x1), np.zeros((n, 4)), np.zeros((n, 4)))
        return (lambda **kw: step4_triangulate(step3, quiet=True, **kw)[0],
                jax_step4(step3, quiet=True)[0], close(1e-9))
    raise AssertionError(name)


ENTRY_POINTS = ["seven_point_algorithm", "dlt_triangulate", "dlt_reprojection_error",
                "image_pair_rectification", "step4_triangulate"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_on_cpu_matches_jax(rng, name):
    call, want, compare = _entry_point_case(name, rng)
    compare(call(device="cpu"), want)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(rng, name, monkeypatch):
    # with no CUDA device the default must raise, never run on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, _, _ = _entry_point_case(name, rng)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()

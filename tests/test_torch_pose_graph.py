"""Port parity: ``spectavi_tpu_torch.sfm`` pose graph, ATE and checkpoint
against ``spectavi_tpu.sfm`` on the same numpy inputs.

Track building and observation flattening are host code and identical,
track order included.  The N-view triangulation returns the null vector
of the DLT system, whose sign is arbitrary on both sides, so points are
compared after division by the last coordinate (1e-9); a system of more
than 32 rows takes the port's block reduction.  Pose chaining agrees to
1e-9, the ATE helpers to 1e-12, and a checkpoint written by either
package loads in the other.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

jpg = importlib.import_module("spectavi_tpu.sfm.pose_graph")
tpg = importlib.import_module("spectavi_tpu_torch.sfm.pose_graph")
jate = importlib.import_module("spectavi_tpu.sfm.ate")
tate = importlib.import_module("spectavi_tpu_torch.sfm.ate")
jck = importlib.import_module("spectavi_tpu.sfm.checkpoint")
tck = importlib.import_module("spectavi_tpu_torch.sfm.checkpoint")
jba = importlib.import_module("spectavi_tpu.sfm.bundle_adjust")

T = lambda a: torch.as_tensor(np.array(a))


def _ring(rng, V=4, M=120, noise=0.0):
    """V cameras on an arc around M points; per-view calibrated keypoints
    (every point in every view) and the relative-pose edges of
    consecutive views."""
    cams = []
    for i in range(V):
        ang = 0.3 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        C = np.array([4.0 * np.sin(ang), 0.2 * i, -10.0 + 0.4 * i])
        cams.append(np.concatenate([jba.rotation_to_rvec(R), -R @ C]))
    cams = np.asarray(cams)
    pts = rng.standard_normal((M, 3))
    Rs = [np.asarray(jba.rodrigues(jnp.asarray(c[:3]))) for c in cams]
    kps = [(pts @ R.T + c[3:])[:, :2] / (pts @ R.T + c[3:])[:, 2:] for R, c in zip(Rs, cams)]
    kps = [k + noise * rng.standard_normal(k.shape) for k in kps]
    edges = {}
    for i in range(V - 1):
        Rr = Rs[i + 1] @ Rs[i].T
        tr = cams[i + 1, 3:] - Rr @ cams[i, 3:]
        idx = np.sort(rng.choice(M, 3 * M // 4, replace=False))
        edges[(i, i + 1)] = {"R": Rr, "t": tr / np.linalg.norm(tr), "idx_i": idx, "idx_j": idx}
    return cams, pts, kps, edges


def test_build_tracks_and_observations_identical(rng):
    pm = {}
    for i, j in ((0, 1), (1, 2), (0, 2), (2, 3)):
        a = rng.choice(200, 120, replace=False)
        pm[(i, j)] = (a, rng.permutation(a))  # cycles make conflicts
    tj = jpg.build_tracks(pm, 4)
    tt = tpg.build_tracks(pm, 4)
    assert tj.shape[0] > 50 and tt.dtype == tj.dtype
    np.testing.assert_array_equal(tt, tj)
    kps = [rng.standard_normal((200, 2)) for _ in range(4)]
    for a, b in zip(tpg.tracks_to_observations(tt, kps), jpg.tracks_to_observations(tj, kps)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tpg.build_tracks({}, 3).shape == (0, 3)


def _euclid(X):
    X = np.asarray(X)
    return X[:, :3] / X[:, 3:]


def test_triangulate_nview(rng):
    for V in (4, 20):
        cams, pts, kps, _ = _ring(rng, V=V, M=50, noise=1e-4)
        P = np.stack([jpg.pose_matrix(c[:3], c[3:]) for c in cams])
        np.testing.assert_allclose(tpg.pose_matrix(cams[1, :3], cams[1, 3:]), P[1], atol=1e-12)
        uv = np.stack(kps, axis=1)  # (T, V, 2)
        mask = rng.random((50, V)) < 0.7
        mask[:, :2] = True
        Xt = tpg.triangulate_nview(T(P), T(uv), T(mask))
        Xj = jpg.triangulate_nview(jnp.asarray(P), jnp.asarray(uv), jnp.asarray(mask))
        np.testing.assert_allclose(_euclid(Xt.numpy()), _euclid(Xj), atol=1e-9)
        np.testing.assert_allclose(_euclid(Xt.numpy()), pts, atol=1e-2)


def test_chain_poses(rng):
    _, _, kps, edges = _ring(rng, V=5, noise=1e-4)
    cj = jpg.chain_poses(edges, 5, kps)
    ct = tpg.chain_poses(edges, 5, kps, device="cpu")
    np.testing.assert_allclose(ct, cj, atol=1e-9)


def test_ate_helpers(rng):
    cams, pts, _, _ = _ring(rng, V=6)
    np.testing.assert_allclose(tate.camera_centers(cams), jate.camera_centers(cams), atol=1e-12)
    dst = 2.0 * pts @ np.asarray(jba.rodrigues(jnp.asarray([0.1, -0.2, 0.3]))).T + 1.0
    dst = dst + 1e-3 * rng.standard_normal(dst.shape)
    for a, b in zip(tate.umeyama(pts, dst), jate.umeyama(pts, dst)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    assert abs(tate.ate_rmse(pts, dst) - jate.ate_rmse(pts, dst)) < 1e-12
    np.testing.assert_allclose(tate.nn_distances(pts, dst), jate.nn_distances(pts, dst))


def test_checkpoint_round_trips_between_packages(tmp_path, rng):
    cams, pts = rng.standard_normal((4, 6)), rng.standard_normal((30, 3))
    tracks = rng.integers(-1, 50, (30, 4)).astype(np.int32)
    for save, load in ((jck.save_sfm_state, tck.load_sfm_state),
                       (tck.save_sfm_state, jck.load_sfm_state)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, cams, pts, tracks, extra={"lam": 1e-3})
        c, p, t, extra = load(path)
        np.testing.assert_array_equal(c, cams)
        np.testing.assert_array_equal(p, pts)
        np.testing.assert_array_equal(t, tracks)
        assert float(extra["lam"]) == 1e-3
    assert tck.load_sfm_state(str(tmp_path / "missing.npz")) is None


@pytest.mark.parametrize("name", ["compose_relative", "align_clouds_icp"])
def test_pose_helpers_vs_jax(rng, name):
    if name == "compose_relative":
        Ri, Rij = (np.asarray(jba.rodrigues(jnp.asarray(v))) for v in rng.standard_normal((2, 3)))
        ti, tij = rng.standard_normal((2, 3))
        for a, b in zip(tpg.compose_relative((Ri, ti), (Rij, tij)),
                        jpg.compose_relative((Ri, ti), (Rij, tij))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
        return
    # a cloud and a rotated, scaled, shifted and noisy copy in another
    # order, with a tenth of the points replaced by outliers
    _, pts, _, _ = _ring(rng, V=4)
    dst = 1.3 * pts @ np.asarray(jba.rodrigues(jnp.asarray([0.02, -0.03, 0.01]))).T + 0.05
    dst = dst[rng.permutation(len(dst))] + 1e-3 * rng.standard_normal(dst.shape)
    dst[: len(dst) // 10] += rng.uniform(-2, 2, (len(dst) // 10, 3))
    got, rmse = tate.align_clouds_icp(pts, dst)
    ref, rmse_j = jate.align_clouds_icp(pts, dst)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-9)
    assert abs(rmse - rmse_j) <= 1e-9

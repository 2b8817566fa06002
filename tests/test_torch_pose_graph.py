"""Port parity: ``spectavi_tpu_torch.sfm`` pose graph, ATE and checkpoint
against ``spectavi_tpu.sfm`` on the same numpy inputs.

Track building and observation flattening are host code and identical,
track order included, on cases that stress the union-find's order (cycles
with conflicts, one keypoint matched twice into a view, a view paired
with itself, empty pairs, unpaired views, unsorted pairs, both integer
widths) and on ~600k matches of 11 views; the port counts the matches
as ``track_edges`` while tracing.  The N-view triangulation returns the null vector
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
profiling = importlib.import_module("spectavi_tpu_torch.utils.profiling")

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


def _swapped(rng, n, m, n_swaps):
    """``m`` distinct keypoints of ``n`` matched to themselves, but for
    ``n_swaps`` swapped pairs: cycles through them make conflicts."""
    a = rng.choice(n, m, replace=False)
    b = a.copy()
    for s in rng.choice(m, (n_swaps, 2), replace=False):
        b[s] = b[s[::-1]]
    return a, b


def _fountain(rng, V=11, K=30000, M=60000):
    """Exhaustive pairs, in shuffled order, of ``V`` views of ``M`` scene
    points, each seen by a view with probability 0.45 under a keypoint
    of its own: 90% of a pair's co-visible points matched, 1% of those
    to a random keypoint (~600k matches)."""
    vis = rng.random((M, V)) < 0.45
    kp = np.zeros((M, V), np.int64)
    for v in range(V):
        kp[vis[:, v], v] = rng.permutation(K)[: vis[:, v].sum()]
    pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    rng.shuffle(pairs)
    pm = {}
    for i, j in pairs:
        both = np.flatnonzero(vis[:, i] & vis[:, j] & (rng.random(M) < 0.9))
        a, b = kp[both, i], kp[both, j].copy()
        wrong = rng.random(len(b)) < 0.01
        b[wrong] = rng.integers(0, K, wrong.sum())
        pm[(i, j)] = (a, b)
    return pm, V


def _track_case(name, rng):
    """``(pair_matches, n_views)`` of one parity case."""
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    if name == "cycles_with_conflicts":
        return {(i, j): _swapped(rng, 80, 60, 3) for i in range(5) for j in range(i + 1, 5)}, 5
    if name == "one_to_two_of_a_view":
        return {(0, 1): (np.array([5, 5, 1, 2, 9]), np.array([3, 7, 1, 2, 4])),
                (1, 2): (np.array([3, 1, 2, 7]), np.array([0, 1, 2, 6])),
                (0, 2): (np.array([9, 1]), np.array([8, 1]))}, 3
    if name == "pair_of_a_view_with_itself":
        return {(0, 1): (np.arange(10), np.arange(10)),
                (1, 1): (np.array([1, 2, 4, 6, 12]), np.array([1, 3, 4, 6, 12])),
                (1, 2): (np.array([4, 6, 8]), np.array([0, 6, 2]))}, 3
    if name == "empty_pair_among_others":
        return {(0, 1): _swapped(rng, 50, 30, 1), (1, 2): empty,
                (0, 2): _swapped(rng, 50, 30, 1), (2, 3): _swapped(rng, 50, 30, 0)}, 4
    if name == "every_pair_empty":
        return {(0, 1): empty, (1, 2): empty}, 3
    if name == "no_pairs":
        return {}, 3
    if name == "views_in_no_pair":
        return {(1, 3): _swapped(rng, 40, 25, 2), (3, 6): _swapped(rng, 40, 25, 1),
                (1, 6): _swapped(rng, 40, 25, 0)}, 8
    if name == "keys_not_sorted":
        keys = [(2, 3), (0, 1), (1, 3), (0, 2), (1, 2), (0, 3)]
        return {k: _swapped(rng, 70, 50, 2) for k in keys}, 4
    return _fountain(rng)


_TRACK_CASES = ("cycles_with_conflicts", "one_to_two_of_a_view", "pair_of_a_view_with_itself",
                "empty_pair_among_others", "every_pair_empty", "no_pairs", "views_in_no_pair",
                "keys_not_sorted")


@pytest.mark.parametrize("name,dtype", [(n, d) for n in _TRACK_CASES for d in (np.int32, np.int64)]
                         + [("fountain_sized", np.int64)])
def test_build_tracks_matches_the_union_find(rng, name, dtype):
    pm, V = _track_case(name, rng)
    pm = {k: (a.astype(dtype), b.astype(dtype)) for k, (a, b) in pm.items()}
    if name == "fountain_sized":
        assert sum(len(a) for a, _ in pm.values()) >= 500_000
    tj = jpg.build_tracks(pm, V)
    tt = tpg.build_tracks(pm, V)
    assert tt.dtype == tj.dtype == np.int32
    np.testing.assert_array_equal(tt, tj)
    assert tt.shape == tj.shape


def test_build_tracks_counts_its_matches(rng):
    pm = {(0, 1): _swapped(rng, 50, 30, 2), (1, 2): _swapped(rng, 50, 20, 0),
          (0, 2): (np.zeros(0, np.int32), np.zeros(0, np.int32))}
    profiling.take()
    was = profiling.enable()
    try:
        with profiling.annotate("tracks"):
            tpg.build_tracks(pm, 3)
        rec = profiling.take()
    finally:
        profiling.enable(was)
        profiling.take()
    assert rec["counters"] == {"track_edges": 50}
    assert [(s["name"], s["counts"]) for s in rec["spans"]] == [("tracks", {"track_edges": 50})]

    was = profiling.disable()
    try:
        profiling.take()
        tpg.build_tracks(pm, 3)
        assert profiling.take() == {"spans": [], "counters": {}}
    finally:
        profiling.enable(was)


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

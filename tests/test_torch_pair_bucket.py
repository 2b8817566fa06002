"""The pair step's sized compaction bucket, on the CPU.

* ``bucket_rows``: the largest survivor count rounded up to 256 rows,
  never below ``min(floor, Y)``, never above ``Y``.
* A masked batch whose survivors exceed a small floor: the sized step
  (``sized=True``, the floor as ``compact_to``) equals the fixed step
  built with the bucket's size, drawing the same sample tables, and
  survivors beyond the floor are among its inliers.
* Where no pair has more survivors than the floor, the sized step's
  outputs are the fixed step's to the byte.
* ``_match_pairs_batched`` on four small rendered views with a small
  floor against the benchmark's plain reference
  (``sfmbench.reference.ransac.pair_step``) given the same bucket: the
  same survivors, and the same inliers under the program's camera.
* The counters ``pair_survivors`` and ``ba_observations`` are recorded
  while tracing is on and absent while it is off; the bucket is decided
  in the pair step alone, so no count of survivors cut from it is kept.
"""

import numpy as np
import pytest
import torch

from spectavi_tpu_torch.parallel.two_view import bucket_rows, make_two_view_step
from spectavi_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPROJ, SVR, MIN_RATIO = 3.35e-4, 1e-3, 1.75


def _geometry(rng, n, outliers=0.2):
    """Calibrated correspondences of a two-view scene, a share of them
    replaced by outliers."""
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(3, 6, n)], 1)
    a = 0.2
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    Y = X @ R.T + np.array([-1.0, 0.1, 0.2])
    x0, x1 = X[:, :2] / X[:, 2:], Y[:, :2] / Y[:, 2:]
    bad = rng.random(n) < outliers
    x1[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return x0, x1


def _batch(seed, ns, rows=512, D=128):
    """A masked batch: pair ``b`` has ``ns[b]`` database rows (random
    bytes) and as many queries, noisy copies of them in a shuffled
    order, every one but row 0's a ratio-test survivor (row 0 ties with
    its padding); the database padded by replicating row 0, the queries
    with zeros."""
    rng = np.random.default_rng(seed)
    B = len(ns)
    d0 = np.zeros((B, rows, D), np.uint8)
    d1 = np.zeros((B, rows, D), np.uint8)
    p0 = np.zeros((B, rows, 2), np.float32)
    p1 = np.zeros((B, rows, 2), np.float32)
    for b, n in enumerate(ns):
        x0, x1 = _geometry(rng, n)
        db = rng.integers(0, 256, (n, D))
        perm = rng.permutation(n)
        d0[b, :n], d0[b, n:] = db, db[0]
        d1[b, :n] = np.clip(db[perm] + rng.integers(-3, 4, (n, D)), 0, 255)
        p0[b, :n], p1[b, :n] = x0, x1[perm]
    t = torch.as_tensor
    return (t(d0), t(d1), t(p0), t(p1)), np.asarray(ns), np.asarray(ns)


def _run(step, inputs, nx, ny, seed=5):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return [o.numpy() for o in step(*inputs, gen, nx, ny)]


def _step(**kw):
    return make_two_view_step(trials=128, reproj_allowed=1e-3, svr_allowed=3e-2,
                              min_ratio=MIN_RATIO, masked=True, **kw)


@pytest.mark.parametrize("survivors,floor,rows,expect", [
    (0, 4096, 4352, 4096),
    (4096, 4096, 4352, 4096),
    (4097, 4096, 4352, 4352),
    (9000, 4096, 31232, 9216),
    (150, 64, 512, 256),
    (480, 128, 512, 512),
    (200, 300, 512, 300),
    (100, 4096, 512, 512),
])
def test_bucket_rows(survivors, floor, rows, expect):
    assert bucket_rows(survivors, floor, rows) == expect


def test_sized_bucket_is_the_fixed_step_of_its_size():
    inputs, nx, ny = _batch(0, [480, 400])
    floor = 128
    C = bucket_rows(480, floor, 512)
    assert C == 512
    sized = _run(_step(compact_to=floor, sized=True), inputs, nx, ny)
    fixed = _run(_step(compact_to=C), inputs, nx, ny)
    for a, b in zip(sized, fixed):
        np.testing.assert_array_equal(a, b)
    ratio_ok, inl = sized[5], sized[3]
    # the query of database row 0 ties with its replicated padding
    assert (ratio_ok.sum(1) == [479, 399]).all()
    # survivors beyond the floor competed and won: more inliers than
    # the floor's bucket could hold
    assert (inl.sum(1) > floor).all()
    assert (inl <= ratio_ok).all()
    capped = _run(_step(compact_to=floor), inputs, nx, ny)
    assert (capped[3].sum(1) <= floor).all()


@pytest.mark.parametrize("floor", [256, 300, 4096])
def test_sized_bucket_under_the_floor_is_todays_step(floor):
    inputs, nx, ny = _batch(1, [200, 150])
    sized = _run(_step(compact_to=floor, sized=True), inputs, nx, ny)
    fixed = _run(_step(compact_to=floor), inputs, nx, ny)
    assert (sized[5].sum(1) <= floor).all()
    for a, b in zip(sized, fixed):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def views():
    """Four rendered 120x160 views: the port's SIFT metas, quantized
    descriptor tables, calibrated keypoints, and the exhaustive pairs."""
    from sfmbench import scene
    from spectavi_tpu_torch.features.normalize import normalize_to_ubyte_device
    from spectavi_tpu_torch.features.sift import sift_filter_batch_device

    torch.set_num_threads(2)
    s = scene.render_scene(4, 120, 160, "cpu", (25, 35), seed=0)
    outs = sift_filter_batch_device(s["grays"], device="cpu")
    metas = [o["meta"] for o in outs]
    descs = [normalize_to_ubyte_device(o["desc"].to(torch.float32)) for o in outs]
    iK = np.linalg.inv(s["K"])
    pts = []
    for m in metas:
        h = np.hstack([m[:, :2], np.ones((m.shape[0], 1))]) @ iK.T
        pts.append(h[:, :2] / h[:, 2:3])
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    return {"metas": metas, "descs": descs, "pts": pts, "pairs": pairs, "K": s["K"]}


def _batched(views, floor, seed=7):
    from spectavi_tpu_torch.pipeline.sfm import _match_pairs_batched

    gen = torch.Generator()
    gen.manual_seed(seed)
    ropts = {"reprojection_error_allowed": REPROJ, "singular_value_ratio_allowed": SVR}
    return _match_pairs_batched(views["descs"], views["pts"], views["pairs"], gen, ropts,
                                MIN_RATIO, compact_to=floor, device="cpu")


def test_match_pairs_batched_against_the_reference(views):
    from sfmbench.reference import judge
    from sfmbench.reference.ransac import pair_step

    floor = 64
    prog = {tuple(r["pair"]): r for r in _batched(views, floor)}
    args = (views["descs"], views["pts"], views["pairs"])
    survivors = pair_step(*args, None, REPROJ, SVR, MIN_RATIO, compact_to=1 << 30, fit=False)
    Y = -(-max(d.shape[0] for d in views["descs"][1:]) // 256) * 256
    C = bucket_rows(max(r["n_matches"] for r in survivors.values()), floor, Y)
    assert max(r["n_matches"] for r in survivors.values()) > floor and C > floor
    in_bucket = pair_step(*args, None, REPROJ, SVR, MIN_RATIO, compact_to=C, fit=False)
    for p, ref in survivors.items():
        np.testing.assert_array_equal(in_bucket[p]["idx_j"], ref["idx_j"])
    metas, K = views["metas"], views["K"]
    for p, ref in survivors.items():
        got = prog[p]
        assert got["n_matches"] == ref["n_matches"]
        # every survivor competed: the consensus is over all of them
        assert got["inlier_percent"] == len(got["idx_j"]) / got["n_matches"]
        i, j = p
        keep = judge.inlier_mask(metas[i][ref["idx_i"]], metas[j][ref["idx_j"]], K,
                                 got["camera"], REPROJ, "cpu")
        np.testing.assert_array_equal(got["idx_j"], ref["idx_j"][keep])
        np.testing.assert_array_equal(got["idx_i"], ref["idx_i"][keep])


def _ba_problem(rng, n_cams=3, n_pts=20):
    cams = np.zeros((n_cams, 6))
    cams[:, 3] = np.arange(n_cams) * -0.3
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 6, n_pts)], 1)
    ci = np.repeat(np.arange(n_cams), n_pts)
    pi = np.tile(np.arange(n_pts), n_cams)
    Xc = pts[pi] + cams[ci, 3:]
    uv = Xc[:, :2] / Xc[:, 2:] + 1e-4 * rng.standard_normal((len(ci), 2))
    return cams, pts + 1e-3 * rng.standard_normal(pts.shape), ci, pi, uv


def _counted(views):
    from spectavi_tpu_torch.sfm.bundle_adjust import bundle_adjust_device

    batch = _batched(views, 64)
    cams, pts, ci, pi, uv = _ba_problem(np.random.default_rng(3))
    bundle_adjust_device(cams, pts, ci, pi, uv, max_iters=2, device="cpu")
    return batch, len(ci)


def test_counters_recorded_only_while_tracing(views):
    profiling.take()
    was = profiling.enable()
    try:
        batch, n_obs = _counted(views)
        rec = profiling.take()
    finally:
        profiling.enable(was)
        profiling.take()
    counters = rec["counters"]
    assert counters["pair_survivors"] == sum(r["n_matches"] for r in batch)
    assert "pair_survivors_cut" not in counters
    assert counters["ba_observations"] == n_obs
    spans = {s["name"]: s["counts"] for s in rec["spans"]}
    assert "pair_survivors_cut" not in spans["pairs.unpack"]
    assert spans["ba.setup"]["ba_observations"] == n_obs

    was = profiling.disable()
    try:
        profiling.take()
        _counted(views)
        assert profiling.take() == {"spans": [], "counters": {}}
    finally:
        profiling.enable(was)

"""Port parity for the multi-view slice: the essential RANSAC core, the
batched two-view step and ``run_sfm`` of ``spectavi_tpu_torch`` against
``spectavi_tpu`` on the CPU.

* ``ransac_essential_core`` handed the JAX package's ``(trials, 7)``
  table: the same count and inlier mask, E and camera to 1e-9; a batch
  of two problems gives each problem's own answer.
* The pair step (``make_two_view_step``) against JAX's ``masked=True``
  step on a 1x1 CPU mesh, handed JAX's per-pair tables (drawn over JAX's own
  compacted survivors): identical nearest rows, ratio masks and inlier
  masks, cameras to 1e-9, with padded rows and a compaction cap that
  engages.  The unmasked step (JAX's default, ``masked=False``, called
  in JAX's argument order) against JAX's on the same mesh: counts and
  inlier masks identical, E to 1e-9, and the same bytes as the masked
  step at full row counts.
* ``run_sfm`` on the 3 rendered views of ``tests/test_sfm_pipeline.py``
  with the port's ``loop`` and ``batched`` backends against JAX's loop
  run: each side draws its own RANSAC samples, so keypoints agree within
  1%, matches within 2% a pair, tracks within 3%; both ATEs are under
  10% of the span and the port's cameras within 1% of the span of
  JAX's after alignment.  At 0.5 px noise on 160-pixel views only a few
  of a batch's 24576 seven-point roots pass the default singular-value
  gate of 1e-3, so the batch can miss a pair for some draws and the
  pair is then retried on the loop path (``batched_retry``, as in JAX).
  The batched case runs with the gate at 1e-2, where every pair is
  resolved by the batch itself, and asserts that no pair was retried.
* A checkpoint that JAX's ``run_sfm`` wrote is resumed by the port's.
  Resuming needs the same track table, and each side draws its own
  RANSAC samples, so this runs on views 1-2 at a threshold where both
  sides keep every match.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mvg import _scene

torch.set_num_threads(2)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmarks"))

jran = importlib.import_module("spectavi_tpu.mvg.ransac")
tran = importlib.import_module("spectavi_tpu_torch.mvg.ransac")

T = lambda a: torch.as_tensor(np.array(a))
J = jnp.asarray


def _same_winner(out, ref, tol=1e-9):
    assert int(out["count"]) == int(ref["count"]) > 0
    np.testing.assert_array_equal(out["inlier_mask"].numpy(), np.asarray(ref["inlier_mask"]))
    np.testing.assert_allclose(out["essential"].numpy(), np.asarray(ref["essential"]), atol=tol)
    np.testing.assert_allclose(out["camera"].numpy(), np.asarray(ref["camera"]), atol=tol)


def test_ransac_essential_core_given_jax_table(rng):
    trials, reproj, svr = 512, 3.35e-4, 1e-3
    outs, refs, args = [], [], []
    for seed in (1, 2):
        x0, x1 = _scene(rng, n=250)
        x0 = np.pad(x0, ((0, 6), (0, 0)))
        x1 = np.pad(x1, ((0, 6), (0, 0)))
        pm = np.arange(256) < 250
        key = jax.random.PRNGKey(seed)
        table = np.asarray(jran._sample_subsets(key, 256, trials, J(pm)))
        refs.append(jran.ransac_essential_batch(key, J(x0), J(x1), trials, reproj, svr,
                                                point_mask=J(pm)))
        outs.append(tran.ransac_essential_core(None, T(x0), T(x1), trials, reproj, svr,
                                               point_mask=T(pm), sample=T(table)))
        args.append((table, x0, x1, pm))
        _same_winner(outs[-1], refs[-1])
    # the two problems as one batch
    table, x0, x1, pm = (T(np.stack(a)) for a in zip(*args))
    both = tran.ransac_essential_core(None, x0, x1, trials, reproj, svr, point_mask=pm,
                                      sample=table)
    for b, ref in enumerate(refs):
        _same_winner({k: v[b] for k, v in both.items()}, ref)


def _pair_inputs(rng, B=2, n=200, ny=190, X=256, Y=256, D=32):
    """Per pair: ``n`` database rows (random bytes) with their
    correspondences' coordinates, ``ny`` queries that are noisy copies of
    permuted database rows, the database padded by replicating row 0
    and the queries with zeros."""
    d0 = np.zeros((B, X, D), np.uint8)
    d1 = np.zeros((B, Y, D), np.uint8)
    p0 = np.zeros((B, X, 2))
    p1 = np.zeros((B, Y, 2))
    for b in range(B):
        x0, x1 = _scene(rng, n=n, outliers=0.2)
        db = rng.integers(0, 256, (n, D))
        perm = rng.permutation(n)[:ny]
        q = np.clip(db[perm] + rng.integers(-6, 7, (ny, D)), 0, 255)
        q[:10] = db[perm[:10]]  # exact copies
        d0[b, :n] = db
        d0[b, n:] = db[0]
        d1[b, :ny] = q
        p0[b, :n] = x0
        p1[b, :ny] = x1[perm]
    return d0, d1, p0, p1, np.full(B, n), np.full(B, ny)


def jax_step_tables(d0, d1, keys, trials, C, min_ratio, nx=None, ny=None):
    """JAX's per-pair sample tables, drawn over its own compacted
    survivors: the ratio test (with the row counts ``nx, ny`` when the
    step is masked), the survivor compaction, then its sampler."""
    from spectavi_tpu.ops.l2nn import l2_topk_mxu

    Y = d1.shape[1]
    tables = []
    for b in range(d0.shape[0]):
        idx, dist = l2_topk_mxu(J(d0[b]), J(d1[b]), k=2)
        dd1 = jnp.maximum(dist[:, 0].astype(jnp.float64), 1e-12)
        dd2 = dist[:, 1].astype(jnp.float64)
        ok = dd2 >= min_ratio**2 * dd1
        if nx is not None:
            ok = ok & (idx[:, 0] < nx[b]) & (jnp.arange(Y) < ny[b])
        _, topq = jax.lax.top_k(jnp.where(ok, dd2 / dd1, -1.0), C)
        tables.append(np.asarray(jran._sample_subsets(keys[b], C, trials, ok[topq])))
    return np.stack(tables)


def _assert_step_equal(out, ref):
    """The first four outputs of two steps: counts and inlier masks
    identical, E and the camera to 1e-9."""
    E, P1, count, inl = (np.asarray(o) for o in out[:4])
    np.testing.assert_array_equal(count, np.asarray(ref[2]))
    assert (count > 0).all()
    np.testing.assert_array_equal(inl, np.asarray(ref[3]))
    np.testing.assert_allclose(E, np.asarray(ref[0]), atol=1e-9)
    np.testing.assert_allclose(P1, np.asarray(ref[1]), atol=1e-9)


def test_two_view_step_vs_jax(rng):
    from spectavi_tpu.parallel.mesh import make_mesh
    from spectavi_tpu.parallel.two_view import make_two_view_step as jax_step
    from spectavi_tpu_torch.parallel.two_view import make_two_view_step

    trials, C = 256, 128
    d0, d1, p0, p1, nx, ny = _pair_inputs(rng)
    kw = dict(trials=trials, reproj_allowed=3.35e-3, svr_allowed=1e-3, min_ratio=1.2,
              masked=True, compact_to=C)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    mesh = make_mesh(n_pairs=1, n_blocks=1, devices=jax.devices()[:1])
    ref = jax_step(mesh, **kw)(J(d0), J(d1), J(p0), J(p1), keys, J(nx), J(ny))
    tables = jax_step_tables(d0, d1, keys, trials, C, 1.2, nx, ny)
    out = make_two_view_step(None, **kw)(T(d0), T(d1), T(p0), T(p1), None, nx, ny,
                                         sample=tables)
    midx0, ratio_ok = (o.numpy() for o in out[4:])
    np.testing.assert_array_equal(midx0, np.asarray(ref[4]))
    np.testing.assert_array_equal(ratio_ok, np.asarray(ref[5]))
    assert (ratio_ok.sum(1) > C).all()  # the compaction cap engaged
    _assert_step_equal(out, ref)
    # the step's own draws: the same matching, a valid winner per pair
    own = [o.numpy() for o in make_two_view_step(**kw)(T(d0), T(d1), T(p0), T(p1),
                                                       nx=nx, ny=ny)]
    np.testing.assert_array_equal(own[4], midx0)
    np.testing.assert_array_equal(own[5], ratio_ok)
    assert (own[2] > 0).all() and (own[3] <= ratio_ok).all()


def test_unmasked_two_view_step_vs_jax(rng):
    # JAX's default form: make_two_view_step(mesh, trials, ...) with
    # masked=False, the keys as the fifth input and four outputs
    from spectavi_tpu.parallel.mesh import make_mesh
    from spectavi_tpu.parallel.two_view import make_two_view_step as jax_step
    from spectavi_tpu_torch.parallel.two_view import make_two_view_step

    trials, C = 256, 128
    d0, d1, p0, p1, nx, ny = _pair_inputs(rng, n=256, ny=256)  # no padded row
    args = (trials, 3.35e-3, 1e-3, 1.2, False, C)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    mesh = make_mesh(n_pairs=1, n_blocks=1, devices=jax.devices()[:1])
    ref = jax_step(mesh, *args)(J(d0), J(d1), J(p0), J(p1), keys)
    tables = jax_step_tables(d0, d1, keys, trials, C, 1.2)
    step = make_two_view_step(None, *args)
    out = step(T(d0), T(d1), T(p0), T(p1), sample=tables)
    assert len(out) == len(ref) == 4
    _assert_step_equal(out, ref)
    # the masked step at full row counts gives the same bytes
    full = make_two_view_step(None, *args[:4], True, C)(T(d0), T(d1), T(p0), T(p1), None,
                                                        nx, ny, sample=tables)
    for a, b in zip(out, full[:4]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    with pytest.raises(ValueError, match="no row counts"):
        step(T(d0), T(d1), T(p0), T(p1), None, nx, ny)
    with pytest.raises(ValueError, match="takes the row counts"):
        make_two_view_step(None, *args[:4], True, C)(T(d0), T(d1), T(p0), T(p1))


RANSAC = {"reprojection_error_allowed": 3e-3}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The 3-view scene, and JAX's loop run on it with a checkpoint."""
    from test_sfm_pipeline import _tiny_dataset

    from spectavi_tpu.pipeline.sfm import run_sfm

    tmp = tmp_path_factory.mktemp("sfm")
    paths, kfile, gt_C = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF))
    ckpt = str(tmp / "jax_state.npz")
    ref = run_sfm(paths, kfile, key=jax.random.PRNGKey(0), quiet=True, checkpoint=ckpt,
                  ransac_options=RANSAC)
    return paths, kfile, gt_C, ckpt, ref


@pytest.mark.parametrize("backend", ["loop", "batched"])
def test_run_sfm_vs_jax(tiny, backend, tmp_path):
    from spectavi_tpu_torch.pipeline.sfm import run_sfm
    from spectavi_tpu_torch.sfm import ate_rmse, camera_centers

    paths, kfile, gt_C, _, ref = tiny
    # the batch's singular-value gate loosened so that it resolves every
    # pair itself (module docstring)
    opts = RANSAC if backend == "loop" else dict(RANSAC, singular_value_ratio_allowed=1e-2)
    res = run_sfm(paths, kfile, quiet=True, ransac_options=opts, pair_backend=backend,
                  outdir=str(tmp_path / "out"), device="cpu")
    m, mj = res["metrics"], ref["metrics"]
    assert m["pair_backend"] == backend and m["init_used"] == "pnp"
    assert not any(p.get("batched_retry") for p in m["pairs"])
    assert set(mj) <= set(m)
    for a, b in zip(m["keypoints_per_view"], mj["keypoints_per_view"]):
        assert abs(a - b) <= 0.01 * b
    for p, pj in zip(m["pairs"], mj["pairs"]):
        assert p["pair"] == list(pj["pair"]) and abs(p["matches"] - pj["matches"]) <= 0.02 * pj["matches"]
        assert p["success"]
    assert abs(m["n_tracks"] - mj["n_tracks"]) <= 0.03 * mj["n_tracks"]
    assert m["ba_cost_final"] <= m["ba_cost_initial"]
    assert m["ba_accepted_iters"] == len(res["ba_history"]) - 1
    assert res["keypoints"][0].shape[1] == ref["keypoints"][0].shape[1] == 132
    span = np.ptp(gt_C, axis=0).max()
    est, est_j = camera_centers(res["cams"]), camera_centers(ref["cams"])
    assert ate_rmse(est, gt_C) < 0.10 * span and ate_rmse(est_j, gt_C) < 0.10 * span
    assert ate_rmse(est, est_j) < 0.01 * span
    for name in ("sparse_cloud.ply", "poses.txt", "metrics.json"):
        assert os.path.exists(tmp_path / "out" / name)


def test_port_resumes_a_jax_checkpoint(tiny, capsys, tmp_path):
    from spectavi_tpu.pipeline.sfm import run_sfm as jax_run_sfm
    from spectavi_tpu_torch.pipeline.sfm import run_sfm
    from spectavi_tpu_torch.sfm import load_sfm_state

    paths, kfile = tiny[0][1:], tiny[1]
    ckpt = str(tmp_path / "jax_state.npz")
    opts = {"reprojection_error_allowed": 1e-2}
    ref = jax_run_sfm(paths, kfile, key=jax.random.PRNGKey(0), quiet=True, checkpoint=ckpt,
                      ransac_options=opts)
    assert ref["metrics"]["pairs"][0]["inlier_percent"] == 1.0
    tracks = load_sfm_state(ckpt)[2]
    res = run_sfm(paths, kfile, ransac_options=opts, checkpoint=ckpt, device="cpu")
    assert "resuming BA from checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(res["tracks"], tracks)
    # the port's BA started from JAX's solution, not from its own graph
    assert res["ba_history"][0] < 0.5 * ref["ba_history"][0]


def test_ex02_cli(tiny, tmp_path):
    from spectavi_tpu_torch.pipeline.ex02 import main

    paths, kfile = tiny[0], tiny[1]
    out = str(tmp_path / "ex02")
    res = main([*paths, kfile, "--outdir", out, "--device", "cpu", "--ba_iters", "5"])
    assert res["cams"].shape == (3, 6) and np.isfinite(res["points"]).all()
    for name in ("sparse_cloud.ply", "poses.txt", "metrics.json"):
        assert os.path.exists(os.path.join(out, name))


def test_entry_points_default_to_the_card(monkeypatch):
    from spectavi_tpu_torch.pipeline.sfm import run_sfm, run_sfm_arrays
    from spectavi_tpu_torch.sfm import (bundle_adjust, bundle_adjust_device, incremental_poses,
                                        pnp_ransac, pnp_ransac_batch)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).standard_normal((10, 3)) + [0, 0, 5]
    calls = [
        lambda: run_sfm(["a.png", "b.png"], "K.txt"),
        lambda: run_sfm_arrays([np.zeros((32, 32), np.float32)] * 2, np.eye(3)),
        lambda: pnp_ransac(X, X[:, :2]),
        lambda: pnp_ransac_batch([(X, X[:, :2])]),
        lambda: bundle_adjust(np.zeros((2, 6)), X, [0], [0], [[0.0, 0.0]]),
        lambda: bundle_adjust_device(np.zeros((2, 6)), X, [0], [0], [[0.0, 0.0]]),
        lambda: incremental_poses({(0, 1): {"R": np.eye(3), "t": np.ones(3), "idx_i": [0],
                                            "idx_j": [0]}}, 2, [X[:, :2]] * 2,
                                  np.zeros((1, 2), np.int32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()


def test_match_pair_vs_jax(rng):
    # keypoint tables (n, 132): the queries are noisy copies of a
    # shuffled subset of the database rows, among unrelated rows
    from spectavi_tpu.pipeline.sfm import match_pair as jax_match_pair
    from spectavi_tpu_torch.pipeline.sfm import match_pair

    a = np.hstack([rng.uniform(0, 100, (300, 4)), rng.integers(0, 120, (300, 128))])
    b = np.hstack([rng.uniform(0, 100, (280, 4)), rng.integers(0, 120, (280, 128))])
    perm = rng.permutation(300)[:200]
    b[:200, 4:] = np.clip(a[perm, 4:] + rng.integers(-3, 4, (200, 128)), 0, 255)
    got = match_pair(a.astype(np.float32), b.astype(np.float32), device="cpu")
    ref = jax_match_pair(a.astype(np.float32), b.astype(np.float32))
    assert len(ref[0]) >= 150
    for g, r in zip(got, ref):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, np.asarray(r))

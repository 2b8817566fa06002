"""Port parity: ``spectavi_tpu_torch.sfm.resection`` against
``spectavi_tpu.sfm.resection`` in float64 on the same numpy inputs.

The PnP functions are handed the JAX package's own sample tables
(``jax.random.choice`` without replacement, per trial, as its fused
program draws them; per chunk and per problem for the batch), so both
pick the same hypothesis: the same inlier counts, identical masks and
poses to 1e-8.  ``incremental_poses`` draws from its own generator; on a
clean chain every view registers and the cameras land within 1e-6 of
JAX's, since the winners' masked polish converges to one optimum.
Called in JAX's argument order (a generator where JAX takes its key,
then ``trials``), ``pnp_ransac`` gives the keyword call's answer.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

jres = importlib.import_module("spectavi_tpu.sfm.resection")
tres = importlib.import_module("spectavi_tpu_torch.sfm.resection")
jba = importlib.import_module("spectavi_tpu.sfm.bundle_adjust")

TRIALS = 512


def _problem(rng, n, outliers=0.25):
    rv = rng.normal(0, 0.3, 3)
    tv = rng.normal(0, 0.3, 3)
    R = np.asarray(jba.rodrigues(jnp.asarray(rv)))
    X = rng.standard_normal((n, 3)) * [1, 1, 0.5] + [0, 0, 6.0]
    Xc = X @ R.T + tv
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-4, (n, 2))
    n_out = int(outliers * n)
    uv[:n_out] += rng.uniform(0.05, 0.2, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return X, uv


def _table(key, n):
    """The JAX program's draws: per trial ``choice`` of 6 of the ``n``
    valid rows of the 256-row bucket, without replacement."""
    Npad = max(256, 1 << int(np.ceil(np.log2(n))))
    p = jnp.asarray(np.arange(Npad) < n, jnp.float64) / n
    keys = jax.random.split(key, TRIALS)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, Npad, shape=(6,), replace=False, p=p))(keys))


def _same(rt, rj):
    assert rt["n_inliers"] == rj["n_inliers"] and rt["success"] == rj["success"]
    np.testing.assert_array_equal(rt["inlier_mask"], rj["inlier_mask"])
    np.testing.assert_allclose(rt["rvec"], rj["rvec"], atol=1e-8)
    np.testing.assert_allclose(rt["tvec"], rj["tvec"], atol=1e-8)


def test_pnp_ransac_given_jax_table(rng):
    X, uv = _problem(rng, 120)
    key = jax.random.PRNGKey(1)
    rj = jres.pnp_ransac(X, uv, key=key)
    rt = tres.pnp_ransac(X, uv, sample=_table(key, 120), device="cpu")
    _same(rt, rj)
    assert rt["success"] and rt["inlier_mask"][:30].sum() == 0
    # its own draws find the same consensus
    rg = tres.pnp_ransac(X, uv, device="cpu")
    assert rg["n_inliers"] == rj["n_inliers"]
    with pytest.raises(ValueError):
        tres.pnp_ransac(X[:5], uv[:5], device="cpu")


def test_pnp_ransac_batch_chunked_given_jax_tables(rng):
    problems = [_problem(rng, 100 + 17 * k) for k in range(3)]
    key = jax.random.PRNGKey(2)
    # max_rows=512 over 256-row buckets: chunks of 2 problems, then 1
    rj = jres.pnp_ransac_batch(problems, key=key, max_rows=512)
    tables, k = [], key
    for s in (0, 2):
        k, sub = jax.random.split(k)
        chunk = problems[s : s + 2]
        bkeys = jax.random.split(sub, 1 << int(np.ceil(np.log2(len(chunk)))))
        tables += [_table(bk, X.shape[0]) for bk, (X, _) in zip(bkeys, chunk)]
    rt = tres.pnp_ransac_batch(problems, sample=np.stack(tables), max_rows=512, device="cpu")
    assert len(rt) == 3
    for a, b in zip(rt, rj):
        _same(a, b)


def test_pnp_ransac_jax_positional_form(rng):
    # JAX's pnp_ransac(X, uv, key, trials): a generator in the key's place
    # and the trial count fourth, as the keyword call takes them
    X, uv = _problem(rng, 50, outliers=0.0)
    gen = torch.Generator()
    gen.manual_seed(3)
    pos = tres.pnp_ransac(X, uv, gen, 64, device="cpu")
    gen.manual_seed(3)
    kw = tres.pnp_ransac(X, uv, generator=gen, trials=64, device="cpu")
    assert pos["success"] and pos["n_inliers"] == 50
    for k in pos:
        np.testing.assert_array_equal(pos[k], kw[k])
    gen.manual_seed(3)
    batch = tres.pnp_ransac_batch([(X, uv)], gen, 64, device="cpu")[0]
    for k in pos:
        np.testing.assert_array_equal(batch[k], pos[k])


def test_incremental_poses_clean_chain(rng):
    from test_resection import _long_chain_scene

    V = 4
    _, kps, edges, pair_matches = _long_chain_scene(
        rng, V, kp_noise=2e-4, edge_rot_noise=0.0, edge_t_noise=0.0, wrong_frac=0.0)
    tracks = importlib.import_module("spectavi_tpu.sfm.pose_graph").build_tracks(pair_matches, V)
    cj, regj = jres.incremental_poses(edges, V, kps, tracks, reproj_thresh=3e-3,
                                      key=jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    ct, regt = tres.incremental_poses(edges, V, kps, tracks, reproj_thresh=3e-3, generator=gen,
                                      device="cpu")
    assert regt.all() and regj.all()
    np.testing.assert_allclose(ct, cj, atol=1e-6)

"""Port parity: RANSAC of ``spectavi_tpu_torch.mvg`` against
``spectavi_tpu.mvg`` in float64 on the same numpy inputs.

The block and ``ransac_essential_batch``, handed the JAX package's own
``(trials, 7)`` sample table and called in JAX's argument order (a
``torch.Generator``, or None beside a table, where JAX takes its key),
must pick the same winner: the same count, the same inlier mask, and E
and the camera equal to 1e-9.  The fitter draws its own samples with a
``torch.Generator`` (torch cannot reproduce JAX's threefry stream), so
it is held to the JAX fitter's consensus within 0.02.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectavi_tpu import mvg as jmvg
from spectavi_tpu_torch import mvg as tmvg
from test_torch_mvg import _scene

torch.set_num_threads(2)

jran = importlib.import_module("spectavi_tpu.mvg.ransac")
tran = importlib.import_module("spectavi_tpu_torch.mvg.ransac")

T = lambda a: torch.as_tensor(np.array(a))
J = jnp.asarray


def hand_jax_draws(monkeypatch, seed):
    """Make the port's RANSAC sampler return the tables that JAX's
    ``ransac_fitter(key=PRNGKey(seed))`` draws, block after block (one
    key split a block, as JAX's fitter does)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(n, trials, point_mask, generator=None):
        state["key"], sub = jax.random.split(state["key"])
        table = jran._sample_subsets(sub, n, trials, J(point_mask.cpu().numpy()))
        return torch.tensor(np.asarray(table), device=point_mask.device)

    monkeypatch.setattr(tran, "sample_subsets", draw)


def _padded(x0, x1):
    N = x0.shape[0]
    Np = max(16, 1 << (N - 1).bit_length())
    pm = np.zeros(Np, bool)
    pm[:N] = True
    return np.pad(x0, ((0, Np - N), (0, 0))), np.pad(x1, ((0, Np - N), (0, 0))), pm


def _castle_points():
    d = np.load("artifacts/round2/castle_matches.npz")
    # one fixed K for both sides (the castle K.txt is not in the repo)
    K = np.array([[2759.48, 0, 1520.69], [0, 2764.16, 1006.81], [0, 0, 1.0]])
    iK = np.linalg.inv(K)
    h = lambda a: np.hstack([a.astype(np.float64), np.ones((a.shape[0], 1))])
    return (h(d["xd"][:, :2]) @ iK.T)[:, :2], (h(d["yd"][:, :2]) @ iK.T)[:, :2]


# the synthetic case has the fitter test's shapes (256 padded rows, 512
# trials), so the JAX side compiles its block program once for both
@pytest.mark.parametrize("scene,trials,seed", [("synthetic", 512, 1), ("castle", 256, 3)])
def test_ransac_block_same_winner_as_jax(rng, scene, trials, seed):
    x0, x1 = _scene(rng, n=250) if scene == "synthetic" else _castle_points()
    x0p, x1p, pm = _padded(x0, x1)
    key = jax.random.PRNGKey(seed)
    sample = np.asarray(jran._sample_subsets(key, pm.shape[0], trials, J(pm)))
    Ej, camj, cj, mj = jran.ransac_fit_block(
        key, J(x0p), J(x1p), J(pm), J(3.35e-4), J(1e-3), J(trials, jnp.int32),
        batch_trials=trials, lo_iters=3,
    )
    Et, camt, ct, mt = tran.ransac_fit_block(
        None, T(x0p), T(x1p), T(pm), 3.35e-4, 1e-3, trials, batch_trials=trials,
        sample=T(sample),
    )
    assert int(ct) == int(cj) > 0
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), atol=1e-9)
    np.testing.assert_allclose(camt.numpy(), np.asarray(camj), atol=1e-9)


def test_ransac_fitter_consensus_vs_jax(rng):
    x0, x1 = _scene(rng, n=250)
    opts = {"required_percent_inliers": 0.9, "reprojection_error_allowed": 3.35e-4,
            "maximum_tries": 512, "singular_value_ratio_allowed": 1e-3}
    gen = torch.Generator()
    gen.manual_seed(0)
    rt = tmvg.ransac_fitter(x0, x1, options=opts, generator=gen, device="cpu")
    rj = jmvg.ransac_fitter(x0, x1, options=opts, key=jax.random.PRNGKey(0))
    assert set(rt) == set(rj)
    assert abs(rt["inlier_percent"] - rj["inlier_percent"]) <= 0.02
    assert rt["inlier_idx"].dtype == np.int32
    assert len(rt["inlier_idx"]) == round(rt["inlier_percent"] * x0.shape[0])
    with pytest.raises(ValueError):
        tmvg.ransac_fitter(x0[:5], x1[:5], device="cpu")
    with pytest.raises(ValueError):
        tmvg.ransac_fitter(x0, x1[:-1], device="cpu")


def test_sample_subsets_distinct_and_masked():
    pm = torch.zeros(64, dtype=torch.bool)
    pm[:40] = True
    gen = torch.Generator()
    gen.manual_seed(1)
    s = tran.sample_subsets(64, 500, pm, gen)
    assert s.shape == (500, 7)
    assert int(s.max()) < 40
    assert all(len(set(row)) == 7 for row in s.tolist())


def test_ransac_essential_batch_jax_form_vs_jax(rng):
    # JAX's call ransac_essential_batch(key, x0, x1, trials, reproj, svr, mask),
    # the port's with None for the key and JAX's table by keyword
    trials, reproj, svr = 256, 3.35e-4, 1e-3
    x0, x1, pm = _padded(*_scene(rng, n=200))
    key = jax.random.PRNGKey(5)
    table = np.asarray(jran._sample_subsets(key, pm.shape[0], trials, J(pm)))
    ref = jran.ransac_essential_batch(key, J(x0), J(x1), trials, reproj, svr, J(pm))
    out = tmvg.ransac_essential_batch(None, T(x0), T(x1), trials, reproj, svr, T(pm),
                                      sample=T(table))
    assert int(out["count"]) == int(ref["count"]) > 0
    np.testing.assert_array_equal(out["inlier_mask"].numpy(), np.asarray(ref["inlier_mask"]))
    np.testing.assert_allclose(out["essential"].numpy(), np.asarray(ref["essential"]),
                               atol=1e-9)
    np.testing.assert_allclose(out["camera"].numpy(), np.asarray(ref["camera"]), atol=1e-9)
    # the port's own draw: a generator in the key's place, the table it
    # would hand over drawn from the same seed gives the same winner
    gen = torch.Generator()
    gen.manual_seed(2)
    own = tmvg.ransac_essential_batch(gen, T(x0), T(x1), trials, reproj, svr, T(pm))
    gen.manual_seed(2)
    drawn = tran.sample_subsets(pm.shape[0], trials, T(pm), gen)
    again = tmvg.ransac_essential_batch(None, T(x0), T(x1), trials, reproj, svr, T(pm),
                                        sample=drawn)
    for k in own:
        np.testing.assert_array_equal(own[k].numpy(), again[k].numpy())
    assert int(own["count"]) > 0.5 * 200
    with pytest.raises(ValueError, match="trials = 128"):
        tmvg.ransac_essential_batch(None, T(x0), T(x1), 128, reproj, svr, T(pm),
                                    sample=T(table))


def test_none_generator_draws_seed_zero(rng):
    # None in the key's place and no table: the seeded default, the same
    # bytes on every call, as a generator seeded with 0 gives
    trials, reproj, svr = 128, 3.35e-4, 1e-3
    x0, x1, pm = (T(a) for a in _padded(*_scene(rng, n=120)))
    zero = torch.Generator()
    zero.manual_seed(0)
    calls = {
        "batch": lambda g: tmvg.ransac_essential_batch(g, x0, x1, trials, reproj, svr, pm),
        "block": lambda g: dict(zip("ECni", tran.ransac_fit_block(
            g, x0, x1, pm, reproj, svr, trials, trials))),
    }
    for name, call in calls.items():
        a, b = call(None), call(None)
        zero.manual_seed(0)
        c = call(zero)
        for k in a:
            assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), (name, k)
            assert a[k].numpy().tobytes() == c[k].numpy().tobytes(), (name, k)


def test_ransac_fitter_given_jax_draws(rng, monkeypatch):
    # the fitter handed JAX's draws: JAX's winner, block for block
    x0, x1 = _scene(rng, n=300)
    opts = {"reprojection_error_allowed": 3.35e-4, "maximum_tries": 4096}
    ref = jmvg.ransac_fitter(x0, x1, options=opts, key=jax.random.PRNGKey(5))
    hand_jax_draws(monkeypatch, 5)
    got = tmvg.ransac_fitter(x0, x1, options=opts, device="cpu")
    np.testing.assert_array_equal(got["inlier_idx"], np.asarray(ref["inlier_idx"]))
    np.testing.assert_allclose(got["essential"], np.asarray(ref["essential"]), atol=1e-9)
    np.testing.assert_allclose(got["camera"], np.asarray(ref["camera"]), atol=1e-9)

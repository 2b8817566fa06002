"""Port parity: RANSAC of ``spectavi_tpu_torch.mvg`` against
``spectavi_tpu.mvg`` in float64 on the same numpy inputs.

The block, handed the JAX package's own ``(trials, 7)`` sample table,
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
        T(sample), T(x0p), T(x1p), T(pm), 3.35e-4, 1e-3, trials
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

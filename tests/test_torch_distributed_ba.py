"""Port parity for the distributed bundle adjustment:
``spectavi_tpu_torch.sfm.distributed`` on four gloo ranks against
``spectavi_tpu.sfm.distributed`` on JAX's ``host_cpu_mesh(4)``, with the
same shard layout.

One module-scoped job of four ranks (``test_torch_parallel.run_ranks``)
runs the port's sharded steps of every case; JAX's run in this process.
The cases are ``tests/test_distributed_ba.py``'s: one interleaved step
and one point-aligned step on a 5-camera scene (cost to rtol 1e-10,
cameras and points to JAX's own 5e-4, since CG amplifies the shards'
summation order, and the after-step cost to rtol 1e-4), five steps that
converge, and three steps that carry the radial ``(k1, k2)`` block down
to the numerical floor.  ``shard_observations_by_point`` and
``pad_observations`` give JAX's arrays; with the reduction hooks at
their defaults the single-device solver is unchanged (also held by
``tests/test_torch_bundle_adjust.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bundle_adjust import _synthetic_scene
from test_torch_parallel import run_ranks

torch.set_num_threads(2)

J = jnp.asarray
T = lambda a: torch.as_tensor(np.array(a))

WORKER = r"""
from spectavi_tpu_torch.parallel import PAIRS, host_cpu_mesh, local_shard
from spectavi_tpu_torch.sfm import make_sharded_ba_step

T = torch.as_tensor
mesh = host_cpu_mesh(4, n_blocks=1)


def run(case, steps, lam, cg_iters, point_aligned=False):
    step = make_sharded_ba_step(mesh, axis="pairs", cg_iters=cg_iters,
                                point_aligned=point_aligned)
    obs = [local_shard(mesh, T(inp[case + k]), PAIRS) for k in ("_ci", "_pi", "_uv", "_w")]
    cams, pts = T(inp[case + "_cams"]), T(inp[case + "_pts"])
    fixed, k = T(inp[case + "_fixed"]), T(inp[case + "_k"])
    costs = []
    for _ in range(steps):
        cams, pts, cost = step(cams, pts, *obs, torch.tensor(lam, dtype=torch.float64), fixed, k)
        costs.append(float(cost))
    out[case + "_cams"], out[case + "_pts"] = cams.numpy(), pts.numpy()
    out[case + "_costs"] = np.array(costs)


run("step", 1, 1e-3, 120)
run("aligned", 1, 1e-3, 120, point_aligned=True)
run("conv", 5, 1e-4, 80)
run("dist", 3, 1e-6, 120)
"""


def _noisy_scene(rng, C, M, cam_noise, pt_noise):
    cams, pts, ci, pi, uv = _synthetic_scene(rng, C=C, M=M)
    cams_n = cams + cam_noise * rng.standard_normal(cams.shape) * (np.arange(C) > 0)[:, None]
    pts_n = pts + pt_noise * rng.standard_normal(pts.shape)
    fixed = np.zeros(C, dtype=bool)
    fixed[0] = True
    return cams_n, pts_n, ci, pi, uv, np.ones(len(uv)), fixed


def _distortion_scene(rng, k_true):
    from spectavi_tpu.sfm.bundle_adjust import rodrigues

    C, M = 3, 120
    cams = np.zeros((C, 6))
    for c in range(1, C):
        cams[c, :3] = rng.normal(0, 0.05, 3)
        cams[c, 3:] = rng.normal(0, 0.3, 3)
    pts = rng.standard_normal((M, 3)) * [1, 1, 0.4] + [0, 0, 5.0]
    ci = np.repeat(np.arange(C), M).astype(np.int32)
    pi = np.tile(np.arange(M), C).astype(np.int32)
    uv = []
    for c, p in zip(ci, pi):
        Xc = np.asarray(rodrigues(J(cams[c, :3]))) @ pts[p] + cams[c, 3:]
        x = Xc[:2] / Xc[2]
        r2 = (x * x).sum()
        uv.append(x * (1 + k_true[0] * r2 + k_true[1] * r2 * r2))
    fixed = np.zeros(C, dtype=bool)
    fixed[0] = True
    return cams, pts, ci, pi, np.asarray(uv), np.ones(M * C), fixed


def _jax_sharded(cams, pts, obs, fixed, k, steps, lam, cg_iters, point_aligned=False):
    """JAX's sharded step on ``host_cpu_mesh(4)``, ``steps`` times."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spectavi_tpu.parallel.mesh import host_cpu_mesh
    from spectavi_tpu.sfm.distributed import make_sharded_ba_step

    mesh = host_cpu_mesh(4, n_blocks=1)
    step = make_sharded_ba_step(mesh, axis="pairs", cg_iters=cg_iters,
                                point_aligned=point_aligned)
    put_obs = lambda a: jax.device_put(J(a), NamedSharding(mesh, P("pairs")))
    put_rep = lambda a: jax.device_put(J(a), NamedSharding(mesh, P()))
    obs = [put_obs(a) for a in obs]
    cams, pts = put_rep(cams), put_rep(pts)
    costs = []
    for _ in range(steps):
        cams, pts, cost = step(cams, pts, *obs, put_rep(J(lam)), put_rep(J(fixed)), put_rep(J(k)))
        costs.append(float(cost))
    return np.asarray(cams), np.asarray(pts), np.array(costs)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from spectavi_tpu_torch.sfm.bundle_adjust import fit_distortion
    from spectavi_tpu_torch.sfm.distributed import pad_observations, shard_observations_by_point

    rng = np.random.default_rng(0xDEADBEEF)
    k_true = np.array([-0.15, 0.03])
    scenes = {
        "step": _noisy_scene(rng, 5, 80, 0.01, 0.03),
        "conv": _noisy_scene(rng, 4, 60, 0.005, 0.02),
        "dist": _distortion_scene(rng, k_true),
    }
    scenes["aligned"] = scenes["step"]
    cams, pts, ci, pi, uv, w, _ = scenes["dist"]
    k_fit = fit_distortion(*(T(a) for a in (cams, pts, ci, pi, uv, w))).numpy()
    np.testing.assert_allclose(k_fit, k_true, atol=5e-3)
    inputs, obs = {}, {}
    for case, (cams, pts, ci, pi, uv, w, fixed) in scenes.items():
        if case == "aligned":
            obs[case] = shard_observations_by_point(4, ci, pi, uv, w)
        else:
            obs[case] = pad_observations(ci, pi, uv, w, 4)
        k = k_fit if case == "dist" else np.zeros(2)
        for name, a in zip(("cams", "pts", "fixed", "k"), (cams, pts, fixed, k)):
            inputs[f"{case}_{name}"] = a
        for name, a in zip(("ci", "pi", "uv", "w"), obs[case]):
            inputs[f"{case}_{name}"] = a
    outs = run_ranks(str(tmp_path_factory.mktemp("dist_ba")), WORKER, 4, inputs)
    return scenes, obs, k_fit, outs


def _cost(cams, pts, ci, pi, uv, w, k=None):
    from spectavi_tpu_torch.sfm import ba_cost

    k = None if k is None else T(k)
    return float(ba_cost(T(cams), T(pts), T(ci), T(pi), T(uv), T(w), k=k))


@pytest.mark.parametrize("case", ["step", "aligned"], ids=["interleaved", "point_aligned"])
def test_sharded_ba_step_vs_jax(job, case):
    from spectavi_tpu_torch.sfm import ba_step

    scenes, obs, _, outs = job
    cams, pts, ci, pi, uv, w, fixed = scenes[case]
    rc, rp, rcost = _jax_sharded(cams, pts, obs[case], fixed, np.zeros(2), 1, 1e-3, 120,
                                 point_aligned=case == "aligned")
    lc, lp, lcost = ba_step(T(cams), T(pts), T(ci), T(pi), T(uv), T(w),
                            torch.tensor(1e-3, dtype=torch.float64), T(fixed), cg_iters=120)
    for out in outs:  # every rank holds the same step
        np.testing.assert_array_equal(out[case + "_cams"], outs[0][case + "_cams"])
        np.testing.assert_array_equal(out[case + "_pts"], outs[0][case + "_pts"])
    out = outs[0]
    cost = out[case + "_costs"][0]
    assert np.isclose(cost, rcost[0], rtol=1e-10)
    assert np.isclose(cost, float(lcost), rtol=1e-10)
    np.testing.assert_allclose(out[case + "_cams"], rc, atol=5e-4)
    np.testing.assert_allclose(out[case + "_pts"], rp, atol=5e-4)
    np.testing.assert_allclose(out[case + "_cams"], lc.numpy(), atol=5e-4)
    after = _cost(out[case + "_cams"], out[case + "_pts"], ci, pi, uv, w)
    assert np.isclose(after, _cost(rc, rp, ci, pi, uv, w), rtol=1e-4)
    assert np.isclose(after, _cost(lc.numpy(), lp.numpy(), ci, pi, uv, w), rtol=1e-4)
    assert after < cost


def test_sharded_ba_converges(job):
    scenes, obs, _, outs = job
    cams, pts, ci, pi, uv, w, fixed = scenes["conv"]
    _, _, rcosts = _jax_sharded(cams, pts, obs["conv"], fixed, np.zeros(2), 5, 1e-4, 80)
    costs = outs[0]["conv_costs"]
    assert np.isclose(costs[0], rcosts[0], rtol=1e-10)
    final = _cost(outs[0]["conv_cams"], outs[0]["conv_pts"], ci, pi, uv, w)
    assert final < costs[0] * 1e-3
    assert (np.diff(costs) < 0).all()


def test_sharded_ba_distortion_recovers_k(job):
    scenes, obs, k, outs = job
    cams, pts, ci, pi, uv, w, fixed = scenes["dist"]
    rc, rp, rcosts = _jax_sharded(cams, pts, obs["dist"], fixed, k, 3, 1e-6, 120)
    assert np.isclose(outs[0]["dist_costs"][0], rcosts[0], rtol=1e-10)
    cost0 = _cost(cams, pts, ci, pi, uv, w)
    final = _cost(outs[0]["dist_cams"], outs[0]["dist_pts"], ci, pi, uv, w, k=k)
    # with k carried, the sharded solve sits at the numerical floor,
    # orders of magnitude below the pinhole-only cost of the same scene
    assert final < 1e-6 * cost0
    assert _cost(rc, rp, ci, pi, uv, w, k=k) < 1e-6 * cost0


def test_shard_observations_by_point_vs_jax(rng):
    from spectavi_tpu.sfm import distributed as jdist
    from spectavi_tpu_torch.sfm.distributed import shard_observations_by_point

    _, _, ci, pi, uv = _synthetic_scene(rng, C=5, M=80)
    w = rng.random(len(uv))
    for n in (1, 3, 8):
        got = shard_observations_by_point(n, ci, pi, uv, w)
        ref = jdist.shard_observations_by_point(n, ci, pi, uv, w)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        per = len(got[0]) // n
        owner = {}
        for o in np.nonzero(got[3] > 0)[0]:  # every point's observations on one shard
            assert owner.setdefault(int(got[1][o]), o // per) == o // per


@pytest.mark.parametrize("multiple", [1, 4, 7, 8])
def test_pad_observations_vs_jax(rng, multiple):
    from spectavi_tpu.sfm import distributed as jdist
    from spectavi_tpu_torch.sfm import pad_observations

    _, _, ci, pi, uv = _synthetic_scene(rng, C=5, M=80)
    w = rng.random(len(uv))
    got = pad_observations(ci, pi, uv, w, multiple)
    ref = jdist.pad_observations(ci, pi, uv, w, multiple)
    assert len(got[0]) % multiple == 0
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_identity_reduce_leaves_the_step_unchanged(rng):
    """A reduction hook that returns its input (one shard) gives the
    bytes of the hooks at None."""
    tba = importlib.import_module("spectavi_tpu_torch.sfm.bundle_adjust")
    cams, pts, ci, pi, uv, w, fixed = _noisy_scene(rng, 5, 80, 0.01, 0.03)
    inc = tba.Incidence(T(ci), T(pi), 5, 80)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    ident = lambda t: t
    base = tba._ba_quantities(T(cams), T(pts), inc, T(uv), T(w), lam)
    hooked = tba._ba_quantities(T(cams), T(pts), inc, T(uv), T(w), lam, reduce=ident)
    for a, b in zip(base, hooked):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    sol = tba._solve_schur(*base[:5], inc, T(fixed), cg_iters=50)
    for point in ("same", None):
        hsol = tba._solve_schur(*base[:5], inc, T(fixed), cg_iters=50, reduce=ident,
                                reduce_point=point)
        for a, b in zip(sol, hsol):
            assert a.numpy().tobytes() == b.numpy().tobytes()

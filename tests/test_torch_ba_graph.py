"""``ba_device_loop`` on a CUDA card, where its LM iterations are replays
of one captured CUDA graph: the replays give the bytes of the same
in-place iteration run eagerly on the card, in the final BA
(``bundle_adjust_device``) as in the loop itself, a call after a call of
another size included.  Needs a card and skips without one; imports no
JAX.  On a machine with a card:

    python3 -m pytest --noconftest tests/test_torch_ba_graph.py
"""

import importlib

import numpy as np
import pytest
import torch

from spectavi_tpu_torch.utils import profiling

tba = importlib.import_module("spectavi_tpu_torch.sfm.bundle_adjust")

LAM = 1.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(seed=1, C=5, M=60, noise=1e-3, spread=2.5, k=(-0.08, 0.02)):
    """``tests/test_torch_bundle_adjust.py``'s scene, built with the
    port's rotations: cameras on an arc around a point cloud, radially
    distorted noisy observations with a few gross outliers, and a
    perturbed start (all but cameras 0 and 1)."""
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(C):
        ang = 0.25 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        Cc = np.array([3.0 * np.sin(ang), 0.3 * i, -8.0 + 0.5 * i])
        cams.append(np.concatenate([tba.rotation_to_rvec(R), -R @ Cc]))
    cams = np.asarray(cams)
    pts = spread * rng.standard_normal((M, 3))
    ci, pi = np.meshgrid(np.arange(C), np.arange(M), indexing="ij")
    ci, pi = ci.ravel(), pi.ravel()
    R = tba.rodrigues(torch.as_tensor(cams[:, :3])).numpy()
    Xc = np.einsum("oij,oj->oi", R[ci], pts[pi]) + cams[ci, 3:]
    p = Xc[:, :2] / Xc[:, 2:]
    r2 = np.sum(p * p, axis=1, keepdims=True)
    uv = p * (1.0 + k[0] * r2 + k[1] * r2 * r2) + noise * rng.standard_normal((len(ci), 2))
    uv[:4] += 0.05
    cams_n = cams.copy()
    cams_n[2:] += 0.01 * rng.standard_normal(cams[2:].shape)
    pts_n = pts + 0.05 * spread * rng.standard_normal(pts.shape)
    return cams_n, pts_n, ci, pi, uv


def _problem(dev, keep=None, **kw):
    """The scene on ``dev``, with the observations ``keep`` selects."""
    cams, pts, ci, pi, uv = _scene(**kw)
    if keep is not None:
        ci, pi, uv = ci[keep], pi[keep], uv[keep]
    f64 = dict(dtype=torch.float64, device=dev)
    fixed = torch.zeros(cams.shape[0], dtype=torch.bool, device=dev)
    fixed[:2] = True
    inc = tba.Incidence(torch.as_tensor(ci, device=dev), torch.as_tensor(pi, device=dev),
                        cams.shape[0], pts.shape[0])
    return (torch.as_tensor(cams, **f64), torch.as_tensor(pts, **f64), inc,
            torch.as_tensor(uv, **f64), torch.ones(len(ci), **f64),
            torch.tensor(0.01, **f64), fixed)


def _eager(cams, pts, inc, uv, w, delta, fixed, iters):
    """The loop's in-place body stepped by hand, eagerly."""
    k = tba._zero_k(cams)
    cost0 = tba._objective(cams, pts, k, inc, uv, w, delta, True)
    state = (cams.clone(), pts.clone(), cost0.clone(),
             torch.tensor(LAM, dtype=torch.float64, device=cams.device))
    for _ in range(iters):
        tba._lm_update(state, k, inc, uv, w, delta, fixed, 100, True)
    return state[0], state[1], cost0, state[2]


def _replayed(cams, pts, inc, uv, w, delta, fixed, iters):
    """``ba_device_loop`` with the tracer on: its result and its
    ``ba_graph_iters`` count."""
    was = profiling.enable()
    profiling.take()
    try:
        out = tba.ba_device_loop(cams, pts, inc, None, uv, w, delta, LAM, fixed, iters=iters)
        torch.cuda.synchronize()
        n = profiling.take()["counters"].get("ba_graph_iters", 0)
    finally:
        profiling.enable(was)
    return out, n


@pytest.mark.parametrize("iters", [5, 15])
def test_replays_give_the_eager_bytes(card, iters):
    p = _problem(card)
    got, n = _replayed(*p, iters)
    want = _eager(*p, iters)
    assert n == iters
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[3]) < float(got[2])


def test_bundle_adjust_device_replayed_and_eager(card, monkeypatch):
    cams, pts, ci, pi, uv = _scene(seed=2)
    kw = dict(fixed_cameras=(0, 1), max_iters=15, lam0=LAM, device="cuda")
    replayed = tba.bundle_adjust_device(cams, pts, ci, pi, uv, **kw)

    def eager(body, iters, device):
        for _ in range(iters):
            body()

    monkeypatch.setattr(tba, "_replay", eager)
    stepped = tba.bundle_adjust_device(cams, pts, ci, pi, uv, **kw)
    for a, b in zip(replayed[:2], stepped[:2]):
        assert a.tobytes() == b.tobytes()
    assert replayed[2] == stepped[2]


def test_calls_of_other_sizes_capture_their_own_graphs(card):
    rng = np.random.default_rng(3)
    for keep in (None, rng.random(300) < 0.8, rng.random(300) < 0.6):
        p = _problem(card, keep=keep)
        got, n = _replayed(*p, 8)
        want = _eager(*p, 8)
        assert n == 8
        for a, b in zip(got, want):
            assert torch.equal(a, b)

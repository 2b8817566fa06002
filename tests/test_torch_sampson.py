"""Sampson counts of RANSAC hypotheses (``spectavi_tpu_torch/ops/sampson.py``,
CUDA kernel K4, and ``mvg/ransac.py::_sampson_counts``).

On the CPU: the wrapper over every trial at once gives the chunked plain
route's ``(counts, gate)`` for any chunk, with and without a leading
batch; counts keep the masked tail out, give -1 for invalid roots and
reach every real row for the true essential matrix, against a float64
count; nothing launches and the tracer's ``sampson_scored`` stays 0; the
CUDA entry's checks raise before any build or launch.

On a card (skipped without one; imports no JAX), K4 against the plain
version at small shapes:

    python3 -m pytest --noconftest tests/test_torch_sampson.py
"""

import importlib

import numpy as np
import pytest
import torch

from spectavi_tpu_torch.mvg.sevenpoint import seven_point
from spectavi_tpu_torch.ops import _build, sampson
from spectavi_tpu_torch.utils import profiling

torch.set_num_threads(2)

tran = importlib.import_module("spectavi_tpu_torch.mvg.ransac")

# the pair step's thresholds (``pipeline/sfm.py``)
REPROJ = 3.35e-4
SVR = 3e-2
THR2 = (0.5 * REPROJ) ** 2


def _pose(a):
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-1.0, 0.1, 0.2])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return R, t, tx @ R


def _views(rng, n, outliers, noise, a):
    """``n`` correspondences in normalized coordinates of a two-view
    scene, and its essential matrix."""
    R, t, E = _pose(a)
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(3, 6, n)], 1)
    Y = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:] + noise * rng.standard_normal((n, 2))
    x1 = Y[:, :2] / Y[:, 2:] + noise * rng.standard_normal((n, 2))
    bad = rng.random(n) < outliers
    x1[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return x0, x1, E


def _problem(lead, T=24, N=160, real=128, seed=0):
    """Hypotheses and rows of ``lead`` problems (``()``: one, unbatched).

    Problem 0 is noise-free and every row an inlier; the others carry
    noise of about the threshold and a quarter outliers.  Rows past
    ``real`` are masked: copies of the first rows, which would count.
    Trial 0 of every problem is the scene's true E (every real row of
    problem 0 in), and every fifth trial's second root is marked
    invalid beside the 7-point solve's own failures."""
    rng = np.random.default_rng(seed)
    P = int(np.prod(lead, dtype=np.int64))
    x0s, x1s, Fs, valids = [], [], [], []
    for p in range(P):
        x0, x1, E = _views(rng, real, 0.0 if p == 0 else 0.25, 0.0 if p == 0 else 2e-4,
                           0.2 + 0.05 * p)
        x0 = np.concatenate([x0, x0[: N - real]])
        x1 = np.concatenate([x1, x1[: N - real]])
        idx = np.stack([rng.choice(real, 7, replace=False) for _ in range(T)])
        F, valid = seven_point(torch.as_tensor(x0[idx], dtype=torch.float32),
                               torch.as_tensor(x1[idx], dtype=torch.float32), nullspace="mgs")
        F[0, 0] = torch.as_tensor(E, dtype=torch.float32)
        valid[0, 0] = True
        valid[::5, 1] = False
        x0s.append(x0)
        x1s.append(x1)
        Fs.append(F)
        valids.append(valid)
    f32 = lambda a: torch.as_tensor(np.stack(a), dtype=torch.float32).reshape(*lead, N, 2)
    mask = torch.zeros((P, N), dtype=torch.bool)
    mask[:, :real] = True
    return (torch.stack(Fs).reshape(*lead, T, 3, 3, 3),
            torch.stack(valids).reshape(*lead, T, 3), f32(x0s), f32(x1s),
            mask.reshape(*lead, N))


def _float64_bounds(E, x0, x1, mask, thr2, band):
    """Per hypothesis, the float64 count of real rows surely in
    (``d <= thr2 (1 - band)``) and of rows possibly in (``d <= thr2 (1 +
    band)``), ``d`` the Sampson distance squared."""
    E = E.double()
    x0h = torch.cat([x0.double(), torch.ones_like(x0[..., :1]).double()], -1)
    x1h = torch.cat([x1.double(), torch.ones_like(x1[..., :1]).double()], -1)
    Ex0 = torch.einsum("...trij,...nj->...trni", E, x0h)
    Etx1 = torch.einsum("...trji,...nj->...trni", E, x1h)
    xEx = torch.einsum("...ni,...trni->...trn", x1h, Ex0)
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    d = xEx * xEx / den.clamp(min=1e-30)
    m = mask[..., None, None, :]
    return (((d <= thr2 * (1 - band)) & m).sum(-1), ((d <= thr2 * (1 + band)) & m).sum(-1))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "P3"])
@pytest.mark.parametrize("chunk", [1, 13, 1024])
def test_wrapper_matches_chunked_plain_route(lead, chunk):
    F, valid, x0, x1, mask = _problem(lead)
    E, gate = tran._essential_gate(F, valid, SVR)
    counts = sampson.sampson_count(E, valid, x0, x1, mask, THR2)
    ref_counts, ref_gate = tran._sampson_counts(F, valid, x0, x1, mask, REPROJ, SVR, chunk=chunk)
    assert counts.dtype == torch.int32 and counts.shape == valid.shape
    assert torch.equal(counts, ref_counts)
    assert torch.equal(gate, ref_gate)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "P3"])
def test_counts_keep_masked_rows_out_and_mark_invalid_roots(lead):
    F, valid, x0, x1, mask = _problem(lead)
    E, _ = tran._essential_gate(F, valid, SVR)
    counts = sampson.sampson_count(E, valid, x0, x1, mask, THR2)
    real = int(mask.reshape(-1, mask.shape[-1])[0].sum())
    flat = counts.reshape(-1, *counts.shape[-2:])
    assert flat[0, 0, 0] == real  # the true E of the noise-free problem: every real row
    assert int(counts.max()) <= real  # the masked copies never count
    assert (~valid).any() and torch.equal(counts == -1, ~valid)
    lo, hi = _float64_bounds(E, x0, x1, mask, THR2, 1e-2)
    assert ((counts >= lo) & (counts <= hi))[valid].all()
    assert (counts[valid] > 0).any() and (counts[valid] < real).any()


def test_no_launch_on_the_cpu():
    F, valid, x0, x1, mask = _problem((3,))
    before = sampson.launches
    gen = torch.Generator().manual_seed(3)
    tran.ransac_essential_core(gen, x0, x1, 16, REPROJ, SVR, mask)
    tran._sampson_counts(F, valid, x0, x1, mask, REPROJ, SVR)
    assert sampson.launches == before == 0


def test_scored_counter_reads_zero_on_the_cpu():
    F, valid, x0, x1, mask = _problem((3,))
    was = profiling.enable()
    profiling.take()
    try:
        with profiling.annotate("pairs.ransac"):
            tran._sampson_counts(F, valid, x0, x1, mask, REPROJ, SVR)
        rec = profiling.take()
    finally:
        profiling.enable(was)
    assert rec["counters"].get(profiling.SAMPSON_SCORED, 0) == 0
    assert rec["spans"][0]["counts"].get(profiling.SAMPSON_SCORED, 0) == 0


def _bad_inputs():
    F, valid, x0, x1, mask = _problem((3,), T=4, N=32, real=24)
    E, _ = tran._essential_gate(F, valid, SVR)
    good = dict(E=E, valid=valid, x0=x0, x1=x1, point_mask=mask)
    cases = {
        "E float64": (TypeError, dict(E=E.double())),
        "x1 float64": (TypeError, dict(x1=x1.double())),
        "valid uint8": (TypeError, dict(valid=valid.to(torch.uint8))),
        "mask int32": (TypeError, dict(point_mask=mask.to(torch.int32))),
        "E not 3x3x3": (ValueError, dict(E=E[..., :2])),
        "valid shape": (ValueError, dict(valid=valid[:, :2])),
        "x0 rows": (ValueError, dict(x0=x0[:, :31])),
        "x0 batch": (ValueError, dict(x0=x0[:2])),
        "mask rows": (ValueError, dict(point_mask=mask[:, :31])),
        "E strided": (ValueError, dict(E=E.transpose(-1, -2))),
        "x0 strided": (ValueError, dict(x0=x0.transpose(0, 1).contiguous().transpose(0, 1))),
        "on the CPU": (ValueError, {}),
    }
    return {k: (err, {**good, **over}) for k, (err, over) in cases.items()}


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_cuda_entry_checks_raise_before_any_launch(monkeypatch, case):
    err, args = _bad_inputs()[case]

    def no_build(name):
        raise AssertionError(f"{name} was built")

    monkeypatch.setattr(_build, "load", no_build)
    before = sampson.launches
    with pytest.raises(err):
        sampson.count_cuda(args["E"], args["valid"], args["x0"], args["x1"],
                           args["point_mask"], THR2)
    assert sampson.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("lead,T,N", [((), 2048, 1000), ((3,), 300, 4096), ((7,), 40, 300)])
def test_kernel_matches_plain_version_on_card(card, lead, T, N):
    F, valid, x0, x1, mask = (t.to(card) for t in _problem(lead, T=T, N=N, real=N * 3 // 4))
    E, _ = tran._essential_gate(F, valid, SVR)
    plain = sampson.count_plain(E, valid, x0, x1, mask, THR2)
    lo, hi = _float64_bounds(E, x0, x1, mask, THR2, 1e-2)
    before = sampson.launches
    got = sampson.sampson_count(E, valid, x0, x1, mask, THR2)
    torch.cuda.synchronize()
    assert sampson.launches == before + 1
    assert torch.equal(got == -1, ~valid)
    assert ((got >= lo) & (got <= hi))[valid].all()
    assert (got != plain).float().mean() < 1e-2
    assert torch.equal(got, sampson.sampson_count(E, valid, x0, x1, mask, THR2))

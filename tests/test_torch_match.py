"""Port parity for ``spectavi_tpu_torch.match``: the same seeded numpy
inputs through every matcher of ``spectavi_tpu.match`` and its
counterpart in the port, both on the CPU.

* Exact matchers (``nn_bruteforce`` at ``mu = 0``, ``l1_topk2_xla``,
  ``nn_bruteforcel1k2``, ``ann``): indices bit for bit, integer
  distances exact, float distances to 1e-5 relative (float32 sums in
  another order); duplicated database rows pin the tie order (lower
  index first).
* ``mu > 0``: valid, distinct, genuine distances, and the same rows as
  the JAX program on at least 99% of the slots (the prune test compares
  float sums taken in another order).
* Cascade hash, k-medians and IVF draw random objects; the port is
  handed the JAX package's draw (hyperplanes, permutations, initial
  rows).  Float32 projections and distances then sum in another order
  than XLA's, so a value near a threshold can fall on the other side:
  each test states the share of identical rows it requires.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectavi_tpu import match as jmatch
from spectavi_tpu.features import normalize_to_ubyte_and_multiple_16_dim
from spectavi_tpu.match.ivf import kmeans_cells as jax_kmeans_cells
from spectavi_tpu.match.kmedians import kmedians as jax_kmedians
from spectavi_tpu_torch import match
from spectavi_tpu_torch.match import ivf

torch.set_num_threads(2)

I32_MAX = 2**31 - 1


def _i64(a):
    return np.asarray(a).astype(np.int64)


def _same_rows(ia, da, ib, db):
    """Share of rows whose indices and distances are identical."""
    return float((np.all(_i64(ia) == _i64(ib), axis=1) & np.all(da == db, axis=1)).mean())


def _clustered(rng, xrows, yrows, dim, n_base=200, noise=6.0):
    """De-meaned byte-range rows: noisy resamples of shared base rows,
    the regime hashing is for."""
    base = rng.uniform(0, 255, size=(n_base, dim))
    return tuple(
        np.clip(base[rng.integers(0, n_base, rows)] + rng.normal(0, noise, (rows, dim)),
                0, 255) - 128
        for rows in (xrows, yrows))


# --- bruteforce ------------------------------------------------------


@pytest.mark.parametrize("p,use_int", [(1.0, False), (2.0, False), (0.5, False), (3.0, False),
                                       (1.0, True), (2.0, True), (0.5, True)])
def test_nn_bruteforce_exact_vs_jax(rng, p, use_int):
    x = rng.standard_normal((1000, 132)).astype("float32")
    y = rng.standard_normal((300, 132)).astype("float32")
    gi, gd = match.nn_bruteforce(x, y, k=3, p=p, use_int=use_int, chunk=128, device="cpu")
    wi, wd = jmatch.nn_bruteforce(x, y, k=3, p=p, use_int=use_int)
    assert gi.dtype == np.uint64 and gd.dtype == (np.int32 if use_int else np.float32)
    np.testing.assert_array_equal(gi, wi)
    if use_int:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=1e-5)


def test_nn_bruteforce_large_k_vs_jax(rng):
    # k above the masked-argmin cap takes the stable sort
    x = rng.standard_normal((400, 32)).astype("float32")
    y = rng.standard_normal((50, 32)).astype("float32")
    gi, gd = match.nn_bruteforce(x, y, k=12, p=2.0, device="cpu")
    wi, wd = jmatch.nn_bruteforce(x, y, k=12, p=2.0)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5)


def _dup_inputs(rng, dtype, D=32):
    """Few distinct rows, each many times in the database: every query
    has several exact ties."""
    base = rng.integers(0, 6, size=(23, D))
    x = base[rng.integers(0, 23, 400)].astype(dtype)
    y = base[rng.integers(0, 23, 150)].astype(dtype)
    return x, y


@pytest.mark.parametrize("name", ["nn_bruteforce_p1", "nn_bruteforce_int", "nn_bruteforce_k12",
                                  "l1_topk2_xla", "nn_bruteforcel1k2", "ann"])
def test_ties_go_to_the_lower_index(rng, name):
    x, y = _dup_inputs(rng, "uint8" if name in ("l1_topk2_xla", "nn_bruteforcel1k2")
                       else "float32")
    k = 12 if name == "nn_bruteforce_k12" else 2
    if name == "nn_bruteforce_p1":
        gi, wi = (m.nn_bruteforce(x, y, p=1.0, **kw)[0]
                  for m, kw in ((match, {"device": "cpu"}), (jmatch, {})))
    elif name == "nn_bruteforce_int":
        gi, wi = (m.nn_bruteforce(x, y, p=2.0, use_int=True, **kw)[0]
                  for m, kw in ((match, {"device": "cpu"}), (jmatch, {})))
    elif name == "nn_bruteforce_k12":
        gi, wi = (m.nn_bruteforce(x, y, p=1.0, k=12, **kw)[0]
                  for m, kw in ((match, {"device": "cpu"}), (jmatch, {})))
    elif name == "l1_topk2_xla":
        gi = match.l1_topk2_xla(x, y, device="cpu")[0].numpy()
        wi = np.asarray(jmatch.l1_topk2_xla(jnp.asarray(x), jnp.asarray(y))[0])
    elif name == "nn_bruteforcel1k2":
        gi, wi = match.nn_bruteforcel1k2(x, y, device="cpu")[0], jmatch.nn_bruteforcel1k2(x, y)[0]
    else:
        gi, wi = match.ann(x, y, device="cpu"), jmatch.ann(x, y)
    # the oracle: a stable sort of exact integer distances
    d = np.abs(x.astype(np.int64)[None] - y.astype(np.int64)[:, None])
    d = (d * d if name in ("nn_bruteforce_int", "ann") else d).sum(-1)
    oracle = np.argsort(d, 1, kind="stable")[:, :k]
    assert (np.sort(d, 1)[:, 0] == np.sort(d, 1)[:, 1]).mean() > 0.9  # ties are the rule here
    np.testing.assert_array_equal(_i64(gi), oracle)
    np.testing.assert_array_equal(_i64(gi), _i64(wi))


@pytest.mark.parametrize("use_int", [False, True])
def test_nn_bruteforce_mu_pruning_vs_jax(rng, use_int):
    centers = rng.uniform(-4, 4, size=(40, 64))
    x = (centers[rng.integers(0, 40, 2000)] + 0.3 * rng.standard_normal((2000, 64))).astype("float32")
    y = (centers[rng.integers(0, 40, 500)] + 0.3 * rng.standard_normal((500, 64))).astype("float32")
    mu = 5.0 if use_int else 0.05
    gi, gd = match.nn_bruteforce(x, y, k=2, p=2.0, mu=mu, use_int=use_int, device="cpu")
    wi, wd = jmatch.nn_bruteforce(x, y, k=2, p=2.0, mu=mu, use_int=use_int)
    assert np.all(gd[:, 0] <= gd[:, 1])
    assert np.all(gi[:, 0] != gi[:, 1])
    xs, ys = (np.round(100 * a).astype(np.int64) for a in (x, y)) if use_int else (x, y)
    d_check = ((ys[:, None, :] - xs[_i64(gi)]) ** 2).sum(-1)
    np.testing.assert_allclose(gd, d_check, rtol=0 if use_int else 1e-4)
    assert (_i64(gi) == _i64(wi)).mean() >= 0.99
    # harder pruning stays valid; explicit prune sizes are honoured and checked
    gi2, gd2 = match.nn_bruteforce(x, y, k=2, p=2.0, mu=10.0 * (100 if use_int else 1),
                                   use_int=use_int, prune_dims=8, prune_candidates=16,
                                   device="cpu")
    wi2, _ = jmatch.nn_bruteforce(x, y, k=2, p=2.0, mu=10.0 * (100 if use_int else 1),
                                  use_int=use_int, prune_dims=8, prune_candidates=16)
    assert np.all(gd2[:, 0] <= gd2[:, 1]) and np.all(gi2[:, 0] != gi2[:, 1])
    assert (_i64(gi2) == _i64(wi2)).mean() >= 0.99
    with pytest.raises(ValueError):
        match.nn_bruteforce(x, y, mu=1.0, prune_dims=0, device="cpu")
    with pytest.raises(ValueError):
        match.nn_bruteforce(x, y, mu=1.0, k=2, prune_candidates=1, device="cpu")


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16", "int32"])
def test_l1_topk2_vs_jax(rng, dtype):
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -40000), min(info.max, 40000)
    x = rng.integers(lo, hi, size=(300, 144)).astype(dtype)
    y = rng.integers(lo, hi, size=(200, 144)).astype(dtype)
    gi, gd = match.l1_topk2_xla(x, y, device="cpu")
    wi, wd = jmatch.l1_topk2_xla(jnp.asarray(x), jnp.asarray(y))
    assert gi.dtype == torch.int32 and gd.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    ni, nd = match.nn_bruteforcel1k2(x, y, device="cpu")
    ji, jd = jmatch.nn_bruteforcel1k2(x, y)
    assert ni.dtype == np.uint64 and nd.dtype == np.int32
    np.testing.assert_array_equal(ni, ji)
    np.testing.assert_array_equal(nd, jd)
    d = np.abs(x.astype(np.int64)[None] - y.astype(np.int64)[:, None]).sum(-1)
    np.testing.assert_array_equal(nd, np.sort(d, 1)[:, :2])


def test_nn_bruteforcel1k2_argument_checks(rng):
    x = rng.uniform(0, 255, size=(10, 20)).astype("uint8")
    with pytest.raises(ValueError, match="16-byte aligned"):
        match.nn_bruteforcel1k2(x, x, device="cpu")
    f = rng.standard_normal((10, 16)).astype("float32")
    with pytest.raises(TypeError):
        match.nn_bruteforcel1k2(f, f, device="cpu")


@pytest.mark.parametrize("name", ["nn_bruteforce", "nn_bruteforcel1k2", "nn_l2k2",
                                  "nn_cascading_hash", "nn_kmedians", "nn_ivf", "ann"])
def test_matchers_refuse_rows_of_two_widths(rng, name):
    x = rng.integers(0, 255, size=(40, 32)).astype("uint8")
    y = rng.integers(0, 255, size=(40, 16)).astype("uint8")
    args = (x, y, 2) if name == "nn_kmedians" else (x, y)
    with pytest.raises(ValueError, match="rows"):
        getattr(match, name)(*args, device="cpu")
    if name == "nn_ivf":
        with pytest.raises(ValueError, match="top-2"):
            match.nn_ivf(x, x, k=3, device="cpu")


# --- ann ---------------------------------------------------------------


def test_ann_vs_jax_and_sharding(rng):
    x = rng.standard_normal((1100, 64)).astype("float32")
    y = rng.standard_normal((200, 64)).astype("float32")
    a = match.ann(x, y, k=2, shard_size=250, device="cpu")
    b = match.ann_hnswlib(x, y, k=2, shard_size=5000, device="cpu")
    assert a.dtype == np.uint64 and a.shape == (200, 2)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jmatch.ann(x, y, k=2, shard_size=250))


# --- cascade hash ---------------------------------------------------------


def _jax_planes(n, D, m, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, D, m), dtype=jnp.float32))


def test_nn_cascading_hash_vs_jax_on_its_planes(rng):
    rows, dim = 2048, 64
    x, y = _clustered(rng, rows, rows, dim)
    m = int(np.floor(np.log2(rows / 6.0)))
    gi, gd, stats = match.nn_cascading_hash(x, y, planes=_jax_planes(2, dim, m), with_stats=True,
                                            device="cpu")
    wi, wd, jstats = jmatch.nn_cascading_hash(x, y, with_stats=True)
    assert gi.dtype == np.uint64 and gd.dtype == np.float32
    # a projection within float32 rounding of zero may flip a bit
    assert _same_rows(gi, gd, wi, wd) >= 0.98
    assert len(stats["dropped_member_slots"]) == 2
    for a, b in zip(stats["dropped_member_slots"], jstats["dropped_member_slots"]):
        assert abs(a - b) <= 0.02 * rows
    # the reference's budget against exact L1: <= 40% of the slots differ
    ei, _ = match.nn_bruteforcel1k2((x + 128).astype("uint8"), (y + 128).astype("uint8"),
                                    device="cpu")
    assert (_i64(gi) != _i64(ei)).sum() <= 2 * round(0.4 * rows)


def test_nn_cascading_hash_own_draw_within_budget(rng):
    x = normalize_to_ubyte_and_multiple_16_dim(rng.standard_normal((200, 144)).astype("float32"))
    y = normalize_to_ubyte_and_multiple_16_dim(rng.standard_normal((200, 144)).astype("float32"))
    gen = torch.Generator()
    gen.manual_seed(3)
    gi, _ = match.nn_cascading_hash(x, y, m=8, n=16, g=5, generator=gen, device="cpu")
    gi0, _ = match.nn_cascading_hash(x, y, m=8, n=16, g=5, device="cpu")
    gi1, _ = match.nn_cascading_hash(x, y, m=8, n=16, g=5, device="cpu")
    np.testing.assert_array_equal(gi0, gi1)  # the default generator is seeded
    d = np.abs(x.astype(np.int64)[None] - y.astype(np.int64)[:, None]).sum(-1)
    oracle = np.argsort(d, 1, kind="stable")[:, :2]
    for got in (gi, gi0):
        assert (_i64(got) != oracle).sum() <= 2 * round(0.4 * 200)
    with pytest.raises(ValueError, match="planes must have shape"):
        match.nn_cascading_hash(x, y, m=8, n=16, g=5, planes=np.zeros((2, 144, 8)), device="cpu")


def test_nn_cascading_hash_fallback_small_vs_jax(rng):
    # m auto-tunes below 4 for tiny inputs: the exact brute-force path
    x = normalize_to_ubyte_and_multiple_16_dim(rng.standard_normal((40, 32)).astype("float32"))
    y = normalize_to_ubyte_and_multiple_16_dim(rng.standard_normal((40, 32)).astype("float32"))
    gi, gd, stats = match.nn_cascading_hash(x, y, with_stats=True, device="cpu")
    wi, wd = jmatch.nn_cascading_hash(x, y)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert stats == {"dropped_member_slots": [0]}


def test_nn_cascading_hash_empty_slots_vs_jax(rng):
    # 2^14 buckets for 100 rows and one flipped bit: most probed buckets
    # are empty, and a slot with no candidate has index 0, distance 2^31-1
    x, y = _clustered(rng, 100, 60, 32, n_base=30)
    gi, gd = match.nn_cascading_hash(x, y, m=14, n=1, g=1, planes=_jax_planes(1, 32, 14),
                                     device="cpu")
    wi, wd = jmatch.nn_cascading_hash(x, y, m=14, n=1, g=1)
    empty = gd == np.float32(I32_MAX)
    assert empty.any() and not empty.all()
    assert np.all(gi[empty] == 0)
    assert _same_rows(gi, gd, wi, wd) >= 0.95


# --- k-medians -----------------------------------------------------------------


def test_kmedians_vs_jax_on_its_permutation(rng):
    x = rng.standard_normal((257, 19)).astype("float32")  # odd shapes
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, 257))
    med, assign = match.kmedians(None, x, 7, niter=4, perm=perm, device="cpu")
    jmed, jassign = jax_kmedians(key, jnp.asarray(x), 7, niter=4)
    assert med.dtype == np.float32 and assign.dtype == np.int32
    np.testing.assert_array_equal(assign, np.asarray(jassign))
    np.testing.assert_allclose(med, np.asarray(jmed), rtol=0, atol=1e-6)
    for c in range(7):
        rows = x[assign == c]
        if len(rows):
            np.testing.assert_allclose(med[c], np.median(rows, axis=0), rtol=0, atol=1e-6)


def test_kmedians_empty_cluster_and_own_draw(rng):
    # more clusters than distinct points: some clusters end up empty and
    # take the first row, as in the JAX package
    x = np.repeat(rng.standard_normal((3, 5)).astype("float32"), 4, axis=0)
    key = jax.random.PRNGKey(1)
    perm = np.asarray(jax.random.permutation(key, 12))
    med, assign = match.kmedians(None, x, 6, niter=3, perm=perm, device="cpu")
    jmed, jassign = jax_kmedians(key, jnp.asarray(x), 6, niter=3)
    np.testing.assert_array_equal(assign, np.asarray(jassign))
    np.testing.assert_allclose(med, np.asarray(jmed), rtol=0, atol=1e-6)
    assert len(np.unique(assign)) < 6
    gen = torch.Generator()
    gen.manual_seed(5)
    med2, assign2 = match.kmedians(gen, x, 3, device="cpu")
    assert med2.shape == (3, 5) and set(assign2) <= {0, 1, 2}
    with pytest.raises(ValueError, match="permutation"):
        match.kmedians(None, x, 3, perm=np.arange(5), device="cpu")


def test_nn_kmedians_vs_jax_on_its_permutations(rng):
    xrows = 500
    x = rng.standard_normal((xrows, 132)).astype("float32")
    y = x.copy()
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    perms = (np.asarray(jax.random.permutation(kx, xrows)),
             np.asarray(jax.random.permutation(ky, xrows)))
    gi, gd = match.nn_kmedians(x, y, 2, c=30, perms=perms, device="cpu")
    wi, wd = jmatch.nn_kmedians(x, y, 2, c=30)
    assert gi.dtype == np.uint64 and gd.dtype == np.float32
    # a point at equal float distance from two medians may change cluster
    assert (_i64(gi) == _i64(wi)).mean() >= 0.99
    ok = _i64(gi) == _i64(wi)
    np.testing.assert_allclose(gd[ok], wd[ok], rtol=1e-5)
    bi, _ = match.nn_bruteforce(x, y, k=2, p=1.0, device="cpu")
    assert (_i64(gi) != _i64(bi)).sum() <= 2 * round(0.4 * xrows)
    # the port's own draw stays inside the reference's budget too
    oi, _ = match.nn_kmedians(x, y, 2, c=30, device="cpu")
    assert (_i64(oi) != _i64(bi)).sum() <= 2 * round(0.4 * xrows)


def test_nn_kmedians_query_chunks_agree(rng, monkeypatch):
    x = rng.standard_normal((300, 16)).astype("float32")
    y = rng.standard_normal((120, 16)).astype("float32")
    a = match.nn_kmedians(x, y, 2, c=5, device="cpu")
    # the package's ``kmedians`` attribute is the function, not the module
    module = sys.modules["spectavi_tpu_torch.match.kmedians"]
    monkeypatch.setattr(module, "_BLOCK_ELEMS", 300 * 16 * 7)  # 7 query rows a chunk
    b = match.nn_kmedians(x, y, 2, c=5, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# --- IVF -------------------------------------------------------------------------


def _ivf_inputs(rng, X=4000, Y=1000):
    base = rng.uniform(0, 255, (300, 64))
    x = (base[rng.integers(0, 300, X)] + rng.normal(0, 10, (X, 64))).astype("float32")
    y = (base[rng.integers(0, 300, Y)] + rng.normal(0, 10, (Y, 64))).astype("float32")
    return x, y


def _jax_init(X, n_cells, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), X, shape=(n_cells,),
                                        replace=False))


def test_kmeans_cells_and_probes_vs_jax(rng):
    x, y = _ivf_inputs(rng, 1500, 200)
    n_cells = 40
    cent, assign = match.ivf.kmeans_cells(x, None, n_cells, iters=5,
                                          init=_jax_init(1500, n_cells), device="cpu")
    jcent, jassign = jax_kmeans_cells(jnp.asarray(x), jax.random.PRNGKey(0), n_cells, 5)
    assert cent.dtype == np.float32 and assign.dtype == np.int32
    # a row at equal float distance from two centroids may change cell
    assert (assign == np.asarray(jassign)).mean() >= 0.995
    np.testing.assert_allclose(cent, np.asarray(jcent), rtol=1e-3, atol=0.5)
    probes = ivf.probe_cells(y, np.asarray(jcent), 8, device="cpu")
    jprobes = np.asarray(jmatch.ivf.probe_cells(jnp.asarray(y), jcent, 8))
    assert probes.shape == (200, 8)
    assert (probes == jprobes).mean() >= 0.995


def test_nn_ivf_vs_jax_on_its_initial_rows(rng):
    x, y = _ivf_inputs(rng)
    n_cells = int(min(max(16, 4.0 * np.sqrt(4000)), 4000 // 8 + 1))
    gi, gd = match.nn_ivf(x, y, k=2, init=_jax_init(4000, n_cells), device="cpu")
    wi, wd = jmatch.nn_ivf(x, y, k=2)
    assert gi.dtype == np.uint64 and gd.dtype == np.float32
    # cells can differ by the rows that sit between two centroids
    assert (_i64(gi) == _i64(wi)).mean() >= 0.98
    ok = np.all(_i64(gi) == _i64(wi), axis=1)
    np.testing.assert_allclose(gd[ok], wd[ok], rtol=1e-3, atol=1.0)
    d = ((x[None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    oracle = np.argsort(d, 1, kind="stable")[:, :2]
    assert (_i64(gi) != oracle).sum() <= 2 * round(0.3 * 1000)
    assert np.isfinite(gd).all() and np.all(gd[:, 0] <= gd[:, 1])


def test_nn_ivf_exhaustive_probe_is_exact(rng, monkeypatch):
    x = rng.standard_normal((500, 32)).astype("float32")
    y = rng.standard_normal((200, 32)).astype("float32")
    d = ((x[None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    oracle = np.argsort(d, 1, kind="stable")[:, :2]
    gen = torch.Generator()
    gen.manual_seed(1)
    gi, _ = match.nn_ivf(x, y, k=2, n_cells=16, n_probe=16, generator=gen, device="cpu")
    np.testing.assert_array_equal(_i64(gi), oracle)
    # a few cells at a time give the same answer
    monkeypatch.setattr(ivf, "_BLOCK_ELEMS", 1 << 14)
    gi2, _ = match.nn_ivf(x, y, k=2, n_cells=16, n_probe=16, device="cpu")
    np.testing.assert_array_equal(_i64(gi2), oracle)


def test_nn_ivf_empty_slots_vs_jax(rng):
    # one probe into cells of one or two members: a second slot with no
    # candidate has index 0 and distance inf
    x = rng.standard_normal((16, 8)).astype("float32")
    y = rng.standard_normal((30, 8)).astype("float32")
    gi, gd = match.nn_ivf(x, y, k=2, n_cells=12, n_probe=1, init=_jax_init(16, 12), device="cpu")
    wi, wd = jmatch.nn_ivf(x, y, k=2, n_cells=12, n_probe=1)
    empty = ~np.isfinite(gd)
    assert empty[:, 1].any() and not empty[:, 0].any()
    assert np.all(gi[empty] == 0)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-4)


# --- the package ---------------------------------------------------------------------


def test_match_exports_what_the_jax_package_exports():
    names = ["ann", "ann_hnswlib", "l1_topk2_xla", "nn_bruteforce", "nn_bruteforcel1k2",
             "nn_l2k2", "nn_cascading_hash", "nn_ivf", "kmedians", "nn_kmedians"]
    for name in names:
        assert callable(getattr(jmatch, name)) and callable(getattr(match, name)), name


# --- the JAX package's positional call forms -------------------------------------


def _seeded(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_jax_positional_forms_equal_keyword_calls(rng):
    # JAX: kmedians(key, x, k, niter), kmeans_cells(x, key, n_cells, iters),
    # nn_cascading_hash(x, y, k, m, n, g, key, chunk); a generator takes the
    # key's place and the same seed gives the keyword call's answer
    x = rng.standard_normal((120, 12)).astype("float32")
    pos = match.kmedians(_seeded(4), x, 5, 3, device="cpu")
    kw = match.kmedians(generator=_seeded(4), x=x, k=5, niter=3, device="cpu")
    for a, b in zip(pos, kw):
        np.testing.assert_array_equal(a, b)
    pos = ivf.kmeans_cells(x, _seeded(5), 9, 4, device="cpu")
    kw = ivf.kmeans_cells(x=x, generator=_seeded(5), n_cells=9, iters=4, device="cpu")
    for a, b in zip(pos, kw):
        np.testing.assert_array_equal(a, b)
    hx, hy = _clustered(rng, 300, 200, 32)
    pos = match.nn_cascading_hash(hx, hy, 2, 6, 4, 3, _seeded(6), 64, device="cpu")
    kw = match.nn_cascading_hash(hx, hy, k=2, m=6, n=4, g=3, generator=_seeded(6), chunk=64,
                                 device="cpu")
    for a, b in zip(pos, kw):
        np.testing.assert_array_equal(a, b)
    # a generator of another seed draws other clusters
    other = match.kmedians(_seeded(9), x, 5, 3, device="cpu")
    assert not np.array_equal(other[1], match.kmedians(_seeded(4), x, 5, 3, device="cpu")[1])

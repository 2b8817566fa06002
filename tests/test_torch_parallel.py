"""Port parity for the distribution layer: ``spectavi_tpu_torch.parallel``
on ``torch.distributed`` against ``spectavi_tpu.parallel`` on the
virtual 8-device CPU mesh.

One module-scoped job of four gloo ranks (four OS processes that meet
through a ``file://`` rendezvous in the test's directory and import
only torch, numpy and the port) runs every check of this file and
writes each rank's outputs; the tests compare them with JAX's
``host_cpu_mesh(4, ...)`` results and with one process's answers:

* ``sharded_l1_topk2`` / ``sharded_l2_topk2`` on meshes ``(1, 4)`` and
  ``(2, 2)``, called as JAX calls them (the whole database on every
  rank, as a tensor and as a host numpy array), bit for bit, on databases full of ties (duplicated rows, equal
  rows in different blocks); a database that does not split over the
  blocks raises;
* the ``(2, 2)`` masked two-view step on 4 padded pairs with a compaction cap
  that engages, handed JAX's sample tables: nearest rows, ratio masks,
  counts and inlier masks identical, E and camera to 1e-9.  On
  ``(2, 2)`` a rank's global rank is not its ``blocks`` coordinate, so
  a merge that offset the indices by the global rank would fail;
* the mesh shapes and coordinates, and the errors of a world too small.

A second job of two ranks runs ``initialize`` + ``local_device_slice``,
as ``tests/test_hosts.py`` does for the JAX package.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sfm import _pair_inputs, jax_step_tables

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = jnp.asarray

STEP_KW = dict(trials=256, reproj_allowed=3.35e-3, svr_allowed=1e-3, min_ratio=1.2,
               compact_to=128)

PREAMBLE = r"""
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch

torch.set_num_threads(1)
rank = int(sys.argv[1])
from spectavi_tpu_torch.parallel import initialize

initialize(%(rdv)r, %(world)d, rank, backend="gloo")
inp = dict(np.load(%(inp)r))
out = {}
"""

WORKER = r"""
from spectavi_tpu_torch.parallel import (BLOCKS, PAIRS, gather_pairs, host_cpu_mesh,
                                         make_two_view_step, sharded_l1_topk2,
                                         sharded_l2_topk2)

T = torch.as_tensor
for nb in (4, 2):
    mesh = host_cpu_mesh(4, n_blocks=nb)
    out[f"mesh_{nb}"] = np.array([mesh.shape[PAIRS], mesh.shape[BLOCKS], mesh.coords[PAIRS],
                                  mesh.coords[BLOCKS]])
    for name, fn in (("l1", sharded_l1_topk2), ("l2", sharded_l2_topk2)):
        # JAX's call: the whole database on every rank
        x, y = T(inp[name + "_x"]), T(inp[name + "_y"])
        idx, dist = fn(mesh, x, y)
        out[f"{name}_{nb}_idx"], out[f"{name}_{nb}_dist"] = idx.numpy(), dist.numpy()
        # the whole database as a host numpy array: only the block is moved
        idx, dist = fn(mesh, inp[name + "_x"], inp[name + "_y"])
        out[f"{name}_{nb}_host_idx"], out[f"{name}_{nb}_host_dist"] = idx.numpy(), dist.numpy()
        try:  # a database that does not split over the blocks
            fn(mesh, x[: x.shape[0] - 1], y)
            out[f"{name}_{nb}_ragged"] = np.array("none")
        except ValueError as e:
            out[f"{name}_{nb}_ragged"] = np.array(str(e))

mesh = host_cpu_mesh(4, n_blocks=2)
step = make_two_view_step(mesh, masked=True, **%(kw)r)
args = [T(inp[k]) for k in ("d0", "d1", "p0", "p1")]
counts = (inp["nx"], inp["ny"])
local = step(*args, None, *counts, sample=inp["tables"])
out["local_count"] = local[2].numpy()
for k, v in zip(("E", "P1", "count", "inl", "midx0", "ratio_ok"), gather_pairs(mesh, local)):
    out["step_" + k] = v.numpy()
# the step's own draws: the ranks of a blocks group agree on the same seed
gen = torch.Generator()
gen.manual_seed(7 + mesh.coords[PAIRS])
own = step(*args, gen, *counts)
out["own_count"], out["own_inl"] = own[2].numpy(), own[3].numpy()
try:
    host_cpu_mesh(8)
    out["too_small"] = np.array("none")
except RuntimeError:
    out["too_small"] = np.array("RuntimeError")
"""

EPILOGUE = r"""
# the ranks run the port alone
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "spectavi_tpu")]
np.savez(%(out)r + f"/rank{rank}.npz", **out)
print(f"rank{rank} done", flush=True)
"""


def run_ranks(tmp, body, world, inputs, subs=None, timeout=600):
    """Run ``body`` (a worker script fragment) in ``world`` gloo ranks
    that rendezvous through a file in ``tmp`` and read ``inputs`` from
    an npz; returns each rank's ``out`` dict.  The ranks get this
    process's environment, which ``tests/conftest.py`` has scrubbed, and
    are killed when ``timeout`` seconds pass."""
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    params = {"repo": ROOT, "rdv": "file://" + os.path.join(tmp, "rendezvous"),
              "world": world, "inp": os.path.join(tmp, "inputs.npz"), "out": str(tmp)}
    params.update(subs or {})
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write((PREAMBLE + body + EPILOGUE) % params)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def _tie_tables(rng):
    """Byte databases whose rows repeat (within a block and across
    blocks) and queries that copy or perturb them: top-2 full of
    ties."""
    base = rng.integers(0, 256, (48, 128))
    x2 = base[rng.integers(0, 48, 512)]
    y2 = np.concatenate([base[rng.integers(0, 48, 60)],
                         np.clip(base[rng.integers(0, 48, 40)] + rng.integers(-3, 4, (40, 128)),
                                 0, 255)])
    small = rng.integers(0, 4, (24, 32))
    x1 = small[rng.integers(0, 24, 512)]
    y1 = rng.integers(0, 4, (100, 32))
    return {"l1_x": x1.astype(np.int32), "l1_y": y1.astype(np.int32),
            "l2_x": x2.astype(np.uint8), "l2_y": y2.astype(np.uint8)}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    rng = np.random.default_rng(0xDEADBEEF)
    inputs = _tie_tables(rng)
    d0, d1, p0, p1, nx, ny = _pair_inputs(rng, B=4)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    inputs.update(d0=d0, d1=d1, p0=p0, p1=p1, nx=nx, ny=ny,
                  tables=jax_step_tables(d0, d1, keys, STEP_KW["trials"], STEP_KW["compact_to"],
                                         STEP_KW["min_ratio"], nx, ny))
    outs = run_ranks(str(tmp_path_factory.mktemp("parallel")), WORKER, 4, inputs,
                     {"kw": STEP_KW})
    return inputs, keys, outs


@pytest.mark.parametrize("n_blocks", [4, 2], ids=["1x4", "2x2"])
@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_sharded_topk2_vs_jax(job, metric, n_blocks):
    from spectavi_tpu.match.bruteforce import l1_topk2_xla
    from spectavi_tpu.ops.l2nn import l2_topk2
    from spectavi_tpu.parallel import host_cpu_mesh, sharded_l1_topk2, sharded_l2_topk2

    inputs, _, outs = job
    x, y = J(inputs[metric + "_x"]), J(inputs[metric + "_y"])
    sharded, local = ((sharded_l1_topk2, l1_topk2_xla) if metric == "l1"
                      else (sharded_l2_topk2, l2_topk2))
    ri, rd = (np.asarray(a) for a in sharded(host_cpu_mesh(4, n_blocks=n_blocks), x, y))
    li, ld = (np.asarray(a) for a in local(x, y))
    np.testing.assert_array_equal(ri, li)
    np.testing.assert_array_equal(rd, ld)
    # the data is full of ties: equal first and second distances
    assert (ld[:, 0] == ld[:, 1]).sum() >= 10
    for out in outs:  # every rank holds the global answer
        np.testing.assert_array_equal(out[f"{metric}_{n_blocks}_idx"], ri)
        np.testing.assert_array_equal(out[f"{metric}_{n_blocks}_dist"], rd)
        assert out[f"{metric}_{n_blocks}_idx"].max() < x.shape[0]  # rows of the whole table
        np.testing.assert_array_equal(out[f"{metric}_{n_blocks}_host_idx"], ri)
        np.testing.assert_array_equal(out[f"{metric}_{n_blocks}_host_dist"], rd)
        assert "does not split" in str(out[f"{metric}_{n_blocks}_ragged"])


def test_mesh_coordinates(job):
    _, _, outs = job
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["mesh_4"], [1, 4, 0, r])
        np.testing.assert_array_equal(out["mesh_2"], [2, 2, r // 2, r % 2])
        assert str(out["too_small"]) == "RuntimeError"


def test_mesh_step_vs_jax(job):
    from spectavi_tpu.parallel import host_cpu_mesh, make_two_view_step

    inputs, keys, outs = job
    d0, d1, p0, p1, nx, ny = (inputs[k] for k in ("d0", "d1", "p0", "p1", "nx", "ny"))
    ref = make_two_view_step(host_cpu_mesh(4, n_blocks=2), masked=True, **STEP_KW)(
        J(d0), J(d1), J(p0), J(p1), keys, J(nx), J(ny))
    E, P1, count, inl, midx0, ratio_ok = (np.asarray(a) for a in ref)
    assert (ratio_ok.sum(1) > STEP_KW["compact_to"]).all()  # the compaction cap engaged
    assert (count > 0).all()
    assert (midx0 >= 128).any()  # matches into the second block of database rows
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["step_midx0"], midx0)
        np.testing.assert_array_equal(out["step_ratio_ok"], ratio_ok)
        np.testing.assert_array_equal(out["step_count"], count)
        np.testing.assert_array_equal(out["step_inl"], inl)
        np.testing.assert_allclose(out["step_E"], E, atol=1e-9)
        np.testing.assert_allclose(out["step_P1"], P1, atol=1e-9)
        # a rank returns its own pairs: the pairs coordinate's half
        np.testing.assert_array_equal(out["local_count"], count[2 * (r // 2): 2 * (r // 2) + 2])


def test_mesh_step_generator_agrees_within_blocks(job):
    _, _, outs = job
    for a, b in ((0, 1), (2, 3)):  # the two ranks of each blocks group
        np.testing.assert_array_equal(outs[a]["own_count"], outs[b]["own_count"])
        np.testing.assert_array_equal(outs[a]["own_inl"], outs[b]["own_inl"])
    for out in outs:
        assert (out["own_count"] > 0).all()
        assert (out["own_inl"].sum(1) > 0).all()


def test_make_mesh_raises(monkeypatch):
    from spectavi_tpu_torch.parallel import host_cpu_mesh, make_mesh

    # no world in this process: nothing to build a mesh over
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        host_cpu_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(device_type="cuda")


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_sharded_topk2_moves_only_the_block(monkeypatch, metric):
    from spectavi_tpu_torch.parallel import two_view
    from spectavi_tpu_torch.parallel.mesh import BLOCKS, PAIRS, Mesh

    mesh = Mesh(shape={PAIRS: 1, BLOCKS: 4}, coords={PAIRS: 0, BLOCKS: 2}, groups={},
                device=torch.device("cpu"))
    seen = {}

    def merge(mesh_, x_block, y, kernel):
        seen["block"], seen["y"] = x_block, y
        return "merged"

    monkeypatch.setattr(two_view, "_sharded_topk2", merge)
    x = np.arange(16 * 8, dtype=np.uint8).reshape(16, 8)  # the whole table, on the host
    fn = two_view.sharded_l1_topk2 if metric == "l1" else two_view.sharded_l2_topk2
    assert fn(mesh, x, x[:3]) == "merged"
    # the kernel sees a tensor on the mesh's device holding this rank's 4 rows only
    assert isinstance(seen["block"], torch.Tensor) and seen["block"].device == mesh.device
    np.testing.assert_array_equal(seen["block"].numpy(), x[8:12])
    assert isinstance(seen["y"], torch.Tensor)
    with pytest.raises(ValueError, match="does not split"):
        fn(mesh, x[:15], x[:3])


def test_local_shard():
    from spectavi_tpu_torch.parallel.mesh import BLOCKS, PAIRS, Mesh, local_shard

    mesh = Mesh(shape={PAIRS: 2, BLOCKS: 4}, coords={PAIRS: 1, BLOCKS: 2}, groups={},
                device=torch.device("cpu"))
    a = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    np.testing.assert_array_equal(local_shard(mesh, a, PAIRS), a[2:4])
    np.testing.assert_array_equal(local_shard(mesh, a.numpy(), BLOCKS, dim=1), a[:, 4:6])
    with pytest.raises(ValueError, match="does not split"):
        local_shard(mesh, a, BLOCKS, dim=2)


HOSTS_WORKER = r"""
import torch.distributed as tdist

from spectavi_tpu_torch.parallel import local_device_slice

initialize(%(rdv)r, 2, rank, backend="gloo")  # a second call is a no-op
assert tdist.get_world_size() == 2 and tdist.get_rank() == rank
full = np.arange(8, dtype=np.float32) + 1.0
sl = local_device_slice(8)
total = torch.as_tensor(full[sl]).sum()
tdist.all_reduce(total)
out["slice"] = np.array([sl.start, sl.stop])
out["total"] = total.numpy()
"""


def test_two_process_initialize_and_slice(tmp_path):
    from spectavi_tpu_torch.parallel import local_device_slice

    assert local_device_slice(8) == slice(0, 8)  # one process owns everything
    outs = run_ranks(str(tmp_path), HOSTS_WORKER, 2, {"unused": np.zeros(1)})
    np.testing.assert_array_equal(outs[0]["slice"], [0, 4])
    np.testing.assert_array_equal(outs[1]["slice"], [4, 8])
    for out in outs:
        assert float(out["total"]) == 36.0

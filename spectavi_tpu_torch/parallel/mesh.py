"""Process meshes for multi-card / multi-host SfM over ``torch.distributed``.

Port of ``spectavi_tpu/parallel/mesh.py``.  JAX puts every device of
the job in one program and names the axes of a ``Mesh``; PyTorch runs
one process per card, so a mesh here is a ``(pairs, blocks)`` grid of
the ranks of the initialized world, with a process group for each
dimension:

* ``"pairs"``  — data parallelism over image pairs: the ranks of one
  ``pairs`` group hold the same block of different pairs;
* ``"blocks"`` — model parallelism over descriptor blocks within one
  pair: the ranks of one ``blocks`` group hold different blocks of the
  same pairs, and merge their partial top-2 lists with an all-gather.

Rank ``r`` sits at ``(r // n_blocks, r % n_blocks)``.  A group's ranks
are in ascending order, so a rank's position in its ``blocks`` group
is its ``blocks`` coordinate, and an all-gather over the group lists
the blocks in coordinate order.  The collectives are NCCL on CUDA
tensors and gloo on CPU tensors unless the caller names a backend
(gloo also takes CUDA tensors, which is how several ranks share one
card: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as tdist

from spectavi_tpu_torch import resolve_device

PAIRS = "pairs"
BLOCKS = "blocks"

_DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """A ``(pairs, blocks)`` grid of ranks: ``shape`` and this rank's
    ``coords`` by axis name, the process ``groups`` of this rank's row
    and column, and the ``device`` its tensors live on."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device


def _rank_device(dev):
    if dev.type != "cuda" or dev.index is not None:
        return dev
    # one process per card: torchrun's local rank picks the card; ranks
    # beyond the card count share them (gloo only)
    local = int(os.environ.get("LOCAL_RANK", tdist.get_rank()))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(n_pairs=None, n_blocks=None, device_type="cuda", backend=None):
    """Build a ``(pairs, blocks)`` mesh over the ranks of the initialized
    world (:func:`spectavi_tpu_torch.parallel.hosts.initialize`).

    Defaults put every rank on the ``pairs`` axis (pure data
    parallelism); pass ``n_blocks`` to split each pair's matching across
    ranks.  ``device_type`` is where this rank's tensors live (``"cuda"``
    raises without CUDA); ``backend`` is the collectives' (NCCL for
    ``"cuda"``, gloo for ``"cpu"`` by default).  Every rank must make
    the same meshes in the same order: each makes one process group a
    row and one a column."""
    dev = resolve_device(device_type)
    if not tdist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "spectavi_tpu_torch.parallel.initialize first")
    dev = _rank_device(dev)
    n = tdist.get_world_size()
    if n_pairs is None and n_blocks is None:
        n_pairs, n_blocks = n, 1
    elif n_pairs is None:
        n_pairs = n // n_blocks
    elif n_blocks is None:
        n_blocks = n // n_pairs
    if n_pairs * n_blocks != n:
        raise ValueError(f"a {n_pairs} x {n_blocks} mesh does not cover the {n} ranks")
    backend = backend or _DEFAULT_BACKEND[dev.type]
    rank = tdist.get_rank()
    groups = {}
    for p in range(n_pairs):
        g = tdist.new_group([p * n_blocks + b for b in range(n_blocks)], backend=backend)
        if p == rank // n_blocks:
            groups[BLOCKS] = g
    for b in range(n_blocks):
        g = tdist.new_group([p * n_blocks + b for p in range(n_pairs)], backend=backend)
        if b == rank % n_blocks:
            groups[PAIRS] = g
    return Mesh(shape={PAIRS: n_pairs, BLOCKS: n_blocks},
                coords={PAIRS: rank // n_blocks, BLOCKS: rank % n_blocks},
                groups=groups, device=dev)


def host_cpu_mesh(n_devices, n_blocks=1):
    """A gloo mesh of ``n_devices`` CPU ranks (``n_devices / n_blocks``
    by ``n_blocks``) for tests and dry runs: the world must have been
    initialized with ``n_devices`` ranks."""
    have = tdist.get_world_size() if tdist.is_initialized() else 1
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the world has {have}; start "
                           "that many processes and initialize them")
    return make_mesh(n_pairs=n_devices // n_blocks, n_blocks=n_blocks, device_type="cpu")


def local_shard(mesh, a, name, dim=0):
    """This rank's part of ``a`` (a tensor or numpy array) split evenly
    along ``dim`` over the mesh axis ``name``: the counterpart of
    placing ``a`` with a ``PartitionSpec`` that names ``name`` on that
    dimension."""
    n, c = mesh.shape[name], mesh.coords[name]
    size = a.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split over {n} {name}")
    per = size // n
    return a[(slice(None),) * dim + (slice(c * per, (c + 1) * per),)]


def all_gather(t, group):
    """The tensors ``t`` of every rank of ``group``, stacked along a new
    first dimension in rank order.  Booleans travel as bytes."""
    n = tdist.get_world_size(group)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(out, src, group=group)
    out = torch.stack(out)
    return out.bool() if t.dtype == torch.bool else out


def all_reduce_sum(group):
    """A reduction hook for the bundle adjuster: ``reduce(t)`` sums a
    tensor, or a tuple of tensors of one dtype, over ``group`` with one
    ``all_reduce`` of a flat buffer, and returns the same structure as
    new tensors of their own (the inputs are left as they were)."""

    def reduce(ts):
        single = isinstance(ts, torch.Tensor)
        ts = (ts,) if single else tuple(ts)
        flat = torch.cat([t.reshape(-1) for t in ts])
        tdist.all_reduce(flat, group=group)
        if single:
            return flat.reshape(ts[0].shape)
        # each part in its own allocation, laid out as a fresh tensor
        return tuple(f.reshape(t.shape).clone()
                     for f, t in zip(flat.split([t.numel() for t in ts]), ts))

    return reduce

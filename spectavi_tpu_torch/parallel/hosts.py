"""Multi-process initialization helpers.

Port of ``spectavi_tpu/parallel/hosts.py``.  JAX runs one process per
host, each driving every chip of its host; PyTorch runs one process per
GPU.  Call :func:`initialize` once in every process before any other
distributed work; the meshes of :mod:`spectavi_tpu_torch.parallel.mesh`
then span every rank of every host.  Under ``torchrun`` the defaults
read its environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``)::

    torchrun --nproc-per-node 4 my_script.py
"""

from __future__ import annotations

import torch.distributed as tdist


def initialize(coordinator_address=None, num_processes=None, process_id=None, backend=None):
    """Initialize ``torch.distributed`` (a no-op when it already is).

    ``coordinator_address``: ``"host:port"`` (rendezvous over TCP) or a
    full init URL such as ``"file:///path"``; with every argument None
    the rendezvous is ``env://``, torchrun's variables.
    ``num_processes`` and ``process_id`` are the world size and this
    process's rank.  ``backend`` is passed on as it is (None: PyTorch's
    default, gloo for CPU tensors and NCCL for CUDA tensors where
    available)."""
    if tdist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    tdist.init_process_group(backend=backend, init_method=init_method,
                             world_size=-1 if num_processes is None else num_processes,
                             rank=-1 if process_id is None else process_id)


def local_device_slice(arr_len):
    """Index range of a globally sharded leading axis owned by this
    process (for host-side sharded loading of images).  Torch runs one
    process per GPU, so this is the rank's share: the world size and
    the rank take the place of JAX's process count and index; one
    process without ``torch.distributed`` owns everything."""
    n = tdist.get_world_size() if tdist.is_initialized() else 1
    i = tdist.get_rank() if tdist.is_initialized() else 0
    per = arr_len // n
    start = i * per
    end = arr_len if i == n - 1 else start + per
    return slice(start, end)

"""Brute-force matchers (port of ``spectavi_tpu/match/bruteforce.py``;
only ``nn_l2k2`` so far)."""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device


def nn_l2k2(x, y, device="cuda"):
    """Exact top-2 squared-L2 matcher on byte descriptors: numpy
    ``(X, D)``, ``(Y, D)`` uint8/int8 in, ``(idx (Y, 2) uint64,
    dist2 (Y, 2) int32)`` numpy out (the CUDA kernel on ``cuda``)."""
    from spectavi_tpu_torch.ops.l2nn import l2_topk2

    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    assert x.shape[1] == y.shape[1]
    idx, dist = l2_topk2(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
    return idx.cpu().numpy().astype(np.uint64), dist.cpu().numpy().astype(np.int32)

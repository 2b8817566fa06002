"""Descriptor quantization for byte matching.

Port of ``spectavi_tpu/features/normalize.py``: center each column,
scale symmetrically into the int8 range, round, and pad the feature
dimension to a multiple of 16.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_to_ubyte_and_multiple_16_dim(x, dtype="float32"):
    """Host quantizer (numpy in, numpy out): center, scale to
    [-128, 127], round half to even, 16-pad columns with zeros."""
    xf = np.asarray(x, np.float32)
    centered = xf - xf.mean(0, dtype=np.float64).astype(np.float32)
    span = np.abs(np.stack([centered.max(0), centered.min(0)])).max(0)
    span = np.maximum(span, np.finfo(np.float32).tiny)
    quant = np.clip(np.rint(centered * (128.0 / span)), -128, 127)
    rows, dim = quant.shape
    out = np.zeros((rows, -(-dim // 16) * 16), dtype=dtype)
    out[:, :dim] = quant
    return out


def normalize_to_ubyte_device(x):
    """Tensor twin of :func:`normalize_to_ubyte_and_multiple_16_dim`
    with the matcher's ``+128`` offset fused in: ``(n, d)`` float
    tensor in, ``(n, 16-padded d)`` uint8 tensor on the same device out
    (padding columns hold 128).  The column mean accumulates in float64,
    as the host quantizer's does."""
    xf = x.to(torch.float32)
    mean = xf.to(torch.float64).mean(0).to(torch.float32)
    centered = xf - mean
    span = torch.clamp(
        torch.maximum(centered.amax(0), -centered.amin(0)),
        min=float(np.finfo(np.float32).tiny),
    )
    quant = torch.clamp(torch.round(centered * (128.0 / span)), -128, 127)
    pad = (-quant.shape[1]) % 16
    out = torch.nn.functional.pad(quant + 128.0, (0, pad), value=128.0)
    return out.to(torch.uint8)

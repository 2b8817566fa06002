"""Port parity: the L2 top-2 matcher (plain version of the CUDA kernel
``csrc/l2nn_top2.cu``) and descriptor quantization, against the JAX
package on the same numpy inputs.

The matcher's outputs are integers, so agreement is bit-exact in both
``idx`` and ``dist2``, ties included (lower database index first); the
JAX side runs the Pallas kernel in interpret mode and the portable XLA
path.  Quantization is bit-exact under x64, where both sides accumulate
the column mean in float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectavi_tpu.features.normalize import (
    normalize_to_ubyte_and_multiple_16_dim as jax_quant_host,
    normalize_to_ubyte_device as jax_quant_device,
)
from spectavi_tpu.ops.l2nn import l2_topk_mxu as jax_l2_topk_mxu
from spectavi_tpu.ops.l2nn_pallas import l2_topk2_fused
from spectavi_tpu_torch.features.normalize import (
    normalize_to_ubyte_and_multiple_16_dim,
    normalize_to_ubyte_device,
)
from spectavi_tpu_torch.match import nn_l2k2
from spectavi_tpu_torch.ops.l2nn import l2_topk2, l2_topk_mxu

torch.set_num_threads(2)


def _descs(rng, X, Y, D, dtype, dup=False):
    if dtype == np.uint8:
        x = rng.integers(0, 256, (X, D)).astype(np.uint8)
        y = rng.integers(0, 256, (Y, D)).astype(np.uint8)
    else:
        x = rng.integers(-128, 128, (X, D)).astype(np.int8)
        y = rng.integers(-128, 128, (Y, D)).astype(np.int8)
    if dup:
        # few distinct rows: duplicated database rows tie exactly
        x = x[rng.integers(0, 17, X) % X]
        y = x[rng.integers(0, X, Y)]
    return x, y


@pytest.mark.parametrize(
    "X,Y,D,dtype,dup",
    [
        (300, 130, 128, np.uint8, False),
        (517, 96, 144, np.uint8, False),
        (260, 70, 160, np.int8, False),
        (300, 64, 144, np.uint8, True),
        (270, 50, 128, np.int8, True),
    ],
)
def test_l2_topk2_bitexact_vs_pallas_interpret(rng, X, Y, D, dtype, dup):
    x, y = _descs(rng, X, Y, D, dtype, dup)
    ij, dj = l2_topk2_fused(jnp.asarray(x), jnp.asarray(y), interpret=True)
    it, dt = l2_topk2(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert it.dtype == torch.int32 and dt.dtype == torch.int32


@pytest.mark.parametrize("dtype,dup", [(np.uint8, False), (np.int8, True)])
def test_l2_topk_mxu_bitexact_vs_xla(rng, dtype, dup):
    x, y = _descs(rng, 333, 77, 144, dtype, dup)
    ij, dj = jax_l2_topk_mxu(jnp.asarray(x), jnp.asarray(y), k=3)
    it, dt = l2_topk_mxu(torch.as_tensor(x), torch.as_tensor(y), k=3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_l2_topk2_rejects_wide_types_and_mixed_dtypes(rng):
    x = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        l2_topk2(x, x)
    with pytest.raises(TypeError):
        l2_topk2(torch.zeros((4, 16), dtype=torch.uint8), torch.zeros((4, 16), dtype=torch.int8))


def test_nn_l2k2_contract(rng):
    x, y = _descs(rng, 200, 40, 144, np.uint8)
    idx, dist = nn_l2k2(x, y, device="cpu")
    assert idx.dtype == np.uint64 and dist.dtype == np.int32
    full = ((y[:, None, :].astype(np.int64) - x[None].astype(np.int64)) ** 2).sum(-1)
    np.testing.assert_array_equal(dist[:, 0], full.min(1))
    np.testing.assert_array_equal(idx[:, 0], full.argmin(1))


def _rows(rng, n):
    # SIFT-like 132-col rows: float meta columns + integer descriptor bytes
    meta = np.stack(
        [rng.uniform(0, 640, n), rng.uniform(0, 480, n), rng.uniform(1, 12, n),
         rng.uniform(0, 2 * np.pi, n)], 1
    )
    desc = rng.integers(0, 256, (n, 128)) * (rng.random((n, 128)) < 0.6)
    return np.concatenate([meta, desc], 1).astype(np.float32)


def test_host_quantizer_bitexact(rng):
    x = _rows(rng, 777)
    np.testing.assert_array_equal(normalize_to_ubyte_and_multiple_16_dim(x), jax_quant_host(x))


def test_device_quantizer_bitexact(rng):
    x = _rows(rng, 901)
    want = np.asarray(jax_quant_device(jnp.asarray(x)))
    got = normalize_to_ubyte_device(torch.as_tensor(x))
    assert got.dtype == torch.uint8 and got.shape == (901, 144)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same bytes as the host quantizer plus the +128 offset
    np.testing.assert_array_equal(
        got.numpy(), (normalize_to_ubyte_and_multiple_16_dim(x) + 128).astype(np.uint8)
    )

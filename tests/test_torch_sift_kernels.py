"""Port parity: the plain versions of the SIFT kernels (orientation
histograms, ``csrc/sift_orient.cu``; descriptors, ``csrc/sift_desc.cu``)
against the JAX package's Pallas kernels in interpret mode and against
its XLA route (``orientations``, ``descriptors``).

The inputs are those of ``tests/test_sift.py``'s kernel tests, where
every window lies inside the Pallas patch, so both sides sum the same
pixels.  Tolerance: atol 2e-5 relative to each row's maximum (float32
sums of up to ~10^4 terms in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spectavi_tpu.features import sift as jsift
from spectavi_tpu.ops import sift_orient as jorient
from spectavi_tpu_torch.features import sift
from spectavi_tpu_torch.features.sift import _R_OR, _r_desc
from spectavi_tpu_torch.ops import sift_desc, sift_orient

torch.set_num_threads(2)


def _rel_close(got, want, valid):
    for k in range(want.shape[0]):
        if valid[k]:
            scale = max(np.abs(want[k]).max(), 1e-9)
            np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=2e-5)
        else:
            assert np.all(got[k] == 0.0)


def _orient_inputs(rng):
    S, H, W = 2, 64, 384
    mod = rng.random((S, H, W)).astype(np.float32)
    ang = (rng.random((S, H, W)) * 2 * np.pi).astype(np.float32)
    K = 7
    ky = rng.uniform(25, H - 25, K).astype(np.float32)
    kx = rng.uniform(30, W - 30, K).astype(np.float32)
    sig = rng.uniform(1.5, 3.0, K).astype(np.float32)
    lvl = rng.integers(0, S, K).astype(np.int32)
    val = np.ones(K, np.int32)
    val[-1] = 0
    return mod, ang, kx, ky, sig, lvl, val


def _pallas_orient(mod, ang, kx, ky, sig, lvl, val):
    so = jorient
    H, W = mod.shape[1:]
    K = kx.shape[0]
    yi = np.clip((np.round(ky).astype(np.int32) - so.PATCH_R // 2) & ~7, 0, H - so.PATCH_R)
    xi = np.clip((np.round(kx).astype(np.int32) - 19) & ~127, 0, W - so.PATCH_C)
    Kp = K + ((-K) % so.KB)
    pad = lambda a, f: np.concatenate([a, np.full(Kp - K, f, a.dtype)])
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=7,
        grid=(Kp // so.KB,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY), pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec((so.KB, 128), lambda g, *_: (g, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((2, so.PATCH_R, so.PATCH_C), jnp.float32),
            pltpu.VMEM((2, so.PATCH_R, so.PATCH_C), jnp.float32),
            pltpu.SemaphoreType.DMA((2, 2)),
        ],
    )
    call = pl.pallas_call(
        so._orient_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((Kp, 128), jnp.float32), interpret=True,
    )
    return np.asarray(call(
        jnp.asarray(pad(yi, 0)), jnp.asarray(pad(xi, 0)), jnp.asarray(pad(lvl, 0)),
        jnp.asarray(pad(ky, 0)), jnp.asarray(pad(kx, 0)), jnp.asarray(pad(sig, 1.0)),
        jnp.asarray(pad(val, 0)), jnp.asarray(mod), jnp.asarray(ang),
    ))[:K, :36]


def _torch_args(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_orient_hist_plain_vs_pallas_interpret(rng):
    mod, ang, kx, ky, sig, lvl, val = _orient_inputs(rng)
    want = _pallas_orient(mod, ang, kx, ky, sig, lvl, val)
    got = sift_orient.orient_hist(
        *_torch_args(mod, ang, kx, ky, sig, lvl), torch.as_tensor(val > 0), _R_OR
    ).numpy()
    assert got.shape == (kx.shape[0], 36)
    _rel_close(got, want, val)


def test_orientations_vs_xla_route(rng):
    mod, ang, kx, ky, sig, lvl, val = _orient_inputs(rng)
    th_j, av_j = jsift.orientations(
        jnp.asarray(mod), jnp.asarray(ang), jnp.asarray(kx), jnp.asarray(ky),
        jnp.asarray(sig), jnp.asarray(lvl), jnp.asarray(val > 0), _R_OR,
    )
    valid = torch.as_tensor(val > 0)
    th, av = sift.orientations(*_torch_args(mod, ang, kx, ky, sig, lvl), valid, _R_OR)
    np.testing.assert_array_equal(av.numpy(), np.asarray(av_j))
    np.testing.assert_allclose(
        np.where(av.numpy(), th.numpy(), 0), np.where(np.asarray(av_j), np.asarray(th_j), 0),
        atol=1e-4,
    )


def _desc_inputs(rng, rows=9):
    """The inputs of ``tests/test_sift.py``'s descriptor-kernel test; the
    first ``rows`` rows, the last of them invalid."""
    S, H, W = 2, 112, 384
    mod = rng.random((S, H, W)).astype(np.float32)
    ang = (rng.random((S, H, W)) * 2 * np.pi).astype(np.float32)
    K = 9
    ky = rng.uniform(40, H - 40, K).astype(np.float32)
    kx = rng.uniform(60, W - 60, K).astype(np.float32)
    sig = rng.uniform(1.5, 3.0, K).astype(np.float32)
    th0 = (rng.random(K) * 2 * np.pi).astype(np.float32)
    lvl = rng.integers(0, S, K).astype(np.int32)
    val = np.ones(K, np.int32)
    val[rows - 1] = 0
    return mod, ang, kx[:rows], ky[:rows], sig[:rows], th0[:rows], lvl[:rows], val[:rows]


def test_describe_vs_xla_route(rng):
    magnif = 3.0
    mod, ang, kx, ky, sig, th0, lvl, val = _desc_inputs(rng)
    r = _r_desc(magnif)
    want = np.asarray(jsift.descriptors(
        jnp.asarray(mod), jnp.asarray(ang), jnp.asarray(kx), jnp.asarray(ky),
        jnp.asarray(sig), jnp.asarray(lvl), jnp.asarray(th0), jnp.asarray(val > 0), r, magnif,
    ))
    valid = torch.as_tensor(val > 0)
    args = (*_torch_args(mod, ang, kx, ky, sig, lvl, th0), valid, r, magnif)
    got = sift.descriptors(*args).numpy()
    _rel_close(got, want, val)
    u8 = sift_desc.describe(*args)
    want_u8 = np.minimum(np.floor(512.0 * want), 255.0)
    assert u8.dtype == torch.uint8
    assert np.abs(u8.numpy().astype(np.int32) - want_u8).max() <= 1

"""Port parity: the plain versions of the SIFT kernels (orientation
histograms, ``csrc/sift_orient.cu``; descriptors, ``csrc/sift_desc.cu``)
against the JAX package's Pallas kernels in interpret mode and against
its XLA route (``orientations``, ``descriptors``).

Also the geometry the CUDA kernels walk (``window_box``,
``cell_boxes``) against the plain versions' selections, the kernels'
algorithms in numpy, and the wrappers' argument checks.

The inputs are those of ``tests/test_sift.py``'s kernel tests, where
every window lies inside the Pallas patch, so both sides sum the same
pixels.  Tolerance: atol 2e-5 relative to each row's maximum (float32
sums of up to ~10^4 terms in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def _box_inputs(rng, K=40):
    """Seeded rows for the window-box tests: every scale the detector
    gives an octave up to the largest (``Wr`` = 20), a third of the rows
    within a few pixels of the octave's border, and centres at and next
    to a half pixel, where ``round`` goes either way."""
    S, H, W = 2, 72, 120
    mod = rng.random((S, H, W)).astype(np.float32)
    ang = (rng.random((S, H, W)) * 2 * np.pi).astype(np.float32)
    ky = rng.uniform(0, H - 1, K).astype(np.float32)
    kx = rng.uniform(0, W - 1, K).astype(np.float32)
    near = np.arange(K) % 3 == 0
    ky[near] = np.where(rng.random(near.sum()) < 0.5, rng.uniform(0, 6, near.sum()),
                        H - 1 - rng.uniform(0, 6, near.sum()))
    kx[near & (np.arange(K) % 2 == 0)] = rng.uniform(0, 5)
    kx[1:7] = np.float32([30.5, 31.5, 30.4999, 31.5001, 0.5, W - 1.5])
    ky[4:10] = np.float32([20.5, 21.5, 20.4999, 21.5001, 0.5, H - 1.5])
    sig = rng.uniform(0.2, 4.52, K).astype(np.float32)
    sig[:3] = np.float32([4.52, 0.2, 4.4444447])  # Wr = 20, 1 and floor(20.0000...)
    lvl = rng.integers(0, S, K).astype(np.int32)
    return mod, ang, kx, ky, sig, lvl


def _counted(kx, ky, sig, H, W, radius, f=np.float32):
    """The plain version's selection of one row over the whole octave,
    in dtype ``f``: ``(sel, r2)``."""
    kx, ky, sig = f(kx), f(ky), f(sig)
    sigmaw = f(1.5) * sig
    Wr = max(np.floor(f(3.0) * sigmaw), f(1.0))
    yi, xi = int(np.round(ky)), int(np.round(kx))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dy, dx = ys.astype(f) - ky, xs.astype(f) - kx
    r2 = dx * dx + dy * dy
    sel = ((np.abs(ys - yi) <= radius) & (np.abs(xs - xi) <= radius)
           & (r2 < Wr * Wr + f(0.6)))
    return sel, r2


def test_window_box_holds_every_counted_pixel(rng):
    mod, ang, kx, ky, sig, lvl = _box_inputs(rng)
    _, H, W = mod.shape
    boxes = sift_orient.window_box(*_torch_args(kx, ky, sig), _R_OR, H, W).numpy()
    assert boxes.shape == (kx.shape[0], 4) and boxes.dtype == np.int32
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    Wr = np.maximum(np.floor(np.float32(3.0) * (np.float32(1.5) * sig)), 1.0)
    assert Wr.max() == 20 and Wr.min() == 1 and _R_OR == 21
    n_counted = 0
    for k in range(kx.shape[0]):
        sel, _ = _counted(kx[k], ky[k], sig[k], H, W, _R_OR)
        x0, x1, y0, y1 = boxes[k]
        inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
        assert not (sel & ~inside).any(), k
        n_counted += int(sel.sum())
        # and is the square of radius Wr, no larger
        assert x1 - x0 + 1 <= 2 * Wr[k] + 1 and y1 - y0 + 1 <= 2 * Wr[k] + 1
        # a smaller radius than Wr cuts the box as it cuts the window
        small = sift_orient.window_box(*_torch_args(kx[k:k + 1], ky[k:k + 1], sig[k:k + 1]),
                                       5, H, W).numpy()[0]
        sel5, _ = _counted(kx[k], ky[k], sig[k], H, W, 5)
        in5 = (xs >= small[0]) & (xs <= small[1]) & (ys >= small[2]) & (ys <= small[3])
        assert not (sel5 & ~in5).any(), k
    assert n_counted > 5000


def test_lanewise_box_sums_equal_orient_hist_plain(rng):
    """The CUDA kernel's algorithm in numpy float64: over the row's box
    only, pixel ``p`` of the box in raster order goes to lane ``p % 32``,
    a lane adds into its own 36 bins in the order of its pixels, and the
    32 lanes are summed bin by bin.  Equal to the plain version (all 36
    bins over the whole window) to 1e-6 of the row maximum, and to the
    float32 plain version at the tolerance the kernel is held to."""
    mod, ang, kx, ky, sig, lvl = _box_inputs(rng)
    _, H, W = mod.shape
    K = kx.shape[0]
    boxes = sift_orient.window_box(*_torch_args(kx, ky, sig), _R_OR, H, W).numpy()
    f = np.float64
    got = np.zeros((K, 36))
    for k in range(K):
        sel, r2 = _counted(kx[k], ky[k], sig[k], H, W, _R_OR, f)
        x0, x1, y0, y1 = boxes[k]
        b = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        den = 2.0 * (1.5 * f(sig[k])) ** 2
        c = np.where(sel[b], mod[lvl[k]][b].astype(f) * np.exp(-r2[b] / den), 0.0).ravel()
        bins = (np.floor(36.0 * ang[lvl[k]][b].astype(f) / (2 * np.pi)).astype(np.int64)
                % 36).ravel()
        lanes = np.zeros((32, 36))
        np.add.at(lanes, (np.arange(c.size) % 32, bins), c)
        got[k] = lanes.sum(0)
    ones = torch.ones(K, dtype=torch.bool)
    t64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    want = sift_orient.orient_hist_plain(
        t64(mod), t64(ang), t64(kx), t64(ky), t64(sig), torch.as_tensor(lvl), ones, _R_OR
    ).numpy()
    assert want.max() > 0
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)
    want32 = sift_orient.orient_hist_plain(
        *_torch_args(mod, ang, kx, ky, sig, lvl), ones, _R_OR
    ).numpy()
    np.testing.assert_allclose(got / scale, want32 / scale, rtol=0, atol=2e-5)


def test_orient_hist_valid_none_means_every_row(rng):
    mod, ang, kx, ky, sig, lvl = _box_inputs(rng, K=12)
    args = _torch_args(mod, ang, kx, ky, sig, lvl)
    ones = torch.ones(12, dtype=torch.bool)
    assert torch.equal(sift_orient.orient_hist(*args, None, _R_OR),
                       sift_orient.orient_hist(*args, ones, _R_OR))
    th0, av0 = sift.orientations(*args, None, _R_OR)
    th1, av1 = sift.orientations(*args, ones, _R_OR)
    assert torch.equal(th0, th1) and torch.equal(av0, av1)


@pytest.mark.parametrize("case,error", [
    ("float64_levels", TypeError), ("level_shapes_differ", ValueError),
    ("two_dim_levels", ValueError), ("float_level", TypeError), ("short_kx", ValueError),
    ("int_valid", TypeError), ("short_valid", ValueError), ("cpu_tensors", ValueError),
])
def test_orient_hist_cuda_argument_checks(rng, case, error):
    """The wrapper checks what the kernel's pointers assume before it
    looks for the card; complete CPU arguments are refused last."""
    mod, ang, kx, ky, sig, lvl = _torch_args(*_box_inputs(rng, K=12))
    valid = torch.ones(12, dtype=torch.bool)
    if case == "float64_levels":
        mod = mod.double()
    elif case == "level_shapes_differ":
        ang = ang[:, :-1]
    elif case == "two_dim_levels":
        mod, ang = mod[0], ang[0]
    elif case == "float_level":
        lvl = lvl.float()
    elif case == "short_kx":
        kx = kx[:-1]
    elif case == "int_valid":
        valid = valid.to(torch.int32)
    elif case == "short_valid":
        valid = valid[:-1]
    with pytest.raises(error):
        sift_orient.orient_hist_cuda(mod, ang, kx, ky, sig, lvl, valid, _R_OR)
    if case == "cpu_tensors":
        with pytest.raises(ValueError, match="CUDA tensors"):
            sift_orient.orient_hist_cuda(mod, ang, kx, ky, sig, lvl, None, _R_OR)
    assert sift_orient.launches == 0


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


def _cell_inputs(rng, K=24):
    """Seeded rows for the cell-box tests: all scales the detector gives
    an octave, every rotation, a third of the rows within a few pixels
    of the octave's border."""
    S, H, W = 2, 96, 160
    mod = rng.random((S, H, W)).astype(np.float32)
    ang = (rng.random((S, H, W)) * 2 * np.pi).astype(np.float32)
    ky = rng.uniform(0, H - 1, K).astype(np.float32)
    kx = rng.uniform(0, W - 1, K).astype(np.float32)
    near = np.arange(K) % 3 == 0
    ky[near] = np.where(rng.random(near.sum()) < 0.5, rng.uniform(0, 6, near.sum()),
                        H - 1 - rng.uniform(0, 6, near.sum()))
    kx[near & (np.arange(K) % 2 == 0)] = rng.uniform(0, 5)
    sig = rng.uniform(1.6, 3.2, K).astype(np.float32)
    th0 = (rng.random(K) * 2 * np.pi).astype(np.float32)
    th0[:4] = np.float32([0.0, np.pi / 2, np.pi / 4, 3 * np.pi / 2])
    lvl = rng.integers(0, S, K).astype(np.int32)
    return mod, ang, kx, ky, sig, th0, lvl


def _row_geometry(kx, ky, sig, th0, H, W, radius, magnif, f):
    """Per-pixel terms of one row over the whole octave, computed in
    dtype ``f`` with the plain version's formulas: ``(sel, nx, ny, dx,
    dy, SBP)``."""
    kx, ky, sig, th0 = f(kx), f(ky), f(sig), f(th0)
    SBP = f(magnif) * sig
    Wr = SBP * f(2.5) * f(np.sqrt(2.0)) + f(0.5)
    yi, xi = int(np.round(ky)), int(np.round(kx))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dy, dx = ys.astype(f) - ky, xs.astype(f) - kx
    ct, st = np.cos(th0), np.sin(th0)
    nx = (ct * dx + st * dy) / SBP
    ny = (-st * dx + ct * dy) / SBP
    sel = ((np.abs(dx) <= Wr) & (np.abs(dy) <= Wr)
           & (np.abs(ys - yi) <= radius) & (np.abs(xs - xi) <= radius))
    return sel, nx, ny, dx, dy, SBP


def test_cell_boxes_hold_every_weighted_pixel(rng):
    magnif = 3.0
    mod, ang, kx, ky, sig, th0, lvl = _cell_inputs(rng)
    _, H, W = mod.shape
    r = _r_desc(magnif)
    boxes = sift_desc.cell_boxes(*_torch_args(kx, ky, sig, th0), r, H, W, magnif).numpy()
    assert boxes.shape == (kx.shape[0], 16, 4) and boxes.dtype == np.int32
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    n_weighted = 0
    for k in range(kx.shape[0]):
        sel, nx, ny, *_ = _row_geometry(kx[k], ky[k], sig[k], th0[k], H, W, r, magnif, np.float32)
        for cell in range(16):
            cy, cx = cell // 4 - 1.5, cell % 4 - 1.5
            wy = np.maximum(0, 1 - np.abs(ny - np.float32(cy)))
            wx = np.maximum(0, 1 - np.abs(nx - np.float32(cx)))
            weighted = sel & (wy * wx > 0)
            x0, x1, y0, y1 = boxes[k, cell]
            inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
            assert not (weighted & ~inside).any(), (k, cell)
            n_weighted += int(weighted.sum())
            # and is no larger than the rotated cell needs: side 2 sqrt(2) SBP
            side = 2 * np.sqrt(2.0) * magnif * sig[k] + 4
            assert x1 - x0 + 1 <= side and y1 - y0 + 1 <= side
    assert n_weighted > 10000


def test_cellwise_box_sums_equal_desc_raw_plain(rng):
    """The CUDA kernel's algorithm in numpy float64: per cell, over its
    box only, each pixel adds to the two orientation bins ``floor(nt)``
    and ``floor(nt) + 1 mod 8``.  Equal to the plain version (8 clamped
    bins per pixel over the whole window) to 1e-6 of the row maximum."""
    magnif = 3.0
    mod, ang, kx, ky, sig, th0, lvl = _cell_inputs(rng)
    _, H, W = mod.shape
    r = _r_desc(magnif)
    boxes = sift_desc.cell_boxes(*_torch_args(kx, ky, sig, th0), r, H, W, magnif).numpy()
    K = kx.shape[0]
    got = np.zeros((K, 128))
    f = np.float64
    for k in range(K):
        sel, nx, ny, dx, dy, SBP = _row_geometry(kx[k], ky[k], sig[k], th0[k], H, W, r, magnif, f)
        win = np.exp(-(dx * dx + dy * dy) / (2.0 * (2.0 * SBP) ** 2))
        c = np.where(sel, mod[lvl[k]].astype(f) * win, 0.0)
        nt = 8.0 * np.remainder(ang[lvl[k]].astype(f) - f(th0[k]), 2 * np.pi) / (2 * np.pi)
        fl = np.floor(nt)
        o0 = fl.astype(np.int64) & 7
        for cell in range(16):
            cy, cx = cell // 4 - 1.5, cell % 4 - 1.5
            x0, x1, y0, y1 = boxes[k, cell]
            if x1 < x0 or y1 < y0:
                continue
            b = (slice(y0, y1 + 1), slice(x0, x1 + 1))
            v = (c[b] * np.maximum(0, 1 - np.abs(ny[b] - cy))
                 * np.maximum(0, 1 - np.abs(nx[b] - cx)))
            a0 = v * (1.0 - (nt[b] - fl[b]))
            a1 = v * (1.0 - ((fl[b] + 1.0) - nt[b]))
            np.add.at(got[k], cell * 8 + o0[b].ravel(), a0.ravel())
            np.add.at(got[k], cell * 8 + ((o0[b] + 1) & 7).ravel(), a1.ravel())
    t64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    want = sift_desc.desc_raw_plain(
        t64(mod), t64(ang), t64(kx), t64(ky), t64(sig), torch.as_tensor(lvl), t64(th0),
        torch.ones(K, dtype=torch.bool), r, magnif,
    ).numpy()
    assert want.max() > 0
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)
    # and the float32 plain version the kernel is held against on the card
    want32 = sift_desc.desc_raw_plain(
        *_torch_args(mod, ang, kx, ky, sig, lvl, th0), torch.ones(K, dtype=torch.bool), r, magnif,
    ).numpy()
    np.testing.assert_allclose(got / scale, want32 / scale, rtol=0, atol=2e-5)

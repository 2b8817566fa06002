#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spectavi_tpu_torch``) on one GPU.

Phases, one JSON line each:

* ``env``       card, power limit, torch and CUDA versions;
* ``build``     compile every kernel under ``spectavi_tpu_torch/csrc/``
                (one ``nvcc`` per source, all started together);
* ``render``    a 2048x3072 two-view pair rendered on the card (a
                heightfield with seeded multi-scale noise texture, known
                K and cameras), plus a 240x320 pair for the CPU check;
* ``check_K1``  the L2 top-2 kernel against its plain version at
                X = Y = 28000, D = 144, on a case full of ties, and on
                shapes that reach every branch of the wrapper and both
                routes of the kernel (D not a multiple of 16, int8, tiny,
                ragged Y, D above the tensor-core cap, uint8 D = 128
                padded as the pair step pads it), all bit-exact, with
                CUDA-event times;
* ``check_K2``, ``check_K3``  the SIFT orientation and descriptor
                kernels against their plain versions on the real octave
                gradients and keypoints of the rendered pair (atol 2e-5
                of the row maximum; uint8 descriptors within 1 LSB), each
                on octave -1, on a small octave and on the rows whose
                window the octave's border clips, with identical bytes
                on a second launch;
* ``two_view``  the port's array-level ``run_two_view`` on the rendered
                pair, one cold and one warm run, every kernel's launch
                count read around the warm run; RANSAC must succeed with
                >= 100 inliers and recover the rendered relative pose;
* ``two_view_matchers``  the same path at 1024x1536 with
                ``matching_method="cascading-hash"`` and ``"bruteforce"``
                (SIFT, then step 2 on the card), held to the same RANSAC
                and pose limits;
* ``matchers``  every matcher of ``spectavi_tpu_torch.match`` on the
                quantized 144-byte rows of the rendered pair, on the
                card: exact L1 top-2 against itself on the CPU and an
                int64 check; IVF and sharded L2 within the reference's
                budgets against the exact answers, the cascade hash on
                the first neighbours that pass the ratio test; k-medians
                and ``nn_bruteforce`` (p = 0.5, and ``mu > 0``) on a
                4000-row subset; each with its milliseconds;
* ``cpu_parity`` the same pipeline on the small pair on the card and on
                the CPU (plain versions): match counts and consensus agree;
* ``profile``   one more warm run under ``torch.profiler``: device time
                by kernel and the device's busy share;
* ``sfm``       ``run_sfm_arrays`` on 10 rendered 480x640 views on the
                benchmark's arc (sequential pairs, batched pair step, PnP
                init, Huber BA of 15 iterations), cold and warm: stage
                seconds, keypoints, pairs, tracks, BA costs, ATE as a share
                of the trajectory's span, the pair step's peak memory and
                every kernel's launches in the warm run; then
                ``check_sfm_kernels``, the kernels against their plain
                versions at the shapes this path gives them (K1 on every
                pair's padded tables from the warm run, bit-exact; K2
                and K3 on every octave of one view), and
                ``profile_sfm``, a profiled warm run (``run_ms_sfm``);
* ``ba_check``  ``bundle_adjust_device`` on that problem twice on the card
                (identical bytes) and once on the CPU (within 1e-6);
* ``pnp_cap``   one PnP dispatch at the chunk cap (8 x 4096 rows): time
                and peak memory;
* ``sfm_scale`` 24 views with sequential and skip-2 pairs (45), 30 BA
                iterations, a checkpoint, and a second run resuming from
                it: seconds, peak memory, the PnP rounds and dispatches;
* ``sfm_cpu_parity`` the 3-view 120x160 scene of the tests on the card and
                on the CPU, with the loop and with the batched pair
                backend (no pair retried): keypoints, matches and tracks
                agree;
* ``kernels``   one line for every kernel: launches in the warm two-view
                run, ms, plain ms, bound ms and what bounds it, ``run_ms``,
                its summed device time over the profiled warm run, and
                ``launches_sfm`` / ``run_ms_sfm`` of the 10-view run.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
last the contract line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero without that line.  Usage: ``python3
chip_smoke.py [--ptxas] [--profile DIR] [--checks-only]`` (``--ptxas``
prints the compiler's register and shared-memory report; ``--profile``
also writes the profiled run's Chrome trace into DIR; ``--checks-only``
stops after the kernel checks, without the contract line).  Nothing of
JAX is imported.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): int8 tensor ops, float32 CUDA-core
# flops, device-memory bytes per second
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# image and texture sizes: ~9 px per texel gives castle-like keypoint
# counts (a few 10k per image) at 2048x3072
H, W = 2048, 3072
TEX = (220, 330)
SMALL_H, SMALL_W = 240, 320
SMALL_TEX = (50, 70)
# the pair the other matchers' two-view runs take
MID_H, MID_W = 1024, 1536
MID_TEX = (110, 165)
# rows of the matchers whose dense (Y, X, D) work is taken in small blocks
SUBSET_ROWS = 4000
SEED = 0
# index of the small octave K3 is also checked on (0 is octave -1): 256x384
SMALL_OCTAVE = 4
# the multi-view scene: views of the benchmark's size on its arc
SFM_H, SFM_W = 480, 640
SFM_TEX = (100, 150)
SFM_VIEWS = 10
SCALE_VIEWS = 24


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --- scene: a torch copy of benchmarks/bench_multiview_synthetic.py's
# look_at/render, with a seeded multi-scale noise texture -------------


def look_at(C, target, up=(0.0, -1.0, 0.0)):
    import numpy as np

    z = target - C
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ C


def make_texture(gen, device, Ht, Wt, octaves=6):
    """Multi-scale smoothed noise in [0, 1]: noise fields at halving
    resolutions, each smoothed by two 5-point averages, upsampled
    bilinearly and summed with equal weights."""
    import torch
    import torch.nn.functional as F

    tex = torch.zeros((1, 1, Ht, Wt), dtype=torch.float64, device=device)
    for o in range(octaves):
        h, w = max(Ht >> o, 4), max(Wt >> o, 4)
        n = torch.rand((1, 1, h, w), generator=gen, device=device, dtype=torch.float64)
        for _ in range(2):
            n = (n + n.roll(1, 2) + n.roll(-1, 2) + n.roll(1, 3) + n.roll(-1, 3)) / 5.0
        tex += F.interpolate(n, size=(Ht, Wt), mode="bilinear", align_corners=True)
    tex = tex[0, 0]
    return (tex - tex.min()) / (tex.max() - tex.min())


def make_scene(rng, gen, device, tex_shape):
    import numpy as np
    import torch

    tex = make_texture(gen, device, *tex_shape)
    Ht, Wt = tex.shape
    aspect = Wt / Ht
    centers = rng.uniform(-0.7, 0.7, size=(8, 2)) * [aspect, 1.0]
    amps = rng.uniform(0.35, 0.7, size=8) * rng.choice([-1, 1], 8)
    widths = rng.uniform(0.3, 0.7, size=8)

    def height(x, y):
        h = 0.15 * (x * x + y * y)
        for (cx, cy), a, w in zip(centers, amps, widths):
            h = h + a * torch.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * w * w))
        return h

    def texture_at(x, y):
        u = torch.clamp((x / aspect * 0.5 + 0.5) * (Wt - 1), 0, Wt - 1.001)
        v = torch.clamp((y * 0.5 + 0.5) * (Ht - 1), 0, Ht - 1.001)
        u0, v0 = u.long(), v.long()
        fu, fv = u - u0, v - v0
        return (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv
        )

    return height, texture_at


def render(height, texture_at, K, R, t, h, w, device, depth=4.0, iters=8, ss=2):
    """Per pixel, intersect the camera ray with the heightfield
    z = depth - h(x, y) by fixed-point iteration, at ``ss``x
    supersampling, then box-downsample."""
    import numpy as np
    import torch

    Kss = np.array([[K[0, 0] * ss, 0, K[0, 2] * ss], [0, K[1, 1] * ss, K[1, 2] * ss], [0, 0, 1.0]])
    h2, w2 = h * ss, w * ss
    f64 = dict(dtype=torch.float64, device=device)
    vs, us = torch.meshgrid(torch.arange(h2, **f64), torch.arange(w2, **f64), indexing="ij")
    rays = torch.stack([us.reshape(-1), vs.reshape(-1), torch.ones(h2 * w2, **f64)])
    d_world = torch.as_tensor(R.T @ np.linalg.inv(Kss), **f64) @ rays
    C = -R.T @ t
    lam = (depth - C[2]) / d_world[2]
    for _ in range(iters):
        x = C[0] + lam * d_world[0]
        y = C[1] + lam * d_world[1]
        lam = (depth - height(x, y) - C[2]) / d_world[2]
    im = texture_at(C[0] + lam * d_world[0], C[1] + lam * d_world[1]).reshape(h2, w2)
    return im.reshape(h, ss, w, ss).mean(dim=(1, 3))


def arc_pose(i, n, target=(0.0, 0.0, 4.0), arc=(1.6, 0.25, 0.35)):
    """View ``i`` of ``n`` on the multi-view benchmark's lateral arc
    ``C = (1.6 s, 0.25 s, 0.35 |s|)``, ``s = i / (n - 1) - 0.5``, looking
    at the surface centre: ``(R, t, C)``."""
    import numpy as np

    s = i / max(n - 1, 1) - 0.5
    C = np.array([arc[0] * s, arc[1] * s, arc[2] * abs(s)])
    R, t = look_at(C, np.asarray(target))
    return R, t, C


def render_views(n, h, w, device, tex_shape, seed=SEED):
    """``n`` views of the scene on the arc, as the pipeline would read
    them from 8-bit files: ``(grays float32, colors uint8 numpy, K,
    [(R, t, C)])``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    height, texture_at = make_scene(rng, gen, device, tex_shape)
    f = 1.1 * w
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    grays, colors, poses = [], [], []
    for i in range(n):
        R, t, C = arc_pose(i, n)
        u8 = (torch.clamp(render(height, texture_at, K, R, t, h, w, device), 0, 1)
              * 255).to(torch.uint8)
        g = u8.to(torch.float32)
        grays.append((g / g.max()).cpu().numpy())
        colors.append(u8.cpu().numpy())
        poses.append((R, t, C))
    return grays, colors, K, poses


def render_pair(h, w, device, tex_shape):
    """Two views on the arc: ``(grays, colors, K, (R1, t1) of view 1
    relative to view 0)``."""
    grays, colors, K, poses = render_views(2, h, w, device, tex_shape)
    (R0, t0, _), (R1, t1, _) = poses
    R01 = R1 @ R0.T
    return grays, colors, K, (R01, t1 - R01 @ t0)


def tiny_views(device, nviews=3, h=120, w=160):
    """The 3-view 120x160 scene of ``tests/test_sfm_pipeline.py``'s
    ``_tiny_dataset`` (same seed, texture, heightfield and arc), rendered
    in memory: ``(grays, K, camera centres)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0xDEADBEEF)
    tex = rng.random((160, 220))
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, -1, 0) + np.roll(tex, 1, 1)
               + np.roll(tex, -1, 1)) / 5.0
    tex = (tex - tex.min()) / max(float(np.ptp(tex)), 1e-9)
    Ht, Wt = tex.shape
    aspect = Wt / Ht
    centers = rng.uniform(-0.6, 0.6, size=(5, 2)) * [aspect, 1.0]
    amps = rng.uniform(0.3, 0.5, size=5) * rng.choice([-1, 1], 5)
    widths = rng.uniform(0.35, 0.7, size=5)
    tex_t = torch.as_tensor(tex, dtype=torch.float64, device=device)

    def height(x, y):
        hh = 0.1 * (x * x + y * y)
        for (cx, cy), a, wd in zip(centers, amps, widths):
            hh = hh + a * torch.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * wd * wd))
        return hh

    def texture_at(x, y):
        u = torch.clamp((x / aspect * 0.5 + 0.5) * (Wt - 1), 0, Wt - 1.001)
        v = torch.clamp((y * 0.5 + 0.5) * (Ht - 1), 0, Ht - 1.001)
        u0, v0 = u.long(), v.long()
        fu, fv = u - u0, v - v0
        return (tex_t[v0, u0] * (1 - fu) * (1 - fv) + tex_t[v0, u0 + 1] * fu * (1 - fv)
                + tex_t[v0 + 1, u0] * (1 - fu) * fv + tex_t[v0 + 1, u0 + 1] * fu * fv)

    f = 1.1 * w
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    grays, centres = [], []
    for i in range(nviews):
        R, t, C = arc_pose(i, nviews, arc=(1.4, 0.2, 0.3))
        u8 = (torch.clamp(render(height, texture_at, K, R, t, h, w, device), 0, 1)
              * 255).to(torch.uint8)
        g = u8.to(torch.float32)
        grays.append((g / g.max()).cpu().numpy())
        centres.append(C)
    return grays, K, np.asarray(centres)


# --- bounds ---------------------------------------------------------


def k1_bound_ms(X, Y, D):
    ops = 2.0 * X * Y * D
    nbytes = (X + Y) * D + Y * 16
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3, (
        "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes")


def window_pixels(H_, W_, xs, ys, radii):
    """In-octave pixel count of square windows of the given radii."""
    import numpy as np

    yi, xi = np.round(ys).astype(np.int64), np.round(xs).astype(np.int64)
    ny = np.minimum(yi + radii, H_ - 1) - np.maximum(yi - radii, 0) + 1
    nx = np.minimum(xi + radii, W_ - 1) - np.maximum(xi - radii, 0) + 1
    return np.clip(ny, 0, None) * np.clip(nx, 0, None)


def k2_bound_ms(L, H_, W_, kx, ky, sigma):
    """Bytes: each row's pixels inside r^2 < Wr^2 + 0.6 (two float32
    levels), capped at the levels' size, plus row metadata and the
    histogram out.  Operations: ~16 float32 flops per counted pixel
    (offsets, r^2, exp, weight, bin)."""
    import numpy as np

    Wr = np.maximum(np.floor(3.0 * 1.5 * sigma), 1.0)
    px = np.pi * (Wr * Wr + 0.6)
    nbytes = min(px.sum() * 8, L * H_ * W_ * 8) + len(kx) * (5 * 4 + 36 * 4)
    flops = 16.0 * px.sum()
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return float(max(t_b, t_o) * 1e3), ("operations" if t_o >= t_b else "bytes")


def k3_bound_ms(L, H_, W_, kx, ky, sigma, R, magnif=3.0):
    """Bytes: each row's pixels inside its box (two float32 levels),
    capped at the levels' size, plus metadata and the uint8 row out.
    Operations: per box pixel ~25 float32 flops of geometry and window
    plus ~4 per each of the 8 bins its trilinear weight reaches."""
    import numpy as np

    Wr = magnif * sigma * 2.5 * math.sqrt(2.0) + 0.5
    r = np.minimum(np.floor(Wr + 0.5).astype(np.int64), R)
    px = window_pixels(H_, W_, kx, ky, r).astype(np.float64)
    nbytes = min(px.sum() * 8, L * H_ * W_ * 8) + len(kx) * (6 * 4 + 128)
    flops = (25.0 + 8 * 4.0) * px.sum()
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return float(max(t_b, t_o) * 1e3), ("operations" if t_o >= t_b else "bytes")


# --- phases ---------------------------------------------------------


# device functions of each wrapper's C entry point, as the profiler names them
DEVICE_FUNCTIONS = {
    "l2nn_top2": ("make_tiles", "row_norms", "top2_wgmma_kernel", "top2_dp4a_kernel"),
    "sift_orient_hist": ("orient_kernel",),
    "sift_desc": ("desc_kernel",),
}


def k1_cases(torch, gen):
    """``(name, x, y)`` beside the main shape: every branch of the
    wrapper and both routes of the kernel."""

    def u8(n, d):
        return torch.randint(0, 256, (n, d), generator=gen, device="cuda", dtype=torch.uint8)

    def i8(n, d):
        return torch.randint(-128, 128, (n, d), generator=gen, device="cuda", dtype=torch.int8)

    # ties: few distinct rows, duplicated database rows
    base = i8(37, 160)
    base_u = u8(29, 132)
    pick = lambda b, n: b[torch.randint(0, b.shape[0], (n,), generator=gen, device="cuda")]
    # the pair step's tables: database padded by replicating row 0,
    # queries (some equal to row 0) padded with zeros, both to 4352 rows
    db = u8(4100, 128)
    q = torch.cat([u8(3990, 128), db[:1].expand(10, 128)])
    pad_db = torch.cat([db, db[:1].expand(252, 128)])
    pad_q = torch.cat([q, q.new_zeros((352, 128))])
    return [
        ("padded_uint8_D128", pad_db, pad_q),
        ("ties_int8_D160", pick(base, 4099), pick(base, 2051)),
        ("ties_uint8_D132", pick(base_u, 1000), pick(base_u, 517)),
        ("uint8_D132", u8(4099, 132), u8(2051, 132)),
        ("int8_D128", i8(3000, 128), i8(1000, 128)),
        ("tiny", u8(5, 144), u8(3, 144)),
        ("ragged_Y", u8(1111, 144), u8(777, 144)),
        ("uint8_D256", u8(2000, 256), u8(300, 256)),
        ("above_cap_uint8_D320", u8(1500, 320), u8(333, 320)),
        ("above_cap_int8_D260", i8(700, 260), i8(200, 260)),
    ]


def check_k1(torch, l2nn):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    X = Y = 28000
    D = 144
    x = torch.randint(0, 256, (X, D), generator=gen, device="cuda", dtype=torch.uint8)
    y = torch.randint(0, 256, (Y, D), generator=gen, device="cuda", dtype=torch.uint8)
    cases = [("main", x, y)] + k1_cases(torch, gen)
    for name, xc, yc in cases:
        ik2, dk2 = l2nn.l2_topk2_cuda(xc, yc)
        ip2, dp2 = l2nn.l2_topk_mxu(xc, yc)
        torch.cuda.synchronize()
        if not (torch.equal(ik2, ip2) and torch.equal(dk2, dp2)):
            raise AssertionError(f"K1 l2nn_top2 disagrees with its plain version on {name}")
    ms = cuda_ms(lambda: l2nn.l2_topk2_cuda(x, y), 10)
    plain_ms = cuda_ms(lambda: l2nn.l2_topk_mxu(x, y), 2)
    bound, by = k1_bound_ms(X, Y, D)
    res = {"name": "l2nn_top2", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "shape": {"X": X, "Y": Y, "D": D}}
    emit("check_K1", exact=True, cases_exact=[c[0] for c in cases], **res)
    return res


def octave_inputs(torch, sift, gray, octaves):
    """Gradient levels and detected keypoints of the octaves with the
    given indices (0 is octave -1, the largest) of one image, as the
    main path hands them to the kernels: ``{index: (mod, ang, sel)}``."""
    budgets = sift._octave_budgets(*gray.shape, -1, sift.num_octaves(*gray.shape, -1), 32768)
    first = sift._base_first(torch.as_tensor(gray[None], device="cuda"), -1)
    out = {}
    for oi in range(max(octaves) + 1):
        first, mod, ang, det = sift._octave_detect(first, 0.0, 10.0, budgets[oi])
        if oi in octaves:
            out[oi] = (mod[0], ang[0], det[0, :4, det[0, 4] > 0])
    return out


def rel_err(a, b):
    """Largest |a - b| relative to each row's largest |b|."""
    scale = b.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    return float(((a - b).abs() / scale).max())


def k2_clipped_rows(torch, so, args):
    """The rows of ``args`` whose box the octave's border clips."""
    mod, ang, kx, ky, ksig, lvl, valid, R = args
    _, H_, W_ = mod.shape
    r = torch.clamp(torch.clamp(torch.floor(3.0 * (1.5 * ksig)), min=1.0), max=R)
    xi, yi = torch.round(kx), torch.round(ky)
    clip = (xi - r < 0) | (xi + r > W_ - 1) | (yi - r < 0) | (yi + r > H_ - 1)
    return (mod, ang, *(t[clip] for t in (kx, ky, ksig, lvl)), valid, R)


def k2_args(torch, sift, mod, ang, sel):
    """The detections of one octave as ``orient_hist`` takes them on the
    main path (``valid`` None: every row)."""
    lvl = torch.clamp(sel[3].to(torch.int32), 0, sift.S - 1)
    return (mod, ang, sel[0], sel[1], sel[2], lvl, None, sift._R_OR)


def k2_compare(torch, so, args, name):
    """Kernel against plain version on one set of rows: ``(err, plain
    histograms)``."""
    if args[2].shape[0] == 0:
        raise AssertionError(f"K2 check set {name} has no rows")
    ones = torch.ones_like(args[2], dtype=torch.bool)
    hk = so.orient_hist_cuda(*args)
    hk2 = so.orient_hist_cuda(*args[:6], ones, args[7])
    hp = so.orient_hist_plain(*args[:6], ones, args[7])
    torch.cuda.synchronize()
    if not torch.equal(hk, hk2):
        raise AssertionError(f"K2 sift_orient_hist is not deterministic on {name}")
    err = rel_err(hk, hp)
    if not err <= 2e-5:
        raise AssertionError(f"K2 sift_orient_hist disagrees with its plain version on {name}: {err}")
    return err, hp


def check_k2(torch, so, args, small_args):
    """``args``: the rows of octave -1 (timed); ``small_args``: those of
    a small octave.  Returns the result and octave -1's plain
    orientations for the descriptor check."""
    sets = {"octave_-1": args, "small_octave": small_args,
            "clipped": k2_clipped_rows(torch, so, args)}
    errs, plain = {}, {}
    for name, a in sets.items():
        errs[name], plain[name] = k2_compare(torch, so, a, name)
    mod, ang, kx, ky, ksig, lvl, _, R = args
    ones = torch.ones_like(kx, dtype=torch.bool)
    ms = cuda_ms(lambda: so.orient_hist_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: so.orient_hist_plain(mod, ang, kx, ky, ksig, lvl, ones, R), 1)
    L, H_, W_ = mod.shape
    k = [t.cpu().numpy() for t in (kx, ky, ksig)]
    bound, by = k2_bound_ms(L, H_, W_, *k)
    box = so.window_box(kx, ky, ksig, R, H_, W_)
    box_px = int(((box[:, 1] - box[:, 0] + 1) * (box[:, 3] - box[:, 2] + 1)).sum())
    res = {"name": "sift_orient_hist", "max_abs_err": max(errs.values()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
           "shape": {"K": int(kx.shape[0]), "L": L, "H": H_, "W": W_}, "box_pixels": box_px}
    emit("check_K2", deterministic=True,
         sets={n: {"rows": int(a[2].shape[0]), "H": a[0].shape[1], "W": a[0].shape[2],
                   "err": errs[n]} for n, a in sets.items()}, **res)
    th, av = so.orientation_peaks(plain["octave_-1"], ones)
    return res, th, av


def k3_args(torch, sift, mod, ang, sel, th, av):
    """The (keypoint, angle) rows of one octave as ``describe`` takes them."""
    rows = av.reshape(-1).nonzero()[:, 0]
    kp = rows // sift.MAX_ANGLES
    kx, ky, ksig = sel[0][kp], sel[1][kp], sel[2][kp]
    lvl = sel[3][kp].to(torch.int32)
    theta = th.reshape(-1)[rows]
    valid = torch.ones_like(kx, dtype=torch.bool)
    return (mod, ang, kx, ky, ksig, lvl, theta, valid, sift._r_desc(3.0), 3.0)


def k3_compare(torch, sd, args, name):
    """Kernel against plain version on one set of rows: ``(err, lsb)``."""
    valid = args[7]
    uk, rk = sd.desc_cuda(*args, return_raw=True)
    uk2 = sd.desc_cuda(*args)
    rp = sd.desc_raw_plain(*args)
    up = sd.quantize_descriptors(sd.finish_descriptors(rp, valid))
    torch.cuda.synchronize()
    if not torch.equal(uk, uk2):
        raise AssertionError(f"K3 sift_desc is not deterministic on {name}")
    err = rel_err(rk, rp)
    lsb = int((uk.to(torch.int32) - up.to(torch.int32)).abs().max())
    if not (err <= 2e-5 and lsb <= 1):
        raise AssertionError(
            f"K3 sift_desc disagrees with its plain version on {name}: {err}, {lsb} LSB")
    return err, lsb


def clipped_rows(torch, args):
    """The rows of ``args`` whose window the octave's border clips."""
    mod, ang, kx, ky, ksig, lvl, theta, valid, R, magnif = args
    _, H_, W_ = mod.shape
    Wr = magnif * ksig * 2.5 * math.sqrt(2.0) + 0.5
    r = torch.clamp(torch.floor(Wr + 0.5) + 1, max=R)
    xi, yi = torch.round(kx), torch.round(ky)
    clip = (xi - r < 0) | (xi + r > W_ - 1) | (yi - r < 0) | (yi + r > H_ - 1)
    return (mod, ang, *(t[clip] for t in (kx, ky, ksig, lvl, theta, valid)), R, magnif)


def check_k3(torch, sd, args, small_args):
    """``args``: the rows of octave -1 (timed); ``small_args``: those of
    a small octave."""
    valid = args[7]
    clip_args = clipped_rows(torch, args)
    sets = {"octave_-1": args, "small_octave": small_args, "clipped": clip_args}
    errs = {}
    for name, a in sets.items():
        if a[2].shape[0] == 0:
            raise AssertionError(f"K3 check set {name} has no rows")
        errs[name] = k3_compare(torch, sd, a, name)
    err = max(e for e, _ in errs.values())
    lsb = max(l for _, l in errs.values())
    ms = cuda_ms(lambda: sd.desc_cuda(*args), 10)

    def plain():
        sd.quantize_descriptors(sd.finish_descriptors(sd.desc_raw_plain(*args), valid))

    plain_ms = cuda_ms(plain, 1)
    mod, kx, ky, ksig, R = args[0], args[2], args[3], args[4], args[8]
    L, H_, W_ = mod.shape
    k = [t.cpu().numpy() for t in (kx, ky, ksig)]
    bound, by = k3_bound_ms(L, H_, W_, *k, R)
    res = {"name": "sift_desc", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None, "max_lsb": lsb,
           "shape": {"K": int(kx.shape[0]), "L": L, "H": H_, "W": W_}}
    emit("check_K3", deterministic=True,
         sets={n: {"rows": int(a[2].shape[0]), "H": a[0].shape[1], "W": a[0].shape[2],
                   "err": errs[n][0], "lsb": errs[n][1]} for n, a in sets.items()}, **res)
    return res


def host_ms(torch, fn):
    """Milliseconds of the second of two calls of a numpy-in, numpy-out
    function, host clock around work that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_matchers(torch, np, match, qx, qy):
    """Every matcher of the package on the card, on the quantized rows
    ``qx, qy (n, 144)`` (integers in [-128, 127] as float) of the
    rendered pair; budgets are the reference suite's."""
    X, Y = qx.shape[0], qy.shape[0]
    xb, yb = (qx + 128).astype(np.uint8), (qy + 128).astype(np.uint8)
    xf, yf = qx.astype(np.float32), qy.astype(np.float32)
    ms, counts = {}, {}

    # exact L1 top-2: the card against the CPU and against an int64 check
    (ei, ed), ms["nn_bruteforcel1k2"] = host_ms(
        torch, lambda: match.nn_bruteforcel1k2(xb, yb, device="cuda"))
    q = np.linspace(0, Y - 1, 256).astype(np.int64)
    ci, cd = match.nn_bruteforcel1k2(xb, yb[q], device="cpu")
    if not (np.array_equal(ei[q], ci) and np.array_equal(ed[q], cd)):
        raise AssertionError("nn_bruteforcel1k2 on the card differs from itself on the CPU")
    xl = torch.as_tensor(xb, device="cuda").to(torch.int64)
    yl = torch.as_tensor(yb[q], device="cuda").to(torch.int64)
    for s0 in range(0, len(q), 32):
        d = (yl[s0 : s0 + 32, None, :] - xl[None, :, :]).abs().sum(-1)
        vals, order = torch.sort(d, dim=1, stable=True)
        if not (np.array_equal(order[:, :2].cpu().numpy(), ei[q[s0 : s0 + 32]].astype(np.int64))
                and np.array_equal(vals[:, :2].cpu().numpy(), ed[q[s0 : s0 + 32]].astype(np.int64))):
            raise AssertionError("nn_bruteforcel1k2 differs from the int64 check")
    del xl, yl, d, vals, order

    # approximate matchers within their budgets against the exact answers
    (hi, hd, stats), ms["nn_cascading_hash"] = host_ms(
        torch, lambda: match.nn_cascading_hash(qx, qy, with_stats=True, device="cuda"))
    # the reference's budget (<= 40% of the slots differ) is for clustered
    # rows; a SIFT row's second neighbour is close to arbitrary, so here it
    # is held on the slots step 2 keeps: the first neighbour of the queries
    # whose exact neighbours pass the ratio test
    kept = ed[:, 1] >= 1.75 * np.maximum(ed[:, 0], 1e-12)
    counts["nn_cascading_hash_mismatches"] = int((hi != ei).sum())
    counts["nn_cascading_hash_kept_queries"] = int(kept.sum())
    counts["nn_cascading_hash_kept_mismatches"] = int((hi[kept, 0] != ei[kept, 0]).sum())
    counts["nn_cascading_hash_dropped_member_slots"] = stats["dropped_member_slots"]
    if not (kept.sum() >= 100
            and counts["nn_cascading_hash_kept_mismatches"] <= round(0.4 * kept.sum())):
        raise AssertionError(f"cascade hash outside its budget: {counts}")
    li, _ = match.nn_l2k2(xb, yb, device="cuda")
    (vi, vd), ms["nn_ivf"] = host_ms(torch, lambda: match.nn_ivf(xf, yf, device="cuda"))
    counts["nn_ivf_mismatches"] = int((vi != li).sum())
    if not (counts["nn_ivf_mismatches"] <= 2 * round(0.3 * Y) and np.isfinite(vd).all()
            and (vd[:, 0] <= vd[:, 1]).all()):
        raise AssertionError(f"IVF outside its budget: {counts}")
    ai, ms["ann"] = host_ms(torch, lambda: match.ann(xf, yf, device="cuda"))
    counts["ann_mismatches"] = int((ai != li).sum())
    if counts["ann_mismatches"] > 2 * round(0.3 * Y):
        raise AssertionError(f"sharded L2 outside its budget: {counts}")

    # the dense matchers on a subset
    n = SUBSET_ROWS
    xs, ys = xf[:: max(1, X // n)][:n], yf[:: max(1, Y // n)][:n]
    (ki, _), ms["nn_kmedians"] = host_ms(
        torch, lambda: match.nn_kmedians(xs, xs, 2, c=30, device="cuda"))
    (bi, bd), ms["nn_bruteforce_p1"] = host_ms(
        torch, lambda: match.nn_bruteforce(xs, xs, k=2, p=1.0, device="cuda"))
    counts["nn_kmedians_mismatches"] = int((ki != bi).sum())
    if counts["nn_kmedians_mismatches"] > 2 * round(0.4 * len(xs)):
        raise AssertionError(f"k-medians outside its budget: {counts}")
    (pi_, pd), ms["nn_bruteforce_p0.5"] = host_ms(
        torch, lambda: match.nn_bruteforce(xs, ys, k=2, p=0.5, device="cuda"))
    x64 = torch.as_tensor(xs, device="cuda").double()
    y64 = torch.as_tensor(ys[:64], device="cuda").double()
    vals, order = torch.sort((y64[:, None, :] - x64[None]).abs().sqrt().sum(-1), dim=1,
                             stable=True)
    counts["nn_bruteforce_p0.5_agreement"] = float(
        (order[:, :2].cpu().numpy() == pi_[:64].astype(np.int64)).mean())
    if not (counts["nn_bruteforce_p0.5_agreement"] >= 0.99
            and np.allclose(pd[:64], vals[:, :2].cpu().numpy(), rtol=1e-4)):
        raise AssertionError(f"nn_bruteforce p = 0.5 differs from the float64 check: {counts}")
    (ui, ud), ms["nn_bruteforce_mu"] = host_ms(
        torch, lambda: match.nn_bruteforce(xs, ys, k=2, p=1.0, mu=4.0, device="cuda"))
    zi, zd = match.nn_bruteforce(xs, ys, k=2, p=1.0, device="cuda")
    genuine = np.abs(ys[:, None, :].astype(np.float64) - xs[ui.astype(np.int64)]).sum(-1)
    counts["nn_bruteforce_mu_agreement"] = float((ui == zi).mean())
    if not ((ud[:, 0] <= ud[:, 1]).all() and (ui[:, 0] != ui[:, 1]).all()
            and np.allclose(ud, genuine, rtol=1e-5) and (ud[:, 0] >= zd[:, 0] - 1e-3).all()):
        raise AssertionError("nn_bruteforce with mu > 0 returned invalid neighbours")
    emit("matchers", rows=[X, Y], D=int(qx.shape[1]), subset_rows=len(xs), ms=ms, **counts)


def pose_errors(np, P1, R_gt, t_gt):
    """Rotation and translation-direction errors in degrees."""
    rot_err = rotation_angle_deg(P1[:, :3], R_gt)
    t_dir = P1[:, 3] / np.linalg.norm(P1[:, 3])
    t_err = float(np.degrees(np.arccos(np.clip(abs(t_dir @ (t_gt / np.linalg.norm(t_gt))), -1, 1))))
    return rot_err, t_err


def check_two_view(np, res, R_gt, t_gt):
    """The gates of a two-view run on a rendered pair; returns the pose
    errors."""
    m = res["metrics"]
    rot_err, t_err = pose_errors(np, res["ransac"]["camera"], R_gt, t_gt)
    pts = res["points"]
    if not (m["ransac_success"] and m["n_inliers"] >= 100):
        raise AssertionError(
            f"RANSAC did not succeed with >= 100 inliers ({m['matching_method']})")
    if not (rot_err < 1.0 and t_err < 3.0):
        raise AssertionError(f"recovered pose off ({m['matching_method']}): rotation {rot_err} "
                             f"deg, translation {t_err} deg")
    if not (pts.shape == (m["n_inliers"], 4) and np.isfinite(pts).all()):
        raise AssertionError("triangulated points are not finite or have the wrong shape")
    return rot_err, t_err


def profile_run(torch, run_once, out_dir, warm_s, phase="profile", trace="two_view_trace.json",
                host_ops=True):
    """One more warm run under ``torch.profiler``: device time by kernel
    (top 15, device-side events only), their sum as the device's busy
    time, its share of the unprofiled warm run's wall time ``warm_s``
    (the profiler slows the host side several fold), and a Chrome trace
    ``trace`` in ``out_dir`` when that is given.  ``host_ops=False``
    records device activity only (a run of ~10^5 launches otherwise
    spends minutes in the profiler's host-side bookkeeping).  Returns
    every wrapper's summed device time in ms (``DEVICE_FUNCTIONS``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host_ops else []
    torch.cuda.synchronize()
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(
        ((e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, trace))
    run_ms = {
        name: sum(ms for key, ms, _ in rows if any(f in key for f in fns))
        for name, fns in DEVICE_FUNCTIONS.items()
    }
    emit(phase, warm_wall_ms=warm_s * 1e3, device_busy_ms=busy_ms,
         busy_share=busy_ms / (warm_s * 1e3), n_kernels=sum(r[2] for r in rows),
         run_ms=run_ms,
         top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:15]])
    if not all(v > 0 for v in run_ms.values()):
        raise AssertionError(f"the profiler saw no device time for a kernel: {run_ms}")
    return run_ms


# --- multi-view SfM -------------------------------------------------


def sfm_run(torch, grays, K, device, ransac=None, **kw):
    """The port's ``run_sfm_arrays`` with the benchmark's RANSAC
    threshold (rendered keypoints are ~pixel-accurate: 1 px at f = 1.1 W
    is ~1.4e-3 in calibrated coordinates), any other RANSAC options in
    ``ransac``, and a seeded generator."""
    from spectavi_tpu_torch.pipeline.sfm import run_sfm_arrays

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    opts = dict({"reprojection_error_allowed": 2e-3}, **(ransac or {}))
    return run_sfm_arrays(grays, K, quiet=True, generator=gen, device=device,
                          ransac_options=opts, **kw)


def ate_share(np, cams, gt_C):
    """Camera ATE-RMSE after similarity alignment, as a share of the
    ground-truth trajectory's span."""
    from spectavi_tpu_torch.sfm import ate_rmse, camera_centers

    return ate_rmse(camera_centers(cams), gt_C) / np.ptp(gt_C, axis=0).max()


def sfm_summary(res, share):
    m = res["metrics"]
    return {
        "seconds": {k[: -len("_seconds")]: m[k] for k in
                    ("sift_seconds", "pairs_seconds", "graph_seconds", "ba_seconds")},
        "keypoints": m["keypoints_per_view"],
        "pairs": len(m["pairs"]),
        "matches": [p.get("matches", 0) for p in m["pairs"]],
        "inlier_percent": [round(p.get("inlier_percent", 0.0), 4) for p in m["pairs"]],
        "tracks": m["n_tracks"], "observations": m["n_observations"],
        "ba_cost_initial": m["ba_cost_initial"], "ba_cost_final": m["ba_cost_final"],
        "init_used": m["init_used"], "pair_backend": m["pair_backend"], "ate_share": share,
    }


def check_sfm(np, res, share, n_pairs, name):
    """The gates of a multi-view run on the rendered scene."""
    m = res["metrics"]
    pairs = m["pairs"]
    if m["pair_backend"] != "batched":
        raise AssertionError(f"{name}: pair backend {m['pair_backend']}, not batched")
    if len(pairs) != n_pairs or not all(
            p.get("matches", 0) >= 10 and p.get("success") for p in pairs):
        raise AssertionError(f"{name}: a pair failed: {pairs}")
    if m["init_used"] != "pnp" or any(p.get("batched_retry") for p in pairs):
        raise AssertionError(f"{name}: a fallback fired: init {m['init_used']}, {pairs}")
    if not m["ba_cost_final"] <= m["ba_cost_initial"]:
        raise AssertionError(f"{name}: BA raised the cost {m['ba_cost_initial']} -> "
                             f"{m['ba_cost_final']}")
    if not np.isfinite(res["points"]).all():
        raise AssertionError(f"{name}: points are not finite")
    if not share < 0.02:
        raise AssertionError(f"{name}: ATE {share:.4f} of the span, limit 0.02")


def track_peak(torch, mod, name, peaks):
    """Wrap ``mod.name`` to record the device's peak allocation (MiB)
    over each call in ``peaks``; returns a function that undoes it."""
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        peaks.append({"base_mib": base / 2**20,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20})
        return out

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, fn)


def capture_step_tables(two_view, tables):
    """Wrap ``two_view.make_two_view_step`` so that each step it builds
    appends its padded descriptor tables ``(desc0, desc1)`` to
    ``tables``; returns a function that undoes it."""
    make = two_view.make_two_view_step

    def wrapped_make(*a, **k):
        step = make(*a, **k)

        def wrapped_step(desc0, desc1, *r, **kk):
            tables.append((desc0, desc1))
            return step(desc0, desc1, *r, **kk)

        return wrapped_step

    two_view.make_two_view_step = wrapped_make
    return lambda: setattr(two_view, "make_two_view_step", make)


def check_sfm_kernels(torch, sift, l2nn, so, sd, tables, gray):
    """Every kernel against its plain version at the shapes of the
    10-view path: K1 on each pair's padded tables as the warm run's pair
    step handed them to it (bit-exact), K2 and K3 on every octave of one
    view with keypoints (as ``check_K2`` / ``check_K3``)."""
    if not tables:
        raise AssertionError("the 10-view run built no pair step")
    d0, d1 = tables[-1]
    for b in range(d0.shape[0]):
        ik, dk = l2nn.l2_topk2_cuda(d0[b], d1[b])
        ip, dp = l2nn.l2_topk_mxu(d0[b], d1[b])
        torch.cuda.synchronize()
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"K1 l2nn_top2 disagrees with its plain version on pair {b}")
    n_oct = sift.num_octaves(*gray.shape, -1)
    octs = octave_inputs(torch, sift, gray, tuple(range(n_oct)))
    per_octave = []
    for oi, (mod, ang, sel) in sorted(octs.items()):
        row = {"octave": oi - 1, "H": mod.shape[1], "W": mod.shape[2], "rows": int(sel.shape[1])}
        if sel.shape[1]:
            a2 = k2_args(torch, sift, mod, ang, sel)
            row["k2_err"], hp = k2_compare(torch, so, a2, f"view octave {oi - 1}")
            th, av = so.orientation_peaks(hp, torch.ones_like(a2[2], dtype=torch.bool))
            a3 = k3_args(torch, sift, mod, ang, sel, th, av)
            row["k3_rows"] = int(a3[2].shape[0])
            if a3[2].shape[0]:
                row["k3_err"], row["k3_lsb"] = k3_compare(torch, sd, a3, f"view octave {oi - 1}")
        per_octave.append(row)
    if sum(r["rows"] for r in per_octave) == 0:
        raise AssertionError("no keypoint on the view's octaves")
    emit("check_sfm_kernels", k1={"pairs": int(d0.shape[0]), "X": int(d0.shape[1]),
                                  "Y": int(d1.shape[1]), "D": int(d0.shape[2]),
                                  "dtype": str(d0.dtype).replace("torch.", ""), "exact": True},
         view_octaves=per_octave)


def phase_sfm(torch, np, wrappers, profile_dir):
    """The 10-view run: cold, warm with launch counts, the kernels
    against their plain versions at this path's shapes, profiled."""
    from spectavi_tpu_torch.features import sift
    from spectavi_tpu_torch.ops import l2nn
    from spectavi_tpu_torch.ops import sift_desc as sd
    from spectavi_tpu_torch.ops import sift_orient as so
    from spectavi_tpu_torch.parallel import two_view
    from spectavi_tpu_torch.pipeline import sfm as sfm_mod

    t0 = time.perf_counter()
    grays, _, K, poses = render_views(SFM_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX)
    gt_C = np.array([C for _, _, C in poses])
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = sfm_run(torch, grays, K, "cuda")
    cold_s = time.perf_counter() - t0
    pair_peaks, tables = [], []
    undo = track_peak(torch, sfm_mod, "_match_pairs_batched", pair_peaks)
    undo_tables = capture_step_tables(two_view, tables)
    for mod_ in wrappers.values():
        mod_.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = sfm_run(torch, grays, K, "cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {name: mod_.launches for name, mod_ in wrappers.items()}
    undo()
    undo_tables()
    share = ate_share(np, warm["cams"], gt_C)
    emit("sfm", views=SFM_VIEWS, shape=[SFM_H, SFM_W], render_seconds=render_s,
         cold_seconds=cold_s, warm_seconds=warm_s,
         cold_stage_seconds=sfm_summary(cold, share)["seconds"], launches=launches,
         pair_step_memory=pair_peaks, **sfm_summary(warm, share))
    check_sfm(np, warm, share, SFM_VIEWS - 1, "sfm")
    if not (launches["l2nn_top2"] == SFM_VIEWS - 1 and launches["sift_orient_hist"] > 0
            and launches["sift_desc"] > 0):
        raise AssertionError(f"the 10-view run did not launch the kernels as expected: {launches}")
    check_sfm_kernels(torch, sift, l2nn, so, sd, tables, grays[0])
    del tables
    run_ms = profile_run(torch, lambda: sfm_run(torch, grays, K, "cuda"), profile_dir, warm_s,
                         "profile_sfm", "sfm_trace.json", host_ops=False)
    return warm, K, launches, run_ms


def phase_ba_check(torch, np, res, K):
    """``bundle_adjust_device`` on the warm 10-view problem (its solution
    perturbed, seeded): twice on the card, once on the CPU, float64."""
    from spectavi_tpu_torch.sfm import bundle_adjust_device, tracks_to_observations

    iK = np.linalg.inv(K)
    pts_cal = []
    for m in res["keypoints"]:
        h = np.hstack([m[:, :2], np.ones((m.shape[0], 1))]) @ iK.T
        pts_cal.append(h[:, :2] / h[:, 2:3])
    ci, pi, uv = tracks_to_observations(res["tracks"], pts_cal)
    rng = np.random.default_rng(SEED)
    cams0 = res["cams"].copy()
    cams0[1:] += 1e-3 * rng.standard_normal(cams0[1:].shape)
    pts0 = res["points"] + 1e-3 * rng.standard_normal(res["points"].shape)
    runs, secs = [], []
    for dev in ("cuda", "cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(bundle_adjust_device(cams0, pts0, ci, pi, uv, max_iters=15, loss="huber",
                                         device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    (ca, pa, ha), (cb, pb, hb), (cc, pc, hc) = runs
    identical = (ca.tobytes() == cb.tobytes() and pa.tobytes() == pb.tobytes()
                 and np.array(ha).tobytes() == np.array(hb).tobytes())
    rel = max(float(np.abs(ca - cc).max() / np.abs(cc).max()),
              float(np.abs(pa - pc).max() / np.abs(pc).max()))
    emit("ba_check", cameras=int(cams0.shape[0]), points=int(pts0.shape[0]),
         observations=int(len(ci)), iters=15, seconds_cuda=secs[:2], seconds_cpu=secs[2],
         cost_cuda=ha, cost_cpu=hc, identical_on_card=identical, rel_err_card_vs_cpu=rel,
         agreement="within_1e-6" if rel <= 1e-6 else "outside_1e-6")
    if not identical:
        raise AssertionError("two card runs of bundle_adjust_device differ")
    if not rel <= 1e-6:
        raise AssertionError(f"card and CPU bundle adjustment differ by {rel} (relative)")


def phase_pnp_cap(torch, np):
    """One ``pnp_ransac_batch`` dispatch at the chunk cap (8 problems of
    4096 rows: Bpad x Npad = 32768), 25% outliers: time and peak device
    memory."""
    from spectavi_tpu_torch.sfm import pnp_ransac_batch, rodrigues

    rng = np.random.default_rng(SEED)
    problems = []
    for _ in range(8):
        rv, tv = rng.normal(0, 0.3, 3), rng.normal(0, 0.3, 3)
        R = rodrigues(torch.as_tensor(rv)).numpy()
        X = rng.standard_normal((4096, 3)) * [1, 1, 0.5] + [0, 0, 6.0]
        Xc = X @ R.T + tv
        uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-4, (4096, 2))
        uv[:1024] += rng.uniform(0.05, 0.2, (1024, 2)) * rng.choice([-1, 1], (1024, 2))
        problems.append((X, uv))
    pnp_ransac_batch(problems[:1], device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = pnp_ransac_batch(problems, device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    emit("pnp_cap", problems=8, rows=4096, trials=512, ms=ms, base_mib=base / 2**20,
         peak_mib=torch.cuda.max_memory_allocated() / 2**20,
         n_inliers=[r["n_inliers"] for r in res])
    if not all(r["success"] and r["n_inliers"] >= 2900 for r in res):
        raise AssertionError("PnP at the chunk cap missed its inliers")


def phase_sfm_scale(torch, np):
    """24 views with sequential and skip-2 pairs (45 pairs), 30 BA
    iterations, written to a checkpoint; then a run that resumes from
    it."""
    from spectavi_tpu_torch.sfm import resection

    grays, _, K, poses = render_views(SCALE_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX)
    gt_C = np.array([C for _, _, C in poses])
    pairs = ([(i, i + 1) for i in range(SCALE_VIEWS - 1)]
             + [(i, i + 2) for i in range(SCALE_VIEWS - 2)])
    ckpt = os.path.join(ROOT, "build", "sfm_scale_state.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    # PnP registration rounds (calls from incremental_poses) and the
    # dispatches they ran (chunks of at most 32768 // Npad problems)
    seen = {"rounds": 0, "depth": 0, "dispatches": []}
    batch_fn, full_fn = resection.pnp_ransac_batch, resection._pnp_full

    def batch(*a, **k):
        seen["rounds"] += seen["depth"] == 0
        seen["depth"] += 1
        try:
            return batch_fn(*a, **k)
        finally:
            seen["depth"] -= 1

    def full(X, *a, **k):
        seen["dispatches"].append([int(X.shape[0]), int(X.shape[1])])
        return full_fn(X, *a, **k)

    resection.pnp_ransac_batch, resection._pnp_full = batch, full
    out = {}
    try:
        for name in ("first", "resume"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = sfm_run(torch, grays, K, "cuda", pairs=pairs, ba_iters=30, checkpoint=ckpt)
            torch.cuda.synchronize()
            share = ate_share(np, res["cams"], gt_C)
            out[name] = (res, dict(sfm_summary(res, share), wall_seconds=time.perf_counter() - t0,
                                   peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                                   pnp_rounds=seen["rounds"],
                                   pnp_dispatches=list(seen["dispatches"])))
            seen["rounds"] = 0
            seen["dispatches"].clear()
    finally:
        resection.pnp_ransac_batch, resection._pnp_full = batch_fn, full_fn
    (r1, s1), (r2, s2) = out["first"], out["resume"]
    resumed = np.array_equal(r1["tracks"], r2["tracks"])
    emit("sfm_scale", views=SCALE_VIEWS, shape=[SFM_H, SFM_W], ba_iters=30,
         resumed=resumed, first=s1, resume=s2)
    for r, sm, name in ((r1, s1, "sfm_scale"), (r2, s2, "sfm_scale resume")):
        check_sfm(np, r, sm["ate_share"], len(pairs), name)
    if not resumed:
        raise AssertionError("the second 24-view run did not resume from the checkpoint")


def phase_sfm_cpu_parity(torch, np):
    """``tests/test_sfm_pipeline.py``'s 3-view 120x160 scene on the card
    and on the CPU (plain kernels), with the loop pair backend (what
    "auto" takes for 2 pairs) and with the batched one.  At 0.5 px noise
    on 160-pixel views few seven-point roots pass the default
    singular-value gate of 1e-3, so the batched runs take it at 1e-2,
    where the batch resolves every pair itself; no pair may be
    retried."""
    grays, K, gt_C = tiny_views("cuda")
    summ, bad = {}, []
    for backend, opts in (("loop", None), ("batched", {"singular_value_ratio_allowed": 1e-2})):
        got = {}
        for dev in ("cuda", "cpu"):
            res = sfm_run(torch, grays, K, dev, ransac=opts, pair_backend=backend)
            got[dev] = (res["metrics"], ate_share(np, res["cams"], gt_C))
        (mg, ag), (mc, ac) = got["cuda"], got["cpu"]
        summ[backend] = {dev: {"keypoints": m["keypoints_per_view"],
                               "matches": [p.get("matches", 0) for p in m["pairs"]],
                               "tracks": m["n_tracks"], "ate_share": a,
                               "pair_backend": m["pair_backend"],
                               "retried": [bool(p.get("batched_retry")) for p in m["pairs"]]}
                         for dev, (m, a) in got.items()}
        kp_ok = all(abs(a - b) <= 0.02 * b for a, b in
                    zip(mg["keypoints_per_view"], mc["keypoints_per_view"]))
        mm = [(a.get("matches", 0), b.get("matches", 0)) for a, b in zip(mg["pairs"], mc["pairs"])]
        m_ok = len(mg["pairs"]) == len(mc["pairs"]) and all(abs(a - b) <= 0.03 * b for a, b in mm)
        t_ok = abs(mg["n_tracks"] - mc["n_tracks"]) <= 0.05 * mc["n_tracks"]
        path_ok = all(m["pair_backend"] == backend and not any(
            p.get("batched_retry") for p in m["pairs"]) for m in (mg, mc))
        if not (kp_ok and m_ok and t_ok and path_ok and ag < 0.10 and ac < 0.10):
            bad.append(backend)
    emit("sfm_cpu_parity", shape=[120, 160], **summ)
    if bad:
        raise AssertionError(f"the card and the CPU disagree on the 3-view scene ({bad}): {summ}")


def rotation_angle_deg(Ra, Rb):
    import numpy as np

    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main(argv):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "spectavi_tpu_torch")):
        print("chip_smoke: spectavi_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import spectavi_tpu_torch  # noqa: F401  (precision pin)
    from spectavi_tpu_torch.features import sift
    from spectavi_tpu_torch.ops import _build, l2nn
    from spectavi_tpu_torch.ops import sift_desc as sd
    from spectavi_tpu_torch.ops import sift_orient as so
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays

    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    reports = _build.build(verbose="--ptxas" in argv)
    emit("build", seconds=time.perf_counter() - t0, built=sorted(reports))
    if "--ptxas" in argv:
        for name, rep in reports.items():
            print(f"--- ptxas {name}\n{rep}", flush=True)

    t0 = time.perf_counter()
    grays, colors, K, (R_gt, t_gt) = render_pair(H, W, "cuda", TEX)
    small = render_pair(SMALL_H, SMALL_W, "cuda", SMALL_TEX)
    torch.cuda.synchronize()
    emit("render", seconds=time.perf_counter() - t0, shape=[H, W])

    res_k1 = check_k1(torch, l2nn)
    octs = octave_inputs(torch, sift, grays[0], (0, SMALL_OCTAVE))
    mod, ang, sel = octs[0]
    mod_s, ang_s, sel_s = octs[SMALL_OCTAVE]
    args_s = k2_args(torch, sift, mod_s, ang_s, sel_s)
    res_k2, th, av = check_k2(torch, so, k2_args(torch, sift, mod, ang, sel), args_s)
    args = k3_args(torch, sift, mod, ang, sel, th, av)
    th_s, av_s = sift.orientations(*args_s)
    res_k3 = check_k3(torch, sd, args,
                      k3_args(torch, sift, mod_s, ang_s, sel_s, th_s, av_s))
    del octs, mod, ang, sel, th, av, args, args_s, mod_s, ang_s, sel_s, th_s, av_s
    torch.cuda.empty_cache()
    if "--checks-only" in argv:
        emit("done", seconds=time.perf_counter() - t_start, checks_only=True)
        return 0

    def run(device, g, c, k, matching_method="auto"):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        return run_two_view_arrays(g, c, k, outdir=None, quiet=True, generator=gen,
                                   matching_method=matching_method, device=device)

    t0 = time.perf_counter()
    cold = run("cuda", grays, colors, K)
    cold_s = time.perf_counter() - t0
    wrappers = {"l2nn_top2": l2nn, "sift_orient_hist": so, "sift_desc": sd}
    for mod_ in wrappers.values():
        mod_.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run("cuda", grays, colors, K)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {name: mod_.launches for name, mod_ in wrappers.items()}
    m = warm["metrics"]
    rot_err, t_err = pose_errors(np, warm["ransac"]["camera"], R_gt, t_gt)
    emit("two_view", cold_seconds=cold_s, warm_seconds=warm_s,
         keypoints=m["keypoints"], n_matches=m["n_matches"], consensus=m["consensus"],
         n_inliers=m["n_inliers"], ransac_success=m["ransac_success"],
         steps={k: v for k, v in m.items() if k.endswith("_seconds")},
         cold_steps={k: v for k, v in cold["metrics"].items() if k.endswith("_seconds")},
         rotation_err_deg=rot_err, translation_err_deg=t_err, launches=launches,
         rectified_shape=list(warm["rectified"][0].shape))
    check_two_view(np, warm, R_gt, t_gt)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    profile_dir = argv[argv.index("--profile") + 1] if "--profile" in argv else None
    run_ms = profile_run(torch, lambda: run("cuda", grays, colors, K), profile_dir, warm_s)

    # the other matchers of step 2: SIFT, then the matcher, both on the card
    mg, mc, mk, (mR, mt_) = render_pair(MID_H, MID_W, "cuda", MID_TEX)
    by_method = {}
    for method in ("cascading-hash", "bruteforce"):
        for mod_ in wrappers.values():
            mod_.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run("cuda", mg, mc, mk, method)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mm = res["metrics"]
        n_launch = {name: mod_.launches for name, mod_ in wrappers.items()}
        r_err, tr_err = check_two_view(np, res, mR, mt_)
        if not (mm["matching_method"] == method and mm["fused_frontend"] is False
                and n_launch["sift_orient_hist"] > 0 and n_launch["sift_desc"] > 0):
            raise AssertionError(f"the {method} run did not take the unfused path: {mm}, {n_launch}")
        by_method[method] = {
            "seconds": seconds, "keypoints": mm["keypoints"], "n_matches": mm["n_matches"],
            "consensus": mm["consensus"], "n_inliers": mm["n_inliers"],
            "step2_seconds": mm["step2_seconds"], "rotation_err_deg": r_err,
            "translation_err_deg": tr_err, "launches": n_launch}
    emit("two_view_matchers", shape=[MID_H, MID_W], **by_method)

    from spectavi_tpu_torch import match
    from spectavi_tpu_torch.features import (normalize_to_ubyte_and_multiple_16_dim,
                                             sift_filter_batch)

    rows = sift_filter_batch(grays, device="cuda")
    check_matchers(torch, np, match, *(normalize_to_ubyte_and_multiple_16_dim(r) for r in rows))
    del rows
    torch.cuda.empty_cache()

    sg, sc, sk, _ = small
    g_res = run("cuda", sg, sc, sk, "l2-mxu")["metrics"]
    c_res = run("cpu", sg, sc, sk, "l2-mxu")["metrics"]
    emit("cpu_parity", shape=[SMALL_H, SMALL_W],
         cuda={k: g_res[k] for k in ("keypoints", "n_matches", "consensus")},
         cpu={k: c_res[k] for k in ("keypoints", "n_matches", "consensus")})
    kp_ok = all(abs(a - b) <= 0.02 * b for a, b in zip(g_res["keypoints"], c_res["keypoints"]))
    nm_ok = abs(g_res["n_matches"] - c_res["n_matches"]) <= max(2, 0.03 * c_res["n_matches"])
    cons_ok = abs(g_res["consensus"] - c_res["consensus"]) <= 0.05
    if not (kp_ok and nm_ok and cons_ok):
        raise AssertionError("the card and the CPU disagree on the small pair")

    # the multi-view phases, each with its own clock
    phase_s = {"before_sfm": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    warm_sfm, sfm_K, launches_sfm, run_ms_sfm = phase_sfm(torch, np, wrappers, profile_dir)
    phase_s["sfm"] = time.perf_counter() - t0
    for name, fn, args in (("ba_check", phase_ba_check, (warm_sfm, sfm_K)),
                           ("pnp_cap", phase_pnp_cap, ()), ("sfm_scale", phase_sfm_scale, ()),
                           ("sfm_cpu_parity", phase_sfm_cpu_parity, ())):
        t0 = time.perf_counter()
        fn(torch, np, *args)
        phase_s[name] = time.perf_counter() - t0
    del warm_sfm

    kernels = []
    for name, res, src, rep in (
        ("l2nn_top2", res_k1, "spectavi_tpu_torch/csrc/l2nn_top2.cu",
         "spectavi_tpu/ops/l2nn_pallas.py:121"),
        ("sift_orient_hist", res_k2, "spectavi_tpu_torch/csrc/sift_orient.cu",
         "spectavi_tpu/ops/sift_orient.py:119"),
        ("sift_desc", res_k3, "spectavi_tpu_torch/csrc/sift_desc.cu",
         "spectavi_tpu/ops/sift_desc.py:195"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "run_ms": run_ms[name], "launches_sfm": launches_sfm[name],
            "run_ms_sfm": run_ms_sfm[name],
        })
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=phase_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

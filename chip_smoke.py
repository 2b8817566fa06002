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
* ``surface``   the JAX package's call forms on the card: the unmasked
                pair step (``masked=False``, JAX's default) on the warm
                10-view run's pair tables, K1 once a pair, byte for byte
                equal to the masked step at full row counts; then
                ``ransac_essential_batch``, ``pnp_ransac``,
                ``nn_cascading_hash``, ``kmedians`` and ``kmeans_cells``
                called positionally in JAX's order with a seeded
                generator, each equal to the keyword call with the same
                seed; milliseconds of each;
* ``distributed`` the mesh layer in worker processes (``--dist-worker``):
                one NCCL rank and four gloo ranks, each with its own
                launch counts (``dist_worker``);
* ``kernels``   one line for every kernel: launches in the warm two-view
                run, ms, plain ms, bound ms and what bounds it, ``run_ms``,
                its summed device time over the profiled warm run,
                ``launches_sfm`` / ``run_ms_sfm`` of the 10-view run,
                ``launches_surface`` of the unmasked step and
                ``launches_dist`` by job and rank.

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


def k1_main_inputs(torch):
    """``check_K1``'s main case, X = Y = 28000 seeded uint8 rows of D =
    144: ``(generator, x, y)``, the generator ready for the other cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    x = torch.randint(0, 256, (28000, 144), generator=gen, device="cuda", dtype=torch.uint8)
    y = torch.randint(0, 256, (28000, 144), generator=gen, device="cuda", dtype=torch.uint8)
    return gen, x, y


def check_k1(torch, l2nn):
    gen, x, y = k1_main_inputs(torch)
    (X, D), Y = x.shape, y.shape[0]
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


def capture_step_tables(torch, two_view, tables):
    """Wrap ``two_view.make_two_view_step`` so that each call of a step
    it builds appends a dict to ``tables``: the step's keyword
    arguments (``kw``), its padded inputs (``desc0, desc1, pts0, pts1,
    nx, ny``), the ``(B, trials, 7)`` sample table drawn for it (one
    ``sample_subsets`` draw a pair, in the RANSAC core: ``sample``) and
    its outputs (``out``); returns a function that undoes it."""
    ransac = sys.modules["spectavi_tpu_torch.mvg.ransac"]  # imported by two_view
    make = two_view.make_two_view_step

    def wrapped_make(*a, **k):
        step = make(*a, **k)

        def wrapped_step(desc0, desc1, pts0, pts1, generator=None, nx=None, ny=None, **kk):
            draws, draw = [], ransac.sample_subsets

            def record(*sa, **sk):
                draws.append(draw(*sa, **sk))
                return draws[-1]

            ransac.sample_subsets = record
            try:
                out = step(desc0, desc1, pts0, pts1, generator, nx, ny, **kk)
            finally:
                ransac.sample_subsets = draw
            sample = torch.stack(draws) if draws else kk.get("sample")
            tables.append({"kw": k, "desc0": desc0, "desc1": desc1, "pts0": pts0,
                           "pts1": pts1, "nx": nx, "ny": ny, "sample": sample, "out": out})
            return out

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
    d0, d1 = tables[-1]["desc0"], tables[-1]["desc1"]
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
    undo_tables = capture_step_tables(torch, two_view, tables)
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
    step_capture = tables[-1]
    del tables
    run_ms = profile_run(torch, lambda: sfm_run(torch, grays, K, "cuda"), profile_dir, warm_s,
                         "profile_sfm", "sfm_trace.json", host_ops=False)
    return warm, K, launches, run_ms, step_capture


def ba_problem(np, res, K):
    """The warm 10-view run's BA problem, its solution perturbed (seeded):
    ``(cams0, pts0, cam_idx, pt_idx, uv)`` numpy."""
    from spectavi_tpu_torch.sfm import tracks_to_observations

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
    return cams0, pts0, ci, pi, uv


def phase_ba_check(torch, np, res, K):
    """``bundle_adjust_device`` on the warm 10-view problem (its solution
    perturbed, seeded): twice on the card, once on the CPU, float64."""
    from spectavi_tpu_torch.sfm import bundle_adjust_device

    cams0, pts0, ci, pi, uv = ba_problem(np, res, K)
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


def pnp_problems(torch, np, count, rows):
    """``count`` seeded PnP problems ``(X, uv)`` of ``rows`` rows, the
    first quarter of each outliers."""
    from spectavi_tpu_torch.sfm import rodrigues

    rng = np.random.default_rng(SEED)
    problems = []
    for _ in range(count):
        rv, tv = rng.normal(0, 0.3, 3), rng.normal(0, 0.3, 3)
        R = rodrigues(torch.as_tensor(rv)).numpy()
        X = rng.standard_normal((rows, 3)) * [1, 1, 0.5] + [0, 0, 6.0]
        Xc = X @ R.T + tv
        uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-4, (rows, 2))
        n_out = rows // 4
        uv[:n_out] += rng.uniform(0.05, 0.2, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
        problems.append((X, uv))
    return problems


def phase_pnp_cap(torch, np):
    """One ``pnp_ransac_batch`` dispatch at the chunk cap (8 problems of
    4096 rows: Bpad x Npad = 32768), 25% outliers: time and peak device
    memory."""
    from spectavi_tpu_torch.sfm import pnp_ransac_batch

    problems = pnp_problems(torch, np, 8, 4096)
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


def seeded(torch, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def same_bytes(np, a, b):
    """Whether two results (tensors, arrays, dicts or sequences of them)
    hold the same values, byte for byte."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bytes(np, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bytes(np, x, y) for x, y in zip(a, b))
    a, b = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_surface(torch, np, cap, wrappers):
    """The JAX package's call forms on the card.  The unmasked pair step
    (``make_two_view_step(mesh, trials, ...)``, JAX's default
    ``masked=False``: keys fifth, four outputs) on the warm 10-view
    run's padded pair tables, with every launch count at 0 around it
    (K1 once a pair), against the masked step at full row counts on the
    same tables and seed, byte for byte.  Then ``ransac_essential_batch``,
    ``pnp_ransac``, ``nn_cascading_hash``, ``kmedians`` and
    ``kmeans_cells`` called positionally in JAX's order, a seeded
    generator where JAX takes its key, each against the keyword call
    with the same seed.  Returns the step's launches by wrapper."""
    from spectavi_tpu_torch import match
    from spectavi_tpu_torch.match import ivf
    from spectavi_tpu_torch.mvg import ransac_essential_batch
    from spectavi_tpu_torch.parallel import make_two_view_step
    from spectavi_tpu_torch.sfm import pnp_ransac

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    kw = cap["kw"]
    d = (cap["desc0"], cap["desc1"], cap["pts0"], cap["pts1"])
    B, X, Y = d[0].shape[0], d[0].shape[1], d[1].shape[1]
    jax_args = (kw["trials"], kw["reproj_allowed"], kw["svr_allowed"], kw["min_ratio"])
    unmasked = make_two_view_step(None, *jax_args, False, kw["compact_to"])
    masked = make_two_view_step(None, *jax_args, True, kw["compact_to"])
    for mod_ in wrappers.values():
        mod_.launches = 0
    out, step_ms = timed(lambda: unmasked(*d, seeded(torch, SEED + 3)))
    launches = {name: mod_.launches for name, mod_ in wrappers.items()}
    full, masked_ms = timed(lambda: masked(*d, seeded(torch, SEED + 3), np.full(B, X),
                                           np.full(B, Y)))
    counts = out[2].cpu().numpy()
    step = {"pairs": B, "X": X, "Y": Y, "outputs": len(out), "ms": step_ms,
            "masked_full_counts_ms": masked_ms, "counts": counts.tolist(),
            "identical_to_masked_full_counts": len(out) == 4 and same_bytes(np, out, full[:4]),
            "launches": launches}

    forms = {}
    # the pair tables' matches: pts0 at the nearest rows, the ratio mask
    midx0, ratio_ok = cap["out"][4], cap["out"][5]
    x0 = torch.take_along_dim(cap["pts0"], midx0[..., None], dim=1)
    ransac = (x0, cap["pts1"], kw["trials"], kw["reproj_allowed"], kw["svr_allowed"], ratio_ok)
    pos, ms = timed(lambda: ransac_essential_batch(seeded(torch, SEED + 4), *ransac))
    kwd = ransac_essential_batch(generator=seeded(torch, SEED + 4), x0=ransac[0], x1=ransac[1],
                                 trials=ransac[2], reproj_allowed=ransac[3],
                                 svr_allowed=ransac[4], point_mask=ransac[5])
    forms["ransac_essential_batch"] = {"equal": same_bytes(np, pos, kwd), "ms": ms,
                                       "problems": B, "rows": Y,
                                       "min_count": int(pos["count"].min())}
    X3, uv = pnp_problems(torch, np, 1, 2048)[0]
    pos, ms = timed(lambda: pnp_ransac(X3, uv, seeded(torch, SEED + 5), 512))
    kwd = pnp_ransac(X3, uv, generator=seeded(torch, SEED + 5), trials=512)
    forms["pnp_ransac"] = {"equal": same_bytes(np, pos, kwd), "ms": ms, "rows": 2048,
                           "success": pos["success"], "n_inliers": pos["n_inliers"]}
    # pair 0's descriptors as the matchers take them: de-meaned byte rows
    nx0, ny0 = int(cap["nx"][0]), int(cap["ny"][0])
    qx = (d[0][0, :nx0].float() - 128).cpu().numpy()
    qy = (d[1][0, :ny0].float() - 128).cpu().numpy()
    pos, ms = timed(lambda: match.nn_cascading_hash(qx, qy, 2, None, 2, 2,
                                                    seeded(torch, SEED + 6), 512))
    kwd = match.nn_cascading_hash(qx, qy, k=2, m=None, n=2, g=2,
                                  generator=seeded(torch, SEED + 6), chunk=512)
    forms["nn_cascading_hash"] = {"equal": same_bytes(np, pos, kwd), "ms": ms,
                                  "rows": [nx0, ny0]}
    pos, ms = timed(lambda: match.kmedians(seeded(torch, SEED + 7), qx, 30, 8))
    kwd = match.kmedians(generator=seeded(torch, SEED + 7), x=qx, k=30, niter=8)
    forms["kmedians"] = {"equal": same_bytes(np, pos, kwd), "ms": ms, "rows": nx0, "k": 30}
    pos, ms = timed(lambda: ivf.kmeans_cells(qx, seeded(torch, SEED + 8), 64, 5))
    kwd = ivf.kmeans_cells(x=qx, generator=seeded(torch, SEED + 8), n_cells=64, iters=5)
    forms["kmeans_cells"] = {"equal": same_bytes(np, pos, kwd), "ms": ms, "rows": nx0,
                             "n_cells": 64}
    emit("surface", unmasked_step=step, jax_forms=forms)
    bad = [name for name, f in forms.items() if not f["equal"]]
    if not (step["identical_to_masked_full_counts"] and (counts > 0).all()
            and launches["l2nn_top2"] == B):
        bad.append("unmasked_step")
    if not (forms["ransac_essential_batch"]["min_count"] > 0 and forms["pnp_ransac"]["success"]
            and forms["pnp_ransac"]["n_inliers"] >= 1400):
        bad.append("results")
    if bad:
        raise AssertionError(f"the surface phase failed on {bad}")
    return launches


# --- distribution over torch.distributed ----------------------------

# the distributed phase's jobs: backend, ranks, matching meshes (n_pairs, n_blocks).
# NCCL refuses two ranks on one card, so the 4-rank job is gloo, over CUDA tensors
DIST_JOBS = {"nccl_1_rank": ("nccl", 1, ((1, 1),)), "gloo_4_ranks": ("gloo", 4, ((1, 4), (2, 2)))}
DIST_TIMEOUT_S = 300
# LM damping of the sharded BA steps
DIST_LAM = 1e-3


def median_ms(np, fn, sync, n=5):
    """Median host-clock milliseconds of ``n`` calls of ``fn``, each
    between two calls of ``sync``."""
    t = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def dist_inputs(torch, np, res, K, cap, path):
    """Write the distributed phase's inputs and single-card answers to
    ``path`` (npz): ``check_K1``'s 28000 x 144 case and K1's answer; a
    4096 x 128 byte case and ``l1_topk2_xla``'s; the warm 10-view run's
    pair step (padded tables, the sample table it drew, its outputs,
    reproduced here from that table); the ``ba_check`` problem with one
    ``ba_step`` from it, and its observations padded for 4 ranks and
    sharded by point.  Returns the median ms of the single-card calls
    (K1, ``l1_topk2_xla``, the step, ``ba_step``) on those inputs."""
    from spectavi_tpu_torch.match import l1_topk2_xla
    from spectavi_tpu_torch.ops import l2nn
    from spectavi_tpu_torch.parallel import make_two_view_step
    from spectavi_tpu_torch.sfm import ba_cost, ba_step, pad_observations
    from spectavi_tpu_torch.sfm.distributed import shard_observations_by_point

    N = lambda t: t.cpu().numpy()
    out = {}
    _, x, y = k1_main_inputs(torch)
    out["k1_x"], out["k1_y"] = N(x), N(y)
    out["k1_idx"], out["k1_dist"] = (N(t) for t in l2nn.l2_topk2_cuda(x, y))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    lx, ly = (torch.randint(0, 256, (4096, 128), generator=gen, device="cuda", dtype=torch.uint8)
              for _ in range(2))
    out["l1_x"], out["l1_y"] = N(lx), N(ly)
    out["l1_idx"], out["l1_dist"] = (N(t) for t in l1_topk2_xla(lx, ly, device="cuda"))
    if cap["sample"] is None:
        raise AssertionError("the 10-view run's pair step drew no sample table")
    names = ("E", "P1", "count", "inl", "midx0", "ratio_ok")
    again = make_two_view_step(**cap["kw"])(cap["desc0"], cap["desc1"], cap["pts0"], cap["pts1"],
                                            None, cap["nx"], cap["ny"], sample=cap["sample"])
    for name, a, b in zip(names, again, cap["out"]):
        if not torch.equal(a, b):
            raise AssertionError(f"the pair step handed its own sample table changed {name}")
        out["step_" + name] = N(b)
    for k in ("desc0", "desc1", "pts0", "pts1", "sample"):
        out[k] = N(cap[k])
    out["nx"], out["ny"] = np.asarray(cap["nx"]), np.asarray(cap["ny"])
    out["step_kw"] = np.array(json.dumps(cap["kw"]))
    cams0, pts0, ci, pi, uv = ba_problem(np, res, K)
    w = np.ones(len(ci))
    fixed = np.zeros(len(cams0), bool)
    fixed[0] = True
    out.update(ba_cams=cams0, ba_pts=pts0, ba_ci=ci, ba_pi=pi, ba_uv=uv, ba_w=w, ba_fixed=fixed)
    T = lambda a: torch.as_tensor(a, device="cuda")
    nc, npt, cost = ba_step(T(cams0), T(pts0), T(ci), T(pi), T(uv), T(w),
                            torch.tensor(DIST_LAM, dtype=torch.float64, device="cuda"), T(fixed),
                            k=torch.zeros(2, dtype=torch.float64, device="cuda"), cg_iters=100)
    out.update(ba_new_cams=N(nc), ba_new_pts=N(npt), ba_cost=N(cost),
               ba_after=N(ba_cost(nc, npt, ci, pi, T(uv), T(w))))
    # the same calls on one card, timed as the workers time theirs
    step1 = make_two_view_step(**cap["kw"])
    lam = torch.tensor(DIST_LAM, dtype=torch.float64, device="cuda")
    zk = torch.zeros(2, dtype=torch.float64, device="cuda")
    single = {
        "l2_topk2": lambda: l2nn.l2_topk2_cuda(x, y),
        "l1_topk2_xla": lambda: l1_topk2_xla(lx, ly, device="cuda"),
        "step": lambda: step1(cap["desc0"], cap["desc1"], cap["pts0"], cap["pts1"], None,
                              cap["nx"], cap["ny"], sample=cap["sample"]),
        "ba_step": lambda: ba_step(T(cams0), T(pts0), T(ci), T(pi), T(uv), T(w), lam, T(fixed),
                                   k=zk, cg_iters=100),
    }
    ms = {name: median_ms(np, fn, torch.cuda.synchronize) for name, fn in single.items()}
    for prefix, arrs in (("pad", pad_observations(ci, pi, uv, w, 4)),
                         ("aligned", shard_observations_by_point(4, ci, pi, uv, w))):
        for k, a in zip(("ci", "pi", "uv", "w"), arrs):
            out[f"{prefix}_{k}"] = a
    np.savez(path, **out)
    return ms


def run_dist_job(name, npz, device="cuda"):
    """Start the ranks of job ``name`` (``DIST_JOBS``) as processes of
    this script (``--dist-worker``) that meet through a file under
    ``build/``, wait for them (killing every one after
    ``DIST_TIMEOUT_S``), and return each rank's report."""
    import shutil

    backend, world, _ = DIST_JOBS[name]
    tmp = os.path.join(ROOT, "build", "dist_" + name)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    cmd = [sys.executable, os.path.abspath(__file__), "--dist-worker", name, device,
           "file://" + os.path.join(tmp, "rendezvous"), npz, tmp]
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        t_end = time.perf_counter() + DIST_TIMEOUT_S
        for p in procs:
            logs.append(p.communicate(timeout=max(t_end - time.perf_counter(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed job {name}, rank {r} failed:\n{log[-6000:]}")
    return [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]


def dist_worker(argv):
    """One rank of a distributed job: ``JOB DEVICE RENDEZVOUS NPZ OUTDIR
    RANK``.  Drives the mesh layer with every launch count at 0 (sharded
    K1 matching on each mesh, sharded L1 on 4 ranks, the mesh two-view
    step, 5 sharded BA steps for each observation layout), reads the
    counts, checks each answer against the single-card one, times each
    call (median of 5) and writes ``rank<RANK>.json`` to OUTDIR."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    name, device, rdv, npz, out_dir, rank = argv
    rank = int(rank)
    backend, world, shapes = DIST_JOBS[name]
    sys.path.insert(0, ROOT)
    from spectavi_tpu_torch.ops import l2nn
    from spectavi_tpu_torch.ops import sift_desc as sd
    from spectavi_tpu_torch.ops import sift_orient as so
    from spectavi_tpu_torch.parallel import (BLOCKS, PAIRS, gather_pairs, initialize, local_shard,
                                             make_mesh, make_two_view_step, sharded_l1_topk2,
                                             sharded_l2_topk2)
    from spectavi_tpu_torch.sfm import ba_cost, make_sharded_ba_step

    if device == "cuda":
        torch.cuda.set_device(0)
    initialize(rdv, world, rank, backend=backend)
    inp = dict(np.load(npz))
    meshes = {f"{p}x{b}": make_mesh(p, b, device_type=device, backend=backend) for p, b in shapes}
    ba_mesh = make_mesh(device_type=device, backend=backend)  # every rank on "pairs"
    dev = ba_mesh.device
    T = lambda a: torch.as_tensor(a, device=dev)
    N = lambda t: t.cpu().numpy()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if world > 1:
            tdist.barrier()

    calls = {}
    # the JAX package's calls: every rank passes the whole database, on
    # the host, and each moves only its block to the card
    k1x, k1y = torch.as_tensor(inp["k1_x"]), T(inp["k1_y"])
    for mname, m in meshes.items():
        calls["sharded_l2_" + mname] = lambda m=m: sharded_l2_topk2(m, k1x, k1y)
    step_name, step_mesh = list(meshes.items())[-1]
    if world > 1:
        l1x, l1y = torch.as_tensor(inp["l1_x"]), T(inp["l1_y"])
        calls["sharded_l1_" + step_name] = lambda: sharded_l1_topk2(step_mesh, l1x, l1y)
    B = len(inp["nx"])
    Bm = B - B % step_mesh.shape[PAIRS]
    step_in = [T(inp[k][:Bm]) for k in ("desc0", "desc1", "pts0", "pts1")]
    step_in += [None, inp["nx"][:Bm], inp["ny"][:Bm]]
    step = make_two_view_step(step_mesh, **json.loads(str(inp["step_kw"])))
    calls["step_" + step_name] = lambda: step(*step_in, sample=inp["sample"][:Bm])
    f64 = dict(dtype=torch.float64, device=dev)
    cams0, pts0, fixed = T(inp["ba_cams"]), T(inp["ba_pts"]), T(inp["ba_fixed"])
    lam, k = torch.tensor(DIST_LAM, **f64), torch.zeros(2, **f64)
    layouts = ({"interleaved": ("ba", False)} if world == 1 else
               {"interleaved": ("pad", False), "point_aligned": ("aligned", True)})
    ba = {}
    for lname, (prefix, aligned) in layouts.items():
        obs = [local_shard(ba_mesh, T(inp[f"{prefix}_{c}"]), PAIRS) for c in ("ci", "pi", "uv", "w")]
        ba[lname] = (make_sharded_ba_step(ba_mesh, cg_iters=100, point_aligned=aligned), obs)

    def ba_steps(lname, n):
        bstep, obs = ba[lname]
        cams, pts, costs = cams0, pts0, []
        for _ in range(n):
            cams, pts, cost = bstep(cams, pts, *obs, lam, fixed, k)
            costs.append(cost)
        return cams, pts, costs

    # the distributed path, every count at 0
    wrappers = {"l2nn_top2": l2nn, "sift_orient_hist": so, "sift_desc": sd}
    for mod in wrappers.values():
        mod.launches = 0
    sync()
    got = {cname: fn() for cname, fn in calls.items()}
    got.update({"ba_" + lname: ba_steps(lname, 5) for lname in ba})
    sync()
    launches = {wname: mod.launches for wname, mod in wrappers.items()}

    checks = {}
    for cname, (idx, dist) in ((c, got[c]) for c in got if c.startswith("sharded_")):
        ref = "k1" if cname.startswith("sharded_l2") else "l1"
        checks[cname + "_exact"] = bool(np.array_equal(N(idx), inp[ref + "_idx"])
                                        and np.array_equal(N(dist), inp[ref + "_dist"]))
    full = [N(t) for t in gather_pairs(step_mesh, got["step_" + step_name])]
    for sname, a in zip(("E", "P1", "count", "inl", "midx0", "ratio_ok"), full):
        ref = inp["step_" + sname][:Bm]
        if sname in ("E", "P1"):
            checks[f"step_{sname}_max_abs_err"] = float(np.abs(a - ref).max())
        else:
            checks[f"step_{sname}_identical"] = bool(np.array_equal(a, ref))
    checks["step_pairs"] = int(Bm)
    obs_full = [T(inp["ba_" + c]) for c in ("ci", "pi", "uv", "w")]
    for lname in ba:
        cams, pts, costs = got["ba_" + lname]
        c1, p1, (cost1,) = ba_steps(lname, 1)
        c0 = float(costs[0])
        after = float(ba_cost(c1, p1, *obs_full))
        row = {"cost": c0, "cost_rel_err": abs(c0 - float(inp["ba_cost"])) / float(inp["ba_cost"]),
               "after_rel_err": abs(after - float(inp["ba_after"])) / float(inp["ba_after"]),
               "costs_5": [float(c) for c in costs] + [float(ba_cost(cams, pts, *obs_full))]}
        if world == 1:  # a one-rank reduction is the identity
            row["identical_to_ba_step"] = bool(
                N(c1).tobytes() == inp["ba_new_cams"].tobytes()
                and N(p1).tobytes() == inp["ba_new_pts"].tobytes()
                and N(cost1).tobytes() == inp["ba_cost"].tobytes())
        checks["ba_" + lname] = row

    def passed():
        ok = launches["l2nn_top2"] > 0
        for key, v in checks.items():
            if key.endswith(("_exact", "_identical")):
                ok &= v
            elif key.endswith("_max_abs_err"):
                ok &= v <= 1e-6
            elif key.startswith("ba_"):
                ok &= v["cost_rel_err"] <= 1e-10 and v["costs_5"][-1] < v["costs_5"][0]
                ok &= v.get("identical_to_ba_step", True) and v["after_rel_err"] <= 1e-4
        return bool(ok)

    timed = dict(calls, **{"ba_step_" + lname: (lambda lname=lname: ba_steps(lname, 1))
                           for lname in ba})
    ms = {cname: median_ms(np, fn, sync) for cname, fn in timed.items()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "backend": backend, "world": world,
                   "coords": {m: [mesh.coords[PAIRS], mesh.coords[BLOCKS]]
                              for m, mesh in meshes.items()},
                   "launches": launches, "checks": checks, "ms": ms, "ok": passed()}, f)
    tdist.destroy_process_group()
    return 0


def phase_distributed(torch, np, res, K, cap, smi):
    """The mesh layer on the card in two jobs of ranks: NCCL on one rank
    (a ``(1, 1)`` mesh) and gloo on four ranks sharing the card over
    CUDA tensors (``(1, 4)`` and ``(2, 2)``).  Returns each job's
    launches by wrapper and rank."""
    npz = os.path.join(ROOT, "build", "dist_inputs.npz")
    single_ms = dist_inputs(torch, np, res, K, cap, npz)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reports, bad = {}, []
    for name in DIST_JOBS:
        t0 = time.perf_counter()
        ranks = run_dist_job(name, npz)
        reports[name] = {"seconds": time.perf_counter() - t0, "backend": ranks[0]["backend"],
                         "ranks": len(ranks), "launches": [r["launches"] for r in ranks],
                         "coords": [r["coords"] for r in ranks], "checks": ranks[0]["checks"],
                         "ms_rank0": ranks[0]["ms"], "ok": [r["ok"] for r in ranks]}
        bad += [f"{name} rank {r['rank']}" for r in ranks if not r["ok"]]
    emit("distributed", card=smi, single_card_ms=single_ms, **reports)
    if bad:
        raise AssertionError(f"the distributed phase failed its gates on {bad}")
    return {name: {w: [r[w] for r in rep["launches"]] for w in rep["launches"][0]}
            for name, rep in reports.items()}


def rotation_angle_deg(Ra, Rb):
    import numpy as np

    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main(argv):
    if argv[:1] == ["--dist-worker"]:
        return dist_worker(argv[1:])
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
    warm_sfm, sfm_K, launches_sfm, run_ms_sfm, step_capture = phase_sfm(torch, np, wrappers,
                                                                         profile_dir)
    phase_s["sfm"] = time.perf_counter() - t0
    for name, fn, args in (("ba_check", phase_ba_check, (warm_sfm, sfm_K)),
                           ("pnp_cap", phase_pnp_cap, ()), ("sfm_scale", phase_sfm_scale, ()),
                           ("sfm_cpu_parity", phase_sfm_cpu_parity, ())):
        t0 = time.perf_counter()
        fn(torch, np, *args)
        phase_s[name] = time.perf_counter() - t0
    # the JAX package's call forms, the unmasked step with its own counts
    t0 = time.perf_counter()
    launches_surface = phase_surface(torch, np, step_capture, wrappers)
    phase_s["surface"] = time.perf_counter() - t0
    # the mesh layer in worker processes, each counting its own launches
    t0 = time.perf_counter()
    launches_dist = phase_distributed(torch, np, warm_sfm, sfm_K, step_capture, smi)
    phase_s["distributed"] = time.perf_counter() - t0
    del warm_sfm, step_capture

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
            "run_ms_sfm": run_ms_sfm[name], "launches_surface": launches_surface[name],
            # by rank, in each job of the distributed phase
            "launches_dist": {job: counts[name] for job, counts in launches_dist.items()},
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

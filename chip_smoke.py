#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spectavi_tpu_torch``) on one GPU.

Phases, one JSON line each:

* ``env``       card, power limit, torch and CUDA versions;
* ``build``     compile every source under ``spectavi_tpu_torch/csrc/``
                (one ``nvcc`` per kernel and ``g++`` for the JPEG codec,
                all started together);
* ``render``    a 2048x3072 two-view pair rendered on the card by the
                benchmark's renderer (``sfmbench/scene.py``: a heightfield
                with seeded multi-scale noise texture, known K and
                cameras), plus a 240x320 pair for the CPU check;
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
* ``check_K4``  the Sampson counting kernel against its plain version at
                the shapes the main path gives it, captured from warm
                runs: the 55-pair step of 11 views of 2048x3072 (every
                survivor, 8192 trials a pair), the 45-pair step of 10
                views of 480x640 and a two-view RANSAC block of the
                rendered pair; to the bit against its own arithmetic as
                separate elementwise operations, and against the plain
                version each differing count explained by rows within
                their float32 rounding bound of the threshold (and how
                many a float64 band of 1e-4 relative explains); CUDA-event ms, bound
                ms, plain ms, the share of counts that differ and the
                launches of each warm run (after ``cpu_parity``);
* ``cpu_parity`` the same pipeline on the small pair on the card and on
                the CPU (plain versions), both given the same RANSAC
                sample tables drawn on the host: keypoint and match
                counts and consensus agree;
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
* ``entry_points`` ex01 and ex02 as users run them, from PNG files that
                the port's codec writes into ``build/entry_points``: ex01
                and ex02 cold in ``python3 -m ...`` subprocesses with no
                ``--device``, ex01's file path identical to the byte to
                its array path, ``--cache``, ``--rsf``/``--reproj``,
                ``--ba`` and ``--ba --distortion`` (pose gates, 240x320
                card against CPU), ``--trace``, ex02 exhaustive with a
                checkpoint and its resume, ``run_sfm`` with
                ``init="chain", loss="linear"``, host-form SIFT against
                the CPU, and the codec's times at 2048x3072
                (``phase_entry_points``);
* ``jpeg``      the port's JPEG codec on the card's host against Pillow's
                pinned digests (the castle file's pixels, the writer's
                files), its seconds at 800x599 and 2048x3072, ex01 cold
                in a subprocess on the rendered pair as RGB JPEG files,
                identical to the byte to the array path on the decodes,
                and ``run_sfm`` from the 10 views as JPEG (``phase_jpeg``);
* ``jpeg_progressive`` every file of ``tests/data/jpeg/`` (progressive,
                restarts, 4:4:0, 4:1:1) against Pillow's pinned digests,
                and ex01 cold from the progressive pair, identical to
                the byte to the array path (``phase_jpeg_progressive``);
* ``png_depths`` PNG of every bit depth and colour type, plain and
                Adam7, from this script's own encoder (``png_encode``):
                (a) 30 files at 37x53 against Pillow's rule and pinned
                digests, (b) decode seconds of 16-bit gray, 16-bit RGB
                and 8-bit Adam7 RGB at 2048x3072 against budgets, (c)
                ex01 cold from the pair as 16-bit gray (the two-view
                gates, identical to the byte to the array path on the
                ``uint16`` decodes, K1-K3 launched in-process), (d) the
                RGB pair as Adam7 and 480x640 pairs at 1 and 4 bits
                against their array paths, (e) ex02 cold from the 10
                views as 16-bit gray against ``run_sfm_arrays``, (f) the
                small 16-bit pair on the card against the CPU
                (``phase_png_depths``);
* ``pillow_free_inputs`` the inputs that went to Pillow before the
                port read them: (a) the progressive fixtures cut after
                every scan, smoothed as libjpeg-turbo smooths them,
                against Pillow's pinned digests, (b) ex01 cold from the
                progressive pair cut after a middle scan, (c) ex01 cold
                from the pair as 8-bit PPM and ex02 cold from the 10
                views as 16-bit PGM, each identical to the byte to its
                array path, (d) 24 small Netpbm files against Pillow's
                pinned digests (``phase_pillow_free_inputs``);
* ``distributed`` the mesh layer in worker processes (``--dist-worker``):
                one NCCL rank and four gloo ranks, each with its own
                launch counts (``dist_worker``);
* ``kernels``   one line for every kernel: launches in the warm two-view
                run, ms, plain ms, bound ms and what bounds it (K1-K3
                by ``sfmbench/bounds.py``, as the benchmark bounds them),
                ``run_ms``, its summed device time over the profiled warm run,
                ``launches_sfm`` / ``run_ms_sfm`` of the 10-view run,
                ``launches_surface`` of the unmasked step,
                ``launches_entry_points``, ``launches_jpeg``,
                ``launches_jpeg_progressive``, ``launches_png_depths``
                and ``launches_pillow_free_inputs`` of those phases'
                in-process runs and ``launches_dist`` by job and rank.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
last the contract line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero without that line.  Usage: ``python3
chip_smoke.py [--ptxas] [--profile DIR] [--checks-only | --k4]`` (``--ptxas``
prints the compiler's register and shared-memory report; ``--profile``
also writes the profiled run's Chrome trace into DIR; ``--checks-only``
stops after the kernel checks, ``--k4`` runs ``check_K4`` alone after the
build and the render, both without the contract line).  Nothing of
JAX is imported.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

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


# --- scene: the benchmark's renderer (sfmbench/scene.py), imported
# after the CUDA check as torch is, with this script's gray rule ------


def render_views(n, h, w, device, tex_shape, seed=SEED):
    """``n`` views of the scene on the arc, as the pipeline would read
    them from 8-bit gray files: ``(grays float32, colors uint8 numpy, K,
    [(R, t, C)])``."""
    import numpy as np
    import torch

    from sfmbench import scene

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    height, texture_at = scene.make_scene(rng, gen, device, tex_shape)
    K = scene.camera_K(h, w)
    grays, colors, poses = [], [], []
    for i in range(n):
        R, t, C = scene.arc_pose(i, n)
        u8 = (torch.clamp(scene.render(height, texture_at, K, R, t, h, w, device), 0, 1)
              * 255).to(torch.uint8)
        g = u8.to(torch.float32)
        grays.append((g / g.max()).cpu().numpy())
        colors.append(u8.cpu().numpy())
        poses.append((R, t, C))
    return grays, colors, K, poses


def render_pair(h, w, device, tex_shape):
    """Two views on the arc: ``(grays, colors, K, (R1, t1) of view 1
    relative to view 0)``."""
    from sfmbench import scene

    grays, colors, K, poses = render_views(2, h, w, device, tex_shape)
    return grays, colors, K, scene.relative_pose(poses)


def tiny_views(device, nviews=3, h=120, w=160):
    """The 3-view 120x160 scene of ``tests/test_sfm_pipeline.py``'s
    ``_tiny_dataset`` (same seed, texture, heightfield and arc), rendered
    in memory: ``(grays, K, camera centres)``."""
    import numpy as np
    import torch

    from sfmbench import scene

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

    K = scene.camera_K(h, w)
    grays, centres = [], []
    for i in range(nviews):
        R, t, C = scene.arc_pose(i, nviews, arc=(1.4, 0.2, 0.3))
        u8 = (torch.clamp(scene.render(height, texture_at, K, R, t, h, w, device), 0, 1)
              * 255).to(torch.uint8)
        g = u8.to(torch.float32)
        grays.append((g / g.max()).cpu().numpy())
        centres.append(C)
    return grays, K, np.asarray(centres)


# --- bounds: K1-K3's are the benchmark's (sfmbench/bounds.py) -------

# float32 operations of one (hypothesis, row) Sampson test: 12 for E x0h,
# 8 for the two components of E^T x1h the denominator uses, 4 for
# x1h . E x0h, 7 for the denominator, clamp, square, quotient, compare
K4_TEST_FLOPS = 35


def k4_bound_ms(tests):
    """Operations: ``tests`` (hypothesis, real row) pairs of valid
    hypotheses; the bytes (each problem's rows and hypotheses read once,
    a count written) are a few MB, far below."""
    from sfmbench.bounds import PEAK_F32_FLOPS

    return K4_TEST_FLOPS * float(tests) / PEAK_F32_FLOPS * 1e3, "operations"


# --- phases ---------------------------------------------------------

# this script's name of each wrapper, by the benchmark's kernel key
WRAPPER_NAMES = {"K1": "l2nn_top2", "K2": "sift_orient_hist", "K3": "sift_desc"}


def device_functions():
    """The device functions of each wrapper's C entry point, as the
    profiler names them: K1-K3 as ``sfmbench.bounds.KERNELS`` lists
    them, then K4's."""
    from sfmbench.bounds import KERNELS

    return {**{WRAPPER_NAMES[k]: fns for k, (_, _, fns) in KERNELS.items()},
            "sampson_count": ("sampson_count_kernel",)}


@contextlib.contextmanager
def launch_counts(wrappers):
    """Zero every wrapper's ``launches``; on leaving the block, the
    yielded dict holds each wrapper's count, by name."""
    for mod in wrappers.values():
        mod.launches = 0
    counts = {}
    yield counts
    counts.update({name: mod.launches for name, mod in wrappers.items()})


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
    from sfmbench.bounds import k1_bound_ms

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
    from sfmbench.bounds import k2_bound_ms

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
    from sfmbench.bounds import k3_bound_ms

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


def capture_sampson(ransac, calls):
    """Wrap ``ransac._sampson_counts`` so that each call appends its
    ``(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed)`` to
    ``calls``; returns a function that undoes it."""
    fn = ransac._sampson_counts

    def wrapped(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed, *a, **k):
        calls.append((F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed))
        return fn(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed, *a, **k)

    ransac._sampson_counts = wrapped
    return lambda: setattr(ransac, "_sampson_counts", fn)


def k4_ordered_counts(torch, E, valid, x0, x1, pm, thr2, step):
    """K4's arithmetic as one elementwise PyTorch operation per rounding,
    in the kernel's order, ``step`` trials at a time: on the card, the
    counts the kernel must give to the bit."""
    x, y = x0[..., None, None, :, 0], x0[..., None, None, :, 1]
    u, v = x1[..., None, None, :, 0], x1[..., None, None, :, 1]
    thr = torch.tensor(thr2, dtype=torch.float32, device=E.device)
    out = []
    for s in range(0, E.shape[-4], step):
        m = E[..., s : s + step, :, :, :]
        e = [m[..., i // 3, i % 3, None] for i in range(9)]
        a0 = e[0] * x + e[1] * y + e[2]
        a1 = e[3] * x + e[4] * y + e[5]
        a2 = e[6] * x + e[7] * y + e[8]
        b0 = e[0] * u + e[3] * v + e[6]
        b1 = e[1] * u + e[4] * v + e[7]
        xex = u * a0 + v * a1 + a2
        den = torch.clamp(a0 * a0 + a1 * a1 + b0 * b0 + b1 * b1, min=1e-30)
        inl = ((xex * xex) / den <= thr) & pm[..., None, None, :]
        c = inl.sum(-1).to(torch.int32)
        out.append(torch.where(valid[..., s : s + step, :], c, torch.full_like(c, -1)))
    return torch.cat(out, dim=-2)


def k4_threshold_rows(torch, E, x0, x1, pm, thr2, bands):
    """For hypotheses ``E (K, 3, 3)`` over their problems' rows ``x0, x1
    (K, N, 2)``, ``pm (K, N)``: per band ``b`` of ``bands``, the count of
    real rows whose float64 Sampson distance squared ``d`` lies within
    ``b`` relative of ``thr2``; under the key ``"float32"``, the count of
    rows within the float32 rounding bound of their own evaluation,
    ``|d - thr2| <= eps max(d, thr2)`` with ``eps = 2 g6 S / |xEx| +
    2 g3 sum_k |c_k| S_k / den + g4 + 2 u``: ``S`` the sum of the absolute
    products of ``x1h . E x0h``, ``S_k`` those of each denominator
    component ``c_k``, ``g_k = k u / (1 - k u)``, ``u = 2^-24``.  A row
    further from the threshold is counted alike by any float32 route."""
    f8 = torch.float64
    E, x0, x1 = E.to(f8), x0.to(f8), x1.to(f8)
    one = torch.ones_like(x0[..., :1])
    x0h, x1h = torch.cat([x0, one], -1), torch.cat([x1, one], -1)
    Ex0 = torch.einsum("kij,knj->kni", E, x0h)
    Etx1 = torch.einsum("kji,knj->kni", E, x1h)
    xEx = (x1h * Ex0).sum(-1)
    c = torch.stack([Ex0[..., 0], Ex0[..., 1], Etx1[..., 0], Etx1[..., 1]], -1)
    den = (c * c).sum(-1)
    d = xEx * xEx / den.clamp(min=1e-30)
    aE = E.abs()
    aEx0 = torch.einsum("kij,knj->kni", aE, x0h.abs())
    aEtx1 = torch.einsum("kji,knj->kni", aE, x1h.abs())
    S = (x1h.abs() * aEx0).sum(-1)
    Sk = torch.stack([aEx0[..., 0], aEx0[..., 1], aEtx1[..., 0], aEtx1[..., 1]], -1)
    u = 2.0**-24
    g = lambda k: k * u / (1 - k * u)
    eps = (2 * g(6) * S / xEx.abs().clamp(min=1e-300)
           + 2 * g(3) * (c.abs() * Sk).sum(-1) / den.clamp(min=1e-300) + g(4) + 2 * u)
    off = (d - thr2).abs()
    out = {b: ((off <= b * thr2) & pm).sum(-1) for b in bands}
    out["float32"] = ((off <= eps * d.clamp(min=thr2)) & pm).sum(-1)
    return out


K4_BANDS = (1e-4, 1e-3, 1e-2)


def k4_compare(torch, sampson, ransac, call, name, reps):
    """K4 on one captured ``_sampson_counts`` call, as that function runs
    it on a card (``_essential_gate`` over every trial, then one launch),
    against (a) the kernel's arithmetic as separate elementwise
    operations, to the bit, and (b) the plain version, chunked as the
    CPU route chunks it: each differing count explained by real rows
    within the float32 rounding bound of the threshold
    (``k4_threshold_rows``).  How many a fixed float64 band of 1e-4,
    1e-3 or 1e-2 relative explains is reported beside: cancellation in
    ``x1h . E x0h`` moves rows near the threshold by more than 1e-4
    between any two float32 routes (the BLAS one against this order)."""
    F, valid, x0, x1, pm, reproj, svr = call
    thr2 = (0.5 * reproj) ** 2
    lead, T, N = tuple(F.shape[:-4]), F.shape[-4], x0.shape[-2]
    P = int(math.prod(lead))
    E, _ = ransac._essential_gate(F, valid, svr)
    before = sampson.launches
    got = sampson.count_cuda(E, valid, x0, x1, pm, thr2)
    again = sampson.count_cuda(E, valid, x0, x1, pm, thr2)
    torch.cuda.synchronize()
    launches = sampson.launches - before
    step = ransac._plain_chunk(F, N)
    t0 = time.perf_counter()
    plain = torch.cat([sampson.count_plain(E[..., s : s + step, :, :, :],
                                           valid[..., s : s + step, :], x0, x1, pm, thr2)
                       for s in range(0, T, step)], dim=-2)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ordered = k4_ordered_counts(torch, E, valid, x0, x1, pm, thr2, step)
    ms = cuda_ms(lambda: sampson.count_cuda(E, valid, x0, x1, pm, thr2), reps)
    real = pm.reshape(P, N).sum(-1)
    tests = int((valid.reshape(P, -1).sum(-1) * real).sum())
    bound, by = k4_bound_ms(tests)

    gf, pf = got.reshape(P, -1), plain.reshape(P, -1)
    pi, hi = torch.nonzero(gf != pf, as_tuple=True)
    delta = (gf[pi, hi] - pf[pi, hi]).abs()
    explained = {b: 0 for b in K4_BANDS + ("float32",)}
    Ef = E.reshape(P, -1, 3, 3)
    x0f, x1f, pmf = x0.reshape(P, N, 2), x1.reshape(P, N, 2), pm.reshape(P, N)
    for s in range(0, int(pi.shape[0]), 256):
        p_, h_ = pi[s : s + 256], hi[s : s + 256]
        rows = k4_threshold_rows(torch, Ef[p_, h_], x0f[p_], x1f[p_], pmf[p_], thr2, K4_BANDS)
        for b, n in rows.items():
            explained[b] += int((delta[s : s + 256] <= n).sum())
    n_diff = int(pi.shape[0])
    res = {"name": "sampson_count", "shape": {"P": P, "T": T, "H": 3 * T, "N": N},
           "hypotheses": P * 3 * T, "valid": int(valid.sum()), "tests": tests,
           "exact_vs_ordered": bool(torch.equal(got, ordered)),
           "deterministic": bool(torch.equal(got, again)), "launches": launches,
           "differ_vs_plain": n_diff, "differ_share": n_diff / max(P * 3 * T, 1),
           "max_count_diff": int(delta.max()) if n_diff else 0,
           "explained": {str(b): n for b, n in explained.items()},
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    res["ok"] = (res["exact_vs_ordered"] and res["deterministic"] and launches == 2
                 and explained["float32"] == n_diff)
    emit("check_K4_case", case=name, **res)
    return res


def phase_check_k4(torch, np, pair):
    """K4 against its plain version at the three shapes the main path
    gives it, each captured from a warm run: the ``fountain-exh11`` pair
    step (11 views of 2048x3072, 55 pairs, 8192 trials, every survivor),
    ``tum-exh10``'s (10 views of 480x640, 45 pairs) and a castle-size
    two-view RANSAC block (``pair``: grays, colors, K; ex01's defaults),
    with each warm run's K4 launches."""
    from spectavi_tpu_torch.mvg import ransac
    from spectavi_tpu_torch.ops import sampson
    from spectavi_tpu_torch.pipeline.sfm import run_sfm_arrays
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays

    def sfm(grays, K):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        return run_sfm_arrays(grays, K, pairs="exhaustive", generator=gen, quiet=True,
                              device="cuda")

    def two_view(grays, K):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        return run_two_view_arrays(grays, pair[1], K, outdir=None, quiet=True, generator=gen,
                                   device="cuda")

    cases = {}
    for name, render_args, run in (
            ("castle_block", None, two_view),
            ("tum_exh10", (SFM_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX), sfm),
            ("fountain_exh11", (11, H, W, "cuda", TEX), sfm)):
        t0 = time.perf_counter()
        grays, K = (pair[0], pair[2]) if render_args is None else render_views(*render_args)[::2]
        run(grays, K)  # cold
        calls = []
        undo = capture_sampson(ransac, calls)
        before = sampson.launches
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(grays, K)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t1
        finally:
            undo()
        job_launches = sampson.launches - before
        call = max(calls, key=lambda c: c[0].numel())
        res = k4_compare(torch, sampson, ransac, call, name, 3 if name == "fountain_exh11" else 10)
        res.update(warm_seconds=warm_s, job_launches=job_launches, calls=len(calls),
                   seconds=time.perf_counter() - t0)
        cases[name] = res
        del grays, calls, call
        torch.cuda.empty_cache()
    bad = [n for n, r in cases.items() if not r["ok"]]
    emit("check_K4", cases={n: {k: r[k] for k in ("shape", "ms", "bound_ms", "plain_ms",
                                                  "differ_share", "launches", "job_launches",
                                                  "warm_seconds", "ok")}
                            for n, r in cases.items()})
    if bad:
        raise AssertionError(f"K4 sampson_count disagrees with its plain version on {bad}")
    main = cases["fountain_exh11"]
    return {"name": "sampson_count", "max_abs_err": float(main["max_count_diff"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "shape": main["shape"],
            "cases": cases}


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
    every wrapper's summed device time in ms (:func:`device_functions`)."""
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
        for name, fns in device_functions().items()
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
    with launch_counts(wrappers) as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = sfm_run(torch, grays, K, "cuda")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
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
    with launch_counts(wrappers) as launches:
        out, step_ms = timed(lambda: unmasked(*d, seeded(torch, SEED + 3)))
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


# --- the entry points, from files ------------------------------------


def run_cli(module, argv, timeout=900):
    """``python3 -m module argv`` from the repository's root, as a user
    runs it: ``(seconds, stdout)``; a non-zero exit raises."""
    t0 = time.perf_counter()
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout, env=dict(os.environ, PYTHONPATH=path))
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{module} exited with {out.returncode}:\n{out.stderr[-4000:]}")
    return seconds, out.stdout


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def sift_agreement(np, ref, got):
    """``test_torch_sift.py``'s rule: the share of ``ref`` rows with a
    ``got`` row within 0.01 px and 1e-3 rad, and the share of those
    rows' descriptor bytes within 1 LSB."""
    from scipy.spatial import cKDTree

    near = cKDTree(got[:, :2]).query_ball_point(ref[:, :2], r=0.01)
    matched, within = 0, []
    for i, cand in enumerate(near):
        if not cand:
            continue
        cand = np.asarray(cand)
        dang = np.abs((got[cand, 3] - ref[i, 3] + np.pi) % (2 * np.pi) - np.pi)
        if dang.min() < 1e-3:
            matched += 1
            within.append(np.abs(got[cand[np.argmin(dang)], 4:] - ref[i, 4:]) <= 1)
    return matched / max(len(ref), 1), float(np.mean(within)) if within else 0.0


def quiet_main(main, argv):
    """An entry point's ``main(argv)`` in-process, its printing dropped."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def capture_ba(sfm_pkg, seen):
    """Wrap ``spectavi_tpu_torch.sfm.bundle_adjust`` (which step 4
    imports at each call) to append each call's cost history and radial
    coefficients to ``seen``; returns a function that undoes it."""
    fn = sfm_pkg.bundle_adjust

    def wrapped(*a, **k):
        out = fn(*a, **k)
        seen.append({"history": [float(c) for c in out[2]],
                     "k": [float(v) for v in out[3]] if len(out) > 3 else None})
        return out

    sfm_pkg.bundle_adjust = wrapped
    return lambda: setattr(sfm_pkg, "bundle_adjust", fn)


def phase_entry_points(torch, np, pair, small, wrappers, smi):
    """ex01 and ex02 as users run them, from PNG files written by the
    port's codec into a temporary directory under ``build/`` (removed
    when every gate holds), on the card:

    * the codec at 2048x3072: encode of the gray pair and of an RGB
      image, decode of that RGB file (Sub rows) and of the RGB image
      with every row Paeth filtered (budget 2 s), all exact;
    * ex01 cold in a subprocess (``python3 -m ...`` with no
      ``--device``) on the 2048x3072 pair; in-process ``run_two_view``
      from the files and ``run_two_view_arrays`` on the decoded arrays,
      same seeded generator: identical matches, inliers, E, points and
      rectified bytes; the subprocess's cloud has as many vertices and
      its ``rect-*`` the same pixels; the two-view gates;
    * ``--cache`` twice in-process (the second run loads the matches),
      ``--rsf 0.5 --reproj`` on the pair as RGBA files (its four
      rectified channels written and read back), ``--ba`` and
      ``--ba --distortion`` with
      the pose gates, the BA cost not raised and ``|k| < 1e-2``;
    * at 240x320, the card and the CPU given one ``cache.npz``: the
      final BA cost within 1e-6 relative (``--ba``) and 1e-4
      (``--distortion``, ROADMAP C's CG amplification); ``--trace``
      there, whose trace names the three kernels;
    * ex02 cold in a subprocess on the 10 rendered 480x640 views,
      ``--pairs exhaustive --checkpoint``, then again resuming: every
      pair ``success``, ATE under 2% of the span;
    * ``run_sfm`` from the same files with ``init="chain",
      loss="linear"``: ATE under 2% of the span;
    * host-form SIFT (``sift_filter``, ``sift_filter_batch``,
      ``sift_filter_striped`` with 3 bands) on one 480x640 view against
      the port on the CPU, under the SIFT rule.

    Returns the launches of the in-process runs by wrapper."""
    import shutil
    import tempfile

    from spectavi_tpu_torch import sfm as sfm_pkg
    from spectavi_tpu_torch.features import sift
    from spectavi_tpu_torch.pipeline import ex01
    from spectavi_tpu_torch.pipeline import io as pio
    from spectavi_tpu_torch.pipeline.sfm import run_sfm
    from spectavi_tpu_torch.pipeline.two_view import run_two_view, run_two_view_arrays
    from spectavi_tpu_torch.sfm import ate_rmse, camera_centers

    grays, colors, K, (R_gt, t_gt) = pair
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ep_dir = tempfile.mkdtemp(prefix="entry_points-", dir=os.path.join(ROOT, "build"))
    d = lambda *p: os.path.join(ep_dir, *p)
    out, bad = {"card": smi}, []

    def gate(ok, name):
        if not ok:
            bad.append(name)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    with launch_counts(wrappers) as launches:
        # the codec at 2048x3072
        paths = [d(f"im{i}.png") for i in (0, 1)]
        kfile = d("K.txt")
        np.savetxt(kfile, K)
        _, enc_gray = synced(lambda: pio.imsave(paths[0], colors[0]))
        pio.imsave(paths[1], colors[1])
        rgb = np.stack([colors[0], colors[1], colors[0] // 2 + colors[1] // 2], axis=-1)
        _, enc_rgb = synced(lambda: pio.imsave(d("rgb.png"), rgb))
        with open(d("rgb_paeth.png"), "wb") as f:
            f.write(png_encode(np, rgb, 2, 8, [4], level=6))
        pio._decode.cache_clear()
        dec, dec_rgb = synced(lambda: pio.imread(d("rgb.png"), dtype="uint8"))
        dec_p, dec_paeth = synced(lambda: pio.imread(d("rgb_paeth.png"), dtype="uint8"))
        gate(np.array_equal(dec, rgb) and np.array_equal(dec_p, rgb) and dec_paeth < 2.0, "png_rgb")
        gate(all(np.array_equal(pio.imread(p, dtype="uint8"), c) for p, c in zip(paths, colors)),
             "png_gray")
        out["png"] = {"shape": list(rgb.shape), "encode_gray_s": enc_gray, "encode_rgb_s": enc_rgb,
                      "decode_rgb_s": dec_rgb, "decode_rgb_paeth_s": dec_paeth,
                      "rgb_bytes": os.path.getsize(d("rgb.png")),
                      "rgb_paeth_bytes": os.path.getsize(d("rgb_paeth.png"))}

        # ex01 cold, as a user runs it
        cli_s, _ = run_cli("spectavi_tpu_torch.pipeline.ex01",
                           [*paths, kfile, "--outdir", d("ex01_cli"), "--seed", str(SEED)])
        names = ("sparse_inliers.ply", "rect-im0.png", "rect-im1.png", "metrics.json")
        gate(all(os.path.getsize(d("ex01_cli", n)) > 0 for n in names), "ex01_cli_outputs")

        def gen(device="cuda"):
            g = torch.Generator(device=device)
            g.manual_seed(SEED)
            return g

        # both without outputs, so that the difference is the two decodes
        pio._decode.cache_clear()
        files, files_s = synced(lambda: run_two_view(paths, kfile, outdir=None, generator=gen(),
                                                     quiet=True))
        dgrays = [pio.imread(p, dtype="float32", force_grayscale=True) for p in paths]
        dcolors = [pio.imread(p, dtype="uint8") for p in paths]
        arrays, arrays_s = synced(lambda: run_two_view_arrays(dgrays, dcolors, np.loadtxt(kfile),
                                                              generator=gen(), quiet=True))
        same = {k: same_bytes(np, files[k], arrays[k]) for k in ("matches", "points", "rectified")}
        same["inliers"] = same_bytes(np, files["ransac"]["inlier_idx"],
                                     arrays["ransac"]["inlier_idx"])
        same["essential"] = same_bytes(np, files["ransac"]["essential"],
                                       arrays["ransac"]["essential"])
        gate(all(same.values()), "files_vs_arrays")
        rect = [r[..., 0] if r.ndim == 3 else r for r in files["rectified"][:2]]
        cli_rect = [pio.imread(d("ex01_cli", f"rect-im{i}.png"), dtype="uint8") for i in (0, 1)]
        cli_ply = pio.read_ply(d("ex01_cli", "sparse_inliers.ply"))
        gate(cli_ply.shape[0] == files["metrics"]["n_inliers"], "cli_ply_vertices")
        gate(all(same_bytes(np, a, b) for a, b in zip(cli_rect, rect)), "cli_rect")
        rot, t_err = check_two_view(np, files, R_gt, t_gt)

        # --cache: written, then loaded
        argv = [*paths, kfile, "--seed", str(SEED)]
        c1 = quiet_main(ex01.main, argv + ["--outdir", d("cache"), "--cache"])
        c2 = quiet_main(ex01.main, argv + ["--outdir", d("cache"), "--cache"])
        gate(c2["metrics"].get("match_cache_hit") is True and "match_cache_hit" not in c1["metrics"]
             and same_bytes(np, c1["ransac"]["inlier_idx"], c2["ransac"]["inlier_idx"])
             and same_bytes(np, c1["ransac"]["essential"], c2["ransac"]["essential"]), "cache")
        out["ex01"] = {"cold_cli_s": cli_s, "warm_files_s": files_s, "warm_arrays_s": arrays_s,
                       "identical": same, "n_inliers": files["metrics"]["n_inliers"],
                       "consensus": files["metrics"]["consensus"], "rotation_err_deg": rot,
                       "translation_err_deg": t_err,
                       # step 5 writing rect-* (ex01.main's first --cache run) and not
                       "step5_with_files_s": c1["metrics"]["step5_seconds"],
                       "step5_s": arrays["metrics"]["step5_seconds"],
                       "cli_ply_bytes_equal": file_bytes(d("ex01_cli", names[0])) == file_bytes(
                           d("cache", names[0]))}
        out["cache"] = {"first_s": c1["metrics"]["total_seconds"],
                        "resumed_s": c2["metrics"]["total_seconds"]}

        # --rsf 0.5 and --reproj (twice the default threshold), on the pair
        # as RGBA files: distinct channels, a varying alpha
        cpaths = [d(f"c{i}.png") for i in (0, 1)]
        for p, c in zip(cpaths, colors):
            g = c.astype(np.int32)
            pio.imsave(p, np.stack([g, 3 * g // 4 + 32, g // 2 + 100, 255 - g // 8],
                                   axis=-1).astype(np.uint8))
        rr = quiet_main(ex01.main, [*cpaths, kfile, "--seed", str(SEED), "--outdir", d("rsf"),
                                    "--rsf", "0.5", "--reproj", "6.7e-4"])
        w_full, w_half = files["rectified"][0].shape[1], rr["rectified"][0].shape[1]
        gate(int(0.5 * W) - 2 <= w_half <= int(0.5 * W) and w_full > int(0.9 * W), "rsf")
        crect = [pio.imread(d("rsf", f"rect-c{i}.png"), dtype="uint8") for i in (0, 1)]
        gate(all(r.ndim == 3 and r.shape[2] == 4 and same_bytes(np, r, q)
                 for r, q in zip(crect, rr["rectified"][:2])), "rgba_rect")
        rot, t_err = check_two_view(np, rr, R_gt, t_gt)
        out["rsf_reproj"] = {"rect_shape": list(crect[0].shape), "rect_width_rsf1": w_full,
                             "n_inliers": rr["metrics"]["n_inliers"], "rotation_err_deg": rot,
                             "translation_err_deg": t_err}

        # --ba and --ba --distortion at 2048x3072, and at 240x320 card vs CPU
        seen = []
        undo = capture_ba(sfm_pkg, seen)
        try:
            out["ba"] = {}
            for name, flags in (("ba", ["--ba"]), ("ba_distortion", ["--ba", "--distortion"])):
                res = quiet_main(ex01.main, argv + ["--outdir", d(name), *flags])
                rot, t_err = check_two_view(np, res, R_gt, t_gt)
                h, k = seen[-1]["history"], seen[-1]["k"]
                gate(h[-1] <= h[0], f"{name}_cost")
                if k is not None:
                    gate(max(abs(v) for v in k) < 1e-2, f"{name}_k")
                out["ba"][name] = {"step4_s": res["metrics"]["step4_seconds"],
                                   "cost": [h[0], h[-1]], "k": k, "rotation_err_deg": rot,
                                   "translation_err_deg": t_err}
            sg, sc, sK, _ = small
            spaths = [d(f"s{i}.png") for i in (0, 1)]
            for p, c in zip(spaths, sc):
                pio.imsave(p, c)
            np.savetxt(d("Ks.txt"), sK)
            sargv = [*spaths, d("Ks.txt"), "--seed", str(SEED), "--cache", "--reproj", "1e-2"]
            os.makedirs(d("small_cpu"))
            costs = {}
            for dev in ("cuda", "cpu"):
                for name, flags in (("ba", ["--ba"]), ("ba_distortion", ["--ba", "--distortion"])):
                    quiet_main(ex01.main, sargv + ["--outdir", d(f"small_{dev}"), "--device", dev,
                                               *flags])
                    costs.setdefault(name, {})[dev] = seen[-1]["history"][-1]
                if dev == "cuda":  # the CPU runs take the card's matches
                    shutil.copy(d("small_cuda", "cache.npz"), d("small_cpu", "cache.npz"))
        finally:
            undo()
        for name, bound in (("ba", 1e-6), ("ba_distortion", 1e-4)):
            c = costs[name]
            c["rel_diff"] = abs(c["cuda"] - c["cpu"]) / abs(c["cpu"])
            c["bound"] = bound
            gate(c["rel_diff"] < bound, f"small_{name}_cpu")
        out["ba_small_card_vs_cpu"] = costs

        # --trace on the small pair: the trace names the three kernels
        quiet_main(ex01.main, [*spaths, d("Ks.txt"), "--outdir", d("small_trace"), "--trace",
                               d("trace")])
        traces = [f for f in os.listdir(d("trace")) if f.endswith(".json")]
        text = "".join(file_bytes(d("trace", f)).decode() for f in traces)
        found = {name: any(f in text for f in fns) for name, fns in device_functions().items()}
        gate(bool(traces) and all(found.values()), "trace")
        out["trace"] = {"files": len(traces), "bytes": len(text), "kernels": found}

        # ex02 cold, as a user runs it, then resuming from its checkpoint
        vgrays, vcolors, vK, poses = render_views(SFM_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX)
        gt_C = np.array([C for _, _, C in poses])
        vpaths = [d(f"v{i:02d}.png") for i in range(SFM_VIEWS)]
        for p, c in zip(vpaths, vcolors):
            pio.imsave(p, c)
        np.savetxt(d("Kv.txt"), vK)
        span = np.ptp(gt_C, axis=0).max()
        out["ex02"] = {}
        for name in ("cold", "resume"):
            secs, stdout = run_cli("spectavi_tpu_torch.pipeline.ex02",
                                   [*vpaths, d("Kv.txt"), "--pairs", "exhaustive", "--checkpoint",
                                    d("ex02_state.npz"), "--outdir", d(f"ex02_{name}"),
                                    "--seed", str(SEED)])
            with open(d(f"ex02_{name}", "metrics.json")) as f:
                m = json.load(f)
            cams = np.loadtxt(d(f"ex02_{name}", "poses.txt"))
            share = ate_rmse(camera_centers(cams), gt_C) / span
            resumed = "resuming BA from checkpoint" in stdout
            pairs_ok = len(m["pairs"]) == SFM_VIEWS * (SFM_VIEWS - 1) // 2 and all(
                p.get("success") for p in m["pairs"])
            gate(pairs_ok and share < 0.02 and resumed == (name == "resume"), f"ex02_{name}")
            out["ex02"][name] = {"cli_s": secs, "pairs": len(m["pairs"]),
                                 "failed_pairs": [p["pair"] for p in m["pairs"]
                                                  if not p.get("success")],
                                 "min_inlier_percent": min(p.get("inlier_percent", 0.0)
                                                           for p in m["pairs"]),
                                 "init_used": m["init_used"], "pair_backend": m["pair_backend"],
                                 "tracks": m["n_tracks"], "ate_share": share, "resumed": resumed,
                                 "ba_cost": [m["ba_cost_initial"], m["ba_cost_final"]]}

        # run_sfm from the same files with init="chain", loss="linear"
        res, secs = synced(lambda: run_sfm(vpaths, d("Kv.txt"), pairs="exhaustive", init="chain",
                                           loss="linear", generator=gen(), quiet=True))
        share = ate_rmse(camera_centers(res["cams"]), gt_C) / span
        m = res["metrics"]
        gate(m["init_used"] == "chain" and share < 0.02
             and m["ba_cost_final"] <= m["ba_cost_initial"], "chain_linear")
        out["chain_linear"] = {"s": secs, "ate_share": share, "init_used": m["init_used"],
                               "tracks": m["n_tracks"]}

        # host-form SIFT on one view: the card against the port on the CPU
        g0 = vgrays[0]
        ref = sift.sift_filter(g0, device="cpu")
        ref_striped = sift.sift_filter_striped(g0, nthread=3, device="cpu")
        out["host_sift"] = {}
        for name, got, r in (("sift_filter", sift.sift_filter(g0, device="cuda"), ref),
                             ("sift_filter_batch",
                              sift.sift_filter_batch([g0], device="cuda")[0], ref),
                             ("sift_filter_striped",
                              sift.sift_filter_striped(g0, nthread=3, device="cuda"), ref_striped)):
            kp_share, byte_share = sift_agreement(np, r, got)
            gate(abs(len(got) - len(r)) <= 0.01 * len(r) and kp_share >= 0.99
                 and byte_share >= 0.99, name)
            out["host_sift"][name] = {"keypoints": [len(got), len(r)], "kp_share": kp_share,
                                      "byte_share": byte_share}

    gate(all(v > 0 for v in launches.values()), "launches")
    emit("entry_points", launches=launches, failed=bad, **out)
    if bad:
        raise AssertionError(f"the entry_points phase failed on {bad} (files in {ep_dir})")
    shutil.rmtree(ep_dir)
    return launches


# --- JPEG files -----------------------------------------------------

# sha256 of Pillow's decode (Pillow 12.1.0 on libjpeg-turbo) of the
# repository's castle_rect-01.jpg as a (599, 800, 3) uint8 array, and of
# the files Pillow writes at its defaults for jpeg_digest_arrays();
# tests/test_torch_jpeg.py holds the same digests against Pillow, so the
# card's host build of the codec is held to Pillow without Pillow there
CASTLE_JPG = os.path.join("artifacts", "round1", "castle_rect-01.jpg")
JPEG_SHA256 = {
    "castle_pixels": "ecc31d49fbaac7b7fda34ac6f9a64000bf6d22ff86320b5e1d842e5125be59c5",
    "rgb_file": "928131061446e4a63b87b2ce7955d3961fd024264be8ffedbb2a9a5b3cd4ee50",
    "gray_file": "97c62584869c7052181fc1e535f9387e1c0dc45792370df6a8315d19e3e4d6bb",
}
# the quality the rendered views are written at
JPEG_QUALITY = 95


def jpeg_digest_arrays(np):
    """A fixed 97x131 RGB array from integer formulas (no random stream,
    so every numpy gives the same bytes) and its green channel."""
    y, x = np.mgrid[0:97, 0:131].astype(np.int64)
    rgb = np.stack([(x * x * 7 + y * 13 + x * y * 3) % 256, (x * 5 + y * y * 11 + 17) % 256,
                    ((x ^ y) * 9 + x * y) % 256], axis=-1).astype(np.uint8)
    return rgb, rgb[..., 1].copy()


def cli_vs_arrays(np, cli_dir, arrays_dir, arrays, names):
    """ex01's CLI outputs in ``cli_dir`` against ``run_two_view_arrays``'
    result ``arrays`` and files in ``arrays_dir``: ``{what: identical}``
    for the matches, keypoint counts, match and inlier counts and the
    files ``names[:3]`` (the cloud and both ``rect-*``), and the
    ``rect-*`` files' shapes read back as they match the rectified
    arrays'."""
    from spectavi_tpu_torch.pipeline import io as pio

    with open(os.path.join(cli_dir, "metrics.json")) as f:
        cli_m = json.load(f)
    cache = np.load(os.path.join(cli_dir, "cache.npz"))
    same = {"matches": same_bytes(np, cache["xd"], arrays["matches"][0])
            and same_bytes(np, cache["yd"], arrays["matches"][1])}
    for key in ("keypoints", "n_matches", "n_inliers"):
        same[key] = cli_m[key] == arrays["metrics"][key]
    for name in names[:3]:
        same[name] = (file_bytes(os.path.join(cli_dir, name))
                      == file_bytes(os.path.join(arrays_dir, name)))
    rect = [pio.imread(os.path.join(cli_dir, n), dtype="uint8") for n in names[1:3]]
    rect_ok = all(r.shape == a.shape and r.ndim == 3 for r, a in zip(rect, arrays["rectified"][:2]))
    return same, rect_ok, list(rect[0].shape)


def phase_jpeg(torch, np, pair, wrappers, smi):
    """ex01 and ``run_sfm`` from JPEG files that the port's codec writes
    into a temporary directory under ``build/`` (removed when every gate
    holds), on the card:

    * the codec on the card's host: the castle file decodes to Pillow's
      array and the writer's files of :func:`jpeg_digest_arrays` are
      Pillow's (pinned sha256); decode and encode seconds at 800x599 and
      at 2048x3072 (the rendered pair as RGB, quality 95), decode under
      1 s;
    * ex01 cold in a subprocess (``python3 -m ...`` with no ``--device``,
      ``--cache``) on that pair: exit 0, ``rect-*.jpg`` written and read
      back at the rectified shape, and its matches, keypoint counts,
      inliers, cloud and ``rect-*`` files identical to the byte to
      ``run_two_view_arrays`` on the codec's decoded arrays, whose pose
      is inside the two-view gates; warm, ``run_two_view`` from the files
      against ``run_two_view_arrays`` on the decodes, identical;
    * ``run_sfm`` from the 10 rendered 480x640 views as RGB JPEG: every
      pair ``success``, PnP init, ATE under 2% of the span.

    Returns the launches of the in-process runs by wrapper."""
    import hashlib
    import shutil
    import tempfile

    from sfmbench import scene
    from spectavi_tpu_torch.pipeline import io as pio
    from spectavi_tpu_torch.pipeline.jpeg import read_jpeg, write_jpeg
    from spectavi_tpu_torch.pipeline.sfm import run_sfm
    from spectavi_tpu_torch.pipeline.two_view import run_two_view, run_two_view_arrays
    from spectavi_tpu_torch.sfm import ate_rmse, camera_centers

    grays, colors, K, (R_gt, t_gt) = pair
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    jp_dir = tempfile.mkdtemp(prefix="jpeg-", dir=os.path.join(ROOT, "build"))
    d = lambda *p: os.path.join(jp_dir, *p)
    sha = lambda b: hashlib.sha256(b).hexdigest()
    out, bad = {"card": smi}, []

    def gate(ok, name):
        if not ok:
            bad.append(name)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def gen():
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        return g

    with launch_counts(wrappers) as launches:
        # the codec on this host against Pillow's pinned answers
        data = file_bytes(os.path.join(ROOT, CASTLE_JPG))
        castle, castle_dec = timed(lambda: read_jpeg(data))
        _, castle_enc = timed(lambda: write_jpeg(d("castle.jpg"), castle))
        rgb_s, gray_s = jpeg_digest_arrays(np)
        write_jpeg(d("digest_rgb.jpg"), rgb_s)
        write_jpeg(d("digest_gray.jpg"), gray_s)
        digests = {"castle_pixels": sha(castle.tobytes()),
                   "rgb_file": sha(file_bytes(d("digest_rgb.jpg"))),
                   "gray_file": sha(file_bytes(d("digest_gray.jpg")))}
        for name, value in digests.items():
            gate(value == JPEG_SHA256[name], f"{name}_digest")
        gate(castle.shape == (599, 800, 3), "castle_shape")

        # the rendered pair as RGB files at 2048x3072
        rgbs = [scene.as_rgb(c) for c in colors]
        paths = [d(f"im{i}.jpg") for i in (0, 1)]
        kfile = d("K.txt")
        np.savetxt(kfile, K)
        _, enc_rgb = timed(lambda: write_jpeg(paths[0], rgbs[0], quality=JPEG_QUALITY))
        write_jpeg(paths[1], rgbs[1], quality=JPEG_QUALITY)
        data = file_bytes(paths[0])
        dec, dec_rgb = timed(lambda: read_jpeg(data))
        err = float(np.abs(dec.astype(np.int16) - rgbs[0]).mean())
        gate(dec.shape == rgbs[0].shape and same_bytes(np, dec, read_jpeg(data)) and err < 3.0,
             "decode_rgb")
        gate(dec_rgb < 1.0, "decode_rgb_under_1s")
        out["codec"] = {"digests": digests, "castle_shape": list(castle.shape),
                        "castle_decode_s": castle_dec, "castle_encode_s": castle_enc,
                        "shape": list(rgbs[0].shape), "quality": JPEG_QUALITY,
                        "encode_rgb_s": enc_rgb, "decode_rgb_s": dec_rgb, "rgb_bytes": len(data),
                        "mean_abs_err": err}

        # ex01 cold, as a user runs it, against the array path on the decodes
        cli_s, _ = run_cli("spectavi_tpu_torch.pipeline.ex01",
                           [*paths, kfile, "--outdir", d("ex01_cli"), "--seed", str(SEED),
                            "--cache"])
        names = ("sparse_inliers.ply", "rect-im0.jpg", "rect-im1.jpg", "metrics.json", "cache.npz")
        gate(all(os.path.getsize(d("ex01_cli", n)) > 0 for n in names), "ex01_cli_outputs")
        # warm, without outputs: the file path against the arrays it decodes
        pio._decode.cache_clear()
        files, files_s = timed(lambda: run_two_view(paths, kfile, outdir=None, generator=gen(),
                                                    quiet=True))
        dgrays = [pio.imread(p, dtype="float32", force_grayscale=True) for p in paths]
        dcolors = [pio.imread(p, dtype="uint8") for p in paths]
        bare, bare_s = timed(lambda: run_two_view_arrays(dgrays, dcolors, np.loadtxt(kfile),
                                                         generator=gen(), quiet=True))
        gate(all(same_bytes(np, files[k], bare[k]) for k in ("matches", "points", "rectified"))
             and same_bytes(np, files["ransac"]["essential"], bare["ransac"]["essential"]),
             "files_vs_arrays")
        arrays = run_two_view_arrays(dgrays, dcolors, np.loadtxt(kfile), image_names=paths,
                                     outdir=d("arrays"), cache=True, generator=gen(), quiet=True)
        same, rect_ok, rect_shape = cli_vs_arrays(np, d("ex01_cli"), d("arrays"), arrays, names)
        m = arrays["metrics"]
        gate(all(same.values()), "cli_vs_arrays")
        gate(rect_ok, "rect_read_back")
        try:
            rot, t_err = check_two_view(np, arrays, R_gt, t_gt)
        except AssertionError as e:
            rot = t_err = None
            gate(False, f"two_view: {e}")
        out["ex01"] = {"cold_cli_s": cli_s, "warm_files_s": files_s, "warm_arrays_s": bare_s,
                       "identical": same,
                       "keypoints": m["keypoints"], "n_matches": m["n_matches"],
                       "n_inliers": m["n_inliers"], "consensus": m["consensus"],
                       "rotation_err_deg": rot, "translation_err_deg": t_err,
                       "rect_shape": rect_shape}

        # run_sfm from the 10 views as RGB JPEG
        vgrays, vcolors, vK, poses = render_views(SFM_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX)
        gt_C = np.array([C for _, _, C in poses])
        vpaths = [d(f"v{i:02d}.jpg") for i in range(SFM_VIEWS)]
        for p, c in zip(vpaths, vcolors):
            write_jpeg(p, scene.as_rgb(c), quality=JPEG_QUALITY)
        np.savetxt(d("Kv.txt"), vK)
        res, secs = timed(lambda: run_sfm(vpaths, d("Kv.txt"), generator=gen(), quiet=True))
        share = ate_rmse(camera_centers(res["cams"]), gt_C) / np.ptp(gt_C, axis=0).max()
        sm = res["metrics"]
        gate(all(p.get("success") for p in sm["pairs"]) and sm["init_used"] == "pnp"
             and share < 0.02, "run_sfm")
        out["run_sfm"] = {"s": secs, "pairs": len(sm["pairs"]), "init_used": sm["init_used"],
                          "pair_backend": sm["pair_backend"], "tracks": sm["n_tracks"],
                          "ate_share": share}

    gate(all(v > 0 for v in launches.values()), "launches")
    emit("jpeg", launches=launches, failed=bad, **out)
    if bad:
        raise AssertionError(f"the jpeg phase failed on {bad} (files in {jp_dir})")
    shutil.rmtree(jp_dir)
    return launches


# --- progressive JPEG and other sampling factors ---------------------

# the files of tests/data/jpeg (written by Pillow, which the card's
# machine lacks, and regenerated by tests/test_torch_jpeg_progressive.py)
# and the sha256 of Pillow's decode of each (Pillow 12.1.0 on
# libjpeg-turbo 3.1.3), which the codec must give on the card's host
JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")
JPEG_FIXTURE_SHA256 = {
    "castle-progressive.jpg": "07daa172b1e009ff4d601223f4ba1b025bda349cf058ea5f2594253dd5a0a5cb",
    "digest-gray-progressive-rst3.jpg": "979d44478f24f09e304e81e11b1c0fc2d327919aecfa50183bbc6d827eafcc37",
    "digest-rgb-411.jpg": "4d0d60279e998190c09399bc666516d71bf3451e05d2ce6b7fa9f4b363235451",
    "digest-rgb-440-progressive.jpg": "0ba416f831ca538ff4b749402cc69e5b9a36b6c50056ce80d50799600d94a1e4",
    "digest-rgb-440.jpg": "f01c5c6fd9c76bb8a5d1b77cc1fe17f850b50aa2f921c1cabefa6b47c85b2089",
    "digest-rgb-progressive-444.jpg": "e0db1599f169c4e3f5fb16874005a5b06f3582b112b2a0e1073576c9a694038a",
    "digest-rgb-progressive-rst3.jpg": "5ef507b0f3c0b8a1344e88b2bb1fa2cea7f93da5237e1654413e557fdbd43655",
    "pair0.jpg": "31323d6aeac5856d3e928cb1b03738eb2c7b2010140642177d9dc0c271f01b81",
    "pair1.jpg": "d78c886718a247c36af126eaa7fb44bb0f223b66615d1a4eda077babb742290d",
}


def phase_jpeg_progressive(torch, np, wrappers, smi):
    """ex01 from progressive JPEG, as users run it, on the card:

    * the codec on the card's host decodes every fixture (the rendered
      2048x3072 pair and the castle file progressive; the digest arrays
      progressive with restarts and at 4:4:4; SOF-patched 4:4:0, 4:1:1
      and a progressive 4:4:0) to Pillow's pinned digest; decode seconds
      of the progressive pair image and castle file beside the baseline
      files of the same pixels (the codec's writer at quality 90 and
      the repository's castle file), the 2048x3072 decode under 1 s;
    * ex01 cold in a subprocess (``python3 -m ...`` with no ``--device``,
      ``--cache``) on the progressive pair and its ``K.txt``: exit 0,
      ``rect-*.jpg`` read back at the rectified shape, its matches,
      keypoint counts, inliers, cloud and ``rect-*`` files identical to
      the byte to ``run_two_view_arrays`` on the codec's decoded arrays,
      whose pose is inside the two-view gates against ``pose.txt``.

    Returns the launches of the in-process run by wrapper."""
    import hashlib
    import shutil
    import tempfile

    from spectavi_tpu_torch.pipeline import io as pio
    from spectavi_tpu_torch.pipeline.jpeg import read_jpeg, write_jpeg
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    jp_dir = tempfile.mkdtemp(prefix="jpeg-progressive-", dir=os.path.join(ROOT, "build"))
    d = lambda *p: os.path.join(jp_dir, *p)
    fx = lambda *p: os.path.join(ROOT, JPEG_FIXTURES, *p)
    out, bad = {"card": smi}, []

    def gate(ok, name):
        if not ok:
            bad.append(name)

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0

    with launch_counts(wrappers) as launches:
        # every fixture against Pillow's pinned decode
        decoded, seconds = {}, {}
        for name, want in JPEG_FIXTURE_SHA256.items():
            data = file_bytes(fx(name))
            decoded[name], seconds[name] = timed(lambda: read_jpeg(data))
            gate(decoded[name] is not None
                 and hashlib.sha256(decoded[name].tobytes()).hexdigest() == want, f"{name}_digest")
        # the same pixels as baseline files, decoded in this run
        write_jpeg(d("pair0-baseline.jpg"), decoded["pair0.jpg"], quality=90)
        data = file_bytes(d("pair0-baseline.jpg"))
        _, base_pair_s = timed(lambda: read_jpeg(data))
        data = file_bytes(os.path.join(ROOT, CASTLE_JPG))
        _, base_castle_s = timed(lambda: read_jpeg(data))
        gate(seconds["pair0.jpg"] < 1.0, "decode_progressive_under_1s")
        out["codec"] = {"decode_s": seconds,
                        "shapes": {k: list(v.shape) for k, v in decoded.items()},
                        "pair_bytes": os.path.getsize(fx("pair0.jpg")),
                        "baseline_pair_decode_s": base_pair_s,
                        "baseline_castle_decode_s": base_castle_s}

        # ex01 cold, as a user runs it, against the array path on the decodes
        paths, kfile = [fx("pair0.jpg"), fx("pair1.jpg")], fx("K.txt")
        cli_s, _ = run_cli("spectavi_tpu_torch.pipeline.ex01",
                           [*paths, kfile, "--outdir", d("ex01_cli"), "--seed", str(SEED),
                            "--cache"])
        names = ("sparse_inliers.ply", "rect-pair0.jpg", "rect-pair1.jpg", "metrics.json",
                 "cache.npz")
        gate(all(os.path.getsize(d("ex01_cli", n)) > 0 for n in names), "ex01_cli_outputs")
        pio._decode.cache_clear()
        dgrays = [pio.imread(p, dtype="float32", force_grayscale=True) for p in paths]
        dcolors = [pio.imread(p, dtype="uint8") for p in paths]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        arrays, arrays_s = timed(lambda: run_two_view_arrays(
            dgrays, dcolors, np.loadtxt(kfile), image_names=paths, outdir=d("arrays"), cache=True,
            generator=gen, quiet=True))
        same, rect_ok, rect_shape = cli_vs_arrays(np, d("ex01_cli"), d("arrays"), arrays, names)
        m = arrays["metrics"]
        gate(all(same.values()), "cli_vs_arrays")
        gate(rect_ok, "rect_read_back")
        pose = np.loadtxt(fx("pose.txt"))
        try:
            rot, t_err = check_two_view(np, arrays, pose[:, :3], pose[:, 3])
        except AssertionError as e:
            rot = t_err = None
            gate(False, f"two_view: {e}")
        gate(m["consensus"] >= 0.8, "consensus")
        out["ex01"] = {"cold_cli_s": cli_s, "arrays_s": arrays_s, "identical": same,
                       "keypoints": m["keypoints"], "n_matches": m["n_matches"],
                       "n_inliers": m["n_inliers"], "consensus": m["consensus"],
                       "rotation_err_deg": rot, "translation_err_deg": t_err,
                       "rect_shape": rect_shape}

    gate(all(v > 0 for v in launches.values()), "launches")
    emit("jpeg_progressive", launches=launches, failed=bad, **out)
    if bad:
        raise AssertionError(f"the jpeg_progressive phase failed on {bad} (files in {jp_dir})")
    shutil.rmtree(jp_dir)
    return launches


# --- PNG of every bit depth, and Adam7 --------------------------------

# (colour type, bit depth) of every pair that PNG allows
PNG_DEPTH_CASES = {"gray1": (0, 1), "gray2": (0, 2), "gray4": (0, 4), "gray8": (0, 8),
                   "gray16": (0, 16), "rgb8": (2, 8), "rgb16": (2, 16), "palette1": (3, 1),
                   "palette2": (3, 2), "palette4": (3, 4), "palette8": (3, 8),
                   "gray_alpha8": (4, 8), "gray_alpha16": (4, 16), "rgba8": (6, 8),
                   "rgba16": (6, 16)}
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# entries of the digest files' palette (indices stay below it)
PNG_PALETTE_SIZE = 40
# sha256 (png_digest: dtype name and shape included) of Pillow's array
# (Pillow 12.1.0, np.asarray(Image.open(f))) of each case's files of
# png_depth_files(), plain and Adam7 alike; tests/test_torch_png_depths.py
# holds them to Pillow, so that the card's host, which has no Pillow,
# holds the codec to Pillow's arrays
PNG_DEPTH_SHA256 = {
    "gray1": "bc42d6f49c4732f698bc77114fb4ee7370d27ae4dcc5979d0f024dce0db63f87",
    "gray2": "a0aa85558c124d68c7439c2e1b04d54d00cb47e059a3be4cf5a9a8adbbf8aa96",
    "gray4": "d93b66205ae38b3468909e489f9f5f1bc1d6a2d13b0b409daa07ea93580da129",
    "gray8": "b3424d82fc07a3bdf4f503b74770d10987ba14428159fdbca02b89a95617d5ac",
    "gray16": "e8eeb7ac55a03673be5b738b40dae9dbaa47a42327db39ead065c8d8d6e017fb",
    "rgb8": "d3b5f759ea2105a719204b33e3531b5527c0b7f44f91ba3a2b02ece76ce06a7a",
    "rgb16": "9442dacdc690fc3717253958ef946f4e1a021b046ec0720655779e05c30ca82a",
    "palette1": "63551f0a212f13ef6bc3b3e7ad57e466f0844679e5ee3e7545011a82e44b0aa8",
    "palette2": "561dc3bd614d3754fc4d258b71d7278c0574ddc8aa2a32f1043e00013e92f54b",
    "palette4": "dda66ba7ffe499f39e08ee5371d5565f2b8c63c6b4d77240f6f1b9e2fe47849f",
    "palette8": "d30c7477ea212608c0cff8358650534315c8d91c05fbcd7c3973a38db99af015",
    "gray_alpha8": "704430c2711effbc546ffa2101c652671eeac774d94fc2785e6513393ead49fc",
    "gray_alpha16": "024f48e879866d096887a9e21ecf787f8b58bc3c545c98eaf0da6adfe72806af",
    "rgba8": "97656c4b02cd0f1a112b23ec1051fcec39a6427c0c716449b90a7f8632e0d10f",
    "rgba16": "e13577a72ab1cf52d6f1760e712e8157cfc1d16a8bff68601bd20077ce7f6061",
}
# the phase's budgets, seconds a 2048x3072 decode on the card's host:
# 16-bit gray and 16-bit RGB of Paeth rows, and 8-bit RGB Adam7 of
# Paeth rows (seven wavefronts of ~12.3k diagonal steps, against ~5.1k)
PNG_DECODE_BUDGET_S = {"gray16_paeth": 2.0, "rgb16_paeth": 2.0, "rgb8_adam7_paeth": 4.0}


def mix64(np, x):
    """splitmix64's finaliser of uint64 ``x``: a seeded stream of
    integers that every numpy gives alike."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def png_depth_samples(np, ctype, depth, h=37, w=53, seed=SEED):
    """A seeded image of colour type ``ctype`` at ``depth`` bits, as its
    samples ``(h, w[, C])`` (uint16 at 16 bits, else uint8): a ramp with
    noise, so that every row filter predicts something, or random
    palette indices."""
    ch = PNG_CHANNELS[ctype]
    idx = np.arange(h * w * ch, dtype=np.uint64).reshape(h, w, ch)
    noise = mix64(np, idx + np.uint64((seed * 1000 + ctype * 100 + depth) << 32))
    top = 1 << depth
    if ctype == 3:
        x = noise % np.uint64(min(top, PNG_PALETTE_SIZE))
    else:
        y_, x_, c_ = np.indices((h, w, ch), dtype=np.int64)
        ramp = (y_ * 3 + x_ * 5 + c_ * 7) * max(1, top // 64)
        x = (ramp + (noise % np.uint64(max(2, top // 16))).astype(np.int64)) % top
    x = x.astype(np.uint16 if depth == 16 else np.uint8)
    return x[..., 0] if ch == 1 else x


def png_paeth(np, a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_encode(np, samples, ctype, depth, filters, interlace=0, level=3, palette=None):
    """A PNG file's bytes (numpy and ``zlib``) of ``samples`` ``(H,
    W[, C])`` at ``depth`` bits of colour type ``ctype``, Adam7 when
    ``interlace``; the ``k``-th row of the stream (counting across
    passes) filtered by ``filters[k % len(filters)]`` (0-4: None, Sub,
    Up, Average, Paeth); a palette of ``PNG_PALETTE_SIZE`` grays unless
    ``palette`` is given."""
    import struct
    import zlib

    h, w = samples.shape[:2]
    ch = PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
              (0, 1, 2, 2), (1, 0, 2, 1)) if interlace else ((0, 0, 1, 1),)
    parts, k = [], 0
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        ph = sub.shape[0]
        x = sub.reshape(ph, -1)
        if depth == 16:
            rows = x.astype(">u2").view(np.uint8).reshape(ph, -1)
        elif depth == 8:
            rows = x.astype(np.uint8)
        else:  # packed most significant bits first, zero padding bits
            per = 8 // depth
            n = -(-x.shape[1] // per)
            padded = np.zeros((ph, n * per), np.uint16)
            padded[:, :x.shape[1]] = x
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint16)
            rows = (padded.reshape(ph, n, per) << shifts).sum(axis=2).astype(np.uint8)
        cur = rows.astype(np.int16)
        a = np.zeros_like(cur)
        a[:, bpp:] = cur[:, :-bpp]
        b = np.zeros_like(cur)
        b[1:] = cur[:-1]
        c = np.zeros_like(cur)
        c[1:, bpp:] = cur[:-1, :-bpp]
        ftype = np.asarray([filters[(k + r) % len(filters)] for r in range(ph)], np.uint8)
        k += ph
        out = np.empty((ph, 1 + rows.shape[1]), np.uint8)
        out[:, 0] = ftype
        for f in np.unique(ftype):
            sel = ftype == f
            pred = (0, a[sel], b[sel], (a[sel] + b[sel]) >> 1,
                    png_paeth(np, a[sel], b[sel], c[sel]) if f == 4 else None)[f]
            out[sel, 1:] = (cur[sel] - pred) & 255
        parts.append(out.tobytes())
    chunk = lambda name, body: (struct.pack(">I", len(body)) + name + body
                                + struct.pack(">I", zlib.crc32(name + body)))
    if palette is None:
        palette = bytes(np.repeat(np.arange(PNG_PALETTE_SIZE) * 6, 3).astype(np.uint8))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + (chunk(b"PLTE", palette) if ctype == 3 else b"")
            + chunk(b"IDAT", zlib.compress(b"".join(parts), level)) + chunk(b"IEND", b""))


def png_pillow_rule(np, samples, ctype, depth):
    """The array Pillow gives a PNG of these samples
    (``np.asarray(Image.open(f))``): palette indices; gray at 1 bit as
    bool, at 2 and 4 bits times 85 and 17, at 16 bits as uint16; RGB,
    RGBA and gray + alpha at 16 bits as their high bytes, gray + alpha
    at 16 bits as RGBA with the gray in R, G and B."""
    if ctype == 0 and depth == 1:
        return samples != 0
    if ctype == 0 and depth in (2, 4):
        return (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16 and ctype != 0:
        hi = (samples >> 8).astype(np.uint8)
        return np.stack([hi[..., 0]] * 3 + [hi[..., 1]], axis=-1) if ctype == 4 else hi
    return samples


def png_digest(arr):
    """sha256 of an array's dtype name, shape and values.  Booleans are
    hashed as 0 and 1: Pillow's ``bool`` arrays hold 0xFF for True,
    which numpy reads as True like the codec's 1."""
    import hashlib

    head = f"{arr.dtype.name}{tuple(arr.shape)}".encode()
    values = arr.astype("uint8") if arr.dtype.kind == "b" else arr
    return hashlib.sha256(head + values.tobytes()).hexdigest()


def png_depth_files(np, seed=SEED):
    """``{(case, interlace): (file bytes, Pillow's array by
    png_pillow_rule)}`` of every (colour type, depth) pair of
    ``PNG_DEPTH_CASES``, plain and Adam7, at 37x53, each row's filter
    drawn from the seeded stream."""
    files = {}
    for name, (ctype, depth) in PNG_DEPTH_CASES.items():
        samples = png_depth_samples(np, ctype, depth, seed=seed)
        filters = (mix64(np, np.arange(400, dtype=np.uint64) + np.uint64(seed))
                   % np.uint64(5)).astype(int).tolist()
        want = png_pillow_rule(np, samples, ctype, depth)
        for interlace in (0, 1):
            files[name, interlace] = (png_encode(np, samples, ctype, depth, filters, interlace),
                                      want)
    return files


def to_depth(np, x01, depth, seed):
    """Floats in [0, 1] as integer samples of ``depth`` bits, with a
    seeded dither below one step (so the low byte of 16-bit samples
    carries signal): uint16 above 8 bits, else uint8."""
    top = (1 << depth) - 1
    u = np.random.default_rng(seed).random(np.shape(x01))
    q = np.clip(np.floor(np.asarray(x01, np.float64) * top + u), 0, top)
    return q.astype(np.uint16 if depth > 8 else np.uint8)


def phase_png_depths(torch, np, pair, small, wrappers, smi):
    """ex01 and ex02 from PNG files of other bit depths and Adam7, as
    users run them, on the card (files in a temporary directory under
    ``build/``, removed when every gate holds):

    * (a) every (colour type, bit depth) pair PNG allows, plain and
      Adam7, at 37x53 (``png_depth_files``, this script's own encoder:
      numpy and ``zlib``, every filter type): the codec on the card's
      host gives Pillow's array by its rule and its pinned digest;
    * (b) decode seconds at 2048x3072 against budgets: the pair as
      16-bit gray of Paeth rows, one 16-bit RGB image of Paeth rows,
      the RGB image as 8-bit Adam7 of Paeth rows, each exact;
    * (c) ex01 cold in a subprocess (``python3 -m ...`` with no
      ``--device``, ``--cache``) on the 16-bit gray pair: exit 0, the
      two-view gates, its matches, counts, cloud and ``rect-*`` files
      identical to the byte to ``run_two_view_arrays`` on the codec's
      ``uint16`` decodes; in-process, ``run_two_view`` from the files
      against the arrays, identical (matches, inliers, E, points, the
      cloud's integer-branch colours, step 5's float-branch pixels);
      K1, K2 and K3 launched in these in-process runs;
    * (d) ``run_two_view`` from the RGB pair as 8-bit Adam7 files (the
      two-view gates), and from 480x640 pairs as 1-bit (``bool``) and
      4-bit gray, each identical to the byte to its array path, or
      both raising the same ``ValueError`` when RANSAC gets too few
      matches;
    * (e) ex02 cold in a subprocess on the 10 rendered 480x640 views as
      16-bit gray, ``--pairs sequential``: every pair ``success``, ATE
      under 2% of the span, ``poses.txt`` and ``sparse_cloud.ply``
      identical to the byte to ``run_sfm_arrays`` on the decodes;
    * (f) the small pair as 16-bit gray on the card and on the CPU, both
      given the same RANSAC sample tables: keypoints, matches and
      consensus agree as ``cpu_parity`` holds them.

    Returns the launches of the phase's in-process runs by wrapper."""
    import shutil
    import tempfile

    from sfmbench import scene
    from spectavi_tpu_torch.pipeline import io as pio
    from spectavi_tpu_torch.pipeline.sfm import run_sfm_arrays
    from spectavi_tpu_torch.pipeline.two_view import run_two_view, run_two_view_arrays
    from spectavi_tpu_torch.sfm import ate_rmse, camera_centers

    grays, colors, K, (R_gt, t_gt) = pair
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    pd_dir = tempfile.mkdtemp(prefix="png-depths-", dir=os.path.join(ROOT, "build"))
    d = lambda *p: os.path.join(pd_dir, *p)
    out, bad = {"card": smi}, []

    def gate(ok, name):
        if not ok:
            bad.append(name)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def gen(device="cuda"):
        g = torch.Generator(device=device)
        g.manual_seed(SEED)
        return g

    def write(path, data):
        with open(path, "wb") as f:
            f.write(data)

    def decode(path):
        pio._decode.cache_clear()
        return pio.imread(path, dtype="uint8")

    def decodes(paths):
        pio._decode.cache_clear()
        return ([pio.imread(p, dtype="float32", force_grayscale=True) for p in paths],
                [pio.imread(p, dtype="uint8") for p in paths])

    def files_vs_arrays(paths, kfile, tag):
        """``run_two_view`` from ``paths`` (outputs in ``tag-files``)
        against ``run_two_view_arrays`` on their decodes (``tag-arrays``):
        ``(arrays result or None, {what: identical}, ValueError text)``."""
        pio._decode.cache_clear()
        try:
            files = run_two_view(paths, kfile, outdir=d(f"{tag}-files"), generator=gen(),
                                 quiet=True)
        except ValueError as e:
            files = e
        dgrays, dcolors = decodes(paths)
        try:
            arrays = run_two_view_arrays(dgrays, dcolors, np.loadtxt(kfile), image_names=paths,
                                         outdir=d(f"{tag}-arrays"), generator=gen(), quiet=True)
        except ValueError as e:
            arrays = e
        if isinstance(files, ValueError) or isinstance(arrays, ValueError):
            same = {"value_error": isinstance(files, ValueError) and isinstance(arrays, ValueError)
                    and str(files) == str(arrays)}
            return None, same, str(arrays)
        same = {k: same_bytes(np, files[k], arrays[k]) for k in ("matches", "points", "rectified")}
        same["inliers"] = same_bytes(np, files["ransac"]["inlier_idx"],
                                     arrays["ransac"]["inlier_idx"])
        same["essential"] = same_bytes(np, files["ransac"]["essential"],
                                       arrays["ransac"]["essential"])
        names = ["sparse_inliers.ply"] + ["rect-" + os.path.basename(p) for p in paths]
        for n in names:
            same[n] = file_bytes(d(f"{tag}-files", n)) == file_bytes(d(f"{tag}-arrays", n))
        return arrays, same, None

    # (a) every depth and colour type, plain and Adam7, against Pillow's rule and digest
    failed = []
    for (name, interlace), (data, want) in png_depth_files(np).items():
        got = pio._read_png(data)
        if not (got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
                and png_digest(got) == PNG_DEPTH_SHA256[name]):
            failed.append(name + ("-adam7" if interlace else ""))
    gate(not failed, f"digests: {failed}")
    out["digests"] = {"files": 2 * len(PNG_DEPTH_CASES), "failed": failed}

    # (b) decode seconds at the pair's size
    g16 = [to_depth(np, g, 16, SEED + i) for i, g in enumerate(grays)]
    rgb8 = [scene.as_rgb(c) for c in colors]
    paths = [d(f"pair{i}.png") for i in (0, 1)]
    kfile = d("K.txt")
    np.savetxt(kfile, K)
    enc = {}
    for p, g in zip(paths, g16):
        data, enc["gray16_paeth"] = timed(lambda: png_encode(np, g, 0, 16, [4]))
        write(p, data)
    rgb16 = to_depth(np, rgb8[0] / 255.0, 16, SEED + 2)
    data, enc["rgb16_paeth"] = timed(lambda: png_encode(np, rgb16, 2, 16, [4]))
    write(d("rgb16.png"), data)
    apaths = [d(f"adam7-{i}.png") for i in (0, 1)]
    for p, c in zip(apaths, rgb8):
        data, enc["rgb8_adam7_paeth"] = timed(lambda: png_encode(np, c, 2, 8, [4], interlace=1))
        write(p, data)
    dec, exact = {}, {}
    for i, p in enumerate(paths):
        im, dec[f"gray16_paeth_{i}"] = timed(lambda: decode(p))
        exact[f"gray16_paeth_{i}"] = same_bytes(np, im, g16[i])
    im, dec["rgb16_paeth"] = timed(lambda: decode(d("rgb16.png")))
    exact["rgb16_paeth"] = same_bytes(np, im, (rgb16 >> 8).astype(np.uint8))
    for i, p in enumerate(apaths):
        im, dec[f"rgb8_adam7_paeth_{i}"] = timed(lambda: decode(p))
        exact[f"rgb8_adam7_paeth_{i}"] = same_bytes(np, im, rgb8[i])
    for key, secs in dec.items():
        budget = PNG_DECODE_BUDGET_S[key.rsplit("_", 1)[0] if key[-1].isdigit() else key]
        gate(exact[key] and secs < budget, f"decode_{key}")
    out["codec"] = {"shape": [int(v) for v in g16[0].shape], "decode_s": dec, "encode_s": enc,
                    "budget_s": PNG_DECODE_BUDGET_S, "exact": exact,
                    "bytes": {"gray16_paeth": os.path.getsize(paths[0]),
                              "rgb16_paeth": os.path.getsize(d("rgb16.png")),
                              "rgb8_adam7_paeth": os.path.getsize(apaths[0])}}

    # (c) ex01 cold from the 16-bit gray pair, as a user runs it
    cli_s, _ = run_cli("spectavi_tpu_torch.pipeline.ex01",
                       [*paths, kfile, "--outdir", d("ex01_cli"), "--seed", str(SEED), "--cache"])
    with launch_counts(wrappers) as launches:
        with launch_counts(wrappers) as launches_c:
            (arrays, same, _), warm_s = timed(lambda: files_vs_arrays(paths, kfile, "gray16"))
        gate(all(v > 0 for v in launches_c.values()), "ex01_launches")
        gate(all(same.values()), "gray16_files_vs_arrays")
        dcolors = decodes(paths)[1]
        gate(all(c.dtype == np.uint16 for c in dcolors), "gray16_decodes_uint16")
        names = ("sparse_inliers.ply", "rect-pair0.png", "rect-pair1.png", "metrics.json",
                 "cache.npz")
        gate(all(os.path.getsize(d("ex01_cli", n)) > 0 for n in names), "ex01_cli_outputs")
        cli_same, _, rect_shape = cli_vs_arrays(np, d("ex01_cli"), d("gray16-arrays"), arrays,
                                                names)
        gate(all(cli_same.values()), "cli_vs_arrays")
        # gray rect-* files: the rectified (H, W, 1) pixels, read back as (H, W)
        gate(all(same_bytes(np, pio.imread(d("ex01_cli", n), dtype="uint8"), r[..., 0])
                 for n, r in zip(names[1:3], arrays["rectified"][:2])), "rect_read_back")
        m = arrays["metrics"]
        gate(m["consensus"] >= 0.8, "consensus")
        try:
            rot, t_err = check_two_view(np, arrays, R_gt, t_gt)
        except AssertionError as e:
            rot = t_err = None
            gate(False, f"two_view: {e}")
        out["ex01_gray16"] = {"cold_cli_s": cli_s, "files_and_arrays_s": warm_s,
                              "identical": {**same, **{"cli_" + k: v for k, v in cli_same.items()}},
                              "keypoints": m["keypoints"], "n_matches": m["n_matches"],
                              "n_inliers": m["n_inliers"], "consensus": m["consensus"],
                              "rotation_err_deg": rot, "translation_err_deg": t_err,
                              "rect_shape": rect_shape, "launches": launches_c}

        # (d) the RGB pair as 8-bit Adam7; 480x640 pairs at 1 and 4 bits
        arrays, same, _ = files_vs_arrays(apaths, kfile, "adam7")
        gate(all(same.values()), "adam7_files_vs_arrays")
        try:
            rot, t_err = check_two_view(np, arrays, R_gt, t_gt)
        except (AssertionError, TypeError) as e:
            rot = t_err = None
            gate(False, f"adam7_two_view: {e}")
        out["ex01_adam7_rgb8"] = {"identical": same, "n_inliers": arrays["metrics"]["n_inliers"],
                                  "consensus": arrays["metrics"]["consensus"],
                                  "rotation_err_deg": rot, "translation_err_deg": t_err}
        lg, _, lK, _ = render_pair(SFM_H, SFM_W, "cuda", SFM_TEX)
        np.savetxt(d("Kl.txt"), lK)
        for depth in (1, 4):
            lpaths = [d(f"gray{depth}-{i}.png") for i in (0, 1)]
            for i, (p, g) in enumerate(zip(lpaths, lg)):
                write(p, png_encode(np, to_depth(np, g, depth, SEED + 10 * depth + i), 0, depth,
                                    [0, 1, 2, 3, 4]))
            dtype = decodes(lpaths)[1][0].dtype
            arrays, same, err = files_vs_arrays(lpaths, d("Kl.txt"), f"gray{depth}")
            gate(all(same.values()) and dtype == (np.bool_ if depth == 1 else np.uint8),
                 f"gray{depth}_files_vs_arrays")
            out[f"ex01_gray{depth}"] = {"dtype": str(dtype), "identical": same,
                                        "value_error": err} | ({} if arrays is None else {
                "n_matches": arrays["metrics"]["n_matches"],
                "n_inliers": arrays["metrics"]["n_inliers"],
                "consensus": arrays["metrics"]["consensus"]})

        # (e) ex02 cold from the 10 views as 16-bit gray
        vgrays, _, vK, poses = render_views(SFM_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX)
        gt_C = np.array([C for _, _, C in poses])
        vpaths = [d(f"v{i:02d}.png") for i in range(SFM_VIEWS)]
        for i, (p, g) in enumerate(zip(vpaths, vgrays)):
            write(p, png_encode(np, to_depth(np, g, 16, SEED + 100 + i), 0, 16, [1, 2, 3, 4]))
        np.savetxt(d("Kv.txt"), vK)
        secs, _ = run_cli("spectavi_tpu_torch.pipeline.ex02",
                          [*vpaths, d("Kv.txt"), "--pairs", "sequential", "--outdir", d("ex02_cli"),
                           "--seed", str(SEED)])
        with open(d("ex02_cli", "metrics.json")) as f:
            sm = json.load(f)
        cams = np.loadtxt(d("ex02_cli", "poses.txt"))
        share = ate_rmse(camera_centers(cams), gt_C) / np.ptp(gt_C, axis=0).max()
        gate(len(sm["pairs"]) == SFM_VIEWS - 1 and all(p.get("success") for p in sm["pairs"])
             and share < 0.02, "ex02")
        sgrays = decodes(vpaths)[0]
        res, arrays_s = timed(lambda: run_sfm_arrays(sgrays, np.loadtxt(d("Kv.txt")),
                                                     outdir=d("ex02_arrays"), generator=gen(),
                                                     quiet=True))
        ex02_same = {n: file_bytes(d("ex02_cli", n)) == file_bytes(d("ex02_arrays", n))
                     for n in ("poses.txt", "sparse_cloud.ply")}
        gate(all(ex02_same.values()), "ex02_cli_vs_arrays")
        out["ex02_gray16"] = {"cold_cli_s": secs, "arrays_s": arrays_s, "pairs": len(sm["pairs"]),
                              "failed_pairs": [p["pair"] for p in sm["pairs"]
                                               if not p.get("success")],
                              "init_used": sm["init_used"], "tracks": sm["n_tracks"],
                              "ate_share": share, "identical": ex02_same,
                              "tracks_arrays": res["metrics"]["n_tracks"]}

        # (f) the small pair as 16-bit gray on the card and on the CPU
        sg, _, sK, _ = small
        spaths = [d(f"small{i}.png") for i in (0, 1)]
        for i, (p, g) in enumerate(zip(spaths, sg)):
            write(p, png_encode(np, to_depth(np, g, 16, SEED + 200 + i), 0, 16, [4]))
        np.savetxt(d("Ks.txt"), sK)
        par = {}
        for dev in ("cuda", "cpu"):
            pio._decode.cache_clear()
            with host_ransac_tables(torch):
                r = run_two_view(spaths, d("Ks.txt"), outdir=None, matching_method="l2-mxu",
                                 generator=gen(dev), quiet=True, device=dev)["metrics"]
            par[dev] = {k: r[k] for k in ("keypoints", "n_matches", "consensus")}
        gate(parity_holds(par["cuda"], par["cpu"]), "cpu_parity")
        out["cpu_parity"] = {"shape": [int(v) for v in sg[0].shape], **par}

    gate(all(v > 0 for v in launches.values()), "launches")
    emit("png_depths", launches=launches, failed=bad, **out)
    if bad:
        raise AssertionError(f"the png_depths phase failed on {bad} (files in {pd_dir})")
    shutil.rmtree(pd_dir)
    return launches


# --- inputs that went to Pillow: smoothed progressive JPEG, Netpbm ---

# the progressive fixtures of tests/data/jpeg that the phase cuts after
# every scan but their last, and the sha256 of Pillow's decodes of each
# file's cuts (Pillow 12.1.0 on libjpeg-turbo 3.1.3, which smooths the
# blocks the cuts leave unrefined), concatenated in scan order;
# tests/test_torch_jpeg_smoothing.py holds them to Pillow
JPEG_SMOOTH_SHA256 = {
    "castle-progressive.jpg": "e4eef1443423a53b2913ec8bacf5662d7f2f7735d4162b3f7f75fdcd6b28cb2f",
    "digest-gray-progressive-rst3.jpg": "57098a215e1624666f1b19282965605d06c1f28c37cfa1962c9748a57dcf06dc",
    "digest-rgb-440-progressive.jpg": "c342c445e5729c9727066039f48b1015d156499205a08d0e7b2610092a8c942d",
    "digest-rgb-progressive-444.jpg": "6d3f7d1e517e2503ec40dd062ff08bf2be3da8f9c3d62b0a64e3c55af8d8df37",
    "digest-rgb-progressive-rst3.jpg": "27c6a8520daf648d15396b5d9dee8719e0e3b6e86858a6a38a93b7ac5c5fa600",
}
# the scan the progressive pair is cut after: Pillow's fifth scan (Y's
# AC 6-63 at Al 2), which leaves Y's first AC band and both chroma AC
# bands unrefined, so the cut pair is smoothed
PAIR_CUT_SCAN = 5
# the Netpbm files of pnm_digest_files(): (magic, maxval) of each, every
# magic plain and raw, and the sha256 (png_digest) of Pillow's array of
# each (Pillow 12.1.0), which tests/test_torch_pnm.py holds to Pillow
PNM_CASES = {f"p{m}-{v}": (m, v) for m, vs in ((1, (1,)), (4, (1,)),
                                              (2, (1, 15, 100, 255, 256, 1000, 65535)),
                                              (5, (1, 15, 100, 255, 256, 1000, 65535)),
                                              (3, (100, 255, 1000, 65535)),
                                              (6, (100, 255, 1000, 65535))) for v in vs}
PNM_SHA256 = {
    "p1-1": "3b6cab54fade8217020505095321c3488499787c52e70e998e4038ad3a62f515",
    "p4-1": "38c8da604a6db2f3743a76c947db4f6ec10d01adb009355270f1627a835feb02",
    "p2-1": "021dba1b97fbd9f1967eb89fef41ff649b1e58bee97b5ff024a1f7a433be0bbf",
    "p2-15": "f2bebc45e6f20af63f047dbddacae998ddbd8b9fe90bef2f73d20b6673cc89c4",
    "p2-100": "588428b017a20f01885e14eab36436a6b6a9188d6ebb3bd7a381db065cb6b18b",
    "p2-255": "73cb6485facb5f14fca5668d4d5120ece6b88ba2eeb4d69df9190b81996f1b6f",
    "p2-256": "65a4850b3afd10c476ac9433d897e03ff471265d392eb8f1bf8366b8b6cc7afb",
    "p2-1000": "92845e50bf968a31bdb12d6dd09fefff453eecd1af2aa9da1a91145f4a374f5c",
    "p2-65535": "bf01a54fa9d187a64d11d22c9fbf10400ca0e56e8c46a210e4504af461f9a057",
    "p5-1": "f340eaa2310222366b70cc61484df6b952d57185901f5173c75cced5329dde5c",
    "p5-15": "bf4c137ff938619360f5f4ce875b2e14bfd3e4924c0c69c538ccf14e9b968f7d",
    "p5-100": "a49d346059685a83579591037c3a390d1171270279830fe48d2d1c783ec884ec",
    "p5-255": "6f059887d8df664c40bbb3cdd788021f68ad61bd721206f377f865f10899e086",
    "p5-256": "cbea9c8883dc8ad0e990a5d90e4bc12689484b8d8dd1b9e17b7016ec8edc4ecb",
    "p5-1000": "5e36c2eab908fead8d770ecc6ba84c2fcfdcd774a73f7b7fb657eb73e726ec35",
    "p5-65535": "4ed5004b95adf212b60299771149a5eadd90721421430dffbf10abc6fc6dd083",
    "p3-100": "f31f0f6831863507c516f4a4ac1f33f8c59dc814442f3fce9b6c32234829d2c2",
    "p3-255": "5b294d1cc8859b10ac1fbbec7b75ff1c0d7c5601483ff4bc1ac0e8316e7692c4",
    "p3-1000": "bec7bf662277c028abc8e6fcb49eaf7faedfadbb52aaf278acb5bb853aca03cc",
    "p3-65535": "bf28ed7da3b8848949b6fe7b9e927ce11898638aec7d379b318cfd7eae502951",
    "p6-100": "a51da86763cbb16dfffd5ca880b3f8e60e712ada678ecf50e4dc33e43044df90",
    "p6-255": "65ef5b244b5b914c701904d836e31c8635872623b5b9ada67328d8c983bfd876",
    "p6-1000": "2f6162afd1e8d1bb70fc4cd6282b6b64a4504101a9e4128dc4ffba2f1f9e942f",
    "p6-65535": "be1cb3480f46b09ff6a014be1538f4d3fc5b6ce28ab788babe721b70fa026629",
}
# the maxval of one of the 10 views, the others' being 65535
PNM_VIEW_12BIT = 3


def cut_after_scan(data, k):
    """A copy of ``tests/test_torch_jpeg.py``'s: ``data`` cut after its
    ``k``-th scan's entropy-coded data, with EOI appended."""
    pos = 0
    for _ in range(k):
        pos = data.index(b"\xff\xda", pos) + 2
    pos += int.from_bytes(data[pos:pos + 2], "big")
    # the next marker: FF followed by neither a stuffed 00 nor an RSTn
    while not (data[pos] == 0xFF and data[pos + 1] not in (0x00, *range(0xD0, 0xD8))):
        pos += 1
    return data[:pos] + b"\xff\xd9"


def jpeg_smooth_digest(np, data, decode):
    """sha256 of ``decode``'s arrays of ``data`` cut after each scan but
    its last, concatenated in scan order (``decode`` gives a uint8 array
    or None; None fails)."""
    import hashlib

    h = hashlib.sha256()
    for k in range(1, data.count(b"\xff\xda")):
        im = decode(cut_after_scan(data, k))
        if im is None:
            return None
        h.update(np.ascontiguousarray(im).tobytes())
    return h.hexdigest()


def pnm_encode(np, samples, magic, maxval):
    """A Netpbm file's bytes of ``samples``: the values as the file holds
    them (bits with 1 black for ``P1`` / ``P4``, ``(H, W)`` for ``P2`` /
    ``P5``, ``(H, W, 3)`` for ``P3`` / ``P6``), a header with comments and
    mixed whitespace; plain bodies a row a line (``P1`` without spaces),
    raw bodies big-endian above maxval 255."""
    h, w = samples.shape[:2]
    head = b"P%d\n# written by chip_smoke.py\n%d\t%d\r\n" % (magic, w, h)
    if magic in (1, 4):
        bits = np.asarray(samples, np.uint8)
        if magic == 4:
            return head + np.packbits(bits, axis=1).tobytes()
        return head + b"\n".join(bytes(r + 48) for r in bits) + b"\n"
    head += b"# maxval\n%d\n" % maxval
    if magic in (5, 6):
        return head + np.ascontiguousarray(samples, ">u2" if maxval > 255 else np.uint8).tobytes()
    rows = np.asarray(samples).reshape(h, -1)
    return head + b"".join(b" ".join(b"%d" % v for v in r) + b"\n" for r in rows.tolist())


def pnm_samples(np, magic, maxval, h=37, w=53, seed=SEED):
    """Seeded samples from 0 to ``maxval`` for a file of ``magic`` (uint16,
    ``(h, w, 3)`` for PPM), drawn from ``mix64``'s stream."""
    ch = 3 if magic in (3, 6) else 1
    idx = np.arange(h * w * ch, dtype=np.uint64).reshape(h, w, ch)
    x = mix64(np, idx + np.uint64((seed * 1000 + magic * 100 + maxval % 97) << 32))
    x = (x % np.uint64(maxval + 1)).astype(np.uint16)
    return x if ch == 3 else x[..., 0]


def pnm_digest_files(np, seed=SEED):
    """``{case: file bytes}`` of every case of ``PNM_CASES`` at 37x53."""
    return {name: pnm_encode(np, pnm_samples(np, magic, maxval, seed=seed), magic, maxval)
            for name, (magic, maxval) in PNM_CASES.items()}


def phase_pillow_free_inputs(torch, np, pair, wrappers, smi):
    """ex01 and ex02 from the inputs that went to Pillow until the port's
    codecs read them, as users run them, on the card (files in a
    temporary directory under ``build/``, removed when every gate holds):

    * (a) the progressive fixtures of ``tests/data/jpeg/`` cut after
      every scan but their last: their decodes, whose unrefined blocks
      the codec smooths as libjpeg-turbo does, equal Pillow's pinned
      digests (``JPEG_SMOOTH_SHA256``);
    * (b) ex01 cold in a subprocess (no ``--device``, ``--cache``) on the
      progressive pair cut after scan ``PAIR_CUT_SCAN``: the two-view
      gates against ``pose.txt``, its matches, counts, cloud and
      ``rect-*`` files identical to the byte to ``run_two_view_arrays``
      on the codec's decodes; decode seconds;
    * (c) ex01 cold on the rendered 2048x3072 pair as 8-bit P6 (this
      script's ``pnm_encode``), the same gates and identity, decode
      seconds of P6 and of 16-bit P5 at that size; ex02 cold
      (``--pairs sequential``) on the 10 views as 16-bit P5, one at
      maxval 4095: every pair ``success``, ATE under 2% of the span,
      ``poses.txt`` and the cloud identical to the byte to
      ``run_sfm_arrays`` on the decodes;
    * (d) 24 small Netpbm files (``pnm_digest_files``: every magic, plain
      and raw, maxvals 1 to 65535, comments in the header) decode to
      Pillow's pinned digests (``PNM_SHA256``).

    Returns the launches of the phase's in-process runs by wrapper."""
    import shutil
    import tempfile

    from sfmbench import scene
    from spectavi_tpu_torch.pipeline import io as pio
    from spectavi_tpu_torch.pipeline.jpeg import read_jpeg
    from spectavi_tpu_torch.pipeline.sfm import run_sfm_arrays
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays
    from spectavi_tpu_torch.sfm import ate_rmse, camera_centers

    grays, colors, K, (R_gt, t_gt) = pair
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    pf_dir = tempfile.mkdtemp(prefix="pillow-free-", dir=os.path.join(ROOT, "build"))
    d = lambda *p: os.path.join(pf_dir, *p)
    fx = lambda *p: os.path.join(ROOT, JPEG_FIXTURES, *p)
    out, bad = {"card": smi}, []

    def gate(ok, name):
        if not ok:
            bad.append(name)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def gen():
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        return g

    def write(path, data):
        with open(path, "wb") as f:
            f.write(data)

    def ex01_cold_vs_arrays(paths, kfile, tag, R, t):
        """ex01 cold on ``paths`` against the array path on their
        decodes: the gates into ``bad``, the report's entries."""
        names = ("sparse_inliers.ply", *("rect-" + os.path.basename(p) for p in paths),
                 "metrics.json", "cache.npz")
        cli_s, _ = run_cli("spectavi_tpu_torch.pipeline.ex01",
                           [*paths, kfile, "--outdir", d(f"{tag}-cli"), "--seed", str(SEED),
                            "--cache"])
        gate(all(os.path.getsize(d(f"{tag}-cli", n)) > 0 for n in names), f"{tag}_cli_outputs")
        pio._decode.cache_clear()
        dgrays = [pio.imread(p, dtype="float32", force_grayscale=True) for p in paths]
        dcolors = [pio.imread(p, dtype="uint8") for p in paths]
        arrays, arrays_s = timed(lambda: run_two_view_arrays(
            dgrays, dcolors, np.loadtxt(kfile), image_names=paths, outdir=d(f"{tag}-arrays"),
            cache=True, generator=gen(), quiet=True))
        same, rect_ok, rect_shape = cli_vs_arrays(np, d(f"{tag}-cli"), d(f"{tag}-arrays"), arrays,
                                                  names)
        gate(all(same.values()), f"{tag}_cli_vs_arrays")
        gate(rect_ok, f"{tag}_rect_read_back")
        m = arrays["metrics"]
        gate(m["consensus"] >= 0.8, f"{tag}_consensus")
        try:
            rot, t_err = check_two_view(np, arrays, R, t)
        except AssertionError as e:
            rot = t_err = None
            gate(False, f"{tag}_two_view: {e}")
        return {"cold_cli_s": cli_s, "arrays_s": arrays_s, "identical": same,
                "dtype": str(dcolors[0].dtype), "keypoints": m["keypoints"],
                "n_matches": m["n_matches"], "n_inliers": m["n_inliers"],
                "consensus": m["consensus"], "rotation_err_deg": rot, "translation_err_deg": t_err,
                "rect_shape": rect_shape}

    with launch_counts(wrappers) as launches:
        # (a) every progressive fixture cut after each scan but its last
        digests, smooth_s = {}, {}
        for name, want in JPEG_SMOOTH_SHA256.items():
            data = file_bytes(fx(name))
            digests[name], smooth_s[name] = timed(lambda: jpeg_smooth_digest(np, data, read_jpeg))
            gate(digests[name] == want, f"{name}_smooth_digest")
        out["smoothing"] = {"cuts": {n: file_bytes(fx(n)).count(b"\xff\xda") - 1
                                     for n in JPEG_SMOOTH_SHA256},
                            "decode_all_cuts_s": smooth_s, "digests": digests}

        # (b) ex01 cold from the progressive pair cut after scan PAIR_CUT_SCAN
        cpaths = [d(f"cut{i}.jpg") for i in (0, 1)]
        dec_s = []
        for i, p in enumerate(cpaths):
            cut = cut_after_scan(file_bytes(fx(f"pair{i}.jpg")), PAIR_CUT_SCAN)
            write(p, cut)
            im, secs = timed(lambda: read_jpeg(cut))
            dec_s.append(secs)
            gate(im is not None and im.shape == (H, W, 3), f"cut{i}_decode")
        pose = np.loadtxt(fx("pose.txt"))
        out["ex01_smoothed_jpeg"] = {"scan": PAIR_CUT_SCAN, "bytes": os.path.getsize(cpaths[0]),
                                     "decode_s": dec_s, **ex01_cold_vs_arrays(
                                         cpaths, fx("K.txt"), "smoothed", pose[:, :3], pose[:, 3])}

        # (c) ex01 cold from the pair as 8-bit P6, ex02 cold from 16-bit P5 views
        ppaths = [d(f"pair{i}.ppm") for i in (0, 1)]
        kfile = d("K.txt")
        np.savetxt(kfile, K)
        enc, dec = {}, {}
        for p, c in zip(ppaths, colors):
            data, enc["p6_8bit"] = timed(lambda: pnm_encode(np, scene.as_rgb(c), 6, 255))
            write(p, data)
        im, dec["p6_8bit"] = timed(lambda: pio._read_pnm(file_bytes(ppaths[0])))
        exact = {"p6_8bit": same_bytes(np, im, scene.as_rgb(colors[0]))}
        g16 = to_depth(np, grays[0], 16, SEED)
        data = pnm_encode(np, g16, 5, 65535)
        im, dec["p5_16bit"] = timed(lambda: pio._read_pnm(data))
        exact["p5_16bit"] = same_bytes(np, im, g16.astype(np.int32))
        gate(all(exact.values()), f"pnm_decode_exact: {exact}")
        out["pnm_codec"] = {"shape": [H, W], "decode_s": dec, "encode_s": enc, "exact": exact,
                            "bytes": {"p6_8bit": os.path.getsize(ppaths[0]), "p5_16bit": len(data)}}
        out["ex01_p6"] = ex01_cold_vs_arrays(ppaths, kfile, "p6", R_gt, t_gt)

        vgrays, _, vK, poses = render_views(SFM_VIEWS, SFM_H, SFM_W, "cuda", SFM_TEX)
        gt_C = np.array([C for _, _, C in poses])
        vpaths = [d(f"v{i:02d}.pgm") for i in range(SFM_VIEWS)]
        for i, (p, g) in enumerate(zip(vpaths, vgrays)):
            depth = 12 if i == PNM_VIEW_12BIT else 16
            write(p, pnm_encode(np, to_depth(np, g, depth, SEED + 300 + i), 5, (1 << depth) - 1))
        np.savetxt(d("Kv.txt"), vK)
        secs, _ = run_cli("spectavi_tpu_torch.pipeline.ex02",
                          [*vpaths, d("Kv.txt"), "--pairs", "sequential", "--outdir", d("ex02_cli"),
                           "--seed", str(SEED)])
        with open(d("ex02_cli", "metrics.json")) as f:
            sm = json.load(f)
        cams = np.loadtxt(d("ex02_cli", "poses.txt"))
        share = ate_rmse(camera_centers(cams), gt_C) / np.ptp(gt_C, axis=0).max()
        gate(len(sm["pairs"]) == SFM_VIEWS - 1 and all(p.get("success") for p in sm["pairs"])
             and share < 0.02, "ex02")
        pio._decode.cache_clear()
        sgrays = [pio.imread(p, dtype="float32", force_grayscale=True) for p in vpaths]
        dtypes = sorted({str(pio.imread(p, dtype="uint8").dtype) for p in vpaths})
        res, arrays_s = timed(lambda: run_sfm_arrays(sgrays, np.loadtxt(d("Kv.txt")),
                                                     outdir=d("ex02_arrays"), generator=gen(),
                                                     quiet=True))
        ex02_same = {n: file_bytes(d("ex02_cli", n)) == file_bytes(d("ex02_arrays", n))
                     for n in ("poses.txt", "sparse_cloud.ply")}
        gate(all(ex02_same.values()), "ex02_cli_vs_arrays")
        out["ex02_p5_16bit"] = {"cold_cli_s": secs, "arrays_s": arrays_s, "pairs": len(sm["pairs"]),
                                "failed_pairs": [p["pair"] for p in sm["pairs"]
                                                 if not p.get("success")],
                                "dtypes": dtypes, "init_used": sm["init_used"],
                                "tracks": sm["n_tracks"], "ate_share": share,
                                "identical": ex02_same,
                                "tracks_arrays": res["metrics"]["n_tracks"]}

        # (d) the small Netpbm files against Pillow's pinned digests
        failed = [name for name, data in pnm_digest_files(np).items()
                  if png_digest(pio._read_pnm(data)) != PNM_SHA256[name]]
        gate(not failed, f"pnm_digests: {failed}")
        out["pnm_digests"] = {"files": len(PNM_CASES), "failed": failed}

    gate(all(v > 0 for v in launches.values()), "launches")
    emit("pillow_free_inputs", launches=launches, failed=bad, **out)
    if bad:
        raise AssertionError(f"the pillow_free_inputs phase failed on {bad} (files in {pf_dir})")
    shutil.rmtree(pf_dir)
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
    from spectavi_tpu_torch.ops import l2nn, sampson
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
    wrappers = {"l2nn_top2": l2nn, "sift_orient_hist": so, "sift_desc": sd,
                "sampson_count": sampson}
    with launch_counts(wrappers) as launches:
        sync()
        got = {cname: fn() for cname, fn in calls.items()}
        got.update({"ba_" + lname: ba_steps(lname, 5) for lname in ba})
        sync()

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


@contextlib.contextmanager
def host_ransac_tables(torch):
    """RANSAC's sample tables drawn on the host from ``SEED`` whatever
    the device, for a run on the card and one on the CPU to take the same
    tables: at 240x320 the consensus of the rendered pair spans 0.50-0.64
    over generator seeds, so two random streams cannot be held within
    ``parity_holds``' 0.05; what differs is then the device alone."""
    from spectavi_tpu_torch.mvg import ransac as tran

    draw = tran.sample_subsets
    host = torch.Generator()
    host.manual_seed(SEED)
    tran.sample_subsets = lambda n, trials, mask, generator=None: draw(
        n, trials, mask.cpu(), host).to(mask.device)
    try:
        yield
    finally:
        tran.sample_subsets = draw


def parity_holds(card, cpu):
    """The card's and the CPU's run of one pair agree: keypoints within
    2%, matches within 3% (or 2), consensus within 0.05."""
    return (all(abs(a - b) <= 0.02 * b for a, b in zip(card["keypoints"], cpu["keypoints"]))
            and abs(card["n_matches"] - cpu["n_matches"]) <= max(2, 0.03 * cpu["n_matches"])
            and abs(card["consensus"] - cpu["consensus"]) <= 0.05)


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
    from spectavi_tpu_torch.ops import _build, l2nn, sampson
    from spectavi_tpu_torch.ops import sift_desc as sd
    from spectavi_tpu_torch.ops import sift_orient as so
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays

    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    reports = _build.build(_build.KERNELS + _build.HOST_SOURCES, verbose="--ptxas" in argv)
    emit("build", seconds=time.perf_counter() - t0, built=sorted(reports))
    if "--ptxas" in argv:
        for name, rep in reports.items():
            if name in _build.KERNELS:
                print(f"--- ptxas {name}\n{rep}", flush=True)

    t0 = time.perf_counter()
    grays, colors, K, (R_gt, t_gt) = render_pair(H, W, "cuda", TEX)
    small = render_pair(SMALL_H, SMALL_W, "cuda", SMALL_TEX)
    torch.cuda.synchronize()
    emit("render", seconds=time.perf_counter() - t0, shape=[H, W])
    if "--k4" in argv:
        phase_check_k4(torch, np, (grays, colors, K))
        emit("done", seconds=time.perf_counter() - t_start, k4_only=True)
        return 0

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
    wrappers = {"l2nn_top2": l2nn, "sift_orient_hist": so, "sift_desc": sd,
                "sampson_count": sampson}
    with launch_counts(wrappers) as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = run("cuda", grays, colors, K)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
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
        with launch_counts(wrappers) as n_launch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run("cuda", mg, mc, mk, method)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        mm = res["metrics"]
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
    par = {}
    for dev in ("cuda", "cpu"):
        with host_ransac_tables(torch):
            r = run(dev, sg, sc, sk, "l2-mxu")["metrics"]
        par[dev] = {k: r[k] for k in ("keypoints", "n_matches", "consensus")}
    emit("cpu_parity", shape=[SMALL_H, SMALL_W], tables="host", **par)
    if not parity_holds(par["cuda"], par["cpu"]):
        raise AssertionError("the card and the CPU disagree on the small pair")

    # the multi-view phases, each with its own clock
    phase_s = {"before_sfm": time.perf_counter() - t_start}
    # K4 at the pair steps' and a castle block's shapes, from warm runs
    t0 = time.perf_counter()
    res_k4 = phase_check_k4(torch, np, (grays, colors, K))
    phase_s["check_K4"] = time.perf_counter() - t0
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
    # ex01 and ex02 from PNG files, as users run them
    t0 = time.perf_counter()
    launches_entry = phase_entry_points(torch, np, (grays, colors, K, (R_gt, t_gt)), small,
                                        wrappers, smi)
    phase_s["entry_points"] = time.perf_counter() - t0
    # ex01 and run_sfm from JPEG files, through the port's own codec
    t0 = time.perf_counter()
    launches_jpeg = phase_jpeg(torch, np, (grays, colors, K, (R_gt, t_gt)), wrappers, smi)
    phase_s["jpeg"] = time.perf_counter() - t0
    # ex01 from progressive JPEG; the codec on every sampling factor
    t0 = time.perf_counter()
    launches_progressive = phase_jpeg_progressive(torch, np, wrappers, smi)
    phase_s["jpeg_progressive"] = time.perf_counter() - t0
    # ex01 and ex02 from PNG of 1, 2, 4 and 16 bits and Adam7
    t0 = time.perf_counter()
    launches_png = phase_png_depths(torch, np, (grays, colors, K, (R_gt, t_gt)), small,
                                    wrappers, smi)
    phase_s["png_depths"] = time.perf_counter() - t0
    # ex01 and ex02 from smoothed progressive JPEG and from Netpbm
    t0 = time.perf_counter()
    launches_free = phase_pillow_free_inputs(torch, np, (grays, colors, K, (R_gt, t_gt)),
                                             wrappers, smi)
    phase_s["pillow_free_inputs"] = time.perf_counter() - t0
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
        # replaces none: the JAX package's Sampson scoring is fused XLA
        ("sampson_count", res_k4, "spectavi_tpu_torch/csrc/sampson_count.cu", None),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "run_ms": run_ms[name], "launches_sfm": launches_sfm[name],
            "run_ms_sfm": run_ms_sfm[name], "launches_surface": launches_surface[name],
            "launches_entry_points": launches_entry[name],
            "launches_jpeg": launches_jpeg[name],
            "launches_jpeg_progressive": launches_progressive[name],
            "launches_png_depths": launches_png[name],
            "launches_pillow_free_inputs": launches_free[name],
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

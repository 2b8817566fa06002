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
                X = Y = 28000, D = 144 and on a case full of ties
                (bit-exact), with CUDA-event times;
* ``check_K2``, ``check_K3``  the SIFT orientation and descriptor
                kernels against their plain versions on the real octave
                gradients and keypoints of the rendered pair (atol 2e-5
                of the row maximum; uint8 descriptors within 1 LSB);
* ``two_view``  the port's array-level ``run_two_view`` on the rendered
                pair, one cold and one warm run, every kernel's launch
                count read around the warm run; RANSAC must succeed with
                >= 100 inliers and recover the rendered relative pose;
* ``cpu_parity`` the same pipeline on the small pair on the card and on
                the CPU (plain versions): match counts and consensus agree;
* ``kernels``   one line for every kernel: launches in the warm run, ms,
                plain ms, bound ms and what bounds it.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
last the contract line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero without that line.  Usage: ``python3
chip_smoke.py [--ptxas] [--profile DIR]`` (``--ptxas`` prints the
compiler's register and shared-memory report; ``--profile`` adds a warm
two-view run under ``torch.profiler``: device time by kernel, the
device's busy share, and a Chrome trace in DIR).  Nothing of JAX is
imported.
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
SEED = 0


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


def render_pair(h, w, device, tex_shape):
    """Two views on a lateral arc (cameras as in the multi-view benchmark),
    as the pipeline would read them from 8-bit files: ``(grays float32,
    colors uint8 numpy, K, (R1, t1) of view 1 relative to view 0)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    height, texture_at = make_scene(rng, gen, device, tex_shape)
    f = 1.1 * w
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    target = np.array([0.0, 0.0, 4.0])
    grays, colors, poses = [], [], []
    for i in range(2):
        s = i - 0.5
        R, t = look_at(np.array([1.6 * s, 0.25 * s, 0.35 * abs(s)]), target)
        im = render(height, texture_at, K, R, t, h, w, device)
        u8 = (torch.clamp(im, 0, 1) * 255).to(torch.uint8)
        g = u8.to(torch.float32)
        grays.append((g / g.max()).cpu().numpy())
        colors.append(u8.cpu().numpy())
        poses.append((R, t))
    (R0, t0), (R1, t1) = poses
    R01 = R1 @ R0.T
    return grays, colors, K, (R01, t1 - R01 @ t0)


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


def check_k1(torch, l2nn):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    X = Y = 28000
    D = 144
    x = torch.randint(0, 256, (X, D), generator=gen, device="cuda", dtype=torch.uint8)
    y = torch.randint(0, 256, (Y, D), generator=gen, device="cuda", dtype=torch.uint8)
    ik, dk = l2nn.l2_topk2_cuda(x, y)
    ip, dp = l2nn.l2_topk_mxu(x, y)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
        raise AssertionError("K1 l2nn_top2 disagrees with its plain version")
    # ties: few distinct rows, duplicated database rows, int8 input
    base = torch.randint(-128, 128, (37, 160), generator=gen, device="cuda", dtype=torch.int8)
    xt = base[torch.randint(0, 37, (4099,), generator=gen, device="cuda")]
    yt = base[torch.randint(0, 37, (2051,), generator=gen, device="cuda")]
    ik2, dk2 = l2nn.l2_topk2_cuda(xt, yt)
    ip2, dp2 = l2nn.l2_topk_mxu(xt, yt)
    torch.cuda.synchronize()
    if not (torch.equal(ik2, ip2) and torch.equal(dk2, dp2)):
        raise AssertionError("K1 l2nn_top2 disagrees with its plain version on ties")
    ms = cuda_ms(lambda: l2nn.l2_topk2_cuda(x, y), 5)
    plain_ms = cuda_ms(lambda: l2nn.l2_topk_mxu(x, y), 2)
    bound, by = k1_bound_ms(X, Y, D)
    res = {"name": "l2nn_top2", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "shape": {"X": X, "Y": Y, "D": D}}
    emit("check_K1", exact=True, ties_exact=True, **res)
    return res


def octave_inputs(torch, sift, gray):
    """Octave -1 (the largest) of one image: gradient levels and the
    detected keypoints, as the main path hands them to the kernels."""
    budgets = sift._octave_budgets(*gray.shape, -1, sift.num_octaves(*gray.shape, -1), 32768)
    first = sift._base_first(torch.as_tensor(gray[None], device="cuda"), -1)
    _, mod, ang, det = sift._octave_detect(first, 0.0, 10.0, budgets[0])
    sel = det[0, :4, det[0, 4] > 0]
    return mod[0], ang[0], sel


def rel_err(a, b):
    """Largest |a - b| relative to each row's largest |b|."""
    scale = b.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    return float(((a - b).abs() / scale).max())


def check_k2(torch, so, sift, mod, ang, sel):
    kx, ky, ksig = sel[0], sel[1], sel[2]
    lvl = torch.clamp(sel[3].to(torch.int32), 0, sift.S - 1)
    ones = torch.ones_like(kx, dtype=torch.bool)
    args = (mod, ang, kx, ky, ksig, lvl, ones, sift._R_OR)
    hk = so.orient_hist_cuda(*args)
    hk2 = so.orient_hist_cuda(*args)
    hp = so.orient_hist_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(hk, hk2):
        raise AssertionError("K2 sift_orient_hist is not deterministic")
    err = rel_err(hk, hp)
    if not err <= 2e-5:
        raise AssertionError(f"K2 sift_orient_hist disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: so.orient_hist_cuda(*args), 5)
    plain_ms = cuda_ms(lambda: so.orient_hist_plain(*args), 1)
    L, H_, W_ = mod.shape
    k = [t.cpu().numpy() for t in (kx, ky, ksig)]
    bound, by = k2_bound_ms(L, H_, W_, *k)
    res = {"name": "sift_orient_hist", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "shape": {"K": int(kx.shape[0]), "L": L, "H": H_, "W": W_}}
    emit("check_K2", deterministic=True, **res)
    th, av = so.orientation_peaks(hp, ones)
    return res, th, av


def check_k3(torch, sd, sift, mod, ang, sel, th, av):
    rows = av.reshape(-1).nonzero()[:, 0]
    kp = rows // sift.MAX_ANGLES
    kx, ky, ksig = sel[0][kp], sel[1][kp], sel[2][kp]
    lvl = sel[3][kp].to(torch.int32)
    theta = th.reshape(-1)[rows]
    valid = torch.ones_like(kx, dtype=torch.bool)
    R = sift._r_desc(3.0)
    args = (mod, ang, kx, ky, ksig, lvl, theta, valid, R, 3.0)
    uk, rk = sd.desc_cuda(*args, return_raw=True)
    uk2 = sd.desc_cuda(*args)
    rp = sd.desc_raw_plain(*args)
    up = sd.quantize_descriptors(sd.finish_descriptors(rp, valid))
    torch.cuda.synchronize()
    if not torch.equal(uk, uk2):
        raise AssertionError("K3 sift_desc is not deterministic")
    err = rel_err(rk, rp)
    lsb = int((uk.to(torch.int32) - up.to(torch.int32)).abs().max())
    if not (err <= 2e-5 and lsb <= 1):
        raise AssertionError(f"K3 sift_desc disagrees with its plain version: {err}, {lsb} LSB")
    ms = cuda_ms(lambda: sd.desc_cuda(*args), 3)

    def plain():
        sd.quantize_descriptors(sd.finish_descriptors(sd.desc_raw_plain(*args), valid))

    plain_ms = cuda_ms(plain, 1)
    L, H_, W_ = mod.shape
    k = [t.cpu().numpy() for t in (kx, ky, ksig)]
    bound, by = k3_bound_ms(L, H_, W_, *k, R)
    res = {"name": "sift_desc", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None, "max_lsb": lsb,
           "shape": {"K": int(kx.shape[0]), "L": L, "H": H_, "W": W_}}
    emit("check_K3", deterministic=True, **res)
    return res


def profile_two_view(torch, run_once, out_dir, warm_s):
    """One more warm two-view run under ``torch.profiler``: device time by
    kernel (top 15, device-side events only), their sum as the device's
    busy time, its share of the unprofiled warm run's wall time
    ``warm_s`` (the profiler slows the host side several fold), and a
    Chrome trace in ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "two_view_trace.json"))
    emit("profile", warm_wall_ms=warm_s * 1e3, device_busy_ms=busy_ms,
         busy_share=busy_ms / (warm_s * 1e3), n_kernels=sum(r[2] for r in rows),
         top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:15]])


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
    mod, ang, sel = octave_inputs(torch, sift, grays[0])
    res_k2, th, av = check_k2(torch, so, sift, mod, ang, sel)
    res_k3 = check_k3(torch, sd, sift, mod, ang, sel, th, av)
    del mod, ang, sel, th, av
    torch.cuda.empty_cache()

    def run(device, g, c, k):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        return run_two_view_arrays(g, c, k, outdir=None, quiet=True, generator=gen,
                                   device=device)

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
    P1 = warm["ransac"]["camera"]
    rot_err = rotation_angle_deg(P1[:, :3], R_gt)
    t_dir = P1[:, 3] / np.linalg.norm(P1[:, 3])
    t_err = float(np.degrees(np.arccos(np.clip(abs(t_dir @ (t_gt / np.linalg.norm(t_gt))), -1, 1))))
    pts = warm["points"]
    emit("two_view", cold_seconds=cold_s, warm_seconds=warm_s,
         keypoints=m["keypoints"], n_matches=m["n_matches"], consensus=m["consensus"],
         n_inliers=m["n_inliers"], ransac_success=m["ransac_success"],
         steps={k: v for k, v in m.items() if k.endswith("_seconds")},
         cold_steps={k: v for k, v in cold["metrics"].items() if k.endswith("_seconds")},
         rotation_err_deg=rot_err, translation_err_deg=t_err, launches=launches,
         rectified_shape=list(warm["rectified"][0].shape))
    if not (m["ransac_success"] and m["n_inliers"] >= 100):
        raise AssertionError("RANSAC did not succeed with >= 100 inliers on the rendered pair")
    if not (rot_err < 1.0 and t_err < 3.0):
        raise AssertionError(f"recovered pose off: rotation {rot_err} deg, translation {t_err} deg")
    if not (pts.shape == (m["n_inliers"], 4) and np.isfinite(pts).all()):
        raise AssertionError("triangulated points are not finite or have the wrong shape")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    if "--profile" in argv:
        profile_two_view(torch, lambda: run("cuda", grays, colors, K),
                         argv[argv.index("--profile") + 1], warm_s)

    sg, sc, sk, _ = small
    g_res = run("cuda", sg, sc, sk)["metrics"]
    c_res = run("cpu", sg, sc, sk)["metrics"]
    emit("cpu_parity", shape=[SMALL_H, SMALL_W],
         cuda={k: g_res[k] for k in ("keypoints", "n_matches", "consensus")},
         cpu={k: c_res[k] for k in ("keypoints", "n_matches", "consensus")})
    kp_ok = all(abs(a - b) <= 0.02 * b for a, b in zip(g_res["keypoints"], c_res["keypoints"]))
    nm_ok = abs(g_res["n_matches"] - c_res["n_matches"]) <= max(2, 0.03 * c_res["n_matches"])
    cons_ok = abs(g_res["consensus"] - c_res["consensus"]) <= 0.05
    if not (kp_ok and nm_ok and cons_ok):
        raise AssertionError("the card and the CPU disagree on the small pair")

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
        })
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""End-to-end two-view SfM pipeline (the reference's ex01).

Port of ``spectavi_tpu/pipeline/two_view.py``, same five steps:

1. SIFT keypoints + descriptors on both images;
2. top-2 matching + inverted-Lowe ratio test ``d2/d1 >= min_ratio``
   (``min_ratio^2`` for the squared distances of ``l2-mxu``); the
   matcher is ``l2-mxu`` (exact squared L2, the CUDA kernel),
   ``bruteforce`` (exact L1) or ``cascading-hash``;
3. essential-matrix RANSAC on K^-1-normalized points;
4. DLT triangulation of the inliers -> sparse PLY cloud;
5. epipolar rectification with ``P = K [R|t]``.

On CUDA with ``l2-mxu``, steps 1+2 run as one device-resident front
end (:func:`step12_fused_device`): descriptors stay on the card from
SIFT through quantization to the matcher.  :func:`run_two_view` reads
the image files and K; :func:`run_two_view_arrays` is the array-level
core that takes decoded images.  ``ba=True`` polishes step 4's camera
and points by bundle adjustment (with ``distortion=True`` also a shared
radial lens model).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spectavi_tpu_torch import mvg, resolve_device
from spectavi_tpu_torch.features import normalize_to_ubyte_and_multiple_16_dim, sift_filter_batch
from spectavi_tpu_torch.pipeline.io import Timer, imread, imsave, write_ply
from spectavi_tpu_torch.utils.profiling import annotate, spanned, step


def homogeneous(x):
    return np.hstack((x, np.ones((x.shape[0], 1))))


MATCHING_METHODS = ("l2-mxu", "bruteforce", "cascading-hash")


def resolve_matching_method(matching_method, device="cuda"):
    """Resolve the ``"auto"`` matcher as the JAX package does: the exact
    L2 top-2 kernel on the card, the reference example's cascade hash
    when the caller asked for the CPU."""
    if matching_method == "auto":
        return "l2-mxu" if torch.device(device).type == "cuda" else "cascading-hash"
    if matching_method not in MATCHING_METHODS:
        raise ValueError(matching_method)
    return matching_method


def _read_grays(image_paths):
    return [imread(p, dtype="float32", force_grayscale=True) for p in image_paths]


def step1_sift_detect(image_paths, quiet=False, device="cuda", images=None):
    """SIFT rows ``(n, 132)`` of both images (``images``: decoded
    float32 grayscale arrays, read from ``image_paths`` when None)."""
    ims = images if images is not None else _read_grays(image_paths)
    return sift_filter_batch(ims, device=device)


def step2_match_keypoints(siftkps, matching_method="auto", min_ratio=1.75, quiet=False,
                          device="cuda"):
    """Host-quantized 132-col rows, top-2 matching by the chosen matcher,
    ratio test.  Returns the matched rows ``(xd, yd)``."""
    from spectavi_tpu_torch.match import nn_bruteforcel1k2, nn_cascading_hash, nn_l2k2

    x, y = siftkps
    matching_method = resolve_matching_method(matching_method, device)
    # the full 132-col rows are quantized and matched, as the reference
    # does: the de-meaned x, y, sigma, angle act as a weak spatial prior
    with annotate("quantize"):
        _x = normalize_to_ubyte_and_multiple_16_dim(x)
        _y = normalize_to_ubyte_and_multiple_16_dim(y)
    with annotate("match.nn"):
        if matching_method == "cascading-hash":
            nn_idx, nn_dist = nn_cascading_hash(_x, _y, device=device)
        else:
            nn = nn_bruteforcel1k2 if matching_method == "bruteforce" else nn_l2k2
            nn_idx, nn_dist = nn((_x + 128).astype("uint8"), (_y + 128).astype("uint8"),
                                 device=device)
    with annotate("ratio"):
        ratio = nn_dist[:, 1] / np.maximum(nn_dist[:, 0].astype("float64"), 1e-12)
        # nn_l2k2 returns squared L2 distances, so its threshold is squared too
        pass_idx = ratio >= (min_ratio**2 if matching_method == "l2-mxu" else min_ratio)
        idx0 = nn_idx[:, 0].astype(np.int64)
        return x[idx0[pass_idx]], y[pass_idx]


def step12_fused_device(image_paths, min_ratio=1.75, quiet=False, device="cuda", images=None):
    """Steps 1+2 with descriptors never leaving the device: SIFT leaves
    uint8 descriptors on the device, the 132-col rows are assembled and
    quantized there, and the matcher consumes them in place.  Returns
    ``(metas, (xd, yd))`` with 4-col keypoint rows (steps 3-5 use only
    columns 0-1).  Same matching semantics as step1 + step2."""
    from spectavi_tpu_torch.features.normalize import normalize_to_ubyte_device
    from spectavi_tpu_torch.features.sift import sift_filter_batch_device
    from spectavi_tpu_torch.ops.l2nn import l2_topk2

    dev = resolve_device(device)
    ims = images if images is not None else _read_grays(image_paths)
    with annotate("sift"):
        outs = sift_filter_batch_device(ims, device=dev)
    with annotate("quantize"):
        rows = [
            torch.cat(
                [torch.as_tensor(o["meta"], device=dev), o["desc"].to(torch.float32)], dim=1
            )
            for o in outs
        ]
        _x = normalize_to_ubyte_device(rows[0])
        _y = normalize_to_ubyte_device(rows[1])
    with annotate("match"):
        nn_idx, nn_dist = (t.cpu().numpy() for t in l2_topk2(_x, _y))
    with annotate("ratio"):
        ratio = nn_dist[:, 1] / np.maximum(nn_dist[:, 0].astype("float64"), 1e-12)
        pass_idx = ratio >= min_ratio**2
        idx0 = nn_idx[:, 0].astype(np.int64)
        xd = outs[0]["meta"][idx0[pass_idx]]
        yd = outs[1]["meta"][pass_idx]
    return [o["meta"] for o in outs], (xd, yd)


def step3_estimate_essential(xd, yd, K, ransac_quality="ultra", options=None, generator=None,
                             quiet=False, device="cuda"):
    iK = np.linalg.inv(K)
    x0 = homogeneous(xd[..., :2]) @ iK.T
    x1 = homogeneous(yd[..., :2]) @ iK.T
    quality = {"low": 0.6, "medium": 0.7, "high": 0.75, "ultra": 0.8, "uber": 0.9}
    ransac_options = {
        "required_percent_inliers": quality[ransac_quality],
        "reprojection_error_allowed": 3.35e-4,
        "maximum_tries": 10000000,
        # keep the best model when the required consensus is not met,
        # so steps 4-5 always have a model to work with
        "find_best_even_in_failure": True,
        "singular_value_ratio_allowed": 1e-3,
        "progressbar": False,
    }
    if options:
        ransac_options.update(options)
    ransac = mvg.ransac_fitter(x0, x1, options=ransac_options, generator=generator, device=device)
    return ransac, x0, x1, xd, yd


def step4_triangulate(step3_out, image_paths=None, outdir=None, quiet=False, ba=False,
                      distortion=False, images=None, device="cuda"):
    """DLT triangulation of the inliers (float64 on ``device``); PLY
    output with vertex colors sampled from ``images`` (raw decodes) when
    given.  ``ba``: with 10 or more inliers, refine P1 and the points by
    bundle adjustment against the inlier observations (10 iterations,
    camera 0 fixed), with a shared radial ``(k1, k2)`` model when
    ``distortion`` (which alone changes nothing)."""
    dev = resolve_device(device)
    ransac, x0, x1, xd, yd = step3_out
    idx = ransac["inlier_idx"]
    P1 = ransac["camera"]
    P0 = np.hstack((np.eye(3), np.zeros((3, 1))))
    RX = mvg.dlt_triangulate(P0, P1, x0[idx], x1[idx], device=dev)
    RX = RX / RX[..., -1:].reshape(-1, 1)
    if ba and len(idx) >= 10:
        from spectavi_tpu_torch.sfm import bundle_adjust, rodrigues, rotation_to_rvec

        cams0 = np.zeros((2, 6))
        cams0[1, :3] = rotation_to_rvec(P1[:, :3])
        cams0[1, 3:] = P1[:, 3]
        M = len(idx)
        ci = np.concatenate([np.zeros(M, np.int32), np.ones(M, np.int32)])
        pi = np.concatenate([np.arange(M, dtype=np.int32)] * 2)
        uv = np.concatenate([x0[idx, :2] / x0[idx, 2:], x1[idx, :2] / x1[idx, 2:]])
        with Timer("step4-ba", quiet, "ba"):
            out = bundle_adjust(
                cams0, RX[:, :3], ci, pi, uv, fixed_cameras=(0,), max_iters=10,
                estimate_distortion=distortion, device=dev,
            )
        cams_ba, pts_ba, hist = out[:3]
        if not quiet:
            k_msg = f"  (k1,k2)=({out[3][0]:.4f},{out[3][1]:.4f})" if distortion else ""
            print(f"  two-view BA: cost {hist[0]:.3e} -> {hist[-1]:.3e}{k_msg}")
        R1 = rodrigues(torch.as_tensor(cams_ba[1, :3])).numpy()
        ransac = dict(ransac, camera=np.hstack([R1, cams_ba[1, 3:, None]]))
        RX = np.hstack([pts_ba, np.ones((M, 1))])
    rgb = None
    if images is None and image_paths is not None:
        images = (imread(image_paths[0], dtype="uint8"), imread(image_paths[1], dtype="uint8"))
    if images is not None:
        im0, im1 = images
        xy0 = xd[idx, :2].astype("int32")
        xy1 = yd[idx, :2].astype("int32")
        if np.issubdtype(im0.dtype, np.integer):
            im0v = im0[xy0[:, 1], xy0[:, 0]] / np.float64(max(int(im0.max()), 1))
            im1v = im1[xy1[:, 1], xy1[:, 0]] / np.float64(max(int(im1.max()), 1))
        else:
            im0v = im0[xy0[:, 1], xy0[:, 0]]
            im1v = im1[xy1[:, 1], xy1[:, 0]]
        rgb = np.round(255 * (im0v + im1v) / 2.0).astype("uint8")
        if rgb.ndim == 1:
            rgb = np.stack([rgb] * 3, axis=1)
    if outdir is not None:
        with annotate("write"):
            write_ply(os.path.join(outdir, "sparse_inliers.ply"), RX, rgb=rgb)
    return RX, ransac


def _max_normalized(im):
    im = im.astype(np.float64)
    return im / np.maximum(np.max(im), np.finfo(np.float64).tiny)


def step5_rectify(ransac, K, image_paths, outdir=None, sampling_factor=1.0, quiet=False,
                  images=None, device="cuda"):
    """Rectify the pair: uint8 device rectification on CUDA
    (:func:`mvg.rectify_pair_quantized`), the float64 reference API on
    the CPU.  ``images``: raw decodes (read from ``image_paths`` when
    None).  Writes ``rect-*`` images and index maps into ``outdir``."""
    dev = resolve_device(device)
    P1 = K @ ransac["camera"]
    P0 = K @ np.hstack((np.eye(3), np.zeros((3, 1))))
    if images is None:
        images = (imread(image_paths[0], dtype="uint8"), imread(image_paths[1], dtype="uint8"))
    im0, im1 = images
    if dev.type == "cuda":
        if im0.dtype != np.uint8 or im0.shape != im1.shape:
            im0, im1 = _max_normalized(im0), _max_normalized(im1)
        r0u, r1u, ri0, ri1 = mvg.rectify_pair_quantized(
            P0, P1, im0, im1, sampling_factor=sampling_factor, device=dev
        )
        r0, r1 = r0u, r1u
    else:
        r0, r1, ri0, ri1 = mvg.image_pair_rectification(
            P0, P1, _max_normalized(im0), _max_normalized(im1),
            sampling_factor=sampling_factor, device=dev,
        )
        r0u = np.clip(r0 * 255, 0, 255).astype("uint8")
        r1u = np.clip(r1 * 255, 0, 255).astype("uint8")
    if outdir is not None:
        with annotate("write"):
            for r, p in ((r0u, image_paths[0]), (r1u, image_paths[1])):
                arr = r[..., 0] if (r.ndim == 3 and r.shape[-1] == 1) else r
                imsave(os.path.join(outdir, "rect-" + os.path.basename(p)), arr)
            for ri, p in ((ri0, image_paths[0]), (ri1, image_paths[1])):
                stem = os.path.basename(p).split(".")[0]
                ri.tofile(os.path.join(outdir, "rect-idx-" + stem) + ".bin")
    return r0, r1, ri0, ri1


@spanned("two_view")
def run_two_view_arrays(grays, colors, K, image_names=("im0.png", "im1.png"), outdir=None,
                        matching_method="auto", min_ratio=1.75, ransac_quality="ultra",
                        rsf=1.0, cache=False, generator=None, quiet=False,
                        ransac_options=None, ba=False, distortion=False, plots=False,
                        device="cuda", decode_seconds=0.0):
    """The pipeline on decoded images: ``grays`` two float32 grayscale
    arrays in [0, 1] (SIFT input), ``colors`` the two raw decodes
    (rectification and vertex colors), ``K (3, 3)``.  Output files, when
    ``outdir`` is set, are named after ``image_names``.  Returns the
    same dict as :func:`run_two_view`."""
    dev = resolve_device(device)
    if plots and outdir is not None:
        # the plots come after SIFT and matching: fail before them
        import matplotlib  # noqa: F401
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
    K = np.asarray(K, dtype=np.float64)
    matching_method = resolve_matching_method(matching_method, dev)
    metrics = {
        "images": [str(p) for p in image_names],
        "matching_method": matching_method,
        "ransac_quality": ransac_quality,
    }

    cache_file = os.path.join(outdir, "cache.npz") if outdir else None
    step2_out = None
    if cache and cache_file and os.path.exists(cache_file):
        data = np.load(cache_file)
        step2_out = (data["xd"], data["yd"])
        metrics["match_cache_hit"] = True
    if step2_out is None:
        fused = matching_method == "l2-mxu" and dev.type == "cuda"
        metrics["fused_frontend"] = fused
        if fused:
            with Timer("step1-computation", quiet, "frontend") as t:
                kps, step2_out = step12_fused_device(
                    image_names, min_ratio, quiet, device=dev, images=grays
                )
            metrics["step1_seconds"] = t.elapsed
            metrics["step2_seconds"] = 0.0  # fused into step 1
        else:
            with Timer("step1-computation", quiet, "sift") as t:
                kps = step1_sift_detect(image_names, quiet, device=dev, images=grays)
            metrics["step1_seconds"] = t.elapsed
            with Timer("step2-computation", quiet, "match") as t:
                step2_out = step2_match_keypoints(kps, matching_method, min_ratio, quiet,
                                                  device=dev)
            metrics["step2_seconds"] = t.elapsed
        metrics["keypoints"] = [int(kps[0].shape[0]), int(kps[1].shape[0])]
        if not quiet:
            print("sift 1 #: ", kps[0].shape[0])
            print("sift 2 #: ", kps[1].shape[0])
        if cache and cache_file:
            np.savez_compressed(cache_file, xd=step2_out[0], yd=step2_out[1])
        if plots and outdir is not None:
            from spectavi_tpu_torch.pipeline.viz import save_keypoint_plot, save_match_plot

            save_keypoint_plot(grays[0], grays[1], kps[0], kps[1],
                               os.path.join(outdir, "step1-keypoints.png"))
            save_match_plot(grays[0], grays[1], step2_out[0], step2_out[1],
                            os.path.join(outdir, "step2-matches.png"))

    with Timer("step3-computation", quiet, "ransac") as t:
        step3_out = step3_estimate_essential(
            step2_out[0], step2_out[1], K, ransac_quality, options=ransac_options,
            generator=generator, quiet=quiet, device=dev,
        )
    metrics["step3_seconds"] = t.elapsed
    ransac = step3_out[0]
    metrics["n_matches"] = int(step2_out[0].shape[0])
    metrics["consensus"] = float(ransac["inlier_percent"])
    metrics["n_inliers"] = int(len(ransac["inlier_idx"]))
    metrics["ransac_success"] = bool(ransac["success"])
    if not quiet:
        print(" Number of keypoints: ", step2_out[0].shape[0])
        print(" Percent of inliers: ", ransac["inlier_percent"])
        _, s, _ = np.linalg.svd(ransac["essential"])
        print(" Fundamental Matrix Singular Values: ", s)
        print(" Singular Values ratio score: ", np.abs(s[0] - s[1]) / np.abs(s[0] + s[1]))
    metrics["decode_seconds"] = float(decode_seconds)
    with Timer("step4-computation", quiet, "triangulate") as t:
        RX, ransac = step4_triangulate(step3_out, None, outdir, quiet, ba=ba,
                                       distortion=distortion, images=colors, device=dev)
    metrics["step4_seconds"] = t.elapsed
    metrics["n_points"] = int(RX.shape[0])
    with Timer("step5-computation", quiet, "rectify") as t:
        rect = step5_rectify(
            ransac, K, list(image_names), outdir, rsf, quiet, images=colors, device=dev
        )
    metrics["step5_seconds"] = t.elapsed
    metrics["total_seconds"] = sum(v for k, v in metrics.items() if k.endswith("_seconds"))
    if outdir is not None:
        from spectavi_tpu_torch.pipeline.io import write_metrics

        with annotate("write"):
            write_metrics(os.path.join(outdir, "metrics.json"), metrics)
    return {
        "matches": step2_out,
        "ransac": ransac,
        "points": RX,
        "rectified": rect,
        "metrics": metrics,
    }


def run_two_view(image_paths, K_path, outdir="ex01_out", matching_method="auto",
                 min_ratio=1.75, ransac_quality="ultra", rsf=1.0, cache=False,
                 generator=None, quiet=False, ransac_options=None, ba=False,
                 distortion=False, plots=False, device="cuda"):
    """Full ex01 pipeline from image files and a ``K.txt``; returns
    ``{"matches", "ransac", "points", "rectified", "metrics"}`` and
    writes ``sparse_inliers.ply``, ``rect-*``, ``metrics.json`` (and
    ``cache.npz`` with ``cache``, ``step1-keypoints.png`` and
    ``step2-matches.png`` with ``plots``) into ``outdir``.  ``generator``: a
    ``torch.Generator`` on ``device`` for the RANSAC samples."""
    resolve_device(device)
    with annotate("decode"):
        K = np.loadtxt(K_path)
        grays = _read_grays(image_paths)
        with step("decode.colors") as t:
            colors = (imread(image_paths[0], dtype="uint8"), imread(image_paths[1], dtype="uint8"))
    decode_seconds = t.elapsed
    return run_two_view_arrays(
        grays, colors, K, image_names=image_paths, outdir=outdir,
        matching_method=matching_method, min_ratio=min_ratio,
        ransac_quality=ransac_quality, rsf=rsf, cache=cache, generator=generator,
        quiet=quiet, ransac_options=ransac_options, ba=ba, distortion=distortion,
        plots=plots, device=device, decode_seconds=decode_seconds,
    )

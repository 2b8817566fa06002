"""CLI for the two-view pipeline — ex01 equivalent, on PyTorch/CUDA.

Usage:

    python -m spectavi_tpu_torch.pipeline.ex01 IM0 IM1 K.txt [--outdir DIR]
        [--ransac_quality {low,medium,high,ultra,uber}]
        [--matching_method {auto,bruteforce,cascading-hash,l2-mxu}]
        [--min_ratio R] [--rsf F] [--cache] [--plots] [--seed N]
        [--device cuda|cpu] [--trace DIR] [--view]
"""

from __future__ import annotations

import argparse
import contextlib
import os

from spectavi_tpu_torch.pipeline.two_view import run_two_view


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Estimate the essential matrix of an image pair, "
        "triangulate a sparse cloud, and rectify the pair (PyTorch/CUDA)."
    )
    parser.add_argument("images", metavar="IM", type=str, nargs=2)
    parser.add_argument("K", metavar="K", type=str)
    parser.add_argument("--min_ratio", default=1.75, type=float)
    parser.add_argument(
        "--ransac_quality", default="ultra", choices=["low", "medium", "high", "ultra", "uber"]
    )
    parser.add_argument(
        "--matching_method",
        default="auto",
        choices=["auto", "bruteforce", "cascading-hash", "l2-mxu"],
        help="'auto' = the exact L2 top-2 kernel on the card, the cascade hash "
             "with --device cpu",
    )
    parser.add_argument("--outdir", default="ex01_out", type=str)
    parser.add_argument("--rsf", default=1.0, type=float)
    parser.add_argument("--cache", action="store_true")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--reproj", default=None, type=float,
                        help="override RANSAC reprojection threshold (normalized coords)")
    parser.add_argument("--ba", action="store_true",
                        help="two-view bundle-adjustment polish of the camera and points")
    parser.add_argument("--distortion", action="store_true",
                        help="radial lens model during --ba")
    parser.add_argument("--plots", action="store_true",
                        help="also save keypoint/match visualizations (needs matplotlib)")
    parser.add_argument("--view", action="store_true",
                        help="open the sparse cloud interactively with "
                        "open3d (reference ex01's final viz step; falls "
                        "back to a message when open3d is unavailable)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to DIR "
                        "(chrome://tracing, Perfetto or tensorboard), with the "
                        "pipeline's step tree beside the kernels")
    args = parser.parse_args(argv)

    import torch

    from spectavi_tpu_torch import resolve_device
    from spectavi_tpu_torch.utils.profiling import annotate, trace

    generator = torch.Generator(device=resolve_device(args.device))
    generator.manual_seed(args.seed)
    ransac_options = None
    if args.reproj is not None:
        ransac_options = {"reprojection_error_allowed": args.reproj,
                          "find_best_even_in_failure": True}
    trace_ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    with trace_ctx, annotate("cli"):
        res = run_two_view(
            args.images,
            args.K,
            outdir=args.outdir,
            matching_method=args.matching_method,
            min_ratio=args.min_ratio,
            ransac_quality=args.ransac_quality,
            rsf=args.rsf,
            cache=args.cache,
            generator=generator,
            ransac_options=ransac_options,
            ba=args.ba,
            distortion=args.distortion,
            plots=args.plots,
            device=args.device,
        )
    if args.view:
        from spectavi_tpu_torch.pipeline.viz import try_open3d_viz

        try_open3d_viz(os.path.join(args.outdir, "sparse_inliers.ply"))
    return res


if __name__ == "__main__":
    main()

"""CLI for the multi-view pipeline — ex02 equivalent, on PyTorch/CUDA.

Runs SIFT -> pairwise matching and RANSAC -> tracks -> PnP registration
-> N-view triangulation -> bundle adjustment over images that share one
intrinsics matrix, and writes ``sparse_cloud.ply``, ``poses.txt`` and
``metrics.json``:

    python -m spectavi_tpu_torch.pipeline.ex02 IM0 IM1 [IM2 ...] K.txt
        [--outdir sfm_out] [--pairs sequential|exhaustive]
        [--min_ratio R] [--ba_iters N] [--checkpoint state.npz]
        [--seed N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("inputs", nargs="+", help="image files followed by K.txt")
    ap.add_argument("--outdir", default="sfm_out")
    ap.add_argument("--pairs", default="sequential", choices=["sequential", "exhaustive"])
    ap.add_argument("--min_ratio", default=1.75, type=float)
    ap.add_argument("--ba_iters", default=15, type=int)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    images, K_path = args.inputs[:-1], args.inputs[-1]
    if len(images) < 2:
        ap.error("need at least two images plus K.txt")

    import torch

    from spectavi_tpu_torch import resolve_device
    from spectavi_tpu_torch.pipeline.sfm import run_sfm

    generator = torch.Generator(device=resolve_device(args.device))
    generator.manual_seed(args.seed)
    res = run_sfm(
        images,
        K_path,
        outdir=args.outdir,
        pairs=args.pairs,
        min_ratio=args.min_ratio,
        ba_iters=args.ba_iters,
        generator=generator,
        checkpoint=args.checkpoint,
        device=args.device,
    )
    print(
        f"done: {res['points'].shape[0]} points, "
        f"BA cost {res['ba_history'][0]:.3e} -> {res['ba_history'][-1]:.3e}; "
        f"outputs in {args.outdir}"
    )
    return res


if __name__ == "__main__":
    main()

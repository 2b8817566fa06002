"""Two-view jobs on decoded arrays: ``run_two_view_arrays`` back to back.

A closed loop with one client.  Set-up renders the cell's pool of image
pairs (each the two ends of the arc of one scene of the configuration)
and hands every job a pair as a decoder would: float32 grays and RGB
``uint8`` colours on the host.  Job ``i`` takes pool pair
``order[i % pool]`` (``order`` a permutation drawn from ``--seed``), as
fresh copies of its arrays, and a RANSAC generator seeded from
``--seed`` and ``i``; ``outdir`` is None.  The reference replays the
job's RANSAC with that seed on its own matches.

Traffic keys: ``pool`` (pairs), ``rect_every`` (every how many jobs the
rectified pair is kept for the check), ``profile_jobs`` (jobs under the
profiler in a traced run).
"""

from __future__ import annotations

import numpy as np
import torch

from sfmbench import scene
from sfmbench.reference import judge

# one cold and one warm job, one on each pool pair
WARM_JOBS = 2

# the RANSAC reprojection threshold of ex01's step 3 (calibrated
# coordinates), which decides an inlier
STEP3_REPROJ = 3.35e-4
# ex01's step 3 at the configuration's ``ransac_quality``: the required
# consensus by quality, and the options it states
STEP3_REQUIRED = {"low": 0.6, "medium": 0.7, "high": 0.75, "ultra": 0.8, "uber": 0.9}
STEP3_OPTIONS = {"reprojection_error_allowed": STEP3_REPROJ, "maximum_tries": 10000000,
                 "find_best_even_in_failure": True, "singular_value_ratio_allowed": 1e-3}


class State:
    def __init__(self):
        self.pairs = []
        self.order = None
        self.rect_phase = 0


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    for scene_seed in cfg["scene_seeds"][: tr["pool"]]:
        s = scene.render_scene(2, cfg["height"], cfg["width"], ctx.device, tuple(cfg["texture"]),
                               scene_seed, cfg["focal_over_width"])
        st.pairs.append({"grays": s["grays"], "colors": s["colors"], "K": s["K"],
                         "truth": scene.relative_pose(s["poses"])})
    rng = ctx.rng(1)
    st.order = rng.permutation(len(st.pairs))
    st.rect_phase = int(rng.integers(tr["rect_every"]))
    return st


def _run(ctx, st, i):
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays

    p = int(st.order[i % len(st.pairs)]) if i >= 0 else (-1 - i) % len(st.pairs)
    pair = st.pairs[p]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.job_seed(i))
    res = run_two_view_arrays([g.copy() for g in pair["grays"]],
                              [c.copy() for c in pair["colors"]], pair["K"].copy(), outdir=None,
                              generator=gen, quiet=True, device=ctx.device,
                              **ctx.config["settings"])
    ctx.sync()
    return p, res


def job(ctx, st, i):
    p, res = _run(ctx, st, i)
    if i < 0:
        return None
    keep_rect = i % ctx.traffic["rect_every"] == st.rect_phase
    return {
        "pair": p,
        "seed": ctx.job_seed(i),
        "matches": res["matches"],
        "camera": res["ransac"]["camera"],
        "inlier_idx": res["ransac"]["inlier_idx"],
        "points": res["points"],
        "rectified": res["rectified"] if keep_rect else None,
    }


def profile_jobs(ctx, st, i):
    _run(ctx, st, i)


def front_end(ctx, st, dtype=torch.float32):
    """The reference's matches of every pool pair, SIFT's scale space in
    ``dtype``."""
    out = []
    for pair in st.pairs:
        views = judge.sift_views(pair["grays"], ctx.device, dtype)
        out.append(judge.match_rows(views[0], views[1], ctx.config["settings"]["min_ratio"]))
        del views
    return out


def consensus(ctx, K, xd, yd, seed):
    """ex01's step 3 replayed by the reference on the matches ``(xd,
    yd)`` with the job's generator seed: the inlier correspondences of
    its winning model."""
    iK = np.linalg.inv(K)
    x0 = np.hstack([xd[:, :2], np.ones((xd.shape[0], 1))]) @ iK.T
    x1 = np.hstack([yd[:, :2], np.ones((yd.shape[0], 1))]) @ iK.T
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seed)
    opts = dict(STEP3_OPTIONS,
                required_percent_inliers=STEP3_REQUIRED[ctx.config["settings"]["ransac_quality"]])
    res = judge.ransac.ransac_fitter(x0, x1, options=opts, generator=gen, device=ctx.device)
    idx = res["inlier_idx"]
    return np.hstack([xd[idx, :3], yd[idx, :3]])


NUMBERS = ("match_diff", "consensus_diff", "inlier_diff", "point_err", "rect_diff",
           "rotation_deg", "translation_deg")


def numbers(ctx, st, answers, ref_matches):
    """The compared numbers over every answered job, the worst of each.
    An answer holds a job's matches, its consensus (inlier
    correspondences), camera, inlier indices, points and (every
    ``rect_every`` jobs) rectified pair."""
    rsf = ctx.config["settings"]["rsf"]
    worst = dict.fromkeys(NUMBERS, 0.0)

    def worse(key, v):
        worst[key] = max(worst[key], v)

    for ans in answers:
        if ans is None:
            continue
        pair = st.pairs[ans["pair"]]
        K = pair["K"]
        xd, yd = ans["matches"]
        ref_xd, ref_yd = ref_matches[ans["pair"]]
        worse("match_diff", judge.match_diff(xd, yd, ref_xd, ref_yd))
        worse("consensus_diff", judge.set_diff(
            ans["consensus"], consensus(ctx, K, ref_xd, ref_yd, ans["seed"])))
        mask = judge.inlier_mask(xd, yd, K, ans["camera"], STEP3_REPROJ, ctx.device)
        worse("inlier_diff", judge.inlier_diff(ans["inlier_idx"], mask))
        pts = judge.triangulate(xd, yd, K, ans["camera"], ans["inlier_idx"], ctx.device)
        worse("point_err", judge.point_err(ans["points"], pts))
        if ans["rectified"] is not None:
            rect = judge.rectify(K, ans["camera"], pair["colors"], rsf, ctx.device)
            worse("rect_diff", judge.rect_diff(ans["rectified"], rect))
        rot, tra = judge.geometry.pose_errors_deg(ans["camera"], *pair["truth"])
        worse("rotation_deg", rot)
        worse("translation_deg", tra)
    return worst


def _with_consensus(out):
    xd, yd = out["matches"]
    idx = np.asarray(out["inlier_idx"], np.int64)
    return dict(out, consensus=np.hstack([xd[idx, :3], yd[idx, :3]]))


def check(ctx, st, outputs):
    limits = ctx.config["limits"]
    answers = [None if o is None else _with_consensus(o) for o in outputs]
    worst = numbers(ctx, st, answers, front_end(ctx, st))
    return {k: (v, limits[k]) for k, v in worst.items()}


def control(ctx, st, outputs):
    """The control's numbers: the reference put in the program's place a
    precision below the configuration's (the front end's scale space in
    bfloat16; TF32 matrix products in RANSAC, the inlier test and the
    rectification; float32 for the float64 triangulation), judged as the
    program's answers are.  The program's camera stands (the pose has the
    configuration's limit)."""
    ref = front_end(ctx, st)
    low = front_end(ctx, st, judge.LOW_FRONT_END)
    answers = []
    for out in outputs:
        if out is None:
            continue
        pair = st.pairs[out["pair"]]
        xd, yd = low[out["pair"]]
        with judge.lowered():
            agreed = consensus(ctx, pair["K"], xd, yd, out["seed"])
            mask = judge.inlier_mask(xd, yd, pair["K"], out["camera"], STEP3_REPROJ, ctx.device)
            rect = None
            if out["rectified"] is not None:
                rect = judge.rectify(pair["K"], out["camera"], pair["colors"],
                                     ctx.config["settings"]["rsf"], ctx.device)
        idx = np.where(mask)[0]
        pts = judge.triangulate(xd, yd, pair["K"], out["camera"], idx, ctx.device,
                                dtype=torch.float32)
        answers.append({"pair": out["pair"], "seed": out["seed"], "matches": (xd, yd),
                        "consensus": agreed, "camera": out["camera"], "inlier_idx": idx,
                        "points": pts, "rectified": rect})
    return numbers(ctx, st, answers, ref)

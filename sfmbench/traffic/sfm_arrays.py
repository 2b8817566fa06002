"""Multi-view jobs on decoded arrays: ``run_sfm_arrays`` back to back.

A closed loop with one client.  Set-up renders the cell's pool of
scenes, the configuration's ``views_per_job`` frames each on the arc, as
float32 grays on the host.
Job ``i`` takes scene ``order[i % pool]`` (``order`` drawn from
``--seed``), handed over as fresh copies of its arrays, with a generator
seeded from ``--seed`` and ``i``, and the configuration's settings with
the traffic's ``pairs``.

The benchmark wraps two of the program's functions to keep what they
were handed and what they gave (references only, no copy): the pair
step ``spectavi_tpu_torch.pipeline.sfm._match_pairs_batched`` (each
view's quantized descriptors, every pair's ratio-test survivors and
inliers) and the final bundle adjustment
``spectavi_tpu_torch.sfm.bundle_adjust.bundle_adjust_device``.  The
reference works out every view's keypoints and descriptors and each
pair's ratio-test survivors, takes of those the inliers of the
program's camera for the pair by its own inlier test, unions them into
tracks, and adjusts again from the state the program handed its final
BA.

Traffic keys: ``pool``, ``pairs``, ``ba_checks`` (jobs whose
final BA the reference runs again, drawn from ``--seed``),
``profile_jobs``.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from sfmbench import scene
from sfmbench.reference import judge

# one cold and one warm job, one on each pool scene
WARM_JOBS = 2

BA_TARGET = ("spectavi_tpu_torch.sfm.bundle_adjust", "bundle_adjust_device")
PAIR_TARGET = ("spectavi_tpu_torch.pipeline.sfm", "_match_pairs_batched")

# ex02's RANSAC options in the pair step: the reprojection threshold
# that decides an inlier and the singular-value gate of a 7-point root
PAIR_REPROJ = 3.35e-4
PAIR_SVR = 1e-3


class State:
    def __init__(self):
        self.scenes = []
        self.order = None
        self.ba_calls = []
        self.pair_calls = []
        self.restore = []


def _keep(st, target, calls, keep):
    owner = importlib.import_module(target[0])
    orig = getattr(owner, target[1])

    def kept(*a, **k):
        out = orig(*a, **k)
        calls.append(keep(a, k, out))
        return out

    setattr(owner, target[1], kept)
    st.restore.append(lambda: setattr(owner, target[1], orig))


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    for scene_seed in cfg["scene_seeds"][: tr["pool"]]:
        s = scene.render_scene(cfg["views_per_job"], cfg["height"], cfg["width"], ctx.device,
                               tuple(cfg["texture"]), scene_seed, cfg["focal_over_width"])
        st.scenes.append({"grays": s["grays"], "K": s["K"],
                          "centres": np.stack([C for _, _, C in s["poses"]])})
    st.order = ctx.rng(1).permutation(len(st.scenes))
    _keep(st, BA_TARGET, st.ba_calls, lambda a, k, out: (a, k))
    # the pair step's descriptors (its first argument) and its results
    _keep(st, PAIR_TARGET, st.pair_calls, lambda a, k, out: (a[0], out))
    return st


def pair_list(ctx, n_views):
    if ctx.traffic["pairs"] == "sequential":
        return [(i, i + 1) for i in range(n_views - 1)]
    if ctx.traffic["pairs"] == "exhaustive":
        return [(i, j) for i in range(n_views) for j in range(i + 1, n_views)]
    raise ValueError(f"unknown pairs {ctx.traffic['pairs']!r}")


def _run(ctx, st, i):
    from spectavi_tpu_torch.pipeline.sfm import run_sfm_arrays

    p = int(st.order[i % len(st.scenes)]) if i >= 0 else (-1 - i) % len(st.scenes)
    sc = st.scenes[p]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.job_seed(i))
    st.ba_calls.clear()
    st.pair_calls.clear()
    res = run_sfm_arrays([g.copy() for g in sc["grays"]], sc["K"].copy(),
                         pairs=ctx.traffic["pairs"], generator=gen, quiet=True,
                         device=ctx.device, **ctx.config["settings"])
    ctx.sync()
    return p, res


def job(ctx, st, i):
    p, res = _run(ctx, st, i)
    if i < 0:
        return None
    descs, pairs = st.pair_calls[-1] if st.pair_calls else (None, None)
    return {
        "scene": p,
        "seed": ctx.job_seed(i),
        "cams": res["cams"],
        "points": res["points"],
        "tracks": res["tracks"],
        "metas": [np.asarray(k)[:, :4] for k in res["keypoints"]],
        "descs": descs,
        "pairs": None if pairs is None else {tuple(r["pair"]): r for r in pairs
                                             if not r.get("skipped")},
        "ba_start": st.ba_calls[-1] if st.ba_calls else None,
    }


def profile_jobs(ctx, st, i):
    _run(ctx, st, i)


def release(ctx, st):
    while st.restore:
        st.restore.pop()()
    return st


def features(ctx, st, dtype=torch.float32):
    """The reference's features of every view of every scene, SIFT's
    scale space in ``dtype``: per scene ``(metas, quantized descriptor
    tables on the device, calibrated keypoints)``."""
    out = []
    for sc in st.scenes:
        views = judge.sift_views(sc["grays"], ctx.device, dtype)
        metas = [m for m, _ in views]
        out.append((metas, [judge.quantized(d) for _, d in views],
                    [judge.calibrated(m, sc["K"]) for m in metas]))
        del views
    return out


def _pairs(ctx, feats, generator=None):
    metas, descs, pts = feats
    return judge.ransac.pair_step(descs, pts, pair_list(ctx, len(metas)), generator, PAIR_REPROJ,
                                  PAIR_SVR, ctx.config["settings"]["min_ratio"],
                                  fit=generator is not None)


def _tracks(pairs, n_views):
    """The tracks of the pairs' inliers, by the program's rule for an
    edge of the graph."""
    edges = {p: (r["idx_i"], r["idx_j"]) for p, r in pairs.items()
             if r["n_matches"] >= 10 and len(r["idx_j"]) >= 8}
    return judge.tracks.build_tracks(edges, n_views)


def judged_pairs(ctx, K, metas, survivors, answered):
    """Each pair's reference survivors (``survivors``: the compacted
    ratio-test survivors of the reference's features) and, of them, the
    inliers of the answer's camera for that pair by the reference's
    inlier test; a pair the answer lacks keeps no inlier."""
    out = {}
    for p, r in survivors.items():
        a = (answered or {}).get(p)
        keep = np.zeros(len(r["idx_j"]), bool)
        if a is not None and len(keep):
            i, j = p
            keep = judge.inlier_mask(metas[i][r["idx_i"]], metas[j][r["idx_j"]], K, a["camera"],
                                     PAIR_REPROJ, ctx.device)
        out[p] = {"n_matches": r["n_matches"], "idx_i": r["idx_i"][keep],
                  "idx_j": r["idx_j"][keep]}
    return out


def ba_sample(ctx, outputs):
    """Indices of the answered jobs whose final BA is run again."""
    done = [i for i, o in enumerate(outputs) if o is not None and o["ba_start"] is not None]
    k = min(int(ctx.traffic["ba_checks"]), len(done))
    return sorted(ctx.rng(2).choice(done, size=k, replace=False).tolist()) if k else []


NUMBERS = ("feature_diff", "pair_match_diff", "pair_inlier_diff", "track_diff", "ate_pct",
           "ba_diff")


def numbers(ctx, st, answers, ref_feats, ref_ba):
    """The compared numbers, the worst over the answered jobs:
    ``feature_diff`` (keypoints and quantized descriptor bytes);
    ``pair_match_diff`` and ``pair_inlier_diff``, the pair step's
    survivors and inliers against the reference's survivors and those
    that pass the reference's inlier test under the answer's camera of
    the pair; ``track_diff`` against the tracks of those inliers;
    ``ate_pct`` of the cameras against the rendered trajectory; and
    ``ba_diff`` of the final BA against the reference's (``ref_ba``:
    job index -> cams, points)."""
    worst = dict.fromkeys(NUMBERS, 0.0)

    def worse(key, v):
        worst[key] = max(worst[key], v)

    survivors = {}
    for i, ans in enumerate(answers):
        if ans is None:
            continue
        sc = st.scenes[ans["scene"]]
        feats = ref_feats[ans["scene"]]
        if ans["descs"] is None or ans["pairs"] is None:
            # the pair step never ran: nothing to judge it by
            for k in ("feature_diff", "pair_match_diff", "pair_inlier_diff"):
                worse(k, float("inf"))
        else:
            worse("feature_diff", judge.feature_diff(ans["metas"], ans["descs"], feats[0],
                                                     feats[1]))
        if ans["scene"] not in survivors:
            survivors[ans["scene"]] = _pairs(ctx, feats)
        ref_pairs = judged_pairs(ctx, sc["K"], feats[0], survivors[ans["scene"]], ans["pairs"])
        if ans["pairs"] is not None:
            m, n = judge.pair_diffs(ans["pairs"], ans["metas"], ref_pairs, feats[0])
            worse("pair_match_diff", m)
            worse("pair_inlier_diff", n)
        worse("track_diff", judge.track_diff(ans["tracks"], ans["metas"],
                                             _tracks(ref_pairs, len(feats[0])), feats[0]))
        worse("ate_pct", 100.0 * judge.geometry.ate_share(ans["cams"], sc["centres"]))
        if i in ref_ba:
            worse("ba_diff", judge.ba_diff((ans["cams"], ans["points"]), ref_ba[i]))
    return worst


def check(ctx, st, outputs):
    limits = ctx.config["limits"]
    ref_ba = {i: judge.bundle_adjust(outputs[i]["ba_start"], ctx.device)
              for i in ba_sample(ctx, outputs)}
    worst = numbers(ctx, st, outputs, features(ctx, st), ref_ba)
    return {k: (v, limits[k]) for k, v in worst.items()}


def control(ctx, st, outputs):
    """The control's numbers: the reference put in the program's place
    a precision below the configuration's (SIFT's scale space in
    bfloat16; the pair step on those features with TF32 products and
    the job's generator seed; the tracks of its inliers; the final BA in
    float32 from the same start), judged as the program's answers are.
    The cameras stand: the trajectory has the configuration's limit."""
    ref = features(ctx, st)
    low = features(ctx, st, judge.LOW_FRONT_END)
    sample = ba_sample(ctx, outputs)
    ref_ba = {i: judge.bundle_adjust(outputs[i]["ba_start"], ctx.device) for i in sample}
    answers = []
    for i, out in enumerate(outputs):
        if out is None:
            answers.append(None)
            continue
        metas, descs, _ = low[out["scene"]]
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(out["seed"])
        with judge.lowered():
            pairs = _pairs(ctx, low[out["scene"]], gen)
        ans = dict(out, metas=metas, descs=descs, pairs=pairs, tracks=_tracks(pairs, len(metas)))
        if i in sample:
            cams, pts = judge.bundle_adjust(out["ba_start"], ctx.device, dtype=torch.float32)
            ans.update(cams=cams, points=pts)
        answers.append(ans)
    return numbers(ctx, st, answers, ref, ref_ba)

"""Multi-view incremental SfM pipeline.

Port of ``spectavi_tpu/pipeline/sfm.py``: SIFT on every image, pairwise
matching (sequential, exhaustive or a given pair list), per-pair RANSAC
relative poses, track building, PnP registration (or pose chaining),
N-view triangulation and bundle adjustment, ending in a refined sparse
cloud and camera trajectory.

On the card with three or more pairs the pairs run batched
(:func:`_match_pairs_batched`): SIFT leaves the descriptors on the card,
and the L2 top-2 kernel, the ratio test and RANSAC take every pair in
one step.  :func:`run_sfm` reads image files and ``K.txt``;
:func:`run_sfm_arrays` is the array-level core that takes decoded
grayscale images.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spectavi_tpu_torch import mvg, resolve_device, seeded_generator
from spectavi_tpu_torch.features import normalize_to_ubyte_and_multiple_16_dim
from spectavi_tpu_torch.pipeline.io import Timer, imread, write_ply
from spectavi_tpu_torch.sfm import (
    build_tracks,
    bundle_adjust,
    chain_poses,
    rodrigues,
    tracks_to_observations,
    triangulate_nview,
)
from spectavi_tpu_torch.utils.profiling import annotate, count, spanned, step


def match_pair(kp_a, kp_b, min_ratio=1.75, device="cuda"):
    """Ratio-test matching between two keypoint tables ``(n, 132)`` on
    their descriptor columns; returns ``(idx_a, idx_b)`` int64."""
    from spectavi_tpu_torch.match import nn_l2k2

    a = normalize_to_ubyte_and_multiple_16_dim(kp_a[:, 4:])
    b = normalize_to_ubyte_and_multiple_16_dim(kp_b[:, 4:])
    idx, dist = nn_l2k2((a + 128).astype("uint8"), (b + 128).astype("uint8"), device=device)
    ratio = np.sqrt(dist[:, 1].astype("float64")) / np.maximum(
        np.sqrt(dist[:, 0].astype("float64")), 1e-12
    )
    keep = ratio >= min_ratio
    return idx[keep, 0].astype(np.int64), np.where(keep)[0].astype(np.int64)


def _match_pair_loop(kps, pts_cal, i, j, generator, ropts, min_ratio, quiet, device):
    """One pair through the host-driven path: ratio-test matching and
    the confidence-looped ``mvg.ransac_fitter``.  Returns ``(record,
    edge_or_None)``."""
    mi, mj = match_pair(kps[i], kps[j], min_ratio, device=device)
    if len(mi) < 10:
        if not quiet:
            print(f"  pair ({i},{j}): only {len(mi)} matches, skipped")
        return {"pair": [i, j], "matches": int(len(mi)), "skipped": True}, None
    x0 = np.hstack([pts_cal[i][mi], np.ones((len(mi), 1))])
    x1 = np.hstack([pts_cal[j][mj], np.ones((len(mj), 1))])
    res = mvg.ransac_fitter(x0, x1, options=ropts, generator=generator, device=device)
    inl = res["inlier_idx"]
    rec = {
        "pair": [i, j],
        "matches": int(len(mi)),
        "inlier_percent": float(res["inlier_percent"]),
        "n_inliers": int(len(inl)),
        "success": bool(res["success"]),
    }
    if not quiet:
        print(
            f"  pair ({i},{j}): {len(mi)} matches, "
            f"{res['inlier_percent']:.2f} inliers, success={res['success']}"
        )
    if len(inl) < 8:
        return rec, None
    edge = {
        "R": res["camera"][:, :3],
        "t": res["camera"][:, 3],
        "idx_i": mi[inl],
        "idx_j": mj[inl],
    }
    return rec, edge


@spanned("pairs.batch")
def _match_pairs_batched(descs, pts_cal, pair_list, generator, ropts, min_ratio, trials=8192,
                         pad_to=256, compact_to=4096, device="cuda"):
    """Every pair's matching and RANSAC in one batched step
    (:func:`spectavi_tpu_torch.parallel.two_view.make_two_view_step`).

    ``descs``: per-view quantized uint8 descriptor tables, numpy or
    tensors on the device (device-resident SIFT: the padded batch is
    assembled there).  Database rows are padded by replicating the
    pair's row 0 (a padding hit can only fail the ratio test), query
    rows with zeros masked by ``ny``; both to a multiple of ``pad_to``.
    Coordinates are float32, as the JAX package's batched path has them.
    The compaction bucket is sized from the batch
    (``make_two_view_step(..., sized=True)``, ``compact_to`` its floor),
    so every ratio-test survivor competes in RANSAC.
    Returns the per-pair result dicts."""
    from spectavi_tpu_torch.parallel.two_view import make_two_view_step

    dev = resolve_device(device)
    coords = [pc.astype(np.float32) for pc in pts_cal]

    # a view with no keypoint cannot seed the replicate-row padding;
    # such pairs are skipped up front
    empty = [(i, j) for (i, j) in pair_list if descs[i].shape[0] == 0 or descs[j].shape[0] == 0]
    skipped = [{"pair": (i, j), "n_matches": 0, "skipped": True} for (i, j) in empty]
    pair_list = [p for p in pair_list if p not in set(empty)]
    if not pair_list:
        return skipped
    B = len(pair_list)

    def ceil_to(n, m):
        return ((n + m - 1) // m) * m

    X = max(ceil_to(max(descs[i].shape[0] for i, _ in pair_list), pad_to), pad_to)
    Y = max(ceil_to(max(descs[j].shape[0] for _, j in pair_list), pad_to), pad_to)
    D = descs[0].shape[1]
    p0 = np.zeros((B, X, 2), np.float32)
    p1 = np.zeros((B, Y, 2), np.float32)
    nx = np.zeros(B, np.int64)
    ny = np.zeros(B, np.int64)
    for b, (i, j) in enumerate(pair_list):
        nx[b], ny[b] = descs[i].shape[0], descs[j].shape[0]
        p0[b, : nx[b]] = coords[i]
        p1[b, : ny[b]] = coords[j]

    def pad_rows(d, rows, replicate):
        d = torch.as_tensor(d, device=dev)
        n = d.shape[0]
        fill = d[:1].expand(rows - n, D) if replicate else d.new_zeros((rows - n, D))
        return torch.cat([d, fill], dim=0)

    with annotate("pairs.upload"):
        d0 = torch.stack([pad_rows(descs[i], X, True) for i, _ in pair_list])
        d1 = torch.stack([pad_rows(descs[j], Y, False) for _, j in pair_list])
        p0t, p1t = torch.as_tensor(p0, device=dev), torch.as_tensor(p1, device=dev)
    pair_step = make_two_view_step(
        trials=trials,
        reproj_allowed=ropts["reprojection_error_allowed"],
        svr_allowed=ropts["singular_value_ratio_allowed"],
        min_ratio=min_ratio,
        masked=True,
        compact_to=compact_to,
        sized=True,
    )
    out = pair_step(d0, d1, p0t, p1t, generator, nx, ny)
    with annotate("pairs.download"):
        E, P1, n_best, inl_mask, midx0, ratio_ok = (t.cpu().numpy() for t in out)

    results = []
    with annotate("pairs.unpack"):
        n_matches = [int(ratio_ok[b, : ny[b]].sum()) for b in range(B)]
        count("pair_survivors", sum(n_matches))
        for b, (i, j) in enumerate(pair_list):
            n_match = n_matches[b]
            inl_j = np.where(inl_mask[b, : ny[b]])[0].astype(np.int64)
            inl_i = midx0[b, inl_j].astype(np.int64)
            results.append({
                "pair": (i, j),
                "n_matches": n_match,
                "camera": P1[b],
                "essential": E[b],
                "count": int(n_best[b]),
                "idx_i": inl_i,
                "idx_j": inl_j,
                "inlier_percent": len(inl_j) / n_match if n_match else 0.0,
            })
    return skipped + results


def run_sfm(image_paths, K_path, outdir=None, pairs="sequential", min_ratio=1.75,
            ransac_options=None, ba_iters=15, generator=None, quiet=False, checkpoint=None,
            init="pnp", loss="huber", pair_backend="auto", device="cuda"):
    """Incremental SfM over image files sharing the intrinsics in
    ``K_path``; see :func:`run_sfm_arrays`."""
    resolve_device(device)
    with annotate("decode"):
        grays = [imread(p, dtype="float32", force_grayscale=True) for p in image_paths]
        K = np.loadtxt(K_path)
    return run_sfm_arrays(
        grays, K, outdir=outdir, pairs=pairs, min_ratio=min_ratio,
        ransac_options=ransac_options, ba_iters=ba_iters, generator=generator, quiet=quiet,
        checkpoint=checkpoint, init=init, loss=loss, pair_backend=pair_backend, device=device,
    )


@spanned("sfm")
def run_sfm_arrays(grays, K, outdir=None, pairs="sequential", min_ratio=1.75,
                   ransac_options=None, ba_iters=15, generator=None, quiet=False,
                   checkpoint=None, init="pnp", loss="huber", pair_backend="auto",
                   device="cuda"):
    """Incremental SfM over decoded float32 grayscale images ``grays``
    with intrinsics ``K (3, 3)``, on ``device``.

    ``pairs``: ``"sequential"``, ``"exhaustive"`` or a list of ``(i,
    j)``.  ``pair_backend``: ``"loop"`` (one host-driven match + RANSAC
    per pair), ``"batched"`` (all pairs in one step) or ``"auto"``
    (batched on the card with 3 or more pairs, the loop otherwise).
    ``init``: ``"pnp"`` registers views by RANSAC-PnP with periodic
    local BA, falling back to chaining if that fails
    (``metrics["init_used"] == "chain-fallback"``); ``"chain"`` chains
    pairwise poses.  ``loss`` is the final BA's; on the card the final
    BA runs its LM loop on the device (fixed Huber scale, always
    ``ba_iters`` iterations, counted in ``ba_accepted_iters``), on the
    CPU the host loop.  ``generator``: a ``torch.Generator`` on
    ``device`` for every random draw.  ``checkpoint``: an npz path; a
    checkpoint whose tracks equal this run's seeds the final BA, and
    the result is written back.

    Returns ``cams (V, 6)``, ``points (T, 3)``, ``tracks``,
    ``keypoints`` ((n, 4) rows under device-resident SIFT, (n, 132)
    otherwise), ``ba_history`` and ``metrics``; writes
    ``sparse_cloud.ply``, ``poses.txt`` and ``metrics.json`` when
    ``outdir`` is given."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    generator = seeded_generator(generator, dev)
    V = len(grays)
    K = np.asarray(K, dtype=np.float64)
    iK = np.linalg.inv(K)
    metrics = {"n_views": V, "pairs_mode": str(pairs), "init": init, "loss": loss}

    if pairs == "sequential":
        pair_list = [(i, i + 1) for i in range(V - 1)]
    elif pairs == "exhaustive":
        pair_list = [(i, j) for i in range(V) for j in range(i + 1, V)]
    else:
        pair_list = [tuple(p) for p in pairs]

    if pair_backend == "auto":
        pair_backend = "batched" if on_card and len(pair_list) >= 3 else "loop"
    if pair_backend not in ("loop", "batched"):
        raise ValueError(f"unknown pair_backend {pair_backend!r}")

    # the batched backend matches on the card, so SIFT leaves the
    # descriptors there; the loop backend needs host rows
    device_sift = pair_backend == "batched" and on_card
    outs = None
    descs_u8 = None
    with Timer("sfm-sift", quiet, "sift") as t_sift:
        if device_sift:
            from spectavi_tpu_torch.features.sift import sift_filter_batch_device

            outs = sift_filter_batch_device(grays, device=dev)
            kps_meta = [o["meta"] for o in outs]
            kps = None  # 132-column host rows are built on demand
        else:
            from spectavi_tpu_torch.features import sift_filter_batch

            kps = sift_filter_batch(grays, device=dev)
            kps_meta = [kp[:, :4] for kp in kps]
    metrics["sift_seconds"] = t_sift.elapsed
    if device_sift:
        from spectavi_tpu_torch.features.normalize import normalize_to_ubyte_device

        with step("quantize") as t_quant:
            # descriptor-only quantization: run_sfm matches kp[:, 4:]
            descs_u8 = [
                normalize_to_ubyte_device(o["desc"].to(torch.float32))
                if o["meta"].shape[0]
                else torch.zeros((0, 128), dtype=torch.uint8, device=dev)
                for o in outs
            ]
        metrics["sift_seconds"] += t_quant.elapsed
    metrics["keypoints_per_view"] = [int(m.shape[0]) for m in kps_meta]
    if not quiet:
        for i, m in enumerate(kps_meta):
            print(f"  view {i}: {m.shape[0]} keypoints")

    def host_rows():
        """Full 132-column host rows (under device SIFT only a pair that
        the batch failed needs them)."""
        nonlocal kps
        if kps is None:
            kps = [
                np.concatenate([o["meta"], o["desc"].cpu().numpy().astype(np.float32)], axis=1)
                for o in outs
            ]
        return kps

    pts_cal = []
    for m in kps_meta:
        h = np.hstack([m[:, :2], np.ones((m.shape[0], 1))]) @ iK.T
        pts_cal.append(h[:, :2] / h[:, 2:3])

    ropts = {
        "required_percent_inliers": 0.5,
        "reprojection_error_allowed": 3.35e-4,
        "maximum_tries": 100000,
        "find_best_even_in_failure": True,
        "singular_value_ratio_allowed": 1e-3,
    }
    if ransac_options:
        ropts.update(ransac_options)

    edges = {}
    pair_matches = {}
    metrics["pairs"] = []
    metrics["pair_backend"] = pair_backend
    with Timer("sfm-pairs", quiet, "pairs") as t_pairs:
        if pair_backend == "batched":
            if descs_u8 is None:
                descs_u8 = [
                    (normalize_to_ubyte_and_multiple_16_dim(kp[:, 4:]) + 128).astype(np.uint8)
                    for kp in host_rows()
                ]
            batch = _match_pairs_batched(descs_u8, pts_cal, pair_list, generator, ropts,
                                         min_ratio, device=dev)
            with annotate("pairs.collect"):
                for res in batch:
                    i, j = res["pair"]
                    if res.get("skipped"):
                        metrics["pairs"].append({"pair": [i, j], "matches": 0, "skipped": True})
                        if not quiet:
                            print(f"  pair ({i},{j}): empty view, skipped")
                        continue
                    if res["n_matches"] >= 10 and len(res["idx_j"]) < 8:
                        # the single trial batch found no valid hypothesis:
                        # retry this pair through the confidence-looped path
                        with annotate("pairs.retry"):
                            rec, edge = _match_pair_loop(host_rows(), pts_cal, i, j, generator,
                                                         ropts, min_ratio, quiet, dev)
                        rec["batched_retry"] = True
                        metrics["pairs"].append(rec)
                        if edge is not None:
                            edges[(i, j)] = edge
                            pair_matches[(i, j)] = (edge["idx_i"], edge["idx_j"])
                        continue
                    rec = {
                        "pair": [i, j],
                        "matches": res["n_matches"],
                        "inlier_percent": float(res["inlier_percent"]),
                        "n_inliers": int(len(res["idx_j"])),
                        # the loop path's statistical rule: success iff the
                        # inlier fraction clears the required threshold
                        "success": bool(
                            res["count"] >= 0
                            and res["inlier_percent"] >= ropts["required_percent_inliers"]
                        ),
                    }
                    metrics["pairs"].append(rec)
                    if not quiet:
                        print(f"  pair ({i},{j}): {res['n_matches']} matches, "
                              f"{res['inlier_percent']:.2f} inliers")
                    if res["n_matches"] < 10 or len(res["idx_j"]) < 8:
                        continue
                    edges[(i, j)] = {
                        "R": res["camera"][:, :3],
                        "t": res["camera"][:, 3],
                        "idx_i": res["idx_i"],
                        "idx_j": res["idx_j"],
                    }
                    pair_matches[(i, j)] = (res["idx_i"], res["idx_j"])
        else:
            for (i, j) in pair_list:
                with annotate("pairs.loop"):
                    rec, edge = _match_pair_loop(host_rows(), pts_cal, i, j, generator, ropts,
                                                 min_ratio, quiet, dev)
                metrics["pairs"].append(rec)
                if edge is not None:
                    edges[(i, j)] = edge
                    pair_matches[(i, j)] = (edge["idx_i"], edge["idx_j"])

    if not edges:
        raise RuntimeError("no usable image pairs")
    pairs_elapsed = t_pairs.elapsed
    metrics["pairs_seconds"] = pairs_elapsed
    metrics["pairs_per_second"] = len(pair_list) / pairs_elapsed if pairs_elapsed else None

    with Timer("sfm-tracks", quiet, "tracks") as t_tracks:
        tracks = build_tracks(pair_matches, V)
    with Timer("sfm-graph", quiet, "graph") as t_graph:
        init_used = init
        if init == "pnp":
            from spectavi_tpu_torch.sfm import incremental_poses

            try:
                cams0, _ = incremental_poses(
                    edges, V, pts_cal, tracks,
                    reproj_thresh=3.0 * ropts["reprojection_error_allowed"],
                    generator=generator, device=dev,
                )
            except (RuntimeError, ValueError) as e:
                if not quiet:
                    print(f"  pnp init failed ({e}); falling back to chaining")
                cams0 = chain_poses(edges, V, pts_cal, device=dev)
                init_used = "chain-fallback"
        else:
            cams0 = chain_poses(edges, V, pts_cal, device=dev)
    metrics["init_used"] = init_used
    with Timer("sfm-triangulate", quiet, "triangulate") as t_tri:
        ci, pi, uv = tracks_to_observations(tracks, pts_cal)
        f64 = dict(dtype=torch.float64, device=dev)
        c0 = torch.as_tensor(cams0, **f64)
        P = torch.cat([rodrigues(c0[:, :3]), c0[:, 3:, None]], dim=2)
        mask = tracks != -1
        T = tracks.shape[0]
        uv_tab = np.zeros((T, V, 2))
        for v in range(V):
            sel = mask[:, v]
            uv_tab[sel, v] = pts_cal[v][tracks[sel, v]]
        X0 = triangulate_nview(P, torch.as_tensor(uv_tab, **f64),
                               torch.as_tensor(mask, device=dev)).cpu().numpy()
        X0 = X0[:, :3] / np.where(np.abs(X0[:, 3:]) > 1e-12, X0[:, 3:], 1e-12)

    if checkpoint is not None:
        from spectavi_tpu_torch.sfm.checkpoint import load_sfm_state

        state = load_sfm_state(checkpoint)
        if state is not None:
            c_ck, p_ck, t_ck, _ = state
            if t_ck.shape == tracks.shape and np.array_equal(t_ck, tracks):
                if not quiet:
                    print(f"  resuming BA from checkpoint {checkpoint}")
                cams0, X0 = c_ck, p_ck

    metrics["graph_seconds"] = t_tracks.elapsed + t_graph.elapsed + t_tri.elapsed
    metrics["n_tracks"] = int(tracks.shape[0])
    metrics["n_observations"] = int(len(ci))

    with Timer("sfm-ba", quiet, "ba") as t_ba:
        if on_card:
            from spectavi_tpu_torch.sfm.bundle_adjust import bundle_adjust_device

            cams_ba, pts_ba, hist = bundle_adjust_device(
                cams0, X0, ci, pi, uv, fixed_cameras=(0,), max_iters=ba_iters, loss=loss,
                device=dev,
            )
            ba_iter_count = ba_iters  # attempted; accept/reject is on the device
        else:
            cams_ba, pts_ba, hist = bundle_adjust(
                cams0, X0, ci, pi, uv, fixed_cameras=(0,), max_iters=ba_iters, loss=loss,
                device=dev,
            )
            ba_iter_count = len(hist) - 1
    metrics["ba_seconds"] = t_ba.elapsed
    metrics["ba_accepted_iters"] = ba_iter_count
    metrics["ba_iters_per_second"] = ba_iter_count / t_ba.elapsed if t_ba.elapsed else None
    metrics["ba_cost_initial"] = float(hist[0])
    metrics["ba_cost_final"] = float(hist[-1])
    if checkpoint is not None:
        from spectavi_tpu_torch.sfm.checkpoint import save_sfm_state

        save_sfm_state(checkpoint, cams_ba, pts_ba, tracks)
    if not quiet:
        print(f"  tracks: {T}, BA cost {hist[0]:.3e} -> {hist[-1]:.3e}")

    if outdir is not None:
        from spectavi_tpu_torch.pipeline.io import write_metrics

        with annotate("write"):
            os.makedirs(outdir, exist_ok=True)
            write_ply(os.path.join(outdir, "sparse_cloud.ply"), pts_ba)
            np.savetxt(os.path.join(outdir, "poses.txt"), cams_ba)
            write_metrics(os.path.join(outdir, "metrics.json"), metrics)
    return {
        "cams": cams_ba,
        "points": pts_ba,
        "tracks": tracks,
        "keypoints": kps if kps is not None else kps_meta,
        "ba_history": hist,
        "metrics": metrics,
    }

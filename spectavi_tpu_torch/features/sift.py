"""SIFT keypoint detection and description.

Port of ``spectavi_tpu/features/sift.py`` (vlfeat conventions: ``S = 3``
levels per octave, ``o_min = -1``, ``edge_thresh = 10``,
``peak_thresh = 0``, ``magnif = 3``; rows ``[x, y, sigma, angle,
128-d descriptor]`` with the descriptor as vlfeat's ``min(floor(512 d),
255)``).

Per octave, on the images' device: the Gaussian scale space from
separable replicate-padded shifted-slice sums, DoG extrema by the
separable 26-neighbour test, a saliency ladder that keeps the strongest
candidates when they exceed the octave's budget, compaction, and
Newton refinement of all candidates at once.  Then, per image and
octave, the orientation histograms (:mod:`..ops.sift_orient`: a CUDA
kernel on the card, its plain version on the CPU), peak picking, and
the descriptors (:mod:`..ops.sift_desc`, likewise).  The JAX package
stacks every octave into one canvas so that one Pallas compile serves
them all; here each octave's ``(mod, ang)`` levels go to the kernels
as they are, one launch per image and octave.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device
from spectavi_tpu_torch.mvg.core import inv3x3
from spectavi_tpu_torch.ops.sift_desc import describe, finish_descriptors
from spectavi_tpu_torch.ops.sift_orient import orient_hist, orientation_peaks
from spectavi_tpu_torch.utils.profiling import annotate

S = 3
S_MIN = -1
S_MAX = S + 1
SIGMA_N = 0.5
SIGMA_K = 2.0 ** (1.0 / S)
SIGMA_0 = 1.6 * SIGMA_K
NBINS_ORI = 36
NBP = 4
NBO = 8
WIN_FACTOR = float(NBP) / 2
MAX_ANGLES = 4
TWO_PI = 2.0 * np.pi

# window radii of the orientation and descriptor stages
_R_OR = int(np.floor(3.0 * 1.5 * SIGMA_0 * 2 ** ((S - 1 + 1.5) / S)) + 1)


def _r_desc(magnif):
    return int(
        np.floor(
            magnif * SIGMA_0 * 2 ** ((S - 1 + 1.5) / S) * (NBP + 1) / 2.0 * np.sqrt(2.0) + 1.0
        )
    )


def _gaussian_kernel(sigma):
    r = max(int(np.ceil(4.0 * sigma)), 1)
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _edge_pad(a, dim, r):
    n = a.shape[dim]
    lo = a.narrow(dim, 0, 1).expand(*[r if d == dim % a.dim() else -1 for d in range(a.dim())])
    hi = a.narrow(dim, n - 1, 1).expand(*[r if d == dim % a.dim() else -1 for d in range(a.dim())])
    return torch.cat([lo, a, hi], dim=dim)


def _blur(im, sigma):
    """Separable Gaussian blur of ``(..., H, W)`` with replicate padding,
    as sums of shifted slices in the input's dtype."""
    if sigma < 1e-8:
        return im
    k = _gaussian_kernel(sigma)
    r = (k.shape[0] - 1) // 2
    taps = torch.as_tensor(k, device=im.device)

    def pass_along(p, dim, n):
        acc = float(k[0]) * p.narrow(dim, 0, n)
        for d in range(1, 2 * r + 1):
            # multiply-add in one rounding where the backend fuses it,
            # as XLA's fused loops do for the JAX package's blur
            acc = torch.addcmul(acc, p.narrow(dim, d, n), taps[d])
        return acc

    im = pass_along(_edge_pad(im, -1, r), -1, im.shape[-1])
    return pass_along(_edge_pad(im, -2, r), -2, im.shape[-2])


def _upsample2(im):
    """2x bilinear upsample of ``(..., H, W)`` (vlfeat
    ``copy_and_upsample_rows`` twice)."""

    def up_axis(a, dim):
        n = a.shape[dim]
        nxt = torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim=dim)
        half = 0.5 * (a + nxt)
        out = torch.stack([a, half], dim=dim + 1 if dim >= 0 else dim)
        shape = list(a.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)

    return up_axis(up_axis(im, -2), -1)


def _downsample2(im):
    return im[..., ::2, ::2]


def num_octaves(height, width, o_min=-1):
    return max(int(np.floor(np.log2(min(width, height)))) - o_min - 3, 1)


def _gradients(gss):
    """Gradient modulus and angle ``(B, S, H, W)`` of levels 1..S of
    ``gss (B, S+3, H, W)``: central differences, one-sided at edges."""
    lv = gss[:, 1 : 1 + S]
    gx = 0.5 * (torch.roll(lv, -1, 3) - torch.roll(lv, 1, 3))
    gy = 0.5 * (torch.roll(lv, -1, 2) - torch.roll(lv, 1, 2))
    gx[..., 0] = lv[..., 1] - lv[..., 0]
    gx[..., -1] = lv[..., -1] - lv[..., -2]
    gy[..., 0, :] = lv[..., 1, :] - lv[..., 0, :]
    gy[..., -1, :] = lv[..., -1, :] - lv[..., -2, :]
    mod = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx), TWO_PI)
    return mod, ang


def _octave_levels_core(first):
    """All levels of one octave from its first level ``(B, H, W)``:
    ``(gss (B, S+3, H, W), dog (B, S+2, H, W), mod, ang (B, S, H, W))``."""
    levels = [first]
    for s in range(S_MIN + 1, S_MAX + 1):
        sd = SIGMA_0 * np.sqrt(SIGMA_K ** (2 * s) - SIGMA_K ** (2 * s - 2))
        levels.append(_blur(levels[-1], sd))
    gss = torch.stack(levels, dim=1)
    dog = gss[:, 1:] - gss[:, :-1]
    mod, ang = _gradients(gss)
    return gss, dog, mod, ang


def _extrema_mask(dog, peak_thresh):
    """Strict 26-neighbour extrema of ``dog (S+2, H, W)`` at detection
    scales 1..S and interior pixels: ``(S, H, W)`` bool."""
    v = dog
    thr = 0.8 * peak_thresh

    def ext3(a, dim, op):
        return op(a, op(torch.roll(a, 1, dim), torch.roll(a, -1, dim)))

    def neigh26(a, op):
        a_x = ext3(a, 2, op)
        a_xy = ext3(a_x, 1, op)
        return op(
            op(torch.roll(a_xy, 1, 0), torch.roll(a_xy, -1, 0)),
            op(
                op(torch.roll(a_x, 1, 1), torch.roll(a_x, -1, 1)),
                op(torch.roll(a, 1, 2), torch.roll(a, -1, 2)),
            ),
        )

    is_max = (v > thr) & (v > neigh26(v, torch.maximum))
    is_min = (v < -thr) & (v < neigh26(v, torch.minimum))
    mask = (is_max | is_min)[1:-1]
    Sn, H, W = dog.shape
    mask[:, 0] = False
    mask[:, H - 1] = False
    mask[:, :, 0] = False
    mask[:, :, W - 1] = False
    return mask


def _gather3x3x3(dog, si, yi, xi):
    """3x3x3 DoG neighbourhoods around ``(si+1, yi, xi)``: ``(K, 3, 3, 3)``."""
    offs = torch.arange(-1, 2, device=dog.device)
    Sn, H, W = dog.shape
    sidx = ((si.long() + 1)[:, None, None, None] + offs[None, :, None, None]).clamp(0, Sn - 1)
    yidx = (yi.long()[:, None, None, None] + offs[None, None, :, None]).clamp(0, H - 1)
    xidx = (xi.long()[:, None, None, None] + offs[None, None, None, :]).clamp(0, W - 1)
    return dog.reshape(-1)[(sidx * H + yidx) * W + xidx]


def _det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _newton_terms(n):
    Dx = 0.5 * (n[:, 1, 1, 2] - n[:, 1, 1, 0])
    Dy = 0.5 * (n[:, 1, 2, 1] - n[:, 1, 0, 1])
    Ds = 0.5 * (n[:, 2, 1, 1] - n[:, 0, 1, 1])
    v = n[:, 1, 1, 1]
    Dxx = n[:, 1, 1, 2] + n[:, 1, 1, 0] - 2 * v
    Dyy = n[:, 1, 2, 1] + n[:, 1, 0, 1] - 2 * v
    Dss = n[:, 2, 1, 1] + n[:, 0, 1, 1] - 2 * v
    Dxy = 0.25 * (n[:, 1, 2, 2] + n[:, 1, 0, 0] - n[:, 1, 2, 0] - n[:, 1, 0, 2])
    Dxs = 0.25 * (n[:, 2, 1, 2] + n[:, 0, 1, 0] - n[:, 2, 1, 0] - n[:, 0, 1, 2])
    Dys = 0.25 * (n[:, 2, 2, 1] + n[:, 0, 0, 1] - n[:, 2, 0, 1] - n[:, 0, 2, 1])
    Hm = torch.stack(
        [
            torch.stack([Dxx, Dxy, Dxs], -1),
            torch.stack([Dxy, Dyy, Dys], -1),
            torch.stack([Dxs, Dys, Dss], -1),
        ],
        -2,
    )
    g = torch.stack([Dx, Dy, Ds], -1)
    safe = torch.abs(_det3(Hm)) > 1e-30
    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    Hs = torch.where(safe[:, None, None], Hm, eye)
    b = -torch.einsum("kij,kj->ki", inv3x3(Hs), g)
    b = torch.where(safe[:, None], b, torch.zeros_like(b))
    return b, (Dx, Dy, Ds, v, Dxx, Dyy, Dxy)


def detect_refine(dog, peak_thresh, edge_thresh, max_kp, n_iter=5):
    """DoG extrema of ``dog (S+2, H, W)`` refined to sub-pixel accuracy.

    Returns a dict of ``(max_kp,)`` tensors ``x, y, s`` (refined
    octave pixels / detection scale), ``is_``, ``yi``, ``xi``,
    ``valid``, and the raw candidate ``count``."""
    Sn, H, W = dog.shape
    dev = dog.device
    mask = _extrema_mask(dog, peak_thresh)
    count = mask.sum()
    # saliency ladder: when candidates exceed the budget keep the
    # strongest |DoG| responses (tau = 0 keeps all when they fit)
    strength = torch.where(mask, torch.abs(dog[1 : Sn - 1]), torch.zeros((), dtype=dog.dtype, device=dev))
    smax = strength.max()
    n_lad = 24
    taus = torch.cat(
        [smax * torch.pow(2.0, -torch.arange(0, n_lad, dtype=dog.dtype, device=dev)),
         torch.zeros(1, dtype=dog.dtype, device=dev)]
    )
    safe = strength > 0
    neglog = torch.log2(smax) - torch.log2(torch.where(safe, strength, torch.ones_like(strength)))
    rung = torch.clamp(torch.floor(neglog).to(torch.int32) + 1, 1, n_lad)
    rung = torch.where(safe, rung, n_lad + 1)
    hist = torch.bincount(rung.reshape(-1), minlength=n_lad + 2)
    counts_at = torch.cumsum(hist, 0)[: n_lad + 1]
    ar = torch.arange(n_lad + 1, device=dev)
    jbest = torch.where(counts_at <= max_kp, ar, -1).max()
    tau = taus[torch.clamp(jbest, min=0)]
    mask = mask & (strength > tau)
    flat = mask.reshape(-1)
    kept = flat.sum()
    # compaction in ascending linear order: scatter into a buffer one
    # slot longer, the last slot taking every dropped index
    pos = torch.cumsum(flat.to(torch.int64), 0) - 1
    tgt = torch.where(flat & (pos < max_kp), pos, max_kp)
    cand = torch.zeros(max_kp + 1, dtype=torch.int64, device=dev)
    cand.scatter_(0, tgt, torch.arange(flat.shape[0], device=dev))
    cand = cand[:max_kp]
    valid = torch.arange(max_kp, device=dev) < kept
    si = cand // (H * W)
    rem = cand % (H * W)
    yi = rem // W
    xi = rem % W

    for _ in range(n_iter - 1):
        b, _ = _newton_terms(_gather3x3x3(dog, si, yi, xi))
        dx = ((b[:, 0] > 0.6) & (xi < W - 2)).long() - ((b[:, 0] < -0.6) & (xi > 1)).long()
        dy = ((b[:, 1] > 0.6) & (yi < H - 2)).long() - ((b[:, 1] < -0.6) & (yi > 1)).long()
        yi, xi = yi + dy, xi + dx

    b, (Dx, Dy, Ds, v, Dxx, Dyy, Dxy) = _newton_terms(_gather3x3x3(dog, si, yi, xi))
    val = v + 0.5 * (Dx * b[:, 0] + Dy * b[:, 1] + Ds * b[:, 2])
    det2 = Dxx * Dyy - Dxy * Dxy
    tr2 = (Dxx + Dyy) ** 2
    edge_ok = (det2 > 0) & (
        tr2 / torch.where(det2 > 0, det2, torch.ones_like(det2))
        < (edge_thresh + 1.0) ** 2 / edge_thresh
    )
    xn = xi + b[:, 0]
    yn = yi + b[:, 1]
    sn = si + b[:, 2]
    good = (
        valid
        & (torch.abs(val) > peak_thresh)
        & edge_ok
        & (torch.abs(b[:, 0]) < 1.5)
        & (torch.abs(b[:, 1]) < 1.5)
        & (torch.abs(b[:, 2]) < 1.5)
        & (xn >= 0)
        & (xn <= W - 1)
        & (yn >= 0)
        & (yn <= H - 1)
    )
    return {"x": xn, "y": yn, "s": sn, "is_": si, "yi": yi, "xi": xi,
            "valid": good, "count": count}


def _base_first(im_b, o_min):
    """Up/downsample ``(B, H, W)`` to octave ``o_min`` and apply the
    initial blur."""
    base = im_b
    if o_min < 0:
        for _ in range(-o_min):
            base = _upsample2(base)
    elif o_min > 0:
        for _ in range(o_min):
            base = _downsample2(base)
    sa = SIGMA_0 * (SIGMA_K**S_MIN)
    sb = SIGMA_N * (2.0**-o_min)
    return _blur(base, float(np.sqrt(max(sa * sa - sb * sb, 0.0))))


def _octave_detect(first, peak_thresh, edge_thresh, max_kp):
    """One octave, detection only: ``first (B, H, W)`` -> ``(next_first,
    mod, ang, det (B, 6, max_kp))`` with det rows ``[x, y, sigma_oct,
    is, valid, raw_count]``."""
    gss, dog, mod, ang = _octave_levels_core(first)
    dets = []
    for d in dog:
        det = detect_refine(d, peak_thresh, edge_thresh, max_kp)
        f = d.dtype
        sigma_oct = SIGMA_0 * torch.pow(2.0, det["s"].to(f) / S)
        dets.append(
            torch.stack(
                [
                    det["x"].to(f),
                    det["y"].to(f),
                    sigma_oct.to(f),
                    det["is_"].to(f),
                    det["valid"].to(f),
                    det["count"].to(f).expand(max_kp),
                ]
            )
        )
    nxt = gss[:, S_MIN + S - S_MIN, ::2, ::2].contiguous()
    return nxt, mod, ang, torch.stack(dets)


def _octave_budgets(H0, W0, o_min, n_octaves, max_kp_per_octave):
    budgets = []
    H, W = H0 << max(-o_min, 0), W0 << max(-o_min, 0)
    if o_min > 0:
        H, W = H0 >> o_min, W0 >> o_min
    for _ in range(n_octaves):
        budgets.append(int(min(max_kp_per_octave, max(512, (H * W) // 16))))
        H, W = H // 2, W // 2
    return tuple(budgets)


def orientations(mod, ang, kp_x, kp_y, kp_sigma, kp_is, kp_valid, radius):
    """Dominant orientations per keypoint (vlfeat: 36-bin histogram over
    the window, Gaussian sigma 1.5 sigma, 6x circular box smoothing,
    peaks >= 0.8 max with parabolic refinement, up to 4).  The histogram
    is the CUDA kernel on the card.  ``kp_valid`` None means every row.
    Returns ``(angles (K, 4), avalid (K, 4))``."""
    hist = orient_hist(mod, ang, kp_x, kp_y, kp_sigma, kp_is, kp_valid, radius)
    return orientation_peaks(hist, kp_valid)


def descriptors(mod, ang, kp_x, kp_y, kp_sigma, kp_is, kp_angle, kp_valid, radius, magnif=3.0):
    """4x4x8 vlfeat descriptors of (keypoint, angle) rows, normalized
    float ``(K, 128)`` (the CUDA kernel's raw rows on the card)."""
    _, raw = describe(mod, ang, kp_x, kp_y, kp_sigma, kp_is, kp_angle, kp_valid, radius,
                      magnif, return_raw=True)
    return finish_descriptors(raw, kp_valid)


def _describe_stage(mod, ang, meta_sel, magnif):
    """uint8 descriptors ``(n, 128)`` of the (keypoint, angle) rows
    ``meta_sel (6, n)`` = ``[angle, valid, x, y, sigma, is]`` of one
    image and octave (``mod, ang (S, H, W)``): one kernel launch."""
    kth, _, kx, ky, ksig, kis = meta_sel
    valid = torch.ones_like(kth, dtype=torch.bool)
    return describe(mod, ang, kx, ky, ksig, kis.to(torch.int32), kth, valid,
                    _r_desc(magnif), magnif)


def _compact_detections(det):
    """Valid rows of one octave's detection table ``det (B, 6, budget)``
    in their order: per image ``(4, n)`` = ``[x, y, sigma, is]``."""
    return [d[:4, d[4] > 0] for d in det]


def _orient_jobs(det_jobs, grads):
    """Orientations of every ``(bi, oi, det_sel, n_kp)`` detection job,
    one histogram launch per job: ``{(bi, oi): (th (n_kp, 4), avalid
    (n_kp, 4))}`` on the device."""
    angles = {}
    for bi, oi, det_sel, n_kp in det_jobs:
        mod, ang = grads[oi]
        kis = torch.clamp(det_sel[3].to(torch.int32), 0, S - 1)
        angles[(bi, oi)] = orientations(
            mod[bi], ang[bi], det_sel[0], det_sel[1], det_sel[2], kis, None, _R_OR
        )
    return angles


def _describe_jobs_dev(jobs, grads, magnif):
    """Descriptors of every ``(bi, oi, meta_sel, n_ang)`` job, left on
    the device grouped per image: ``(per_img, img_jobs_map)`` with
    ``per_img[bi]`` the image's uint8 rows in job order."""
    per_img, img_jobs_map = {}, {}
    for bi in sorted({j[0] for j in jobs}):
        img_jobs = [j for j in jobs if j[0] == bi]
        ds = [
            _describe_stage(grads[oi][0][bi], grads[oi][1][bi], meta_sel, magnif)
            for (_, oi, meta_sel, _) in img_jobs
        ]
        per_img[bi] = torch.cat(ds)
        img_jobs_map[bi] = img_jobs
    return per_img, img_jobs_map


def _sift_batched_same_shape(ims, peak_thresh, edge_thresh, magnif, o_min, n_octaves,
                             max_kp_per_octave, device, return_device=False):
    """SIFT for a list of same-shape images on ``device``: detection for
    every octave, compaction, orientation jobs, then description jobs.

    Returns per image ``(n, 132)`` float32 numpy rows, or with
    ``return_device`` ``{"meta": (n, 4) float32 numpy [x, y, sigma,
    angle], "desc": (n, 128) uint8 tensor on the device}``."""
    B = len(ims)
    H0, W0 = ims[0].shape
    if n_octaves is None:
        n_octaves = num_octaves(H0, W0, o_min)
    budgets = _octave_budgets(H0, W0, o_min, n_octaves, max_kp_per_octave)

    with annotate("sift.upload"):
        first = _base_first(
            torch.as_tensor(np.stack(ims), dtype=torch.float32, device=device), o_min
        )
    comps, grads = [], []
    for oi, budget in enumerate(budgets):
        with annotate("sift.detect"):
            first, mod, ang, det = _octave_detect(first, peak_thresh, edge_thresh, budget)
            grads.append((mod, ang))
            comps.append(_compact_detections(det))
            n_candidates = det[:, 5, 0].tolist()
        for bi, n in enumerate(n_candidates):
            if n > budget:
                warnings.warn(
                    f"SIFT octave {oi}: {int(n)} DoG candidates exceed the "
                    f"static budget {budget}; keeping the strongest |DoG| "
                    "responses. Raise max_kp_per_octave to keep more.",
                    stacklevel=4,
                )
    det_jobs = [
        (bi, oi, comps[oi][bi], comps[oi][bi].shape[1])
        for bi in range(B) for oi in range(len(budgets)) if comps[oi][bi].shape[1] > 0
    ]
    with annotate("sift.orient"):
        angles = _orient_jobs(det_jobs, grads)

    # (keypoint, angle) rows, keypoint-major, compacted to describe jobs
    jobs = []
    with annotate("sift.select"):
        for bi, oi, det_sel, _ in det_jobs:
            th, av = angles[(bi, oi)]
            rows = av.reshape(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            kp = rows // MAX_ANGLES
            meta_sel = torch.stack(
                [th.reshape(-1)[rows], torch.ones_like(rows, dtype=th.dtype), det_sel[0][kp],
                 det_sel[1][kp], det_sel[2][kp], det_sel[3][kp]]
            )
            jobs.append((bi, oi, meta_sel, rows.numel()))

    with annotate("sift.describe"):
        per_img, img_jobs_map = _describe_jobs_dev(jobs, grads, float(magnif))
    out = []
    with annotate("sift.download"):
        for bi in range(B):
            metas = [
                torch.stack([m[2] * 2.0 ** (o_min + oi), m[3] * 2.0 ** (o_min + oi),
                             m[4] * 2.0 ** (o_min + oi), m[0]], dim=1)
                for (_, oi, m, _) in img_jobs_map.get(bi, [])
            ]
            meta = (torch.cat(metas) if metas else torch.zeros((0, 4), device=device)).cpu().numpy()
            desc = per_img.get(bi, torch.zeros((0, 128), dtype=torch.uint8, device=device))
            if return_device:
                out.append({"meta": meta.astype(np.float32), "desc": desc})
            else:
                out.append(np.concatenate(
                    [meta, desc.cpu().numpy().astype(np.float32)], axis=1).astype(np.float32))
    return out


def _check_2d(ims):
    ims = [np.asarray(im, dtype=np.float32) for im in ims]
    for im in ims:
        if im.ndim != 2:
            raise TypeError("Only 2d images are supported.")
    return ims


def _run_groups(ims, device, **kw):
    dev = resolve_device(device)
    ims = _check_2d(ims)
    groups = {}
    for i, im in enumerate(ims):
        groups.setdefault(im.shape, []).append(i)
    out = [None] * len(ims)
    for idxs in groups.values():
        res = _sift_batched_same_shape([ims[i] for i in idxs], device=dev, **kw)
        for i, r in zip(idxs, res):
            out[i] = r
    return out


def sift_filter_batch(ims, nthread=None, peak_thresh=0.0, edge_thresh=10.0, magnif=3.0,
                      o_min=-1, n_octaves=None, max_kp_per_octave=32768, device="cuda"):
    """Batch SIFT: list of 2-D float images in, list of ``(n, 132)``
    float32 numpy rows ``[x, y, sigma, angle, desc x 128]`` out.
    Same-shape images run together; ``nthread`` is kept for API parity."""
    del nthread
    return _run_groups(
        ims, device, peak_thresh=peak_thresh, edge_thresh=edge_thresh, magnif=magnif,
        o_min=o_min, n_octaves=n_octaves, max_kp_per_octave=max_kp_per_octave,
    )


def sift_filter_batch_device(ims, peak_thresh=0.0, edge_thresh=10.0, magnif=3.0, o_min=-1,
                             n_octaves=None, max_kp_per_octave=32768, device="cuda"):
    """Batch SIFT with device-resident descriptors: per image
    ``{"meta": (n, 4) float32 numpy [x, y, sigma, angle], "desc":
    (n, 128) uint8 tensor on the device}``."""
    return _run_groups(
        ims, device, peak_thresh=peak_thresh, edge_thresh=edge_thresh, magnif=magnif,
        o_min=o_min, n_octaves=n_octaves, max_kp_per_octave=max_kp_per_octave,
        return_device=True,
    )


def sift_filter(im, peak_thresh=0.0, edge_thresh=10.0, magnif=3.0, o_min=-1,
                n_octaves=None, max_kp_per_octave=32768, device="cuda"):
    """SIFT of one 2-D float image: ``(n, 132)`` float32 numpy rows."""
    return sift_filter_batch(
        [im], peak_thresh=peak_thresh, edge_thresh=edge_thresh, magnif=magnif,
        o_min=o_min, n_octaves=n_octaves, max_kp_per_octave=max_kp_per_octave,
        device=device,
    )[0]


def sift_filter_striped(im, nthread=8, buffer_size=20, device="cuda"):
    """SIFT over ``nthread`` horizontal bands, each with a
    ``buffer_size``-row halo, keypoints filtered back to the band
    interior (strict inequalities, as the reference)."""
    im = np.asarray(im, dtype=np.float32)
    height = im.shape[0]
    seams = np.linspace(0, height, nthread + 1).round().astype(int)
    halo_lo = np.maximum(seams[:-1] - buffer_size, 0)
    halo_hi = np.minimum(seams[1:] + buffer_size + 1, height)
    bands = sift_filter_batch([im[lo:hi] for lo, hi in zip(halo_lo, halo_hi)], device=device)
    kept = []
    for kp, lo, y0, y1 in zip(bands, halo_lo, seams[:-1], seams[1:]):
        kp = kp.copy()
        kp[:, 1] += lo
        interior = (kp[:, 1] > y0) & (kp[:, 1] < y1)
        kept.append(kp[interior])
    return np.vstack(kept)

"""The benchmark's inputs: rendered stand-ins for photographs.

A frozen copy of ``chip_smoke.py``'s renderer (itself a torch copy of
``benchmarks/bench_multiview_synthetic.py``'s ``look_at`` / ``render``):
a heightfield under a seeded multi-scale noise texture, seen from
cameras on a lateral arc, ray-cast on the device at 2x supersampling.
:func:`render_scene` adds what a decoder would hand the pipelines: RGB
``uint8`` colours with distinct channels and float32 BT.601 grays in
[0, 1], max-normalised as the port's ``imread(..., force_grayscale)``
gives them, plus the ground truth (cameras, centres, depth of view 0).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

def look_at(C, target, up=(0.0, -1.0, 0.0)):

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

    s = i / max(n - 1, 1) - 0.5
    C = np.array([arc[0] * s, arc[1] * s, arc[2] * abs(s)])
    R, t = look_at(C, np.asarray(target))
    return R, t, C


def camera_K(h, w, focal=1.1):
    """The rendered views' intrinsics at ``h`` x ``w``."""
    f = focal * w
    return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])


def as_rgb(gray):
    """A rendered gray view as RGB with distinct channels."""
    g = gray.astype(np.int32)
    return np.stack([g, 3 * g // 4 + 32, g // 2 + 100], axis=-1).astype(np.uint8)


def rgb_to_gray(rgb):
    """BT.601 luma in float32, max-normalised: the pipelines' grays of
    an RGB decode."""
    g = rgb[..., :3].astype(np.float32) @ np.asarray([0.2989, 0.5870, 0.1140], np.float32)
    return g / np.maximum(np.max(g), np.finfo(np.float32).tiny)


def render_scene(n_views, h, w, device, tex_shape, seed, focal=1.1):
    """``n_views`` views of scene ``seed`` on the arc: ``{"grays": [float32
    (h, w)], "colors": [uint8 (h, w, 3)], "K", "poses": [(R, t, C)]}``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    height, texture_at = make_scene(rng, gen, device, tex_shape)
    K = camera_K(h, w, focal)
    grays, colors, poses = [], [], []
    for i in range(n_views):
        R, t, C = arc_pose(i, n_views)
        u8 = (torch.clamp(render(height, texture_at, K, R, t, h, w, device), 0, 1)
              * 255).to(torch.uint8).cpu().numpy()
        rgb = as_rgb(u8)
        colors.append(rgb)
        grays.append(rgb_to_gray(rgb))
        poses.append((R, t, C))
    return {"grays": grays, "colors": colors, "K": K, "poses": poses}


def relative_pose(poses, i=0, j=1):
    """``(R, t)`` of view ``j`` relative to view ``i``."""
    (Ri, ti, _), (Rj, tj, _) = poses[i], poses[j]
    R = Rj @ Ri.T
    return R, tj - R @ ti

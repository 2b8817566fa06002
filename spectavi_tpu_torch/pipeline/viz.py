"""Optional visualization helpers (the port's own copy of
``spectavi_tpu/pipeline/viz.py``; host plotting, ``matplotlib`` is
imported only when a plot is asked for)."""

from __future__ import annotations


def save_keypoint_plot(im0, im1, kp0, kp1, path):
    """Side-by-side keypoint overlay (reference ex01 step 1 figure,
    ``example/ex01_essential_estimation.py:73-85``), saved to disk."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    import numpy as np

    c_im = np.hstack([im0, im1])
    fig, ax = plt.subplots(figsize=(14, 6))
    ax.imshow(c_im, cmap="gray", interpolation="nearest")
    ax.plot(kp0[:, 0], kp0[:, 1], "rx", markersize=1)
    ax.plot(kp1[:, 0] + im0.shape[1], kp1[:, 1], "bx", markersize=1)
    ax.set_title("SIFT keypoints")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def save_match_plot(im0, im1, xd, yd, path, percent_to_show=0.1, seed=0):
    """Match-line visualization (reference ex01 step 2 figure,
    ``example/ex01_essential_estimation.py:107-129``), saved to disk."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import collections as mc, pyplot as plt

    import numpy as np

    c_im = np.hstack([im0, im1])
    fig, ax = plt.subplots(figsize=(14, 6))
    ax.imshow(c_im, cmap="gray", interpolation="nearest")
    shift = im0.shape[1]
    x0, y0 = xd[:, 0], xd[:, 1]
    x1, y1 = yd[:, 0] + shift, yd[:, 1]
    ax.plot(x0, y0, "rx", markersize=3)
    ax.plot(x1, y1, "bx", markersize=3)
    lines = np.stack(
        [np.stack([x0, y0], axis=1), np.stack([x1, y1], axis=1)], axis=1
    )
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, len(lines), size=max(1, int(len(lines) * percent_to_show)))
    lc = mc.LineCollection(lines[sel], cmap=plt.cm.gist_ncar, linewidths=1)
    lc.set_array(rng.random(len(sel)))
    ax.add_collection(lc)
    ax.set_title("matched keypoints")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def try_open3d_viz(ply_file):
    """Open a PLY point cloud in open3d when available; otherwise print
    a hint (same graceful degradation as the reference)."""
    try:
        from open3d import io, visualization as viz

        pc = io.read_point_cloud(ply_file)
        viz.draw_geometries([pc])
    except ImportError:
        print(
            "Failed to import `open3d`; cannot visualize the point cloud. "
            "Install open3d or open the PLY in meshlab."
        )

"""Checkpoint / resume for long reconstructions.

The port's own copy of ``spectavi_tpu/sfm/checkpoint.py``, with the same
npz layout, so a checkpoint written by either package resumes in the
other.

The reference's only persistence is the example-level match cache
(``cache.npz``, reference ``ex01:222-236``) — kept in
:func:`spectavi_tpu_torch.pipeline.two_view.run_two_view`.  Multi-view runs
additionally checkpoint the full SfM state (poses, points, tracks, BA
damping) so long multi-pair jobs resume mid-optimization.
"""

from __future__ import annotations

import os

import numpy as np


def save_sfm_state(path, cams, points, tracks, extra=None):
    """Atomically persist SfM state to ``path`` (.npz)."""
    tmp = path + ".tmp.npz"
    payload = {"cams": np.asarray(cams), "points": np.asarray(points), "tracks": np.asarray(tracks)}
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = np.asarray(v)
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_sfm_state(path):
    """Load SfM state; returns ``(cams, points, tracks, extra)`` or
    ``None`` when the checkpoint does not exist."""
    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    extra = {
        k[len("extra_") :]: data[k] for k in data.files if k.startswith("extra_")
    }
    return data["cams"], data["points"], data["tracks"], extra

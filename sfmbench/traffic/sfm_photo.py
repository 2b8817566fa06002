"""Multi-view jobs on photograph-size arrays: ``sfm_arrays``'s jobs, check
and control, with every ratio-test survivor competing in the
reference's pair step.

At photograph size a pair keeps more ratio-test survivors than the pair
step's fixed bucket of 4096 rows.  The program sizes its compaction
bucket from the batch: the largest survivor count of its pairs, rounded
up to a multiple of 256, never below ``min(4096, Y)`` (``Y`` the padded
query rows).  The reference's pair step is handed a bucket by the same
rule, worked out from the reference's own survivors, so its survivors
and its control's RANSAC see every survivor.

A program whose pair step has no sized bucket (``make_two_view_step``
without ``sized``) cuts every pair to 4096 survivors and cannot give the
configuration's guarantee: set-up refuses it at once, before rendering,
with a non-zero exit.

Everything else is ``sfm_arrays``'s: this module runs a private copy of
that module whose ``_pairs`` is this one's.  Traffic keys as there.
"""

from __future__ import annotations

import inspect
import os
import sys

from sfmbench import harness
from sfmbench.reference import judge

# the program's floor of the sized bucket (``_match_pairs_batched``'s
# ``compact_to``), and the step it grows by
FLOOR = 4096
MULTIPLE = 256
PAD_TO = 256

_base = harness.load_file(os.path.join(harness.HERE, "traffic", "sfm_arrays.py"),
                          name="sfmbench_traffic_sfm_photo_base")


def _ceil_to(n, m):
    return -(-int(n) // m) * m


def bucket(descs, pair_list, survivors):
    """The sized bucket's rows of a batch: ``survivors`` (each pair's
    ratio-test survivor count) over the pairs of ``pair_list`` whose
    views both hold keypoints, padded as the pair step pads."""
    live = [(i, j) for (i, j) in pair_list if descs[i].shape[0] and descs[j].shape[0]]
    if not live:
        return FLOOR
    Y = max(_ceil_to(max(descs[j].shape[0] for _, j in live), PAD_TO), PAD_TO)
    return min(Y, max(min(FLOOR, Y), _ceil_to(max(survivors, default=0), MULTIPLE)))


def _pairs(ctx, feats, generator=None):
    """The reference's pair step with the sized bucket: its survivors
    (every one: any bucket of at least the largest count keeps them
    all), or with a ``generator`` its RANSAC over a bucket of
    :func:`bucket` rows."""
    metas, descs, pts = feats
    pair_list = _base.pair_list(ctx, len(metas))
    args = (descs, pts, pair_list)
    opts = (_base.PAIR_REPROJ, _base.PAIR_SVR, ctx.config["settings"]["min_ratio"])
    everyone = judge.ransac.pair_step(*args, None, *opts, compact_to=sys.maxsize, fit=False)
    rows = bucket(descs, pair_list, [r["n_matches"] for r in everyone.values()])
    print(f"pair step bucket {rows} rows, {sum(r['n_matches'] for r in everyone.values())} "
          f"survivors", file=sys.stderr)
    if generator is None:
        return everyone
    return judge.ransac.pair_step(*args, generator, *opts, compact_to=rows, fit=True)


def setup(ctx):
    from spectavi_tpu_torch.parallel import two_view

    if "sized" not in inspect.signature(two_view.make_two_view_step).parameters:
        raise SystemExit("the program's pair step cuts ratio-test survivors to a fixed bucket: "
                         "it cannot give this configuration's guarantee")
    return _base.setup(ctx)


_base._pairs = _pairs

WARM_JOBS = _base.WARM_JOBS
NUMBERS = _base.NUMBERS
job = _base.job
profile_jobs = _base.profile_jobs
release = _base.release
check = _base.check
control = _base.control

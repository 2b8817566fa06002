"""ba_s.sfm: seconds a multi-view job in the final bundle adjustment."""

SPANS = {"ba": ["spectavi_tpu_torch.sfm.bundle_adjust:bundle_adjust_device"]}


def read(run):
    return run.spans.mean("ba", run.jobs)

"""graph_s.sfm: seconds a multi-view job in registration (PnP with its
local bundle adjustments)."""

SPANS = {"graph": ["spectavi_tpu_torch.sfm:incremental_poses"]}


def read(run):
    return run.spans.mean("graph", run.jobs)

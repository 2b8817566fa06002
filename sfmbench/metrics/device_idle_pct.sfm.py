"""device_idle_pct.sfm: share of the profiled multi-view jobs' wall time in
which no device operation ran, in percent."""


def read(run):
    return run.idle_pct()

"""device_idle_pct.pair: share of the profiled two-view jobs' wall time in
which no device operation ran, in percent."""


def read(run):
    return run.idle_pct()

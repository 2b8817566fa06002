"""kernel_roofline_pct.pair: least time over device time of every K1, K2
and K3 launch in the profiled two-view jobs, in percent."""


def read(run):
    return run.roofline_pct()

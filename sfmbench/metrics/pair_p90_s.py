"""pair_p90_s: the 90th percentile of the window's two-view job seconds
(each from its start to a host result ending in a synchronize)."""


def read(run):
    return run.job_quantile(90)

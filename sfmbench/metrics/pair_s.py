"""pair_s: seconds a two-view job over the window (window seconds over
the jobs completed in it, host clock, every job ending in a synchronize)."""


def read(run):
    return run.per_job_s()

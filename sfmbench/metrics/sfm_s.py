"""sfm_s: seconds a multi-view job over the window (window seconds over
the jobs completed in it, host clock)."""


def read(run):
    return run.per_job_s()

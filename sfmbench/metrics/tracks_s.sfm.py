"""tracks_s.sfm: seconds a multi-view job in track building and the
N-view triangulation of the tracks (the program's ``tracks`` and
``triangulate`` spans, host clock, no synchronize)."""

from sfmbench import program

program.enable()


def read(run):
    return program.job_mean(run, lambda job: program.span_seconds(job, ("tracks", "triangulate")))

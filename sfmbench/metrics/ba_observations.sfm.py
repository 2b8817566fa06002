"""ba_observations.sfm: observations of a multi-view job's final bundle
adjustment (the program's ``ba_observations`` counter, from the
problem's host-known shapes).  The BA's problem size: a fall beside an
``sfm_s`` gain is observations dropped.  None where the program keeps
no such counter."""

from sfmbench import program

program.enable()

COUNTER = "ba_observations"


def read(run):
    jobs = program.collect(run)
    if not jobs or not any(COUNTER in j["counts"] for j in jobs):
        return None
    return program.counter_mean(run, COUNTER)

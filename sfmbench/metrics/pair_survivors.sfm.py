"""pair_survivors.sfm: ratio-test survivors a multi-view job's pair step
hands to RANSAC, summed over its pairs (the program's
``pair_survivors`` counter, counted on the host from the ratio mask the
step already downloads).  The pair step's work: a fall beside an
``sfm_s`` gain is survivors cut before they compete.  None where the
program keeps no such counter."""

from sfmbench import program

program.enable()

COUNTER = "pair_survivors"


def read(run):
    jobs = program.collect(run)
    if not jobs or not any(COUNTER in j["counts"] for j in jobs):
        return None
    return program.counter_mean(run, COUNTER)

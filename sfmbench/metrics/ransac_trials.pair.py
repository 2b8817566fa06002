"""ransac_trials.pair: RANSAC hypotheses a two-view job scores (the
program's ``ransac_trials`` counter: the live trials of each block of
step 3's fitter).  Search effort: a fall beside a ``pair_s`` gain is a
cut in the search, not a faster one."""

from sfmbench import program

program.enable()


def read(run):
    return program.counter_mean(run, "ransac_trials")

"""ransac_trials.sfm: RANSAC hypotheses a multi-view job scores (the
program's ``ransac_trials`` counter: trials times pairs of the batched
pair step, and the fitter's blocks of every pair sent to the loop
path).  Search effort, as ``ransac_trials.pair``."""

from sfmbench import program

program.enable()


def read(run):
    return program.counter_mean(run, "ransac_trials")

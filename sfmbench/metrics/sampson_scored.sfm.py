"""sampson_scored.sfm: RANSAC hypotheses a multi-view job scores in the
Sampson counting kernel (the program's ``sampson_scored`` counter: pairs
times trials times three roots of each launch, from host shapes, on a
card).  0 where the counts come from the plain route (a CPU run, a
program without the kernel): a fall beside a ``pairs_s.sfm`` rise is the
kernel no longer taken."""

from sfmbench import program

program.enable()


def read(run):
    return program.counter_mean(run, "sampson_scored")

"""track_edges.sfm: keypoint matches a multi-view job unions into tracks,
summed over its pairs (the program's ``track_edges`` counter, counted in
the ``tracks`` span from host shapes, no sync).  The work of track
building: a ``tracks_s.sfm`` fall beside an unchanged count is speed,
not fewer inliers.  None where the program keeps no such counter."""

from sfmbench import program

program.enable()

COUNTER = "track_edges"


def read(run):
    jobs = program.collect(run)
    if not jobs or not any(COUNTER in j["counts"] for j in jobs):
        return None
    return program.counter_mean(run, COUNTER)

"""ba_graph_iters.sfm: LM iterations a multi-view job runs as replays of
a captured CUDA graph (the program's ``ba_graph_iters`` counter: the
final BA's and each local BA's iterations, on a card).  0 where the
iterations run eagerly: a fall beside an ``sfm_s`` loss is the graph
path no longer taken."""

from sfmbench import program

program.enable()


def read(run):
    return program.counter_mean(run, "ba_graph_iters")

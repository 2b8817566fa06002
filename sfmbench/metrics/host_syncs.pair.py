"""host_syncs.pair: points a multi-view job where the host waits on the
device (the program's ``host_sync`` counter: the synchronizing
operations the CUDA runtime reports from the program's code, such as
reads of device tensors, shape-dependent ops, copies of pageable host
arrays to the device)."""

from sfmbench import program

program.enable()


def read(run):
    return program.counter_mean(run, "host_sync")

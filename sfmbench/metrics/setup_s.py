"""setup_s: seconds from the process's start to the first timed job
(imports, the CUDA context, inputs, building the kernels on a
checkout's first run, and the warm-up jobs)."""


def read(run):
    return run.setup_s

"""Set-up: from the process's start to the window's (imports, the CUDA
context, loading or building the kernels, weights, warm shapes, the
loop's fill)."""


def read(run):
    return run.setup_s

"""Set-up: importing torch, the CUDA context, the kernels from the
checkout's compile cache, and one experiment of the cell's network cut to
its first wave."""


def read(ctx):
    return ctx["setup_s"]

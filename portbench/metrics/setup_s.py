"""Seconds from the process's start to the window's: imports, CUDA
start, the kernels' libraries (built by the first run of a checkout),
the pool of contexts, the miner and the warm requests."""


def read(view):
    return view.setup_s

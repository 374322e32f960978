"""The port's kernels: CUDA C++ sources in ``csrc/``, their ctypes
wrappers, their plain PyTorch versions (``ref``) and the dispatch
between them (``ops``)."""

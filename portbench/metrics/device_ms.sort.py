"""Device ms a request of Stage 1's and Stage 3's sorts: the union of
the records the frozen map's ``sort`` layer names (the radix kernels,
PyTorch's sort kernels)."""


def read(view):
    return view.layer_ms("sort")

"""The exact cell's launches of the port's kernels a request, read as
``launches.mine`` reads them."""


def read(view):
    total = sum(view.launches.values())
    return total / view.requests if total and view.requests else None

"""Launches of the port's kernels a request (``kernels.ops.
launch_counts()`` over the window, over the requests)."""


def read(view):
    total = sum(view.launches.values())
    return total / view.requests if total and view.requests else None

"""1 - (union of every device record in the traced window) / (the
window's length)."""


def read(view):
    lo, hi = view.window_ns
    return 1.0 - view.busy_ns() / (hi - lo) if hi > lo else None

"""Tuples of every request completed in the window, over the window's
seconds (the window closes at the end of the first request to finish
after ``--seconds``)."""


def read(view):
    return view.tuples / view.window_s

"""Tuples of every request completed in the window, over the window's
seconds, where a request also takes every row's exact density: read as
``mine_tuples_per_s`` reads it, under a name of its own so that its bound
follows its own spread."""
from portbench.metrics.mine_tuples_per_s import read  # noqa: F401

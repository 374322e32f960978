"""The exact cell's device idle share, read as ``device_idle_share``
reads it: a name of its own, as it moves ``exact_tuples_per_s``."""
from portbench.metrics.device_idle_share import read  # noqa: F401

"""95th percentile (nearest rank) of all the window's request
latencies: from the host table handed to the miner to the last leaf on
the host."""
from portbench.lib.stats import percentile


def read(view):
    return percentile(view.latencies_s, 95) * 1e3

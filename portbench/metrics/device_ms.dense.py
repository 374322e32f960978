"""Device ms a request of the dense path (``dense_tensor``, ``fibers``,
``exact_density_dense``): CUDA events on the device's timeline before
``dense_tensor`` and after ``exact_density_dense``, summed over the
window's requests, over the requests.  Events, not the profiler's
records, which have been seen to lose the port's ctypes launches."""


def read(view):
    ms = view.event_ms.get("dense")
    return ms / view.requests if ms and view.requests else None

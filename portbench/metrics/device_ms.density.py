"""Device ms a request of ``exact_density_dense`` (the
``tricluster_density`` kernels and their row counts): CUDA events on the
device's timeline around it, summed over the window's requests, over the
requests.  A time, not a share of a roofline: every count of its
operations so far depends on the formulation (the dense contraction's
2·T·G·M·B, a per-slice product's 4·G²·M·B², a sparse one's far fewer),
so a share would cap the very redesign this layer is measured for."""


def read(view):
    ms = view.event_ms.get("exact_density")
    return ms / view.requests if ms and view.requests else None

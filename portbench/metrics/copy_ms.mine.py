"""Device ms a request of host-to-device and device-to-host copies: the
union of the profiler's memcpy records in the window, over the
requests."""


def read(view):
    return view.layer_ms("copy")

"""Device ms a request of Stage 2's scans: the union of the records the
frozen map's ``scan`` layer names (``segment_reduce``, the ``cummax`` /
``cummin`` and ``cumsum`` scans)."""


def read(view):
    return view.layer_ms("scan")

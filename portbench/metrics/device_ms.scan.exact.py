"""The exact cell's device ms a request of Stage 2's scans, read as
``device_ms.scan`` reads them."""


def read(view):
    return view.layer_ms("scan")

"""The exact cell's device ms a request of Stage 1's and Stage 3's
sorts, read as ``device_ms.sort`` reads them."""


def read(view):
    return view.layer_ms("sort")

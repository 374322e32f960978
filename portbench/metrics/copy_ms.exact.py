"""The exact cell's device ms a request of host-to-device and
device-to-host copies, read as ``copy_ms.mine`` reads them."""


def read(view):
    return view.layer_ms("copy")

"""``torch.cuda.max_memory_allocated()`` over the window (reset after
set-up), in GiB."""


def read(view):
    return view.peak_bytes / 2**30

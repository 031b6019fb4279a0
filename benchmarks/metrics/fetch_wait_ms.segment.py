"""The library call's output side (the program span `library.fetch`:
threshold and resize out enqueued, the host waiting for the mask, the
cast), ms per call (`library.call`)."""

from harness.program_trace import per_unit


def read(view):
    return per_unit(view, "library.fetch", "library.call")

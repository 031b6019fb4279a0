"""Per cent of the traced window in which no operation ran on the device:
1 - (union of the profiler's device operation intervals) / window."""

from harness.reduce import idle_share


def read(view):
    return idle_share(view)

"""Images whose mask PNG and droplet CSV were written in the window, over
the window's seconds (host clock): the batch quantifier's wall rate, which
follows the host's one decode thread (PERF.md)."""

from harness.reduce import total


def read(view):
    return total(view, "images") / view["window_s"]

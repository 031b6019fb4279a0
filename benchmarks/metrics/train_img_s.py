"""Training images stepped in the window, over the window's seconds (host
clock)."""

from harness.reduce import total


def read(view):
    return total(view, "images") / view["window_s"]

"""Device time per image of the batch quantifier: the union of the traced
device operation intervals over the window (every CLI call's uploads,
kernels, copies and fetches) over the images written in it, ms."""

from harness.reduce import total


def read(view):
    tr, imgs = view["trace"], total(view, "images")
    if tr is None or not imgs:
        return None
    return tr.busy_s() / imgs * 1e3

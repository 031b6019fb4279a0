"""K1's share of its roofline (flops/kernels.py: useful operations and
bytes read once and written once, at the cell's shapes) over the mean
device time of one launch in the traced window, per cent."""

from harness.reduce import kernel_roofline


def read(view):
    return kernel_roofline(view, "k1")

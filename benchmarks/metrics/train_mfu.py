"""Useful FLOPs of forward and backward per step (conv shapes,
flops/unet.py) times the steps of the traced window, over its seconds, as
a per cent of the bf16 peak (harness/peaks.py)."""

from flops.unet import train_step_flops
from harness.peaks import BF16_FLOPS
from harness.reduce import total


def read(view):
    s = view["config"]["input_size"]
    b = view["workload"]["traffic"]["batch"]
    steps = total(view, "steps")
    if not steps:
        return None
    return (train_step_flops(b, s, s) * steps / view["window_s"]
            / BF16_FLOPS * 100.0)

"""Useful forward FLOPs of one batch (conv shapes, flops/unet.py) over the
mean megastep time, as a per cent of the bf16 peak (harness/peaks.py).
The megastep also holds the rolling ball, the resizes and the component
tables, so this bounds every kernel share of the forward from above."""

from flops.unet import forward_flops
from harness.peaks import BF16_FLOPS
from harness.reduce import megastep_ms


def read(view):
    ms = megastep_ms(view)
    if not ms:
        return None
    s = view["config"]["input_size"]
    flops = view["workload"]["traffic"]["batch"] * forward_flops(s, s)
    return flops / (ms / 1e3) / BF16_FLOPS * 100.0

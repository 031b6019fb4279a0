"""Operations of the UNet / UNetDC forward and training step, counted from
the conv shapes (2 FLOPs per multiply-add; the taps a padded border
multiplies by zero count too, as the published layers define them).
Frozen copy of the arithmetic of the port's profiler
(`utils/device_profile.py::unet_forward_flops`); dilation does not change
the count.
"""

from __future__ import annotations

WIDTHS = (64, 128, 256, 512, 1024)


def forward_flops(h: int, w: int, widths=WIDTHS, cin: int = 3) -> int:
    """One image's forward: the double 3x3 convs, the 2x2 stride-2
    upconvs and the 1x1 head."""
    f, c = 0, cin
    for i, wd in enumerate(widths):                # encoder, bottleneck
        f += 2 * (h >> i) * (w >> i) * 9 * (c * wd + wd * wd)
        c = wd
    for i in range(len(widths) - 2, -1, -1):       # upconv + decoder
        wd = widths[i]
        f += 2 * (h >> (i + 1)) * (w >> (i + 1)) * c * wd * 4
        f += 2 * (h >> i) * (w >> i) * 9 * (2 * wd * wd + wd * wd)
        c = wd
    return f + 2 * h * w * c


def stem_flops(h: int, w: int, widths=WIDTHS, cin: int = 3) -> int:
    """The first conv (input -> widths[0])."""
    return 2 * h * w * 9 * cin * widths[0]


def train_step_flops(batch: int, h: int, w: int, widths=WIDTHS,
                     cin: int = 3) -> int:
    """Forward plus backward of one step: every layer's product once
    forward, once for the weight gradient and once for the input
    gradient, except the input gradient of the first conv, which no one
    needs."""
    f = forward_flops(h, w, widths, cin)
    return batch * (3 * f - stem_flops(h, w, widths, cin))

"""torchsummary-style model summary (port of the JAX package's
`utils/summary.py`).

The reference optionally imports torchsummary and leaves the actual
`summary(model, input_size=(3, 512, 512))` call commented out
(train_DC_focal.py:26-31, :212); the trainer CLIs implement the intent as
`--summary`: a table of each top-level module's output shape (NHWC, as the
JAX package prints it) and parameter count, from a forward pass on the
`meta` device (shapes only, no memory, no device work)."""

from __future__ import annotations

import copy

import torch


def model_summary(model: torch.nn.Module, input_shape=(1, 512, 512, 3)
                  ) -> str:
    """Formatted summary table for a UNet/UNetDC of the port."""
    meta = copy.deepcopy(model).to("meta").eval()
    shapes = {}

    def hook(name):
        def fn(_mod, _inp, out):
            shapes[name] = tuple(out.permute(0, 2, 3, 1).shape)
        return fn

    for name, mod in meta.named_children():
        mod.register_forward_hook(hook(name))
    with torch.no_grad():
        out = meta(torch.empty(tuple(input_shape), device="meta"))
    # the upconvs and the head run as functional products on the modules'
    # weights (compute-dtype casts), so their shapes come from their users
    for n in (4, 3, 2, 1):
        shapes[f"upconv{n}"] = shapes[f"dec{n}"][:3] + (
            getattr(model, f"upconv{n}").out_channels,)
    shapes["out_conv"] = tuple(out.shape)

    lines = ["-" * 64,
             f"{'Layer (type)':<24}{'Output Shape':<24}{'Param #':>14}",
             "=" * 64]
    total = 0
    for name, mod in model.named_children():
        n = sum(p.numel() for p in mod.parameters())
        total += n
        lines.append(f"{name:<24}{str(shapes.get(name, '-')):<24}{n:>14,}")
    lines += ["=" * 64,
              f"Output shape: {tuple(out.shape)}",
              f"Total params: {total:,}",
              f"Param size (MB): {total * 4 / 1024 / 1024:.2f} (f32)",
              "-" * 64]
    return "\n".join(lines)

"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. A missing
card is an error, never a silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch.device to run on; raises when CUDA is asked for but absent.

    Also turns TF32 off for float32 work on the card: cuDNN convolutions
    default to TF32, which keeps ~3 decimal digits and breaks f32 parity
    with the reference."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "unetdc_tpu_torch: CUDA was requested but no GPU is visible; "
                "pass device='cpu' (or --device cpu) to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

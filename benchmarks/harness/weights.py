"""Weights made by the benchmark from the run's seed, on the device, in a
few large calls: one normal draw for every parameter at once, split and
scaled per tensor. Both sides of a comparison get the same tensors.

`inference_state_dict` shapes a published-size UNet/UNetDC so that its
masks follow the droplets of the traffic while every layer moves the
output: seeded random kernels at He gain everywhere, and one identity
channel that carries the preprocessed image from the input through enc1,
the skip into dec1 and dec1 to the 1x1 head, which thresholds it
steeply; the head's other inputs add a random function of the image at a
set share. BatchNorm is the identity in eval mode.

`train_state_dict` is the trainers' initial state: lecun-normal conv
kernels (std sqrt(1 / fan_in), clipped at 2 std), upconv kernels uniform in
+-sqrt(1 / (2 I O)), zero biases, BatchNorm scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.model import forward as ref_forward
from reference.model import param_shapes


def _draw(shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        out[k] = flat[off:off + n].view(s)
        off += n
    return out


def inference_state_dict(seed: int, device, probe: torch.Tensor,
                         dilations, gain: float, head_scale: float,
                         head_threshold: float, deep_share: float,
                         up_gain: float) -> Dict[str, torch.Tensor]:
    """The published state dict (with BatchNorm running statistics).

    Every conv kernel is random with std gain / sqrt(fan_in). Channel 0
    is the identity path: enc1 averages the input's channels into it, the
    skip carries it to dec1 (which adds up_gain times its random inputs
    from upconv1), and the head gives it head_scale. The head's other 63
    inputs are random too, scaled so that on `probe` (a preprocessed
    (1, 3, S, S) image of the traffic) their sum has a standard deviation
    of deep_share in the identity channel's units: the whole network moves
    the logit, while the threshold head_threshold on the identity channel
    keeps the masks on the droplets."""
    shapes = param_shapes()
    raw = _draw(shapes, seed, device)
    sd = {}
    with torch.no_grad():
        for k, r in raw.items():
            if k.endswith(".bias") or ".1." in k or ".4." in k:
                sd[k] = (torch.ones_like(r) if k.endswith(".weight")
                         else torch.zeros_like(r))
                continue
            fan_in = r[0].numel() if not k.startswith("upconv") \
                else r.shape[0] * 4
            sd[k] = r * (gain / math.sqrt(fan_in))
        for k in list(shapes):
            if k.endswith(".1.weight") or k.endswith(".4.weight"):
                base = k[:-len(".weight")]
                sd[base + ".running_mean"] = torch.zeros_like(sd[k])
                sd[base + ".running_var"] = torch.ones_like(sd[k])
        w = sd["enc1.0.weight"]
        w[0].zero_()
        w[0, :, 1, 1] = 1.0 / w.shape[1]
        w = sd["enc1.3.weight"]
        w[0].zero_()
        w[0, 0, 1, 1] = 1.0
        w = sd["dec1.0.weight"]
        half = w.shape[1] // 2
        w[0, half:].zero_()
        w[0, :half] *= up_gain
        w[0, half, 1, 1] = 1.0
        w = sd["dec1.3.weight"]
        w[0].zero_()
        w[0, 0, 1, 1] = 1.0
        feats = ref_forward(sd, probe.to(device), dilations, features=True)
        r = sd["out_conv.weight"][0, 1:, 0, 0]
        deep = torch.einsum("c,bchw->bhw", r, feats[:, 1:])
        mu, sigma = float(deep.mean()), float(deep.std())
        w = sd["out_conv.weight"]
        w[0, 1:] *= head_scale * deep_share / sigma
        w[0, 0] = head_scale
        sd["out_conv.bias"].fill_(
            -head_scale * (head_threshold + deep_share * mu / sigma))
    return sd


def train_state_dict(seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial parameters of the trainers (no running statistics)."""
    shapes = param_shapes()
    raw = _draw(shapes, seed, device)
    sd = {}
    with torch.no_grad():
        for k, r in raw.items():
            if k.endswith(".bias"):
                sd[k] = torch.zeros_like(r)
            elif ".1." in k or ".4." in k:
                sd[k] = torch.ones_like(r)
            elif k.startswith("upconv"):
                bound = math.sqrt(1.0 / (2 * r.shape[0] * r.shape[1]))
                # a normal draw mapped to a uniform one through its CDF
                sd[k] = (torch.erf(r / math.sqrt(2.0)) * bound).contiguous()
            else:
                std = math.sqrt(1.0 / r[0].numel())
                sd[k] = (r.clamp(-2.0, 2.0) * std).contiguous()
    return sd

"""Reference `.pth` checkpoints <-> the JAX package's variable pytree.

The port's models keep the reference state-dict keys, so a `.pth` loads
straight into `models.unet.UNetDC`. The pytree conversions are kept (as an
own copy, independent of `unetdc_tpu`) so weights cross between the two
packages:

    enc{1..4}.{0,3}.{weight,bias}       Conv2d (O, I, 3, 3)
    enc{1..4}.{1,4}.{weight,bias,running_mean,running_var,
                     num_batches_tracked}  BatchNorm2d
    bottleneck.* / dec{4..1}.*          same Sequential layout
    upconv{4..1}.{weight,bias}          ConvTranspose2d (I, O, 2, 2)
    out_conv.{weight,bias}              Conv2d (O, I, 1, 1)

Pytree layout (JAX package): params/<block>/conv{0,1}/{kernel HWIO, bias},
params/<block>/bn{0,1}/{scale, bias}, batch_stats/<block>/bn{0,1}/{mean,
var}, params/upconv{n}/{kernel (I,O,2,2), bias}, params/out_conv/{kernel
(1,1,I,O), bias}.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BLOCKS = [
    "enc1", "enc2", "enc3", "enc4", "bottleneck",
    "dec4", "dec3", "dec2", "dec1",
]
_UPCONVS = ["upconv4", "upconv3", "upconv2", "upconv1"]
# torch Sequential index -> (pytree name, kind)
_SEQ = {0: ("conv0", "conv"), 1: ("bn0", "bn"), 3: ("conv1", "conv"),
        4: ("bn1", "bn")}


def load_pth_state_dict(path) -> Dict[str, torch.Tensor]:
    """A reference `.pth` state dict, loaded onto the CPU."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict")
    return sd


def torch_state_dict_to_variables(sd) -> dict:
    """Reference state dict -> {'params': ..., 'batch_stats': ...} of numpy
    arrays."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
              else np.asarray(v)) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}
    for block in _BLOCKS:
        pb: dict = {}
        sb: dict = {}
        for seq_idx, (name, kind) in _SEQ.items():
            if kind == "conv":
                pb[name] = {
                    "kernel": np.transpose(sd[f"{block}.{seq_idx}.weight"],
                                           (2, 3, 1, 0)),  # HWIO
                    "bias": sd[f"{block}.{seq_idx}.bias"],
                }
            else:
                pb[name] = {"scale": sd[f"{block}.{seq_idx}.weight"],
                            "bias": sd[f"{block}.{seq_idx}.bias"]}
                sb[name] = {"mean": sd[f"{block}.{seq_idx}.running_mean"],
                            "var": sd[f"{block}.{seq_idx}.running_var"]}
        params[block] = pb
        stats[block] = sb
    for up in _UPCONVS:
        params[up] = {"kernel": sd[f"{up}.weight"], "bias": sd[f"{up}.bias"]}
    params["out_conv"] = {
        "kernel": np.transpose(sd["out_conv.weight"], (2, 3, 1, 0)),
        "bias": sd["out_conv.bias"],
    }
    return {"params": params, "batch_stats": stats}


def variables_to_torch_state_dict(variables: dict) -> Dict[str, np.ndarray]:
    """Inverse of `torch_state_dict_to_variables`: numpy state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for block in _BLOCKS:
        for seq_idx, (name, kind) in _SEQ.items():
            if kind == "conv":
                k = np.asarray(params[block][name]["kernel"])
                sd[f"{block}.{seq_idx}.weight"] = np.transpose(k, (3, 2, 0, 1))
                sd[f"{block}.{seq_idx}.bias"] = np.asarray(
                    params[block][name]["bias"])
            else:
                sd[f"{block}.{seq_idx}.weight"] = np.asarray(
                    params[block][name]["scale"])
                sd[f"{block}.{seq_idx}.bias"] = np.asarray(
                    params[block][name]["bias"])
                st = stats[block][name]
                sd[f"{block}.{seq_idx}.running_mean"] = np.asarray(st["mean"])
                sd[f"{block}.{seq_idx}.running_var"] = np.asarray(st["var"])
                sd[f"{block}.{seq_idx}.num_batches_tracked"] = np.asarray(
                    0, dtype=np.int64)
    for up in _UPCONVS:
        sd[f"{up}.weight"] = np.asarray(params[up]["kernel"])
        sd[f"{up}.bias"] = np.asarray(params[up]["bias"])
    k = np.asarray(params["out_conv"]["kernel"])
    sd["out_conv.weight"] = np.transpose(k, (3, 2, 0, 1))
    sd["out_conv.bias"] = np.asarray(params["out_conv"]["bias"])
    return sd


def variables_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX-package `{'params', 'batch_stats'}` pytree (numpy arrays) -> the
    port's state dict (float32 tensors, `num_batches_tracked` int64), ready
    for `UNetDC.load_state_dict`."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if
                                         k.endswith("num_batches_tracked")
                                         else np.float32))
            for k, v in variables_to_torch_state_dict(variables).items()}

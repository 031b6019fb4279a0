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

Adam's moments cross the same way: an optax adam state dict ({"0":
{"count", "mu", "nu"}, "1": {}}, moments in the params layout) maps onto a
`torch.optim.Adam` state (`step`, `exp_avg`, `exp_avg_sq` per parameter)
and back.
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
    sd = {k: (v.detach().cpu().numpy().copy() if torch.is_tensor(v)
              else np.asarray(v)) for k, v in sd.items()}
    stats = {block: {name: {"mean": sd[f"{block}.{i}.running_mean"],
                            "var": sd[f"{block}.{i}.running_var"]}
                     for i, (name, kind) in _SEQ.items() if kind == "bn"}
             for block in _BLOCKS}
    return {"params": named_to_params(sd), "batch_stats": stats}


def params_to_named(params: dict) -> Dict[str, np.ndarray]:
    """A JAX-package `params` tree, or an Adam moment tree of the same
    layout, -> {port parameter name: numpy array in torch layout}. Moments
    take their weights' layout transforms: HWIO -> OIHW for the convs and
    out_conv, bn scale/bias -> weight/bias, upconvs unchanged."""
    sd: Dict[str, np.ndarray] = {}
    for block in _BLOCKS:
        for seq_idx, (name, kind) in _SEQ.items():
            leaf = params[block][name]
            if kind == "conv":
                sd[f"{block}.{seq_idx}.weight"] = np.transpose(
                    np.asarray(leaf["kernel"]), (3, 2, 0, 1))
            else:
                sd[f"{block}.{seq_idx}.weight"] = np.asarray(leaf["scale"])
            sd[f"{block}.{seq_idx}.bias"] = np.asarray(leaf["bias"])
    for up in _UPCONVS:
        sd[f"{up}.weight"] = np.asarray(params[up]["kernel"])
        sd[f"{up}.bias"] = np.asarray(params[up]["bias"])
    sd["out_conv.weight"] = np.transpose(
        np.asarray(params["out_conv"]["kernel"]), (3, 2, 0, 1))
    sd["out_conv.bias"] = np.asarray(params["out_conv"]["bias"])
    return sd


def named_to_params(named) -> dict:
    """Inverse of `params_to_named` (numpy or tensors in, numpy out)."""
    sd = {k: (v.detach().cpu().numpy().copy() if torch.is_tensor(v)
              else np.asarray(v)) for k, v in named.items()}
    params: dict = {}
    for block in _BLOCKS:
        pb: dict = {}
        for seq_idx, (name, kind) in _SEQ.items():
            w = sd[f"{block}.{seq_idx}.weight"]
            pb[name] = ({"kernel": np.transpose(w, (2, 3, 1, 0))}
                        if kind == "conv" else {"scale": w})
            pb[name]["bias"] = sd[f"{block}.{seq_idx}.bias"]
        params[block] = pb
    for up in _UPCONVS:
        params[up] = {"kernel": sd[f"{up}.weight"], "bias": sd[f"{up}.bias"]}
    params["out_conv"] = {
        "kernel": np.transpose(sd["out_conv.weight"], (2, 3, 1, 0)),
        "bias": sd["out_conv.bias"]}
    return params


def variables_to_torch_state_dict(variables: dict) -> Dict[str, np.ndarray]:
    """Inverse of `torch_state_dict_to_variables`: numpy state dict."""
    sd = params_to_named(variables["params"])
    stats = variables.get("batch_stats", {})
    for block in _BLOCKS:
        for seq_idx, (name, kind) in _SEQ.items():
            if kind != "bn":
                continue
            st = stats[block][name]
            sd[f"{block}.{seq_idx}.running_mean"] = np.asarray(st["mean"])
            sd[f"{block}.{seq_idx}.running_var"] = np.asarray(st["var"])
            sd[f"{block}.{seq_idx}.num_batches_tracked"] = np.asarray(
                0, dtype=np.int64)
    return sd


def variables_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX-package `{'params', 'batch_stats'}` pytree (numpy arrays) -> the
    port's state dict (float32 tensors, `num_batches_tracked` int64), ready
    for `UNetDC.load_state_dict`."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if
                                         k.endswith("num_batches_tracked")
                                         else np.float32))
            for k, v in variables_to_torch_state_dict(variables).items()}


# ------------------------------------------------------- optimizer state --
def _adam_leaves(opt_sd: dict) -> dict:
    """The ScaleByAdamState dict {count, mu, nu} inside an optax state dict:
    `optax.adam` gives {"0": adam, "1": {}}, `inject_hyperparams(adam)`
    wraps that as {"count", "hyperparams", "hyperparams_states",
    "inner_state"}."""
    inner = opt_sd.get("inner_state", opt_sd)
    if set(inner) != {"0", "1"} or set(inner["0"]) != {"count", "mu", "nu"}:
        raise ValueError(f"not an optax adam state dict: keys {list(opt_sd)}")
    return inner["0"]


def load_optax_adam_state(opt: torch.optim.Optimizer, names, opt_sd: dict
                          ) -> None:
    """Load an optax adam state dict (flax `to_state_dict` layout, numpy
    leaves) into `opt`, a torch Adam over the parameters named `names` (in
    the optimizer's order). The step count becomes each parameter's
    `step` (on the parameter's device for fused or capturable Adam, as
    Adam itself creates it); each moment takes its parameter's dtype,
    device and strides; an injected learning rate becomes the group's lr."""
    adam = _adam_leaves(opt_sd)
    mu, nu = params_to_named(adam["mu"]), params_to_named(adam["nu"])
    step = float(np.asarray(adam["count"]))
    group = opt.param_groups[0]
    on_device = bool(group.get("fused") or group.get("capturable"))
    for n, p in zip(names, group["params"]):
        def like(a):
            return torch.empty_like(p, memory_format=torch.preserve_format
                                    ).copy_(torch.from_numpy(
                                        np.array(a, np.float32)))
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": like(mu[n]), "exp_avg_sq": like(nu[n])}
    if "hyperparams" in opt_sd:
        group["lr"] = float(np.asarray(opt_sd["hyperparams"]["learning_rate"]))


def optax_adam_state_dict(opt: torch.optim.Optimizer, names,
                          injected: bool = False) -> dict:
    """The optax state dict that `optax.adam` (or, with `injected`,
    `optax.inject_hyperparams(optax.adam)`) would hold after the same
    steps: {"0": {"count" int32, "mu", "nu"}, "1": {}} with the moments in
    the JAX params layout (zero moments for parameters without state)."""
    state = opt.state_dict()["state"]
    params = opt.param_groups[0]["params"]
    mu, nu, steps = {}, {}, set()
    for i, n in enumerate(names):
        st = state.get(i)
        if st is None:
            mu[n] = nu[n] = np.zeros(tuple(params[i].shape), np.float32)
            steps.add(0)
            continue
        mu[n] = st["exp_avg"].detach().cpu().numpy().copy()
        nu[n] = st["exp_avg_sq"].detach().cpu().numpy().copy()
        steps.add(int(float(st["step"])))
    if len(steps) > 1:
        raise ValueError(f"parameters at different step counts: {steps}")
    count = np.asarray(steps.pop() if steps else 0, np.int32)
    inner = {"0": {"count": count, "mu": named_to_params(mu),
                   "nu": named_to_params(nu)}, "1": {}}
    if not injected:
        return inner
    g = opt.param_groups[0]
    b1, b2 = g["betas"]
    return {"count": count,
            "hyperparams": {k: np.asarray(v, np.float32) for k, v in (
                ("learning_rate", g["lr"]), ("b1", b1), ("b2", b2),
                ("eps", g["eps"]), ("eps_root", 0.0))},
            "hyperparams_states": {}, "inner_state": inner}

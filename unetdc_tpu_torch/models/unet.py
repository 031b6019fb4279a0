"""U-Net and U-Net-DC segmentation models as `nn.Module`s.

Same architecture as the JAX package's `models/unet.py` (reference
models/model.py `UNet`, models/model_2.py `UNetDC`): double 3x3 convs with
BatchNorm, dilations 1/2/4/8/16 in the UNetDC encoder, 2x2 stride-2
transposed-conv upsampling, a 1x1 head and, by default, the sigmoid inside
`forward`. Module names follow the reference state dict (`enc1.0.weight`,
..., `upconv4.weight`, `out_conv.weight`), so a reference `.pth` loads
directly.

`forward` takes and returns NHWC tensors, like the JAX package, so the two
are compared like with like; the convolutions run NCHW-logical on a
channels-last view.

Training follows the JAX package's flax module, not `nn.BatchNorm2d`:
  - `apply_sigmoid=False` returns logits (the trainer's losses work in
    logits space);
  - dtype policy: f32 master weights; the convs and upconvs run in
    `compute_dtype` (inputs and weights cast at use, bias added in that
    dtype after the product, as flax's `nn.Conv` does), BatchNorm always
    in f32 (f64 for an f64 model, as flax promotes its statistics to at
    least f32) with the exact two-pass variance, cast back after;
  - train-mode BatchNorm normalizes with the batch statistics over the
    samples `sample_mask` (B,) keeps (one fused `native_batch_norm` when
    all are kept, explicit f32 ops otherwise), and updates the running
    statistics
    flax's way: `ra = 0.9 * ra + (1 - 0.9) * stat` with the BIASED batch
    variance (`nn.BatchNorm2d` stores the unbiased one);
  - `remat=True` recomputes each double-conv block in the backward pass
    (`torch.utils.checkpoint`, non-reentrant). The block is a pure function
    that returns its batch statistics; the running statistics are updated
    outside it, so a recompute cannot update them twice;
  - `init_flax_` draws flax's initializers from an explicit generator.

`forward_sharded` runs the same model under a ('data', 'space') device
mesh (`core/mesh.py`) as one autograd graph: the batch over the data
groups, the height over the space shards with halo rows, and train-mode
BatchNorm with the statistics of the whole batch (the JAX package's train
step under GSPMD).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unetdc_tpu_torch.core import mesh as M

BN_EPS = 1e-5
BN_MOMENTUM = 0.9          # flax convention: ra = m * ra + (1 - m) * batch
_BLOCKS = ("enc1", "enc2", "enc3", "enc4", "bottleneck",
           "dec4", "dec3", "dec2", "dec1")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with flax's semantics (parameter and buffer names of
    `nn.BatchNorm2d`): f32 statistics, `(x - mean) * (rsqrt(var + eps) *
    scale) + bias`, masked batch statistics in train mode."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def normalize(self, x32: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]

    def fused(self, y: torch.Tensor, train: bool):
        """Normalize y (the conv output, compute dtype) with one fused
        BatchNorm (torch.native_batch_norm: statistics and normalization
        accumulate in f32, or f64 for f64 input, the output is cast back to
        y's dtype, as the flax module casts after its f32 norm). Train mode
        uses the whole batch and also returns its mean and biased variance
        (recovered from the saved inverse std) for the running update."""
        if not train:
            return F.batch_norm(y, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps), None, None
        out, mean, invstd = torch.native_batch_norm(
            y, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(self.eps).to(mean.dtype)
        return out, mean.detach(), var

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)


def batch_stats(x32: torch.Tensor, sample_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of (B, C, H, W) f32 over the
    samples `sample_mask` keeps (flax `_compute_stats` with a mask,
    use_fast_variance=False: var = mean((x - mean)^2))."""
    keep = sample_mask.to(torch.bool)[:, None, None, None]
    n = keep.sum() * x32.shape[2] * x32.shape[3]
    mean = torch.where(keep, x32, 0).sum((0, 2, 3)) / n
    dev = x32 - mean[:, None, None]
    var = torch.where(keep, dev * dev, 0).sum((0, 2, 3)) / n
    return mean, var


# dilated convs at or above this dilation run as undilated convs on the
# dilation's phase sub-images (see `_conv_phases`)
PHASE_MIN_DILATION = 16


def _conv_phases(x: torch.Tensor, w: torch.Tensor, d: int,
                 halo: bool = False) -> torch.Tensor:
    """A 3x3 conv with dilation d and padding d, computed as an undilated
    3x3 conv (padding 1) on each of the d*d phase sub-images x[..., i::d,
    j::d] stacked into the batch: the same taps and zeros for every output,
    so the same arithmetic. cuDNN's dilated kernels are slow where the
    dilation is a large share of the map (the bottleneck's backward at
    dilation 16 on 32x32 maps). Channels-last memory throughout.

    With `halo`, x is a row shard carrying d real rows above and below its
    output rows (`forward_sharded`): only the width is padded, and x's
    height (rows + 2d, not always a multiple of d) is first padded with
    zero rows at the bottom to one; the output rows those feed are
    dropped."""
    b, c, h, wd = x.shape
    out_h = h - 2 * d if halo else h
    if h % d:
        x = F.pad(x, (0, 0, 0, -h % d))
        h = x.shape[2]
    xs = (x.permute(0, 2, 3, 1).reshape(b, h // d, d, wd // d, d, c)
          .permute(0, 2, 4, 1, 3, 5).reshape(b * d * d, h // d, wd // d, c))
    y = F.conv2d(xs.permute(0, 3, 1, 2), w, None, 1, (0 if halo else 1, 1))
    o, hs = y.shape[1], y.shape[2]
    y = (y.permute(0, 2, 3, 1).reshape(b, d, d, hs, wd // d, o)
         .permute(0, 3, 1, 4, 2, 5).reshape(b, hs * d, wd, o)
         .permute(0, 3, 1, 2))
    return y if hs * d == out_h else y[:, :, :out_h]


def _conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int,
             halo: bool = False) -> torch.Tensor:
    """3x3 conv (dilation d) plus bias, in x's dtype: padding d all round,
    or with `halo` (x a row shard with d real rows above and below) the
    width only. Dilations from PHASE_MIN_DILATION run as `_conv_phases`."""
    if d >= PHASE_MIN_DILATION and x.shape[-1] % d == 0 \
            and (halo or x.shape[-2] % d == 0):
        y = _conv_phases(x, w, d, halo)
    else:
        y = F.conv2d(x, w, None, 1, (0 if halo else d, d), d)
    return y + b[:, None, None]


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax nn.Conv(dtype=...): input and kernel cast to `dtype`, product
    in `dtype`, bias (cast) added after."""
    x, w, b = x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype)
    if conv.kernel_size[0] == 1:
        return F.conv2d(x, w) + b[:, None, None]
    return _conv3x3(x, w, b, conv.dilation[0])


class DoubleConv(nn.Sequential):
    """(Conv3x3 -> BN -> ReLU) x 2, padding == dilation (models/model_2.py);
    Sequential indices 0/1/3/4 keep the reference's state-dict keys."""

    def __init__(self, cin: int, cout: int, dilation: int):
        super().__init__(
            nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation),
            BatchNorm(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=dilation, dilation=dilation),
            BatchNorm(cout), nn.ReLU())

    def run(self, x: torch.Tensor, dtype: torch.dtype, train: bool,
            sample_mask: Optional[torch.Tensor]):
        """Pure block function: (output, batch statistics of both BNs, or
        () in eval mode)."""
        stats = []
        bn_dtype = torch.promote_types(dtype, torch.float32)  # f64 stays
        for conv, bn in ((self[0], self[1]), (self[3], self[4])):
            y = _conv(conv, x, dtype)
            if sample_mask is None or not train:
                y, mean, var = bn.fused(y, train)
            else:
                x32 = y.to(bn_dtype)
                mean, var = batch_stats(x32, sample_mask)
                y = bn.normalize(x32, mean, var).to(dtype)
            if train:
                stats += [mean, var]
            x = torch.relu(y)
        return (x, *stats)

    def forward(self, x, dtype=torch.float32, sample_mask=None,
                remat: bool = False):
        train = self.training
        if remat and torch.is_grad_enabled():
            out = checkpoint(self.run, x, dtype, train, sample_mask,
                             use_reentrant=False)
        else:
            out = self.run(x, dtype, train, sample_mask)
        if train:
            self[1].update_running(out[1], out[2])
            self[4].update_running(out[3], out[4])
        return out[0]


class _UNetBase(nn.Module):
    dilations: Tuple[int, int, int, int, int] = (1, 1, 1, 1, 1)

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 apply_sigmoid: bool = True, remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.apply_sigmoid = apply_sigmoid
        self.remat = remat
        d = self.dilations
        self.enc1 = DoubleConv(in_channels, 64, d[0])
        self.enc2 = DoubleConv(64, 128, d[1])
        self.enc3 = DoubleConv(128, 256, d[2])
        self.enc4 = DoubleConv(256, 512, d[3])
        self.bottleneck = DoubleConv(512, 1024, d[4])
        self.upconv4 = nn.ConvTranspose2d(1024, 512, 2, 2)
        self.dec4 = DoubleConv(1024, 512, 1)
        self.upconv3 = nn.ConvTranspose2d(512, 256, 2, 2)
        self.dec3 = DoubleConv(512, 256, 1)
        self.upconv2 = nn.ConvTranspose2d(256, 128, 2, 2)
        self.dec2 = DoubleConv(256, 128, 1)
        self.upconv1 = nn.ConvTranspose2d(128, 64, 2, 2)
        self.dec1 = DoubleConv(128, 64, 1)
        self.out_conv = nn.Conv2d(64, out_channels, 1)

    def _up(self, up: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        """flax UpConv2x2: product in the compute dtype, bias added after."""
        dt = self.compute_dtype
        y = F.conv_transpose2d(x, up.weight.to(dt), None, stride=2)
        return y + up.bias.to(dt)[:, None, None]

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, out): probabilities, or logits when
        `apply_sigmoid` is False; float32 (float64 for a float64 model). `sample_mask` (B,)
        excludes samples from the train-mode batch statistics."""
        dt = self.compute_dtype
        kw = dict(dtype=dt, sample_mask=sample_mask, remat=self.remat)
        x = x.permute(0, 3, 1, 2).to(dt)
        e1 = self.enc1(x, **kw)
        e2 = self.enc2(F.max_pool2d(e1, 2), **kw)
        e3 = self.enc3(F.max_pool2d(e2, 2), **kw)
        e4 = self.enc4(F.max_pool2d(e3, 2), **kw)
        b = self.bottleneck(F.max_pool2d(e4, 2), **kw)
        d4 = self.dec4(torch.cat([self._up(self.upconv4, b), e4], 1), **kw)
        d3 = self.dec3(torch.cat([self._up(self.upconv3, d4), e3], 1), **kw)
        d2 = self.dec2(torch.cat([self._up(self.upconv2, d3), e2], 1), **kw)
        d1 = self.dec1(torch.cat([self._up(self.upconv1, d2), e1], 1), **kw)
        out = _conv(self.out_conv, d1, dt).to(
            torch.promote_types(dt, torch.float32))
        if self.apply_sigmoid:
            out = torch.sigmoid(out)
        return out.permute(0, 2, 3, 1)


class UNet(_UNetBase):
    """Classic 4-level U-Net (reference models/model.py)."""

    dilations = (1, 1, 1, 1, 1)


class UNetDC(_UNetBase):
    """U-Net with dilations 1/2/4/8/16 in the encoder and bottleneck
    (reference models/model_2.py)."""

    dilations = (1, 2, 4, 8, 16)


# ------------------------------------------------------------ sharded --
def sharded_batch_stats(parts, n: int, device: torch.device):
    """`batch_stats` of a batch held in shards: `parts` is a list of
    (x32 (b, C, h, W) on its device, keep (b,) bool on that device or
    None), `n` the number of kept pixels in all. The per-channel mean and
    biased variance come from two cross-shard sums on `device` (the masked
    sums of x, then of (x - mean)^2: flax's two-pass variance); the mean
    goes back to every shard's device between the two. Differentiable, so
    the backward is autograd's. Returns (mean, var, each shard centred)."""
    def masked(t, keep):
        return t if keep is None else torch.where(
            keep[:, None, None, None], t, 0)

    mean = M.reduce_to([masked(x, k).sum((0, 2, 3)) for x, k in parts],
                       device) / n
    means = {x.device: mean.to(x.device) for x, _ in parts}
    cen = [x - means[x.device][:, None, None] for x, _ in parts]
    var = M.reduce_to([masked(c * c, k).sum((0, 2, 3))
                       for c, (_, k) in zip(cen, parts)], device) / n
    return mean, var, cen


class _StepShards:
    """The per-step state of `forward_sharded`: each weight as one
    differentiable copy per distinct device of the mesh (convs cast to the
    compute dtype), and the kept samples of each data group."""

    def __init__(self, model: "_UNetBase", mesh: M.Mesh, n_space: int,
                 batch: int, sample_mask: Optional[torch.Tensor]):
        self.model = model
        self.dt = model.compute_dtype
        self.bn_dt = torch.promote_types(self.dt, torch.float32)
        self.first = mesh.first
        self.train = model.training
        devs = mesh.distinct()
        # the master leaf itself on its own device; a copy elsewhere, whose
        # backward adds that device's gradient into the leaf
        self.w: Dict[torch.device, Dict[str, torch.Tensor]] = {
            d: {} for d in devs}
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                ts, dt = ("weight", "bias"), self.dt
            elif isinstance(mod, BatchNorm):
                ts, dt = ("weight", "bias") + (() if self.train else (
                    "running_mean", "running_var")), None
            else:
                continue
            for t in ts:
                for d in devs:
                    self.w[d][f"{name}.{t}"] = getattr(mod, t).to(d, dt)
        self.keep, self.n_kept = None, batch
        if sample_mask is not None:
            km = sample_mask.detach().to("cpu", torch.bool)
            self.n_kept = int(km.sum())
            self.keep = [{d: k.to(d) for d in mesh.grid[g][:n_space]}
                         for g, k in enumerate(
                             km.chunk(mesh.shape[M.DATA_AXIS]))]

    def _keep(self, g: int, t: torch.Tensor) -> Optional[torch.Tensor]:
        return None if self.keep is None else self.keep[g][t.device]

    def conv(self, groups, key: str, d: int):
        """Each group's 3x3 conv: whole, or per shard on its own halo of d
        rows (zeros past the image)."""
        out = []
        for shards in groups:
            halo = len(shards) > 1
            out.append([_conv3x3(t, self.w[t.device][key + ".weight"],
                                 self.w[t.device][key + ".bias"], d, halo)
                        for t in (M.halo(shards, d, 2) if halo else shards)])
        return out

    def bn(self, groups, key: str):
        """BatchNorm of every shard of every group. Train mode: the
        statistics of the whole batch (`sharded_batch_stats`), returned for
        the running update. Eval mode: each shard normalised alone with
        the running statistics."""
        if not self.train:
            return [[F.batch_norm(
                t, *(self.w[t.device][f"{key}.{n}"] for n in (
                    "running_mean", "running_var", "weight", "bias")),
                False, 0.0, BN_EPS) for t in shards]
                for shards in groups], ()
        parts = [(t.to(self.bn_dt), self._keep(g, t))
                 for g, shards in enumerate(groups) for t in shards]
        rows = sum(t.shape[2] for t in groups[0])
        mean, var, cen = sharded_batch_stats(
            parts, self.n_kept * rows * groups[0][0].shape[3], self.first)
        mul = {d: torch.rsqrt(var.to(d) + BN_EPS) * w[key + ".weight"]
               for d, w in self.w.items()}
        out = iter((v * mul[v.device][:, None, None]
                    + self.w[v.device][key + ".bias"][:, None, None]
                    ).to(self.dt) for v in cen)
        return [[next(out) for _ in shards] for shards in groups], \
            (mean.detach(), var.detach())

    def double_conv(self, name: str, d: int, groups):
        stats = []
        for ci, bi in (("0", "1"), ("3", "4")):
            groups, st = self.bn(self.conv(groups, f"{name}.{ci}", d),
                                 f"{name}.{bi}")
            stats += st
            groups = [[torch.relu(t) for t in s] for s in groups]
        return groups, stats

    def block(self, name: str, d: int, groups):
        """One double conv over the mesh; with `remat`, recomputed in the
        backward as one function of all its shards (non-reentrant
        checkpoint: the cross-device copies and reductions rerun). The
        running statistics are updated once, on the master buffers."""
        if self.model.remat and torch.is_grad_enabled():
            sizes = [len(s) for s in groups]

            def run(*flat):
                it = iter(flat)
                out, stats = self.double_conv(
                    name, d, [[next(it) for _ in range(k)] for k in sizes])
                return [t for s in out for t in s], stats

            flat, stats = checkpoint(run, *[t for s in groups for t in s],
                                     use_reentrant=False,
                                     preserve_rng_state=False)
            it = iter(flat)
            out = [[next(it) for _ in range(k)] for k in sizes]
        else:
            out, stats = self.double_conv(name, d, groups)
        if self.train:
            blk = getattr(self.model, name)
            blk[1].update_running(*stats[:2])
            blk[4].update_running(*stats[2:])
        return out

    def up(self, key: str, groups):
        return [[F.conv_transpose2d(t, self.w[t.device][key + ".weight"],
                                    None, stride=2)
                 + self.w[t.device][key + ".bias"][:, None, None]
                 for t in shards] for shards in groups]

    def head(self, t: torch.Tensor) -> torch.Tensor:
        w = self.w[t.device]
        out = (F.conv2d(t, w["out_conv.weight"]) + w["out_conv.bias"][
            :, None, None]).to(self.bn_dt)
        if self.model.apply_sigmoid:
            out = torch.sigmoid(out)
        return out.permute(0, 2, 3, 1)


def forward_sharded(model: "_UNetBase", x: torch.Tensor, mesh: M.Mesh,
                    shard_space: bool = False,
                    sample_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """`model(x, sample_mask)` under a ('data', 'space') mesh, in train or
    eval mode, as one autograd graph across the mesh (the JAX package's
    train step under GSPMD).

    The master weights stay on `model`'s device; each distinct device of
    the mesh computes with its own differentiable copy, so the backward
    sums every device's gradient into the master leaves. The batch splits
    over the data groups (B must divide: the trainer pads first); with
    `shard_space` each group's height splits over its space shards (H must
    divide by 2 * n_space, else ValueError):
    - every 3x3 conv runs per shard on its own halo of `dilation` rows of
      its input, zeros past the image (the dilation-16 convs as phase
      convs on the haloed shard);
    - pools and upconvs are local; a level whose pool would cut a seam
      (odd rows per shard) is gathered onto the group's first device, the
      levels below run whole there, and the decoder splits again at the
      first level whose encoder ran sharded;
    - train-mode BatchNorm normalises with the statistics of the whole
      batch over the samples `sample_mask` (B,) keeps, and updates the
      running statistics once; eval mode normalises each shard alone.
    Returns (B, H, W, out) f32 logits (probabilities with
    `apply_sigmoid`) on `mesh.first`, in batch order."""
    n_data = mesh.shape[M.DATA_AXIS]
    n_space = mesh.shape[M.SPACE_AXIS] if shard_space else 1
    B, H = x.shape[0], x.shape[1]
    M.check_batch(mesh, B)
    if H % (2 * n_space):
        raise ValueError(f"height {H} does not split into {n_space} row "
                         "shards of an even number of rows")
    st = _StepShards(model, mesh, n_space, B, sample_mask)
    xc = x.permute(0, 3, 1, 2).to(model.compute_dtype)
    cur = [M.split(xg, n_space, 2, mesh.grid[g][:n_space])
           for g, xg in enumerate(xc.chunk(n_data))]
    skips = []
    for i, name in enumerate(("enc1", "enc2", "enc3", "enc4",
                              "bottleneck")):
        if i:
            cur = [[F.max_pool2d(t, 2) for t in M.gather_if_odd(s, 2)]
                   for s in cur]
        cur = st.block(name, model.dilations[i], cur)
        skips.append(cur)
    skips.pop()
    for n in (4, 3, 2, 1):
        skip = skips.pop()
        up = [u if len(u) == len(s)
              else M.split(u[0], len(s), 2, [t.device for t in s])
              for u, s in zip(st.up(f"upconv{n}", cur), skip)]
        cur = st.block(f"dec{n}", 1, [
            [torch.cat(p, 1) for p in zip(u, s)] for u, s in zip(up, skip)])
    return torch.cat([torch.cat([st.head(t).to(mesh.first) for t in s], 1)
                      for s in cur])


# flax variance_scaling "truncated_normal": a standard normal truncated to
# [-2, 2] has this std; dividing by it makes the kernel's std sqrt(1/fan_in)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_flax_(model: _UNetBase, generator: torch.Generator) -> _UNetBase:
    """Re-initialize `model` in place with the JAX package's initializers
    (flax defaults), drawn from `generator`:
      - conv kernels lecun_normal: truncated normal, std sqrt(1/fan_in),
        fan_in = kh * kw * in_channels; conv biases 0;
      - BatchNorm scale 1, bias 0, running mean 0, running var 1;
      - upconv kernels variance_scaling(1/3, "fan_in", "uniform") on the
        (I, O, 2, 2) kernel with flax's default axes (in = -2, out = -1),
        so fan_in = 2 * I * O and the bound is sqrt(1 / (2 * I * O));
        upconv biases 0.
    The JAX and torch random streams differ; the distributions match."""
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            i, o = mod.weight.shape[:2]
            bound = math.sqrt(3.0 * (1.0 / 3.0) / (2 * i * o))
            mod.weight.uniform_(-bound, bound, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.reset_parameters()
    return model


def fold_batchnorm(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold BatchNorm into the convs of a reference state dict (eval mode).

    For y = BN(conv(x) + b): W' = W * gamma / sqrt(var + eps) per output
    channel, b' = (b - mean) * gamma / sqrt(var + eps) + beta, in float32
    and in the JAX package's operation order (`models/unet.py
    fold_batchnorm`). Returns float32 CPU tensors in the folded layout the
    fast forward consumes:
      {block: {"conv0"/"conv1": {"kernel": HWIO, "bias": (O,)}},
       "upconv{n}": {"kernel": (I, O, 2, 2), "bias"},
       "out_conv": {"kernel": (1, 1, I, O), "bias"}}
    """
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in
          state_dict.items() if not k.endswith("num_batches_tracked")}
    out: Dict[str, Dict] = {}
    for block in _BLOCKS:
        convs = {}
        for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
            scale = sd[f"{block}.{bi}.weight"] / torch.sqrt(
                sd[f"{block}.{bi}.running_var"] + BN_EPS)
            w = sd[f"{block}.{ci}.weight"].permute(2, 3, 1, 0)  # HWIO
            convs[f"conv{i}"] = {
                "kernel": (w * scale).contiguous(),
                "bias": (sd[f"{block}.{ci}.bias"]
                         - sd[f"{block}.{bi}.running_mean"]) * scale
                + sd[f"{block}.{bi}.bias"],
            }
        out[block] = convs
    for n in (4, 3, 2, 1):
        out[f"upconv{n}"] = {"kernel": sd[f"upconv{n}.weight"].contiguous(),
                             "bias": sd[f"upconv{n}.bias"]}
    out["out_conv"] = {
        "kernel": sd["out_conv.weight"].permute(2, 3, 1, 0).contiguous(),
        "bias": sd["out_conv.bias"]}
    return out

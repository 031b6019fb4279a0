"""Device mesh and the split/reassembly helpers of the multi-device forward.

Counterpart of the JAX package's `core/mesh.py`: a ('data', 'space') grid
of devices.
- ``data``: batch data parallelism; each data group (a row of the grid)
  runs the engine's megastep on its own batch slice.
- ``space``: the image height split over the devices of a data group, with
  halo rows handed between neighbouring shards (`halo`; the inference
  forwards `models/unet_fast.py::forward_folded_spmd` and
  `models/unet_int8.py::forward_int8_spmd`, the train-mode forward
  `models/unet.py::forward_sharded`).

The grid holds `torch.device`s, and one device may appear more than once:
a mesh over one card repeated computes every shard's arithmetic on that
card, in turn (the counterpart of the JAX package's virtual CPU mesh).
For the CPU the mesh takes `CPU_SLOTS` logical slots of the one CPU device.

Every helper here is differentiable: a copy between devices (`Tensor.to`)
carries its gradient back, so one autograd graph spans the mesh (the
training step's gradient all-reduce is the backward of the weight copies).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"
# logical CPU slots, as the JAX package's tests give XLA 8 virtual CPU
# devices (tests/conftest.py)
CPU_SLOTS = 8


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """Every visible CUDA card, or `CPU_SLOTS` slots of the CPU."""
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_SLOTS
    if kind != "cuda":
        raise ValueError(f"unsupported device kind {kind!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def norm_device(d) -> torch.device:
    """torch.device of d, with index 0 for a bare "cuda" (a tensor's device
    always carries its index)."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


class Mesh:
    """A (n_data, n_space) grid of devices with named axes."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [[norm_device(d) for d in row] for row in grid]
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.grid),
                                      SPACE_AXIS: len(self.grid[0])}

    def row(self, g: int) -> "Mesh":
        """Data group g as a (1, n_space) mesh."""
        return Mesh([self.grid[g]])

    @property
    def first(self) -> torch.device:
        return self.grid[0][0]

    def distinct(self) -> List[torch.device]:
        """The mesh's devices without repeats, in grid order."""
        out: List[torch.device] = []
        for row in self.grid:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape[DATA_AXIS]}x{self.shape[SPACE_AXIS]}, " \
               f"{[[str(d) for d in r] for r in self.grid]})"


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Union[None, str, Sequence] = None) -> Mesh:
    """Build a ('data', 'space') mesh over `devices` (default: every
    visible CUDA card; "cpu" for the CPU's logical slots; or an explicit
    list, which may repeat a device). All devices go on the data axis by
    default, and a sub-mesh over the first n_data * n_space is allowed."""
    if devices is None or isinstance(devices, str):
        devices = visible_devices(devices or "cuda")
    devices = list(devices)
    n_total = len(devices)
    if n_data is None:
        n_data = n_total // n_space
    need = n_data * n_space
    if need > n_total or need == 0:
        raise ValueError(f"mesh {n_data}x{n_space} needs {need} devices, "
                         f"have {n_total}")
    return Mesh([devices[g * n_space:(g + 1) * n_space]
                 for g in range(n_data)])


def check_batch(mesh: Mesh, batch: int) -> None:
    """The batch must divide over the data axis, as for the JAX package's
    batch sharding (it raises at the device put)."""
    n = mesh.shape[DATA_AXIS]
    if batch % n:
        raise ValueError(f"batch of {batch} images does not divide over the "
                         f"mesh's {n} data groups: the batch dimension "
                         f"should be divisible by {n}")


def split(t: torch.Tensor, n: int, dim: int,
          devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`t` cut into n equal parts along `dim`, part i copied to
    devices[i] in t's memory format (a copy even on t's own device: no
    part aliases t)."""
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"into {n} equal parts")
    return [p.to(d, copy=True, non_blocking=True)
            for p, d in zip(torch.chunk(t, n, dim), devices)]


def split_batch(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """The batch (dim 0) over the data groups, each part on its group's
    first device."""
    check_batch(mesh, t.shape[0])
    return split(t, mesh.shape[DATA_AXIS], 0, [r[0] for r in mesh.grid])


def gather(parts: Sequence[torch.Tensor], dim: int,
           device: torch.device) -> torch.Tensor:
    """Reassemble `parts` in order along `dim` on `device`."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim)


def replicate(mesh: Mesh, build) -> Dict[torch.device, object]:
    """One copy of the params per distinct device: `build(device)` is
    called once for each."""
    return {d: build(d) for d in mesh.distinct()}


def pad_to_data_axis(imgs: torch.Tensor, masks: torch.Tensor,
                     valid: np.ndarray, mesh: Mesh
                     ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """A ragged batch padded to a multiple of the data axis by replicating
    its last sample, the replicas with weight 0 in `valid` (the JAX
    trainer's `_device_batch`): they stay out of the loss, the gradients,
    the BatchNorm statistics and the metrics."""
    pad = -imgs.shape[0] % mesh.shape[DATA_AXIS]
    if not pad:
        return imgs, masks, valid

    def rep(t):
        return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])

    return rep(imgs), rep(masks), np.concatenate(
        [valid, np.zeros(pad, valid.dtype)])


def reduce_to(parts: Sequence[torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """The sum of same-shape `parts` (one per shard, on their devices) on
    `device`, added in shard order (the cross-shard all-reduce)."""
    return torch.stack([p.to(device, non_blocking=True) for p in parts]
                       ).sum(0)


def _zeros_like_rows(s: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """n zero rows (along `dim`) in s's type, device and memory format."""
    shape = list(s.shape)
    shape[dim] = n
    z = s.new_zeros(shape)
    if s.dim() == 4 and not s.is_contiguous() and \
            s.is_contiguous(memory_format=torch.channels_last):
        z = z.contiguous(memory_format=torch.channels_last)
    return z


def halo(shards: Sequence[torch.Tensor], n: int, dim: int
         ) -> List[torch.Tensor]:
    """Each shard with n rows (along `dim`) from the shards above and below
    it prepended and appended, taken from as many neighbours as n needs,
    and zeros past the global edges (SAME padding), as the JAX package's
    `lax.ppermute` halo. Rows cross to the shard's device with a copy;
    every result is a new tensor (torch.cat), aliasing no shard."""
    out = []
    for i, s in enumerate(shards):
        parts = []
        for side in (-1, 1):
            need, j, got = n, i + side, []
            while need > 0 and 0 <= j < len(shards):
                src = shards[j]
                k = min(need, src.shape[dim])
                rows = (src.narrow(dim, src.shape[dim] - k, k) if side < 0
                        else src.narrow(dim, 0, k))
                got.append(rows.to(s.device, non_blocking=True))
                need, j = need - k, j + side
            if need > 0:  # past the global edge
                got.append(_zeros_like_rows(s, dim, need))
            parts.append(got[::-1] if side < 0 else got)
        out.append(torch.cat(parts[0] + [s] + parts[1], dim))
    return out


def gather_if_odd(shards: List[torch.Tensor], dim: int
                  ) -> List[torch.Tensor]:
    """The shards of one data group, or, where a 2x2 pool would cut across
    a seam (an odd number of rows per shard), the group gathered whole
    onto its first shard's device (a one-element list): the levels below
    then run unsharded there."""
    if len(shards) > 1 and shards[0].shape[dim] % 2:
        return [gather(shards, dim, shards[0].device)]
    return shards

"""Device mesh and the split/reassembly helpers of the multi-device forward.

Counterpart of the JAX package's `core/mesh.py`: a ('data', 'space') grid
of devices.
- ``data``: batch data parallelism; each data group (a row of the grid)
  runs the engine's megastep on its own batch slice.
- ``space``: the image height split over the devices of a data group, with
  halo rows handed between neighbouring shards
  (`models/unet_fast.py::forward_folded_spmd`).

The grid holds `torch.device`s, and one device may appear more than once:
a mesh over one card repeated computes every shard's arithmetic on that
card, in turn (the counterpart of the JAX package's virtual CPU mesh).
For the CPU the mesh takes `CPU_SLOTS` logical slots of the one CPU device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

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

"""Per-label pixel counts and coordinate-chunk sums (K3) and its plain
PyTorch version.

Replaces the JAX package's Pallas kernel
`ops/pallas_props.py::component_tables` (an MXU one-hot matmul). For each
label k < cap the table row is

    [pixel count, sum((row >> s) & m) for s in shifts,
                  sum((col >> s) & m) for s in shifts],   m = 2^bits - 1

in exact int32; labels >= cap (and negative labels) are dropped. The
`(shifts, bits)` plan comes from `connected_components._coord_plan(h, w,
force_split=True)`, and the output layout `(B, cap, 1 + 2k)` is the JAX
function's, so the two compare directly. Source of the kernel:
`csrc/component_tables.cu`: one 16-CTA thread-block cluster per image
owns the image's table in distributed shared memory (int32 atomics, one
per run of a label rather than per pixel; each output word stored once, no
memset) up to `cluster_max_cap(k)` labels; larger tables take the same
walk with global atomics. Exact for every cap.
"""

from __future__ import annotations

from typing import Sequence

import torch

from unetdc_tpu_torch.ops import cuda_build as cb

CAP = 5120  # the JAX kernel's table size (HI * LO = 40 * 128)
MAX_SHIFTS = 8  # chunks per axis the CUDA kernel takes


def component_tables_plain(labels: torch.Tensor, shifts: Sequence[int] = (0, 8),
                           bits: int = 8, cap: int = CAP) -> torch.Tensor:
    """Plain version: (B, H, W) int32 labels -> (B, cap, 1+2k) int32."""
    b, h, w = labels.shape
    dev = labels.device
    m = (1 << bits) - 1
    p = torch.arange(h * w, device=dev, dtype=torch.int64)
    rows, cols = p // w, p % w
    feats = torch.stack([torch.ones_like(rows)]
                        + [(rows >> s) & m for s in shifts]
                        + [(cols >> s) & m for s in shifts], -1)
    lab = labels.reshape(b, h * w).to(torch.int64)
    ok = (lab >= 0) & (lab < cap)
    # dropped labels land in a spare row per image that is cut off below
    idx = torch.where(ok, lab, cap) + (cap + 1) * torch.arange(
        b, device=dev)[:, None]
    tab = torch.zeros((b * (cap + 1), feats.shape[1]), dtype=torch.int64,
                      device=dev)
    tab.index_add_(0, idx.reshape(-1), feats.repeat(b, 1))
    return tab.view(b, cap + 1, -1)[:, :cap].to(torch.int32)


def component_tables(labels: torch.Tensor, shifts: Sequence[int] = (0, 8),
                     bits: int = 8, cap: int = CAP) -> torch.Tensor:
    """K3 (see module docstring). CPU tensors take the plain version."""
    shifts = tuple(int(s) for s in shifts)
    if labels.device.type == "cpu":
        return component_tables_plain(labels, shifts, bits, cap)
    if labels.dtype != torch.int32 or labels.dim() != 3 or \
            not labels.is_contiguous():
        raise ValueError("component_tables: labels must be a contiguous "
                         "(B, H, W) int32 tensor")
    if not 1 <= len(shifts) <= MAX_SHIFTS or not 1 <= bits <= 8 or \
            cap < 1 or not all(0 <= s < 32 for s in shifts):
        raise ValueError(f"component_tables: unsupported plan {shifts}, "
                         f"bits={bits}, cap={cap}")
    b, h, w = labels.shape
    nfeat = 1 + 2 * len(shifts)
    if b * h * w == 0:  # nothing to launch for
        return torch.zeros((b, cap, nfeat), dtype=torch.int32,
                           device=labels.device)
    if b > 65535:
        raise ValueError(f"component_tables: batch {b} > 65535")
    out = torch.empty((b, cap, nfeat), dtype=torch.int32,
                      device=labels.device)
    packed = sum(s << (8 * i) for i, s in enumerate(shifts))
    with cb.on_device(labels):
        rc = cb.lib().k3_component_tables(
            labels.data_ptr(), out.data_ptr(), b, h, w, cap, packed,
            len(shifts), bits, cb.stream_of(labels))
    cb.check(rc, "k3_component_tables")
    cb.LAUNCHES["component_tables"] += 1
    return out


def cluster_max_cap(k: int = 2) -> int:
    """Largest cap whose table (1 + 2k features) the kernel keeps in one
    cluster's distributed shared memory; larger caps use global atomics.
    Needs the built library (a machine with the CUDA toolkit)."""
    return cb.lib().k3_cluster_max_cap(k)


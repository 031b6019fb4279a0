"""Connected-component quantification of batched binary masks.

Port of the JAX package's `ops/connected_components.py`: `label_batch`,
`quantify_mask_batch` (with its pre-sieve table), `remove_small_batch` and
`component_areas` (reference quantify_droplets_batch.py: label ->
drop components smaller than min_area -> relabel -> area/centroid table in
raster order), and the single-image library surface: `propagate_roots`,
`label`, `sieve_small_components`, `quantify_mask` and
`quantify_mask_adaptive`. `quantify_mask` sums its table with a scatter
over the component roots (`_quantify_from_roots`), as the JAX function
does, not with K3.

Algorithm (same as the JAX package): each pixel starts with its flat index;
sweeps of segmented min-scans along rows and columns (plus four diagonal
mins for 8-connectivity) propagate the component minimum until nothing
changes, so the root of a component is its first pixel in raster order.
A 2D cumsum of the roots ranks them (labels 1..n in raster order, as
skimage/scipy number them), a second propagation of exactly the same
number of sweeps spreads the ranks, and kernel K3
(`ops/component_tables.py`) sums counts and coordinate chunks per label.

The segmented scans are plain `torch.cummin`/`cummax` with the run-id
offset trick (`_seg_scan_cum`). The fixpoint loop is a Python loop with one
host sync per sweep (`_propagate_counted`); while tracing each sweep counts
`cc.sweeps` and its sync is the span `cc.sync` (`utils/profiling.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from unetdc_tpu_torch.ops.component_tables import CAP, component_tables
from unetdc_tpu_torch.ops.morphology import shift as _shift1d
from unetdc_tpu_torch.utils import profiling

_DIAGONALS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    return _shift1d(_shift1d(x, dy, -2, fill), dx, -1, fill)


def _run_ids(fg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row_rid, col_rid): 1-based index of the foreground run each pixel's
    row/column position belongs to (background keeps the preceding run's
    id). Depends only on the mask, so it is computed once."""
    rids = []
    for dim in (-1, -2):
        start = fg & ~_shift1d(fg, -1, dim, False)
        rids.append(torch.cumsum(start.to(torch.int32), dim=dim,
                                 dtype=torch.int32))
    return rids[0], rids[1]


def _seg_scan_cum(v: torch.Tensor, fg: torch.Tensor, fill, dim: int,
                  reverse: bool, is_min: bool, rid: torch.Tensor, big: int
                  ) -> torch.Tensor:
    """Segmented min/max scan along `dim` (foreground runs are segments) as
    a plain cumulative min/max: with values in [0, big), offsetting by
    -/+ big * run_id makes every other run lose each comparison. `rid` and
    the offsets are int64 when int32 could overflow."""
    v = torch.where(fg, v, torch.full_like(v, fill)).to(rid.dtype)
    sgn = (1 if reverse else -1) if is_min else (-1 if reverse else 1)
    off = (sgn * big) * rid
    u = v + off
    if reverse:
        u = u.flip(dim)
    u = (torch.cummin(u, dim) if is_min else torch.cummax(u, dim)).values
    if reverse:
        u = u.flip(dim)
    return (u - off).to(torch.int32)


def _sweep(lab: torch.Tensor, fg: torch.Tensor, fill, connectivity: int,
           is_min: bool, rids, big: int) -> torch.Tensor:
    """One propagation sweep: forward and backward segmented scans along
    rows, then columns, then (8-connectivity) the four diagonal mins."""
    v = torch.where(fg, lab, torch.full_like(lab, fill))
    for dim, rid in ((-1, rids[0]), (-2, rids[1])):
        v = _seg_scan_cum(v, fg, fill, dim, False, is_min, rid, big)
        v = _seg_scan_cum(v, fg, fill, dim, True, is_min, rid, big)
    if connectivity == 2:
        comb = torch.minimum if is_min else torch.maximum
        m = torch.where(fg, v, torch.full_like(v, fill))
        for dy, dx in _DIAGONALS:
            v = comb(v, _shift2d(m, dy, dx, fill))
    return torch.where(fg, v, lab)


def _scan_setup(fg: torch.Tensor):
    """(rids, big): run ids (int64 when the offset trick's headroom
    h*w + big*(max(h,w)//2 + 1) does not fit int32) and the value bound."""
    h, w = fg.shape[-2:]
    big = h * w + 1
    fits = h * w + big * (max(h, w) // 2 + 1) < 2 ** 31
    rids = _run_ids(fg)
    if not fits:
        rids = tuple(r.to(torch.int64) for r in rids)
    return rids, big


def _propagate_counted(init: torch.Tensor, fg: torch.Tensor, fill,
                       connectivity: int, is_min: bool):
    """Sweep to fixpoint; also return the number of sweeps that changed
    anything (one host sync per sweep)."""
    rids, big = _scan_setup(fg)
    lab, k = init, 0
    while True:
        new = _sweep(lab, fg, fill, connectivity, is_min, rids, big)
        profiling.count("cc.sweeps")
        with profiling.span("cc.sync"):
            changed = bool((new != lab).any())
        if not changed:
            return lab, k
        lab, k = new, k + 1


def _propagate_n(init: torch.Tensor, fg: torch.Tensor, fill,
                 connectivity: int, is_min: bool, n: int) -> torch.Tensor:
    """Exactly `n` sweeps. Sound when `n` is the changing-sweep count of a
    prior propagation over the same mask: the distinguished value (root
    index / rank seeded at the same root) spreads identically."""
    rids, big = _scan_setup(fg)
    lab = init
    for _ in range(n):
        lab = _sweep(lab, fg, fill, connectivity, is_min, rids, big)
    return lab


def _cumsum2d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over each flattened (H, W) image, int32."""
    b, h, w = x.shape
    return torch.cumsum(x.reshape(b, h * w), 1, dtype=torch.int32
                        ).reshape(b, h, w)


def _coord_plan(h: int, w: int, force_split: bool = False):
    """(shifts, bits) for exact int32 per-component coordinate sums at any
    image size; (None, None) when one int32 payload per axis is exact
    (n_pix * max_coord < 2^31). Chunk c of a coordinate is
    (coord >> shifts[c]) & (2^bits - 1), with (2^bits - 1) * n_pix < 2^31.
    `force_split` asks for a split plan even when unsplit would do (the
    table kernel's layout always carries chunks)."""
    n_pix = h * w
    if n_pix >= 2 ** 31:
        raise ValueError(
            f"image {h}x{w} has >= 2^31 pixels: flat int32 pixel indices "
            "overflow; tile the image")
    mc = max(h - 1, w - 1, 1)
    if not force_split and n_pix * mc < 2 ** 31:
        return None, None
    bits = min(8, ((2 ** 31 - 1) // n_pix + 1).bit_length() - 1)
    shifts = tuple(range(0, mc.bit_length(), bits))
    return shifts, bits


def _out_base_bits(h: int, w: int) -> int:
    """log2 of the output base of split coordinate sums: totals leave as
    (lo, hi) int32 pairs with total == hi * 2^obits + lo; 8 ('sum-N-lo' /
    'sum-N-hi') while total >> 8 fits int32, else 16 ('-lo16' / '-hi16')."""
    bound = h * w * max(h - 1, w - 1, 1)
    if bound < 2 ** 39:
        return 8
    if bound < 2 ** 47:
        return 16
    raise ValueError(
        f"image {h}x{w}: coordinate-sum bound {bound} exceeds the 2-limb "
        "int32 output contract (2^47); tile the image")


def _chunks_to_lo_hi(chunks: torch.Tensor, shifts: Sequence[int],
                     obits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (lo, hi) int32 recombination of per-chunk coordinate sums:
    sum_c chunks[..., c] << shifts[c] == hi * 2^obits + lo. `(v << s) &
    mask` is exact mod 2^obits even where the int32 shift wraps."""
    lo = torch.zeros_like(chunks[..., 0])
    hi = torch.zeros_like(chunks[..., 0])
    mask = (1 << obits) - 1
    for c, s in enumerate(shifts):
        v = chunks[..., c]
        if s >= obits:
            hi = hi + (v << (s - obits))
        else:
            hi = hi + (v >> (obits - s))
            lo = lo + ((v << s) & mask)
    return lo, hi


def _chunks_to_total(chunks: torch.Tensor, shifts: Sequence[int]
                     ) -> torch.Tensor:
    """Single-int32 recombination; only when the plan says it fits."""
    tot = torch.zeros_like(chunks[..., 0])
    for c, s in enumerate(shifts):
        tot = tot + (chunks[..., c] << s)
    return tot


def _assemble_quantify(csums: torch.Tensor, n_total: torch.Tensor, hw,
                       min_area, max_labels: int, shifts, bits,
                       want_presieve: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Sieve + relabel + output assembly from per-label sums, batched.

    csums: (B, cap, 1 + 2k) int32 [area, axis-0 chunks, axis-1 chunks] in
    raster-rank order, or (B, cap, 3) [area, sum0, sum1] when `shifts` is
    None. Output keys: 'count', 'total', 'area' and per-axis 'sum-N-lo'
    (bare total), 'sum-N-lo'/'sum-N-hi' (base 256) or
    'sum-N-lo16'/'sum-N-hi16' (base 65536). With `want_presieve`, also the
    table before the sieve, in raster order: 'all_area', 'all_sum-0',
    'all_sum-1' (float32 totals, hi * 2^obits + lo when split: rounded
    above 2^24, as the JAX package's are) and 'all_count'
    (min(total, max_labels))."""
    h, w = hw
    cap = max_labels + 1
    dev = csums.device
    slots = torch.arange(cap, device=dev)
    slot_valid = (slots >= 1) & (slots <= n_total[:, None])
    area = torch.where(slot_valid, csums[..., 0], 0)
    if shifts is None:
        payload = csums
        pre = [csums[..., 1].to(torch.float32),
               csums[..., 2].to(torch.float32)]
    else:
        k = len(shifts)
        obits = _out_base_bits(h, w)
        lo0, hi0 = _chunks_to_lo_hi(csums[..., 1:1 + k], shifts, obits)
        lo1, hi1 = _chunks_to_lo_hi(csums[..., 1 + k:1 + 2 * k], shifts,
                                    obits)
        payload = torch.stack([csums[..., 0], lo0, hi0, lo1, hi1], -1)
        pre = [hi.to(torch.float32) * float(2 ** obits) + lo
               for lo, hi in ((lo0, hi0), (lo1, hi1))]
    keep = slot_valid & (area >= min_area)
    new_label = torch.cumsum(keep.to(torch.int32), 1,
                             dtype=torch.int32) * keep
    out = torch.zeros_like(payload)
    out.scatter_(1, new_label.long()[..., None].expand_as(payload),
                 torch.where(keep[..., None], payload, 0))
    result = {"count": keep.sum(1, dtype=torch.int32), "total": n_total,
              "area": out[:, 1:, 0]}
    if shifts is None:
        result["sum-0-lo"] = out[:, 1:, 1]
        result["sum-1-lo"] = out[:, 1:, 2]
    else:
        suffix = "" if obits == 8 else "16"
        result[f"sum-0-lo{suffix}"] = out[:, 1:, 1]
        result[f"sum-0-hi{suffix}"] = out[:, 1:, 2]
        result[f"sum-1-lo{suffix}"] = out[:, 1:, 3]
        result[f"sum-1-hi{suffix}"] = out[:, 1:, 4]
    if want_presieve:
        result["all_area"] = area[:, 1:]
        for axis in (0, 1):
            result[f"all_sum-{axis}"] = torch.where(slot_valid, pre[axis],
                                                    0.0)[:, 1:]
        result["all_count"] = n_total.clamp_max(max_labels)
    return result


def _quantify_from_table(table: torch.Tensor, n_total: torch.Tensor, hw,
                         min_area, max_labels: int,
                         want_presieve: bool = False):
    """Output dict from the K3 table (chunked per `_coord_plan(h, w,
    force_split=True)`), recombined to bare totals when they fit int32."""
    h, w = hw
    kshifts, kbits = _coord_plan(h, w, force_split=True)
    t = table[:, :max_labels + 1]
    k = len(kshifts)
    img_shifts, _ = _coord_plan(h, w)
    if img_shifts is None:
        csums = torch.stack([t[..., 0],
                             _chunks_to_total(t[..., 1:1 + k], kshifts),
                             _chunks_to_total(t[..., 1 + k:1 + 2 * k],
                                              kshifts)], -1)
        return _assemble_quantify(csums, n_total, hw, min_area, max_labels,
                                  None, None, want_presieve)
    return _assemble_quantify(t, n_total, hw, min_area, max_labels, kshifts,
                              kbits, want_presieve)


def label_batch(masks: torch.Tensor, connectivity: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) masks -> (labels (B, H, W) int32 numbered 1..n in raster
    order of first pixel, n (B,) int32)."""
    b, h, w = masks.shape
    fg = masks.to(torch.bool)
    idx = torch.arange(h * w, dtype=torch.int32, device=masks.device
                       ).reshape(1, h, w).expand(b, h, w)
    roots, n_sweeps = _propagate_counted(idx, fg, h * w, connectivity, True)
    is_root = fg & (roots == idx)
    rank = _cumsum2d(is_root.to(torch.int32))
    labels = _propagate_n(torch.where(is_root, rank, 0), fg, 0, connectivity,
                          False, n_sweeps)
    return (torch.where(fg, labels, 0),
            is_root.sum((1, 2), dtype=torch.int32))


def quantify_mask_batch(masks: torch.Tensor, min_area, max_labels: int,
                        connectivity: int = 1,
                        tables: Optional[Callable] = None,
                        want_presieve: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Per-image droplet tables of (B, H, W) 0/1 masks: label, drop
    components with area < min_area, relabel in raster order, and return
    'count' (B,), 'total' (B,) (exact pre-sieve component count, for
    overflow detection) and (B, max_labels) int32 'area' and coordinate-sum
    tables (see `_assemble_quantify`). Components ranked beyond the table
    are dropped; callers compare 'total' with max_labels.

    `tables` defaults to kernel K3; its plain version gives the reference
    path. `want_presieve` adds the table before the sieve (the heatmaps'
    unsieved centroids) at no second propagation."""
    tables = component_tables if tables is None else tables
    b, h, w = masks.shape
    labels, n_total = label_batch(masks, connectivity)
    kshifts, kbits = _coord_plan(h, w, force_split=True)
    table = tables(labels.contiguous(), kshifts, kbits,
                   cap=max(CAP, max_labels + 1))
    return _quantify_from_table(table, n_total, (h, w), min_area, max_labels,
                                want_presieve)


def component_areas(labels: torch.Tensor, num_segments: int
                    ) -> torch.Tensor:
    """(B, num_segments) int64 pixel count of each label of (B, H, W)
    labels (0 = background); labels outside [0, num_segments) are dropped,
    as by a fixed-size segment sum."""
    flat = labels.flatten(1).long()
    ok = (flat >= 0) & (flat < num_segments)
    out = torch.zeros(flat.shape[0], num_segments + 1, dtype=torch.int64,
                      device=labels.device)
    out.scatter_add_(1, torch.where(ok, flat, num_segments), ok.long())
    return out[:, :num_segments]


def remove_small_batch_counted(masks: torch.Tensor, min_size,
                               max_labels: int, connectivity: int = 2
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the components of (B, H, W) masks smaller than min_size ->
    (bool masks, exact per-image component count (B,) int32).

    As the JAX package's version does, a component ranked beyond
    max_labels in raster order (its area is outside the JAX package's
    fixed table) is kept unexamined, so none disappears silently; the
    exact count lets callers detect that and re-run at a larger cap."""
    b, h, w = masks.shape
    labels, n_total = label_batch(masks, connectivity)
    areas = component_areas(labels, h * w + 1)
    ids = torch.arange(h * w + 1, device=masks.device)
    keep = (ids > max_labels) | (areas >= min_size)
    keep[:, 0] = False
    kept = torch.gather(keep, 1, labels.flatten(1).long()).reshape(b, h, w)
    return kept, n_total


def remove_small_batch(masks: torch.Tensor, min_size, max_labels: int,
                       connectivity: int = 2) -> torch.Tensor:
    """`remove_small_batch_counted` without the count (algorithms.py
    remove_objects, batched)."""
    return remove_small_batch_counted(masks, min_size, max_labels,
                                      connectivity)[0]


def propagate_roots(mask: torch.Tensor, connectivity: int = 1
                    ) -> torch.Tensor:
    """(H, W) int32: the smallest flat index of each pixel's component
    (background pixels keep their own index)."""
    h, w = mask.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device
                       ).reshape(1, h, w)
    roots, _ = _propagate_counted(idx, mask.to(torch.bool)[None], h * w,
                                  connectivity, True)
    return roots[0]


def label(mask: torch.Tensor, connectivity: int = 1
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label the components of one (H, W) mask: (labels int32 numbered
    1..n in raster order of first pixel, 0 for background; n int32).
    connectivity 1 = 4-neighbours, 2 = 8-neighbours."""
    labels, n = label_batch(mask[None], connectivity)
    return labels[0], n[0]


def sieve_small_components(labels: torch.Tensor, min_area: int,
                           num_segments: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the components of an (H, W) label image smaller than
    `min_area` pixels and renumber the rest 1..m in raster order ->
    (labels int32, m int32). `num_segments` must exceed the largest label
    (a larger label reads the id of label num_segments - 1, as the JAX
    package's clamped gather does)."""
    areas = component_areas(labels[None], num_segments)[0]
    keep = areas >= min_area
    keep[0] = False
    new_ids = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) * keep
    return (new_ids[labels.long().clamp(0, num_segments - 1)],
            keep.sum(dtype=torch.int32))


def _quantify_from_roots(masks: torch.Tensor, roots: torch.Tensor, min_area,
                         max_labels: int, want_presieve: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """`_assemble_quantify` output of (B, H, W) masks from their component
    roots: area and coordinate sums (chunked per `_coord_plan`) by one
    scatter over the roots, then gathered at the first max_labels roots
    in raster order."""
    b, h, w = masks.shape
    n_pix = h * w
    cap = max_labels + 1
    dev = masks.device
    fg = masks.to(torch.bool)
    idx = torch.arange(n_pix, dtype=torch.int32, device=dev).reshape(1, h, w)
    is_root = fg & (roots == idx)
    n_total = is_root.sum((1, 2), dtype=torch.int32)
    rank = _cumsum2d(is_root.to(torch.int32))
    keys = torch.where(fg, roots, n_pix).reshape(b, n_pix).long()
    flat = torch.arange(n_pix, dtype=torch.int64, device=dev)
    rows, cols = flat // w, flat % w
    shifts, bits = _coord_plan(h, w)
    if shifts is None:
        cols_ = [torch.ones_like(rows), rows, cols]
    else:
        m = (1 << bits) - 1
        cols_ = ([torch.ones_like(rows)] + [(rows >> s) & m for s in shifts]
                 + [(cols >> s) & m for s in shifts])
    feats = torch.stack(cols_, -1)                       # (n_pix, F)
    nf = feats.shape[1]
    sums = torch.zeros(b, n_pix + 1, nf, dtype=torch.int64, device=dev)
    sums.scatter_add_(1, keys[..., None].expand(b, n_pix, nf),
                      feats.expand(b, n_pix, nf))
    slot = torch.where(is_root & (rank <= max_labels), rank, 0
                       ).reshape(b, n_pix).long()
    compact_root = torch.zeros(b, cap, dtype=torch.int64, device=dev)
    compact_root.scatter_(1, slot, torch.where(slot > 0, flat, 0))
    csums = torch.gather(sums, 1, compact_root[..., None].expand(b, cap, nf))
    return _assemble_quantify(csums.to(torch.int32), n_total, (h, w),
                              min_area, max_labels, shifts, bits,
                              want_presieve)


def quantify_mask(mask: torch.Tensor, min_area, max_labels: int,
                  connectivity: int = 1) -> Dict[str, torch.Tensor]:
    """Component table of one (H, W) mask without a label image: label,
    drop components smaller than min_area, relabel in raster order ->
    'count', 'total' (the exact pre-sieve count) and (max_labels,) int32
    'area' and coordinate-sum tables (keys as `_assemble_quantify`)."""
    roots = propagate_roots(mask, connectivity)
    out = _quantify_from_roots(mask[None], roots[None], min_area, max_labels)
    return {k: v[0] for k, v in out.items()}


def quantify_mask_adaptive(mask: torch.Tensor, min_area,
                           max_labels: int = 4096, connectivity: int = 1
                           ) -> Dict[str, torch.Tensor]:
    """`quantify_mask` whose cap doubles (on the host) until it holds
    every component, so no component is cut off the table."""
    cap = max_labels
    while True:
        stats = quantify_mask(mask, min_area, cap, connectivity)
        total = int(stats["total"])
        if total <= cap:
            return stats
        while cap < total:
            cap *= 2

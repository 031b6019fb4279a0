"""The plain version of K3 (per-label counts and coordinate-chunk sums)
against the JAX package's `component_tables_reference` and its Pallas
kernel in interpret mode: exact, including labels >= CAP (dropped), odd
widths, other chunk plans and tables larger than CAP."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unetdc_tpu.ops.pallas_props import (CAP, component_tables,
                                         component_tables_reference)
from unetdc_tpu_torch.ops import component_tables as CT


def _labels(seed, shape, hi):
    r = np.random.RandomState(seed)
    lab = r.randint(0, hi, shape).astype(np.int32)
    lab[r.rand(*shape) < 0.5] = 0
    return lab


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 50, 96), (2, 40, 70)])
def test_plain_matches_pallas_and_reference(shape):
    lab = _labels(0, shape, CAP + 140)
    ref = np.asarray(component_tables_reference(jnp.asarray(lab)))
    kern = np.asarray(component_tables(jnp.asarray(lab), interpret=True))
    got = CT.component_tables(torch.from_numpy(lab)).numpy()
    assert CT.CAP == CAP and got.shape == ref.shape == (shape[0], CAP, 5)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("shifts,bits", [((0, 7), 7), ((0, 5, 10), 5)])
def test_plain_non_default_plans(shifts, bits):
    lab = _labels(11, (2, 48, 80), 900)
    ref = np.asarray(component_tables_reference(jnp.asarray(lab), shifts,
                                                bits))
    got = CT.component_tables_plain(torch.from_numpy(lab), shifts, bits)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_cap_beyond_5120():
    """Tables larger than the JAX kernel's CAP (the engine's overflow
    re-run): rows below CAP equal the reference, rows above it hold the
    labels the reference drops, and labels >= cap are still dropped."""
    cap = 9000
    lab = _labels(5, (2, 60, 90), cap + 200)
    got = CT.component_tables_plain(torch.from_numpy(lab), cap=cap).numpy()
    ref = np.asarray(component_tables_reference(jnp.asarray(lab)))
    assert got.shape == (2, cap, 5)
    np.testing.assert_array_equal(got[:, :CAP], ref)
    for b in range(2):
        for k in (CAP, 7000, cap - 1):
            ys, xs = np.nonzero(lab[b] == k)
            np.testing.assert_array_equal(
                got[b, k], [len(ys), (ys & 255).sum(), (ys >> 8).sum(),
                            (xs & 255).sum(), (xs >> 8).sum()])
    assert got[:, :, 0].sum() == ((lab >= 0) & (lab < cap)).sum()


def _blob_masks(seed, b, h, w, cell, p=0.9):
    """Seeded masks of small blobs, one in a fraction p of the cell x cell
    tiles (the last row and column of each tile stay empty)."""
    r = np.random.RandomState(seed)
    ch, cw = h // cell, w // cell
    tiles = np.zeros((b, ch, cell, cw, cell), bool)
    for dy in range(cell - 1):
        for dx in range(cell - 1):
            tiles[:, :, dy, :, dx] = r.rand(b, ch, cw) < 0.7
    tiles &= (r.rand(b, ch, 1, cw, 1) < p)
    out = np.zeros((b, h, w), bool)
    out[:, :ch * cell, :cw * cell] = tiles.reshape(b, ch * cell, cw * cell)
    return out


def _labelled(masks):
    from scipy import ndimage as ndi

    return np.stack([ndi.label(m)[0] for m in masks]).astype(np.int32)


def _numpy_tables(lab, shifts, bits, cap):
    """Independent oracle: per-label sums with np.add.at, any cap."""
    b, h, w = lab.shape
    m = (1 << bits) - 1
    rows, cols = np.indices((h, w)).reshape(2, -1)
    feats = np.stack([np.ones_like(rows)] + [(rows >> s) & m for s in shifts]
                     + [(cols >> s) & m for s in shifts], -1)
    out = np.zeros((b, cap, feats.shape[1]), np.int64)
    for i in range(b):
        flat = lab[i].reshape(-1)
        ok = (flat >= 0) & (flat < cap)
        np.add.at(out[i], flat[ok], feats[ok])
    return out.astype(np.int32)


def _whole_rows():
    lab = np.zeros((1, 40, 70), np.int32)
    lab[0, 5:9] = 1
    lab[0, 20] = 2
    lab[0, 30:] = 3
    return lab


SCIPY_CASES = {
    # name: (labels, shifts, bits, cap)
    "droplets_64x64": (lambda: _labelled(_blob_masks(0, 2, 64, 64, 6)),
                       (0, 8), 8, CAP),
    "random_fg_97": (lambda: _labelled(np.random.RandomState(1).rand(
        2, 45, 97) < 0.35), (0, 8), 8, CAP),
    "droplets_plan_5": (lambda: _labelled(_blob_masks(2, 2, 48, 80, 4)),
                        (0, 5, 10), 5, CAP),
    "b1_whole_rows": (_whole_rows, (0, 8), 8, CAP),
    "one_component": (lambda: np.ones((2, 30, 50), np.int32), (0, 8), 8,
                      CAP),
    "over_cap_5120_at_9000": (lambda: _labelled(_blob_masks(3, 1, 240, 240,
                                                            3)),
                              (0, 8), 8, 9000),
}


@pytest.mark.parametrize("name", list(SCIPY_CASES))
def test_plain_on_scipy_labels(name):
    """The plain K3 on raster-ranked scipy labels (runs of one label, as the
    engine produces) against the JAX reference and, for the rows the JAX
    table holds (labels < CAP), the Pallas kernel in interpret mode; the
    whole table against a numpy oracle (rows >= CAP at cap 9000 too)."""
    make, shifts, bits, cap = SCIPY_CASES[name]
    lab = make()
    got = CT.component_tables_plain(torch.from_numpy(lab), shifts, bits,
                                    cap).numpy()
    np.testing.assert_array_equal(got, _numpy_tables(lab, shifts, bits, cap))
    ref = np.asarray(component_tables_reference(jnp.asarray(lab), shifts,
                                                bits))
    kern = np.asarray(component_tables(jnp.asarray(lab), shifts, bits,
                                       interpret=True))
    np.testing.assert_array_equal(got[:, :CAP], ref)
    np.testing.assert_array_equal(got[:, :CAP], kern)
    if name.startswith("over_cap"):
        assert lab.max() > CAP and got[:, CAP:, 0].sum() > 0

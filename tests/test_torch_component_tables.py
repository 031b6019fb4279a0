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

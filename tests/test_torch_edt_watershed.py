"""The port's EDT, device watershed, device peak finder and host watershed
(`unetdc_tpu_torch/ops/edt.py`, `ops/watershed.py`) against the JAX
package's on the same seeded inputs, on the CPU. Every output here is
integer or exact (squared distances are integers in float32), so each is
held to equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from unetdc_tpu.ops import edt as JE
from unetdc_tpu.ops import watershed as JW
from unetdc_tpu_torch.ops import edt as TE
from unetdc_tpu_torch.ops import watershed as TW


def _discs(seed, shape, n=12, rmin=9, rmax=64):
    """Overlapping discs: wide integer plateaus in the EDT."""
    r = np.random.RandomState(seed)
    m = np.zeros(shape, bool)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(n):
        cy = r.randint(6, shape[0] - 6)
        cx = r.randint(6, shape[1] - 6)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r.randint(rmin, rmax)
    return m


@pytest.mark.parametrize("shape,p", [((40, 56), 0.7), ((64, 80), 0.3),
                                     ((96, 64), 0.95), ((33, 47), 0.5),
                                     ((8, 8), 0.0), ((70, 3), 1.0)])
def test_edt_sq_equals_jax_and_scipy(shape, p):
    m = np.random.RandomState(sum(shape)).rand(*shape) < p
    ours = TE.distance_transform_edt_sq(torch.from_numpy(m)).numpy()
    jx = np.asarray(JE.distance_transform_edt_sq(jnp.asarray(m)))
    np.testing.assert_array_equal(ours, jx)
    if 0 < p < 1:
        np.testing.assert_array_equal(
            ours, np.round(ndi.distance_transform_edt(m) ** 2))
    np.testing.assert_array_equal(
        TE.distance_transform_edt(torch.from_numpy(m)).numpy(),
        np.asarray(JE.distance_transform_edt(m)))


def test_edt_chunks_bound_the_broadcast(monkeypatch):
    """A tall image takes several row chunks; the result is unchanged."""
    m = _discs(3, (160, 40))
    whole = TE.distance_transform_edt_sq(torch.from_numpy(m))
    monkeypatch.setattr(TE, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(
        TE.distance_transform_edt_sq(torch.from_numpy(m)).numpy(),
        whole.numpy())


@pytest.mark.parametrize("seed,shape,max_peaks", [
    (0, (48, 64), 512), (5, (64, 64), 512), (9, (40, 96), 512),
    (1, (16, 14), 1024)])
def test_peak_local_max_device_equals_jax_on_plateaus(seed, shape,
                                                      max_peaks):
    """Coordinates and valid flags equal JAX's, on plateaued squared EDTs
    (ties everywhere: the stable sort's raster order decides). On an image
    of fewer pixels than max_peaks the JAX function fails to broadcast;
    the port returns one row a pixel, and is held to the host finder."""
    m = _discs(seed, shape, n=12 if shape[0] > 20 else 2, rmin=4,
               rmax=64 if shape[0] > 20 else 9)
    d2 = np.array(JE.distance_transform_edt_sq(jnp.asarray(m)))
    tc, tv = TE.peak_local_max_device(torch.from_numpy(d2),
                                      torch.from_numpy(m), 3, max_peaks)
    if m.size >= max_peaks:
        jc, jv = JE.peak_local_max_device(jnp.asarray(d2), jnp.asarray(m),
                                          3, max_peaks)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        assert tc.shape == (m.size, 2)
    assert tv.any()
    # and the host implementation's sequence
    ref = JW.peak_local_max(d2, labels=m, min_distance=3)
    np.testing.assert_array_equal(tc.numpy()[tv.numpy()], ref)


def test_peak_local_max_device_distinct_values(rng):
    img = ndi.gaussian_filter(rng.rand(64, 80), 3).astype(np.float32)
    region = rng.rand(64, 80) > 0.2
    jc, jv = JE.peak_local_max_device(jnp.asarray(img), jnp.asarray(region),
                                      2, 256)
    tc, tv = TE.peak_local_max_device(torch.from_numpy(img),
                                      torch.from_numpy(region), 2, 256)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _markers_heights(m):
    d2 = np.array(JE.distance_transform_edt_sq(jnp.asarray(m)))
    coords = JW.peak_local_max(np.sqrt(d2), labels=m, min_distance=3)
    peaks = np.zeros_like(m)
    peaks[tuple(coords.T)] = True
    markers, _ = ndi.label(peaks)
    return (int(d2.max()) - d2.astype(np.int32)).astype(np.int32), \
        markers.astype(np.int32)


@pytest.mark.parametrize("case", ["touching", "discs", "terrain"])
def test_watershed_device_equals_jax(case):
    """Labels torch.equal to JAX's while_loop fixpoint: two touching
    blobs, many overlapping discs, and smooth terrain (captured basins,
    long relaxations past several host checks)."""
    if case == "touching":
        m = np.zeros((48, 72), bool)
        yy, xx = np.mgrid[:48, :72]
        m |= (yy - 24) ** 2 + (xx - 24) ** 2 <= 100
        m |= (yy - 24) ** 2 + (xx - 43) ** 2 <= 100
        height, markers = _markers_heights(m)
    elif case == "discs":
        m = _discs(2, (64, 80))
        height, markers = _markers_heights(m)
    else:
        r = np.random.RandomState(3)
        field = ndi.gaussian_filter(r.rand(96, 96), 4)
        m = field > np.percentile(field, 55)
        height = (1000 * (field.max() - field)).astype(np.int32)
        coords = JW.peak_local_max(field * m, labels=m, min_distance=3)
        peaks = np.zeros_like(m)
        peaks[tuple(coords.T)] = True
        markers = ndi.label(peaks)[0].astype(np.int32)
    jx = np.asarray(JE.watershed_device(jnp.asarray(height),
                                        jnp.asarray(markers),
                                        jnp.asarray(m)))
    ours = TE.watershed_device(torch.from_numpy(height),
                               torch.from_numpy(markers),
                               torch.from_numpy(m))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), jx)
    assert len(np.unique(jx)) > 2


@pytest.mark.parametrize("shape", [(40, 60), (72, 96), "touching"])
def test_watershed_custom_equals_jax(shape):
    """Below 64x64 pixels the EDT is scipy's, above it the device's f32
    sqrt: the port dispatches at the same size, so dots and labels are
    equal on both sides (plateau ties included); two overlapping circles
    split into two basins."""
    if shape == "touching":
        m = np.zeros((40, 60), bool)
        yy, xx = np.mgrid[:40, :60]
        m |= (yy - 20) ** 2 + (xx - 20) ** 2 <= 81
        m |= (yy - 20) ** 2 + (xx - 36) ** 2 <= 81
    else:
        m = _discs(7, shape, n=6, rmin=30, rmax=120)
    dots = [[int(y), int(x)] for y, x in np.argwhere(m)][::3] + [[0, 0]]
    jd, jl = JW.watershed_custom(m, dots)
    td, tl = TW.watershed_custom(m, dots, device="cpu")
    assert (td, tl) == (jd, jl)
    assert len(set(tl)) == 2 if shape == "touching" else len(set(tl)) >= 2


def test_host_edt_dispatch_matches_jax():
    for shape in [(20, 30), (64, 64), (70, 90)]:
        m = _discs(4, shape, n=4, rmin=20, rmax=80)
        ours = TW.distance_transform_edt(m, device="cpu")
        assert ours.dtype == np.float64
        np.testing.assert_array_equal(ours, JW.distance_transform_edt(m))


def test_native_flood_equals_python_and_jax():
    """The native flood (tracked libalgo.so, or built) equals the Python
    heap flood and the JAX package's flood, with tie-heavy heights and
    markers outside the mask (dropped)."""
    assert TW._load_algo() is not None
    r = np.random.RandomState(7)
    for _ in range(4):
        H, W = r.randint(24, 64), r.randint(24, 64)
        mask = r.rand(H, W) > 0.4
        height = -r.randint(0, 6, (H, W)).astype(np.float64)
        markers = np.where((r.rand(H, W) > 0.92) & mask,
                           r.randint(1, 7, (H, W)), 0).astype(np.int32)
        m2 = markers.copy()
        m2[~mask] = 5
        for mk in (markers, m2):
            ours = TW.watershed(height, mk, mask)
            np.testing.assert_array_equal(
                ours, TW.watershed_python(height, mk, mask))
            np.testing.assert_array_equal(ours, JW.watershed(height, mk,
                                                             mask))
    assert TW.return_labeling_algorithms() == JW.return_labeling_algorithms()


@pytest.mark.parametrize("min_distance", [0, 1, 3, 5])
def test_greedy_spacing_equals_pairwise_rule(min_distance):
    """The blocked-map greedy keeps exactly the candidates the JAX
    package's pairwise loop keeps (Chebyshev distance < min_distance to a
    kept one rejects), on dense candidate sets near the borders."""
    r = np.random.RandomState(min_distance)
    coords = r.randint(0, 30, (400, 2))
    coords = np.unique(coords, axis=0)[r.permutation(
        len(np.unique(coords, axis=0)))]
    kept = []
    for c in coords:
        if all(np.max(np.abs(c - a)) >= min_distance for a in kept):
            kept.append(c)
    ours = coords[TW.greedy_spacing(coords, (30, 30), min_distance)]
    np.testing.assert_array_equal(ours, np.array(kept))

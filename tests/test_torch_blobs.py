"""The port's blob detectors (`unetdc_tpu_torch/ops/blobs.py`) and its
Gaussian-derivative filter against the JAX package's on the same seeded
inputs, on the CPU.

Tolerances: the exact-operator cubes (LoG, DoG, DoH) and the derivative
filter follow the JAX package's tap-chain rounding and are held at
atol 1e-6 (float32 responses of order 1; in practice they agree to an
ulp or two). The SURF box-filter cube `_doh_cube_approx` follows XLA's
CPU summation order and fusions and is held to equality, also at
600x800 where its integral image passes 2^24. Blob lists, local maxima
and pruning are held to equality on the fixtures."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from unetdc_tpu.ops import blobs as JB
from unetdc_tpu.ops.filters import gaussian_derivative_scipy as j_gds
from unetdc_tpu_torch.ops import blobs as TB
from unetdc_tpu_torch.ops.filters import gaussian_derivative_scipy as t_gds


def _planted_image(rng, shape=(72, 72), n=3, sig_range=(2.0, 5.0)):
    """Well-separated Gaussian bumps (tests/test_blobs_oracle.py)."""
    h, w = shape
    img = np.zeros(shape, np.float64)
    yy, xx = np.mgrid[:h, :w]
    centers = []
    for _ in range(n):
        for _try in range(100):
            cy = rng.randint(12, h - 12)
            cx = rng.randint(12, w - 12)
            if all((cy - a) ** 2 + (cx - b) ** 2 > 24 ** 2
                   for a, b in centers):
                break
        centers.append((cy, cx))
        s = rng.uniform(*sig_range)
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def test_gaussian_derivative_equals_jax_every_order(rng):
    img = rng.rand(33, 47).astype(np.float32)
    for s in (1.0, 2.7, 5.0):
        for oy, ox in [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2)]:
            ours = t_gds(torch.from_numpy(img), s, oy, ox).numpy()
            jx = np.asarray(j_gds(jnp.asarray(img), s, oy, ox))
            np.testing.assert_allclose(ours, jx, rtol=0, atol=1e-6,
                                       err_msg=f"s={s} ({oy},{ox})")
            ref = ndi.gaussian_filter(img.astype(np.float64), s,
                                      order=(oy, ox), mode="reflect")
            np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("cube,sigmas,tol", [
    ("_log_cube", (1.0, 2.0, 3.5), dict(rtol=0, atol=1e-6)),
    ("_log_cube", (1.5, 4.0, 8.0), dict(rtol=0, atol=1e-6)),
    ("_dog_cube", (1.0, 2.0, 4.0), dict(rtol=0, atol=1e-6)),
    ("_dog_cube", (2.0, 3.2, 5.12, 8.192), dict(rtol=0, atol=1e-6)),
    ("_doh_cube", (1.5, 3.0), dict(rtol=0, atol=1e-6)),
    ("_doh_cube", (2.0, 4.0, 6.0), dict(rtol=0, atol=1e-6)),
    ("_doh_cube_approx", (2.0, 3.0, 5.0), dict(rtol=0, atol=0)),
])
def test_cube_equals_jax(rng, cube, sigmas, tol):
    img = rng.rand(40, 52).astype(np.float32)
    ours = getattr(TB, cube)(torch.from_numpy(img), sigmas).numpy()
    jx = np.asarray(getattr(JB, cube)(jnp.asarray(img), sigmas))
    assert ours.shape == jx.shape
    np.testing.assert_allclose(ours, jx, **tol)


def test_doh_cube_approx_large_sums_equal_jax(rng):
    """600x800 at uint8 range: the integral image passes 2^24, where the
    summation order rounds and the box sums cancel; the cube is equal to
    JAX's, and a library cumsum would not be."""
    from unetdc_tpu_torch.ops import threshold as T

    img = (rng.rand(600, 800) * 255).astype(np.float32)
    ours = TB._doh_cube_approx(torch.from_numpy(img), (3.0,)).numpy()
    jx = np.asarray(JB._doh_cube_approx(jnp.asarray(img), (3.0,)))
    np.testing.assert_array_equal(ours, jx)
    lib = torch.cumsum(torch.cumsum(torch.from_numpy(img), 0), 1)
    assert not torch.equal(lib, T.cumsum_xla_cpu(
        T.cumsum_xla_cpu(torch.from_numpy(img).T).T))


def test_host_helpers_equal_jax(rng):
    cube = np.round(rng.rand(4, 12, 14) * 8) / 8.0
    np.testing.assert_array_equal(TB._local_maxima_3d(cube, 0.25),
                                  JB._local_maxima_3d(cube, 0.25))
    for _ in range(50):
        r1, r2 = rng.uniform(0.5, 8, 2)
        d = rng.uniform(0, 10)
        assert TB._disk_overlap_fraction(d, r1, r2) == \
            JB._disk_overlap_fraction(d, r1, r2)
    for _ in range(10):
        n = rng.randint(0, 12)
        blobs = np.column_stack([
            rng.uniform(0, 40, n), rng.uniform(0, 40, n),
            rng.uniform(0.5, 6, n), rng.uniform(0, 1, n)])
        np.testing.assert_array_equal(TB._prune_overlap(blobs.copy()),
                                      JB._prune_overlap(blobs.copy()))
    for s in (1.0, 2.5, 7.3):
        assert TB._surf_geometry(s) == JB._surf_geometry(s)


@pytest.mark.parametrize("kind,seed,kw", [
    ("log", 0, dict(min_sigma=1.0, max_sigma=6.0, num_sigma=6,
                    threshold=0.05)),
    ("log", 2, dict(min_sigma=1.5, max_sigma=5.0, num_sigma=8,
                    threshold=0.05)),
    ("dog", 3, dict(min_sigma=1.0, max_sigma=8.0, sigma_ratio=1.6,
                    threshold=0.02)),
    ("dog", 4, dict(min_sigma=1.5, max_sigma=10.0, sigma_ratio=1.4,
                    threshold=0.02)),
    ("doh", 5, dict(min_sigma=2.0, max_sigma=8.0, num_sigma=7,
                    threshold=1e-4)),
    ("doh", 6, dict(min_sigma=1.5, max_sigma=6.0, num_sigma=10,
                    threshold=1e-4)),
    ("doh_approx", 8, dict(min_sigma=2.0, max_sigma=8.0, num_sigma=7,
                           threshold=0.005, approximate=True)),
])
def test_blob_lists_equal_jax(kind, seed, kw):
    img = _planted_image(np.random.RandomState(seed),
                         sig_range=(2.5, 5.0) if "doh" in kind
                         else (2.0, 5.0))
    name = "blob_" + kind.split("_")[0]
    ours = getattr(TB, name)(img, device="cpu", **kw)
    jx = getattr(JB, name)(img, **kw)
    assert len(jx) >= 2
    np.testing.assert_array_equal(ours, jx)


@pytest.mark.parametrize("algo", [0, 1, 2, 3])
def test_blobs_detection_and_mask_equal_jax(algo):
    """The library dispatch (radius <-> sigma) on a noisy image with
    planted blobs, and the painted mask."""
    r = np.random.RandomState(10 + algo)
    img = _planted_image(r, shape=(64, 72), sig_range=(2.0, 4.0))
    img = img + 0.05 * r.rand(*img.shape).astype(np.float32)
    ours = TB.blobs_detection(img, algo, 2, 6, device="cpu")
    jx = JB.blobs_detection(img, algo, 2, 6)
    if algo == 0:
        assert ours is None and jx is None
        return
    assert len(jx) >= 1
    np.testing.assert_array_equal(ours, jx)
    np.testing.assert_array_equal(TB.blobs_mask(img, ours),
                                  JB.blobs_mask(img, jx))
    assert TB.return_blobs_algorithms() == JB.return_blobs_algorithms()


def test_blob_detectors_find_planted_blobs():
    img = np.zeros((64, 64), np.float32)
    yy, xx = np.mgrid[:64, :64]
    centers = [(16, 16), (40, 44)]
    for cy, cx in centers:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0 ** 2))
    blobs = TB.blobs_detection(img, 1, 2, 6, device="cpu")
    found = {tuple(np.round(b[:2]).astype(int)) for b in blobs}
    for c in centers:
        assert any(abs(f[0] - c[0]) <= 2 and abs(f[1] - c[1]) <= 2
                   for f in found), (c, found)
    # radii (sigma * sqrt(2)) within the asked range
    assert ((blobs[:, 2] >= 2 - 1e-9) & (blobs[:, 2] <= 6 + 1e-9)).all()

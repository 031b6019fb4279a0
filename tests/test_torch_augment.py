"""The port's augmentation against the JAX package's, on the CPU. The two
draw from different random streams, so the port's apply step is fed JAX's
own draws (the key splits of `_augment_one`, repeated here): the elastic
field against `_elastic_displacement` and the frozen golden, the sub-pixel
remap against the golden, whole batches against `augment_batch`; and
`gaussian_filter_scipy` against scipy."""

import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from unetdc_tpu.data import augment as JA
from unetdc_tpu_torch.data import augment as TA
from unetdc_tpu_torch.ops.filters import gaussian_filter_scipy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "elastic_golden.npz")
ATOL = 1e-6


def _jax_noise(key, hw, sigma=50.0):
    """The uniform fields `_elastic_displacement` draws: (noise_y, noise_x)."""
    kx, ky = jax.random.split(key)
    ns = TA.noise_shape(hw, sigma)
    nx = jax.random.uniform(kx, ns, minval=-1.0, maxval=1.0)
    ny = jax.random.uniform(ky, ns, minval=-1.0, maxval=1.0)
    return torch.tensor(np.asarray(ny)), torch.tensor(np.asarray(nx))


def _jax_draws(key, batch, hw, p):
    """`augment_batch`'s per-sample draws, as an `AugmentDraws`."""
    cols = {f.name: [] for f in TA.AugmentDraws.__dataclass_fields__.values()}
    for k in jax.random.split(key, batch):
        keys = jax.random.split(k, 9)
        cols["hflip"].append(bool(jax.random.uniform(keys[0]) < p[0]))
        cols["vflip"].append(bool(jax.random.uniform(keys[1]) < p[1]))
        do_r = bool(jax.random.uniform(keys[2]) < p[2])
        kk = int(jax.random.randint(keys[3], (), 0, 4))
        cols["rot_k"].append(kk if do_r else 0)
        cols["bc"].append(bool(jax.random.uniform(keys[4]) < p[3]))
        cols["contrast"].append(float(1.0 + jax.random.uniform(
            keys[5], minval=-0.2, maxval=0.2)))
        cols["brightness"].append(float(jax.random.uniform(
            keys[6], minval=-0.2, maxval=0.2)))
        cols["elastic"].append(bool(jax.random.uniform(keys[7]) < p[4]))
        ny, nx = _jax_noise(keys[8], hw)
        cols["noise_y"].append(ny)
        cols["noise_x"].append(nx)
    return TA.AugmentDraws(
        hflip=torch.tensor(cols["hflip"]), vflip=torch.tensor(cols["vflip"]),
        rot_k=torch.tensor(cols["rot_k"]), bc=torch.tensor(cols["bc"]),
        contrast=torch.tensor(cols["contrast"], dtype=torch.float32),
        brightness=torch.tensor(cols["brightness"], dtype=torch.float32),
        elastic=torch.tensor(cols["elastic"]),
        noise_x=torch.stack(cols["noise_x"]),
        noise_y=torch.stack(cols["noise_y"]))


@pytest.mark.parametrize("key,hw,names", [
    (1234, (48, 48), ("small_dy", "small_dx")),
    (5678, (256, 256), ("big_dy", "big_dx"))])
def test_field_matches_jax_and_golden(key, hw, names):
    """48x48: the full-resolution path (radius-200 blur); 256x256: the
    stride-4 coarse grid and its bilinear upsampling."""
    g = np.load(GOLDEN)
    ny, nx = _jax_noise(jax.random.PRNGKey(key), hw)
    dy, dx = TA.elastic_field(ny, nx, hw, 1.0, 50.0)
    jdy, jdx = JA._elastic_displacement(jax.random.PRNGKey(key), hw, 1.0,
                                        50.0)
    for got, ref, gold in ((dy, jdy, g[names[0]]), (dx, jdx, g[names[1]])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), gold, atol=ATOL)


def test_coarse_field_edges_match_jax_resize():
    """A non-square image whose size is not a multiple of the stride: the
    upsampling's borders and the crop."""
    hw = (200, 140)
    assert TA.field_stride(hw, 50.0) == 2
    ny, nx = _jax_noise(jax.random.PRNGKey(9), hw)
    dy, dx = TA.elastic_field(ny, nx, hw, 1.0, 50.0)
    jdy, jdx = JA._elastic_displacement(jax.random.PRNGKey(9), hw, 1.0, 50.0)
    np.testing.assert_allclose(dy.numpy(), np.asarray(jdy), atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=ATOL)


def test_remap_matches_golden():
    """Sub-pixel remap: nearest exact, bilinear within 1e-6."""
    g = np.load(GOLDEN)
    dy = torch.from_numpy(g["small_dy"])[None]
    dx = torch.from_numpy(g["small_dx"])[None]
    img = TA.remap_subpixel(torch.from_numpy(g["img"])[None], dy, dx,
                            nearest=False)
    mask = TA.remap_subpixel(torch.from_numpy(g["mask"])[None], dy, dx,
                             nearest=True)
    np.testing.assert_allclose(img[0].numpy(), g["warp_img"], atol=ATOL)
    np.testing.assert_array_equal(mask[0].numpy(), g["warp_mask"])


def test_gather_remap_matches_jax():
    """The remap for displacements beyond one pixel (elastic alpha > 1)."""
    r = np.random.RandomState(2)
    img = r.rand(1, 20, 24, 3).astype(np.float32)
    dy = r.uniform(-3, 3, (1, 20, 24)).astype(np.float32)
    dx = r.uniform(-3, 3, (1, 20, 24)).astype(np.float32)
    yy = jnp.arange(20, dtype=jnp.float32)[:, None] + dy[0]
    xx = jnp.arange(24, dtype=jnp.float32)[None, :] + dx[0]
    t = [torch.from_numpy(a) for a in (img, dy, dx)]
    np.testing.assert_allclose(
        TA._remap_gather(*t, nearest=False)[0].numpy(),
        np.asarray(JA._remap_bilinear(jnp.asarray(img[0]), yy, xx)),
        atol=ATOL)
    np.testing.assert_array_equal(
        TA._remap_gather(*t, nearest=True)[0].numpy(),
        np.asarray(JA._remap_nearest(jnp.asarray(img[0]), yy, xx)))


# (JAX key, image size, probabilities (hflip, vflip, rot90, bc, elastic));
# with p_rot90 = 1 each key's batch of 8 draws every k in 0..3
CASES = [
    (101, 32, (0.5, 0.5, 1.0, 1.0, 1.0)),   # full-resolution field
    (103, 32, (0.5, 0.5, 1.0, 1.0, 0.0)),   # no elastic: the clip shows
    (109, 128, (0.5, 0.5, 1.0, 1.0, 1.0)),  # stride-2 field
    (110, 128, (0.5, 0.2, 0.5, 0.2, 0.3)),  # the trainer's probabilities
]


@pytest.mark.parametrize("key,size,p", CASES)
def test_apply_matches_augment_batch(key, size, p):
    """Whole batches against `augment_batch` given its own draws; the
    batches of 8 cover rot90 k = 0..3 and the brightness/contrast clip
    (bright images pushed past 1)."""
    r = np.random.RandomState(key)
    img = (r.rand(8, size, size, 3) * 0.4 + 0.6).astype(np.float32)
    mask = (r.rand(8, size, size) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(key)
    draws = _jax_draws(key, 8, (size, size), p)
    if p[2] == 1.0:
        assert set(draws.rot_k.tolist()) == {0, 1, 2, 3}
    ji, jm = JA.augment_batch(key, jnp.asarray(img), jnp.asarray(mask),
                              p_hflip=p[0], p_vflip=p[1], p_rot90=p[2],
                              p_bc=p[3], p_elastic=p[4])
    ti, tm = TA.apply_augment(torch.from_numpy(img), torch.from_numpy(mask),
                              draws)
    if p[3] == 1.0 and p[4] == 0.0:
        assert float(ti.max()) == 1.0          # the clip was exercised
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_draws_consume_a_fixed_stream():
    """The same generator state gives the same draws, and the stream after
    a batch does not depend on the decisions taken."""
    hw = (64, 64)
    a = TA.draw_augment(torch.Generator().manual_seed(3), 4, hw)
    b = TA.draw_augment(torch.Generator().manual_seed(3), 4, hw)
    for f in TA.AugmentDraws.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f))
    nxt = []
    for pr in (0.0, 1.0):
        g = torch.Generator().manual_seed(4)
        TA.draw_augment(g, 4, hw, p_hflip=pr, p_vflip=pr, p_rot90=pr,
                        p_bc=pr, p_elastic=pr)
        nxt.append(torch.rand(3, generator=g))
    assert torch.equal(*nxt)
    assert a.noise_x.shape == (4, 64, 64) and a.noise_x.abs().max() <= 1


@pytest.mark.parametrize("shape,sigma", [((48, 48), 50.0), ((64, 64), 6.25),
                                         ((7, 30), 12.0), ((33, 20), 1.5)])
def test_gaussian_filter_matches_scipy(shape, sigma):
    x = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
    ref = ndi.gaussian_filter(x.astype(np.float64), sigma, mode="reflect",
                              truncate=4.0)
    got = gaussian_filter_scipy(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)

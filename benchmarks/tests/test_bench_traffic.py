"""The seeded generators: the same seed gives the same inputs, and the
stated droplet counts and areas are what is drawn."""

import numpy as np

from bench_small import core
from traffic import droplet_images, droplet_pairs


def images(seed, n=6):
    p = dict(core.load_json("workloads", "unetdc.quantify")["traffic"]
             ["images"], n=n)
    return p, droplet_images.make_images(p, seed)


def test_images_are_seed_deterministic():
    _, (a, da) = images(2 ** 31 + 5)
    _, (b, db) = images(2 ** 31 + 5)
    _, (c, _) = images(2 ** 31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and da == db
    assert not np.array_equal(a[0], c[0])


def test_images_hold_the_stated_droplets():
    p, (imgs, drops) = images(11, n=6)
    counts = sorted(len(d) for d in drops)
    assert counts == sorted(np.rint(np.linspace(10, 300, 6)).astype(int))
    for img, d in zip(imgs, drops):
        assert img.shape == (1024, 1024, 3) and img.dtype == np.uint8
        assert np.array_equal(img[..., 0], img[..., 2])
        areas = np.pi * np.array([r for _, _, r in d]) ** 2
        assert areas.min() >= 100 - 1e-6 and areas.max() <= 3300 + 1e-6
        # the droplets cover about the stated total (clipping aside)
        assert 0.5 * p["total_area_px"] <= areas.sum() <= \
            1.5 * p["total_area_px"]


def test_the_seed_keeps_the_work():
    """Another seed gives the same multiset of counts and areas."""
    _, (_, d1) = images(1)
    _, (_, d2) = images(99)
    key = [sorted(round(r, 6) for _, _, r in d) for d in d1]
    key2 = [sorted(round(r, 6) for _, _, r in d) for d in d2]
    assert sorted(map(tuple, key)) == sorted(map(tuple, key2))


def test_pairs_are_seed_deterministic_and_masks_match(tmp_path):
    p = dict(core.load_json("workloads", "unetdc.train")["traffic"]["pairs"])
    rng = droplet_images.rng_for(5, 1000)
    img, mask = droplet_pairs.draw_pair(rng, p)
    img2, mask2 = droplet_pairs.draw_pair(droplet_images.rng_for(5, 1000), p)
    assert np.array_equal(img, img2) and np.array_equal(mask, mask2)
    assert img.shape == (512, 512, 3) and set(np.unique(mask)) == {0, 255}
    inside = img[mask > 0].astype(int).mean()
    outside = img[mask == 0].astype(int).mean()
    assert inside > outside + 60
    d = droplet_pairs.write_pairs(str(tmp_path), dict(p, n=3), 5)
    assert d[2] == ["sample000.png", "sample001.png", "sample002.png"]

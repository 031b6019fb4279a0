"""The port's dataset against the JAX package's and sklearn's, on the CPU:
the 60/20/20 split for n = 3..60 (and sklearn's refusal below that), and
batches equal to `SegmentationData`'s (order, size buckets, ragged tail,
binarized masks)."""

import numpy as np
import pytest
from PIL import Image
from sklearn.model_selection import train_test_split

from unetdc_tpu.data import dataset as JD
from unetdc_tpu_torch.data import dataset as TD


@pytest.mark.parametrize("n", range(3, 61))
def test_split_equals_sklearn_and_jax(n):
    names = [f"img{i:03d}.png" for i in range(n)]
    masks = [f"m{i:03d}.png" for i in range(n)]
    got = TD.split_dataset(names, masks)
    assert got == JD.split_dataset(names, masks)
    tv, te = train_test_split(list(zip(names, masks)), test_size=0.2,
                              random_state=42)
    tr, va = train_test_split(tv, test_size=0.25, random_state=42)
    for part, ref in zip(got, (tr, va, te)):
        assert part == ([p[0] for p in ref], [p[1] for p in ref])


@pytest.mark.parametrize("n", [0, 1, 2])
def test_split_refuses_tiny_sets_like_sklearn(n):
    names = [f"img{i}.png" for i in range(n)]
    with pytest.raises(ValueError):
        JD.split_dataset(names, names)
    with pytest.raises(ValueError):
        TD.split_dataset(names, names)


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """11 pairs of two sizes (interleaved), masks with values 0/1/255."""
    root = tmp_path_factory.mktemp("mixed")
    r = np.random.RandomState(0)
    for sub in ("img", "msk"):
        (root / sub).mkdir()
    for i in range(11):
        h, w = (24, 30) if i % 3 else (20, 20)
        Image.fromarray((r.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / "img" / f"p{i:02d}.png")
        m = r.choice([0, 1, 255], (h, w)).astype(np.uint8)
        Image.fromarray(m).save(root / "msk" / f"p{i:02d}.png")
    return str(root / "img"), str(root / "msk")


@pytest.mark.parametrize("shuffle,batch", [(False, 4), (True, 4), (True, 3)])
def test_batches_equal_jax(mixed_dir, shuffle, batch):
    img_dir, mask_dir = mixed_dir
    assert TD.discover_pairs(img_dir, mask_dir) == \
        JD.discover_pairs(img_dir, mask_dir)
    images, masks = TD.discover_pairs(img_dir, mask_dir)
    kw = dict(batch_size=batch, shuffle=shuffle, seed=5)
    jd = JD.SegmentationData(img_dir, mask_dir, images, masks, **kw)
    td = TD.SegmentationData(img_dir, mask_dir, images, masks, **kw)
    assert len(td) == len(jd)
    for epoch in range(2):   # the shuffle reseeds per epoch
        jb, tb = list(jd.batches()), list(td.batches())
        assert len(tb) == len(jb)
        for a, b in zip(jb, tb):
            assert a["filenames"] == b["filenames"], epoch
            assert a["orig_size"] == b["orig_size"]
            assert a["n_valid"] == b["n_valid"]
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["masks"], b["masks"])
            assert set(np.unique(b["masks"])) <= {0, 1}
    sizes = [b["n_valid"] for b in td.batches()]
    assert sum(sizes) == 11 and min(sizes) < batch   # ragged batches


def test_decode_cache_hands_out_the_same_arrays(mixed_dir):
    img_dir, mask_dir = mixed_dir
    images, masks = TD.discover_pairs(img_dir, mask_dir)
    d = TD.SegmentationData(img_dir, mask_dir, images, masks, batch_size=4)
    a = [x for b in d.batches() for x in b["sample_images"]]
    b = [x for b in d.batches() for x in b["sample_images"]]
    assert all(x is y for x, y in zip(a, b))
    assert not a[0].flags.writeable
    d0 = TD.SegmentationData(img_dir, mask_dir, images, masks, batch_size=4,
                             cache_bytes=0)
    list(d0.batches())
    assert not d0._cache

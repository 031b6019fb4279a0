"""The port's native image IO (`unetdc_tpu_torch/io/native.py`) against
the JAX package's `io/native.py` and PIL, on the same seeded images.

Decodes are held to equality with the JAX module's (the same libfastio
source) and with PIL's where PIL decodes exactly (PNG); JPEG decodes may
differ from PIL's IDCT by up to 2 levels. Encoded files are byte-equal to
the JAX module's and decode back to their input. With the library
unavailable every entry point gives PIL's result."""

import numpy as np
import pytest
from PIL import Image

from unetdc_tpu.io import native as JN
from unetdc_tpu_torch.io import native as TN


@pytest.fixture(params=["native", "pil"])
def codec(request, monkeypatch):
    """Each case runs with libfastio and with it unavailable."""
    if request.param == "native":
        assert TN.native_available()
    else:
        monkeypatch.setattr(TN, "_load", lambda: None)
        assert not TN.native_available()
    return request.param


def _write(tmp_path, name, arr, **kw):
    p = tmp_path / name
    Image.fromarray(arr).save(p, **kw)
    return p


def test_png_decodes_equal(rng, tmp_path, codec):
    """RGB, gray, palette, RGBA (alpha stripped) and 16-bit (high byte,
    as cv2.imread) PNGs."""
    gray = (rng.rand(40, 50) * 255).astype(np.uint8)
    rgba = (rng.rand(24, 31, 4) * 255).astype(np.uint8)
    a16 = (rng.rand(24, 31) * 65535).astype(np.uint16)
    cases = {
        "rgb.png": (rng.rand(64, 80, 3) * 255).astype(np.uint8),
        "g.png": gray,
        "rgba.png": rgba,
        "a16.png": a16,
    }
    for name, arr in cases.items():
        p = _write(tmp_path, name, arr)
        ours = TN.decode_rgb(p)
        np.testing.assert_array_equal(ours, JN.decode_rgb(p), err_msg=name)
        if name == "a16.png":
            want = np.repeat((a16 >> 8).astype(np.uint8)[..., None], 3, -1)
        elif name == "rgba.png":
            want = rgba[..., :3]
        else:
            want = np.array(Image.open(p).convert("RGB"))
        np.testing.assert_array_equal(ours, want, err_msg=name)
    pal = tmp_path / "p.png"
    Image.fromarray(gray).convert("P").save(pal)
    np.testing.assert_array_equal(TN.decode_rgb(pal),
                                  np.array(Image.open(pal).convert("RGB")))


@pytest.mark.parametrize("quality", [75, 90, 95])
def test_jpeg_decode(rng, tmp_path, codec, quality):
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    p = _write(tmp_path, "t.jpg", img, quality=quality)
    ours = TN.decode_rgb(p)
    ref = np.array(Image.open(p).convert("RGB"))
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2
    if codec == "native":
        np.testing.assert_array_equal(ours, JN.decode_rgb(p))


def test_encodes_round_trip_and_equal_jax(rng, tmp_path, codec):
    mask = ((rng.rand(64, 64) > 0.5) * 255).astype(np.uint8)
    rgb = (rng.rand(32, 40, 3) * 255).astype(np.uint8)
    for fn, arr in (("encode_png_gray", mask), ("encode_png_rgb", rgb)):
        ours, theirs = tmp_path / f"t_{fn}.png", tmp_path / f"j_{fn}.png"
        getattr(TN, fn)(ours, arr)
        getattr(JN, fn)(theirs, arr)
        np.testing.assert_array_equal(np.array(Image.open(ours)), arr)
        if codec == "native":
            assert ours.read_bytes() == theirs.read_bytes(), fn
    with pytest.raises(ValueError):
        TN.encode_png_gray(tmp_path / "bad.png", rgb)


def test_unknown_suffix_falls_back_to_pil(rng, tmp_path):
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    p = _write(tmp_path, "t.tiff", img)
    np.testing.assert_array_equal(TN.decode_rgb(p), img)


def test_batch_pipeline_uses_native_io():
    """The batch pipeline, the heatmap writers and the dataset decode
    through io/native, as the JAX package's do."""
    from unetdc_tpu_torch.data import dataset
    from unetdc_tpu_torch.pipelines import quantify_batch

    assert quantify_batch.decode_rgb is TN.decode_rgb
    assert quantify_batch.encode_png_gray is TN.encode_png_gray
    assert quantify_batch.encode_png_rgb is TN.encode_png_rgb
    assert dataset.decode_rgb is TN.decode_rgb

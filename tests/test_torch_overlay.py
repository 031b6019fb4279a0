"""The port's overlay drawing against the JAX package's: the same seeded
masks on the same image give byte-equal overlays. The JAX pipeline draws on
BGR and writes with cv2.imwrite; the port draws on RGB and writes RGB, so
the port's result is compared with the JAX result flipped back to RGB."""

import numpy as np
import pytest

from unetdc_tpu.pipelines.quantify_batch import draw_overlay as draw_jax
from unetdc_tpu_torch.pipelines.quantify_batch import draw_overlay as draw_port

H, W = 48, 56


def _mask(kind: str) -> np.ndarray:
    r = np.random.RandomState(sum(map(ord, kind)))
    m = np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[:H, :W]
    if kind == "border":      # components cut by each edge and a corner
        m[:5, 10:20] = 1
        m[20:30, -4:] = 1
        m[-3:, :7] = 1
        m[15:25, :2] = 1
    elif kind == "holes":     # rings and a filled disk with a pit
        for cy, cx, ro, ri in ((14, 14, 9, 4), (30, 38, 11, 6)):
            d = (yy - cy) ** 2 + (xx - cx) ** 2
            m[(d <= ro ** 2) & (d > ri ** 2)] = 1
        m[40:46, 5:15] = 1
        m[42, 9] = 0
    elif kind == "single":    # isolated pixels
        idx = r.choice(H * W, 25, replace=False)
        m.ravel()[idx] = 1
    elif kind == "diagonal":  # pixels touching only at their corners
        for i in range(12):
            m[5 + i, 5 + i] = 1
            m[30 - i, 20 + i] = 1
        m[40, 40] = m[41, 41] = m[40, 42] = m[42, 40] = 1
    elif kind == "random":    # seeded blobs of every shape
        m = (r.rand(H, W) < 0.45).astype(np.uint8)
    return m


@pytest.mark.parametrize("kind", ["border", "holes", "single", "diagonal",
                                  "random", "empty"])
def test_overlay_matches_jax(kind):
    rgb = (np.random.RandomState(5).rand(H, W, 3) * 255).astype(np.uint8)
    mask = _mask(kind)
    got = draw_port(rgb, mask)
    ref_bgr = draw_jax(np.ascontiguousarray(rgb[..., ::-1]), mask)
    ref = np.ascontiguousarray(ref_bgr[..., ::-1])
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    assert got.tobytes() == ref.tobytes()
    if kind == "empty":
        assert got.tobytes() == rgb.tobytes()
    else:
        assert (got != rgb).any()

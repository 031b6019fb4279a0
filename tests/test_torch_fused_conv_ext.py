"""`ext` mode of the fused conv kernels' plain versions (K1, K2): one row
shard of the image with real halo rows from its neighbours, and K2's edge
flags. Held to the JAX package's Pallas kernels in `ext` mode (interpret
mode) at tests/test_pallas_conv.py's tolerances (K1 atol 2e-5 / rtol 1e-5,
the f32 head atol 3e-6 / rtol 1e-5), and shards reassembled against the
unsharded plain version. The CUDA kernels' `ext` mode is held bit-equal on
the card (test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unetdc_tpu.models import unet_fast as JF
from unetdc_tpu.ops.pallas_conv import dec1_head, pair_conv_pool, pair_mid_side
from unetdc_tpu_torch.core.mesh import halo
from unetdc_tpu_torch.ops import fused_conv as fc

FLAGS = [(0, 0), (1, 0), (0, 1), (1, 1)]


@pytest.fixture(scope="module")
def heads():
    """(JAX pallas head weights, the port's head weights), f32, from one
    set of seeded dec1-head weights (reference layouts: HWIO convs, the
    ConvTranspose2d kernel (I, O, 2, 2))."""
    r = np.random.RandomState(3)
    f = {"enc1": {"conv1": {"kernel": r.randn(3, 3, 64, 64) * 0.05,
                            "bias": r.randn(64) * 0.1}},
         "dec1": {"conv0": {"kernel": r.randn(3, 3, 128, 64) * 0.05,
                            "bias": r.randn(64) * 0.1},
                  "conv1": {"kernel": r.randn(3, 3, 64, 64) * 0.05,
                            "bias": r.randn(64) * 0.1}},
         "upconv1": {"kernel": r.randn(128, 64, 2, 2) * 0.05,
                     "bias": r.randn(64) * 0.1},
         "out_conv": {"kernel": r.randn(1, 1, 64, 1) * 0.2,
                      "bias": r.randn(1) * 0.1}}
    f = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), f)
    jhead = JF.build_pallas_head_params(f, dtype=jnp.float32)["head"]
    d1 = f["dec1"]
    phead = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in {
        "w_up": f["upconv1"]["kernel"].transpose(2, 3, 0, 1),
        "b_up": f["upconv1"]["bias"],
        "w0": d1["conv0"]["kernel"], "b0": d1["conv0"]["bias"],
        "w1": d1["conv1"]["kernel"], "b1": d1["conv1"]["bias"],
        "w_oc": f["out_conv"]["kernel"].reshape(-1),
        "b_oc": f["out_conv"]["bias"].reshape(1)}.items()}
    return jhead, phead


def _relu_randn(rng, *shape):
    return np.maximum(rng.randn(*shape), 0).astype(np.float32)


def _k1_weights(rng):
    w = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.2
    b = rng.randn(64).astype(np.float32) * 0.1
    return w, b


def test_k1_ext_plain_matches_pallas_ext():
    rng = np.random.RandomState(11)
    B, H, W, c = 2, 16, 32, 64
    x = _relu_randn(rng, B, H + 2, W, c)  # real halo rows, not zeros
    w, b = _k1_weights(rng)
    mid, side = pair_mid_side(w)
    y_ref, p_ref = pair_conv_pool(
        jnp.asarray(x.reshape(B, H + 2, W // 2, 2 * c)), jnp.asarray(mid),
        jnp.asarray(side), jnp.asarray(np.concatenate([b, b])[None]),
        tile=8, interpret=True, ext=True)
    y, p = fc.conv3x3_relu_pool(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), ext=True)
    assert y.shape == (B, H, W, c) and p.shape == (B, H // 2, W // 2, c)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(y_ref).reshape(B, H, W, c),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("flags", FLAGS, ids=str)
def test_k2_ext_plain_matches_dec1_head_ext(heads, flags):
    jhead, phead = heads
    rng = np.random.RandomState(12)
    B, H, W = 2, 16, 32
    dec2 = _relu_randn(rng, B, H // 2 + 2, W // 2, 128)
    enc1 = _relu_randn(rng, B, H + 4, W, 64)
    ref = dec1_head(jnp.asarray(dec2),
                    jnp.asarray(enc1.reshape(B, H + 4, W // 2, 128)), jhead,
                    interpret=True, ext=True,
                    edge_flags=jnp.asarray(flags, jnp.int32))
    ref = np.asarray(ref).reshape(B, H, W, 1)
    got = fc.dec1_head(torch.from_numpy(dec2), torch.from_numpy(enc1),
                       phead, ext=True, edge_flags=flags)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6, rtol=1e-5)


def test_k2_ext_edge_flags_matter(heads):
    """The flags change the edge rows (the halo rows are not zeros), so
    the parametrised test above tells the four patterns apart."""
    _, phead = heads
    rng = np.random.RandomState(12)
    dec2 = torch.from_numpy(_relu_randn(rng, 1, 10, 16, 128))
    enc1 = torch.from_numpy(_relu_randn(rng, 1, 20, 32, 64))
    outs = [fc.dec1_head(dec2, enc1, phead, ext=True, edge_flags=f)
            for f in FLAGS]
    for i in range(4):
        for j in range(i):
            assert float((outs[i] - outs[j]).abs().max()) > 1e-4
    # interior rows do not depend on the flags
    assert torch.equal(outs[0][:, 2:-2], outs[3][:, 2:-2])


def _shards(t, S, n):
    """Row shards of t (dim 1) with n halo rows each, zeros at the edges."""
    return halo(list(torch.chunk(t, S, 1)), n, 1)


@pytest.mark.parametrize("S", [2, 4])
def test_ext_shards_reassemble_to_unsharded(heads, S):
    """K1 and K2 plain, run per row shard in ext mode on halos taken from
    the neighbours (zeros at the global edges), reassemble to the
    unsharded plain version within 1e-6 in f32."""
    _, phead = heads
    rng = np.random.RandomState(13)
    B, H, W = 2, 32, 24
    x = torch.from_numpy(_relu_randn(rng, B, H, W, 64))
    w, b = (torch.from_numpy(a) for a in _k1_weights(rng))
    y_ref, p_ref = fc.conv3x3_relu_pool(x, w, b)
    parts = [fc.conv3x3_relu_pool(s, w, b, ext=True) for s in _shards(x, S, 1)]
    dy = float((torch.cat([q[0] for q in parts], 1) - y_ref).abs().max())
    dp = float((torch.cat([q[1] for q in parts], 1) - p_ref).abs().max())

    dec2 = torch.from_numpy(_relu_randn(rng, B, H // 2, W // 2, 128))
    o_ref = fc.dec1_head(dec2, x, phead)
    o = torch.cat([fc.dec1_head(d, e, phead, ext=True,
                                edge_flags=(i == 0, i == S - 1))
                   for i, (d, e) in enumerate(zip(_shards(dec2, S, 1),
                                                  _shards(x, S, 2)))], 1)
    do = float((o - o_ref).abs().max())
    print(f"S={S}: max |d| K1 y {dy:.3g}, pool {dp:.3g}, K2 {do:.3g}")
    assert dy <= 1e-6 and dp <= 1e-6 and do <= 1e-6


def test_ext_wrappers_check_shapes():
    x = torch.zeros(1, 10, 8, 64)
    w, b = torch.zeros(3, 3, 64, 64), torch.zeros(64)
    fc._check_k1(x, w, b, ext=True)  # 8 rows + 2 halo rows
    with pytest.raises(ValueError):
        fc._check_k1(torch.zeros(1, 9, 8, 64), w, b, ext=True)
    head = {"w_up": torch.zeros(2, 2, 128, 64), "b_up": torch.zeros(64),
            "w0": torch.zeros(3, 3, 128, 64), "b0": torch.zeros(64),
            "w1": torch.zeros(3, 3, 64, 64), "b1": torch.zeros(64),
            "w_oc": torch.zeros(64), "b_oc": torch.zeros(1)}
    fc._check_k2(torch.zeros(1, 6, 4, 128), torch.zeros(1, 12, 8, 64), head,
                 ext=True)
    with pytest.raises(ValueError):  # dec2 without its halo rows
        fc._check_k2(torch.zeros(1, 4, 4, 128), torch.zeros(1, 12, 8, 64),
                     head, ext=True)

"""The port's multi-device forward (`models/unet_fast.py::forward_folded_spmd`)
and engine under a mesh, on the CPU's logical mesh slots, against the JAX
package's `forward_folded_pallas_spmd` and sharded engine on its 8 virtual
CPU devices.

The JAX fast path applies upconv4..2 flipped (ROADMAP queue C), so its
weights get the kernels flipped back (as tests/test_torch_int8.py does);
the test first shows on the port that the flip moves the output by more
than 10x the tolerance on these weights. Tolerances: f32 atol 2e-5 (the
whole-forward bound of test_torch_fused_conv.py); bf16 |dprob| < 0.05 and
equal masks, with the decisive head at scale 60 (at 300, bf16 rounding
differences between XLA and ATen move saturating probabilities by up to
~0.07; at 1-10 every pixel passes 0.3 and the mask shows nothing).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_reference import make_decisive_checkpoint
from unetdc_tpu_torch.core.mesh import halo, make_mesh, replicate
from unetdc_tpu_torch.models import unet as TU
from unetdc_tpu_torch.models import unet_fast as PF

MESHES = [(8, 1), (2, 4), (1, 8)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and full-width models on all cores in each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
X = np.random.RandomState(5).rand(8, 64, 64, 3).astype(np.float32)


def _flip_up(fp):
    fp = dict(fp)
    for n in (4, 3, 2):
        fp[f"upconv{n}"] = dict(fp[f"upconv{n}"],
                                k=fp[f"upconv{n}"]["k"][::-1, ::-1])
    return fp


@pytest.fixture(scope="module", params=["f32", "bf16"])
def model(request, tmp_path_factory):
    """(dtype name, JAX fast params with the flip undone, the port's
    folded params) of a decisive checkpoint."""
    from unetdc_tpu.checkpoint import (load_pth_state_dict,
                                       torch_state_dict_to_variables)
    from unetdc_tpu.models import unet_fast as JF
    from unetdc_tpu.models.unet import fold_batchnorm

    path = tmp_path_factory.mktemp("spmd") / "m.pth"
    make_decisive_checkpoint(str(path), seed=1, img_size=64,
                             out_scale=300.0 if request.param == "f32"
                             else 60.0)
    jf = fold_batchnorm(torch_state_dict_to_variables(
        load_pth_state_dict(str(path))))["params"]
    jdt = jnp.float32 if request.param == "f32" else jnp.bfloat16
    jfp = JF.build_fast_params(jf, dtype=jdt)
    jfp["_pa"] = JF.build_pallas_head_params(jf, dtype=jdt)
    return request.param, _flip_up(jfp), TU.fold_batchnorm(
        torch.load(str(path)))


def _port(folded, dtype, nd, ns, flip=False):
    if flip:
        folded = dict(folded)
        for n in (4, 3, 2):
            u = folded[f"upconv{n}"]
            folded[f"upconv{n}"] = dict(u, kernel=u["kernel"].flip(2, 3))
    fp = PF.build_fast_params(folded, dtype)
    mesh = make_mesh(nd, ns, devices="cpu")
    return PF.forward_folded_spmd(replicate(mesh, lambda d: fp),
                                  torch.from_numpy(X), mesh=mesh).numpy()


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_spmd_matches_jax_pallas_spmd(model, shape):
    from unetdc_tpu.core.mesh import make_mesh as jax_mesh
    from unetdc_tpu.models import unet_fast as JF

    name, jfp, folded = model
    nd, ns = shape
    dtype = torch.float32 if name == "f32" else torch.bfloat16
    got = _port(folded, dtype, nd, ns)
    mesh = jax_mesh(nd, ns)
    ref = np.asarray(jax.jit(lambda c: JF.forward_folded_pallas_spmd(
        jfp, c, mesh=mesh, shard_space=True, interpret=True))(
            jnp.asarray(X)))
    assert got.shape == ref.shape == (8, 64, 64, 1)
    if name == "f32":
        # these weights see the flip: it moves the output > 10x the atol
        flipped = _port(folded, dtype, nd, ns, flip=True)
        assert np.abs(flipped - got).max() > 10 * 2e-5
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    else:
        assert np.abs(got - ref).max() < 0.05
        np.testing.assert_array_equal(got > 0.3, ref > 0.3)
        assert 0.005 < (ref > 0.3).mean() < 0.995  # the mask has structure


def _layout(x, layout):
    """x (NHWC) as the engine hands it over: NHWC memory (an RGB batch
    permuted back), NCHW memory under an NHWC view (`_preprocess`), or one
    plane broadcast to 3 channels (a grayscale upload)."""
    t = torch.from_numpy(x)
    if layout == "nchw_memory":
        return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    if layout == "gray_expanded":
        return t[..., :1].expand(-1, -1, -1, 3)
    return t


F32, BF16 = torch.float32, torch.bfloat16
EQUAL_CASES = ([(s, dt, "nchw_memory") for s in ((1, 2), (2, 2), (1, 4),
                                                 (2, 4), (1, 8))
                for dt in (F32, BF16)]
               + [((1, 4), F32, "nhwc"), ((2, 4), BF16, "gray_expanded"),
                  ((1, 8), F32, "gray_expanded")])


@pytest.mark.parametrize("shape,dtype,layout", EQUAL_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_spmd_equals_unsharded(dtype, shape, layout):
    """Space shards (with 1, 2 or 8 data groups) reassemble to the
    unsharded forward exactly on the CPU, whatever the input's memory
    layout: the halo rows make every library conv see the rows it would
    see unsharded, in the same memory format. (1, 8) at 64 rows gathers
    enc4 (1 row a shard before its pool) and splits again at dec4; (1, 4)
    runs the dilation-16 bottleneck on 1-row shards, so its halo comes
    from 16 neighbours' rows and zeros."""
    torch.manual_seed(0)
    folded = TU.fold_batchnorm(TU.UNetDC().eval().state_dict())
    fp = PF.build_fast_params(folded, dtype)
    x = _layout(X, layout)
    ref = PF.forward_folded(fp, x).numpy()
    mesh = make_mesh(*shape, devices="cpu")
    got = PF.forward_folded_spmd({mesh.first: fp}, x, mesh=mesh).numpy()
    np.testing.assert_array_equal(got, ref)


def test_spmd_routes_undividable_shapes_to_one_device(capsys):
    """B % n_data or H % (2 n_space): the unsharded forward on the mesh's
    first device, logged once to stderr."""
    torch.manual_seed(0)
    fp = PF.build_fast_params(TU.fold_batchnorm(
        TU.UNetDC().eval().state_dict()), torch.float32)
    x = torch.from_numpy(X[:6, :48])  # 48 % (2 * 8) == 0, but 6 % 4 != 0
    ref = PF.forward_folded(fp, x)
    mesh = make_mesh(4, 2, devices="cpu")
    PF._ROUTED.clear()
    for _ in range(2):
        got = PF.forward_folded_spmd({mesh.first: fp}, x, mesh=mesh)
        assert torch.equal(got, ref)
    err = capsys.readouterr().err
    assert err.count("does not divide over the 4x2 mesh") == 1


def test_halo_takes_rows_from_neighbours_and_never_aliases():
    shards = [torch.arange(2 * i, 2 * i + 2.).view(1, 2, 1) for i in range(4)]
    ext = halo(shards, 3, 1)
    assert [e.view(-1).tolist() for e in ext] == [
        [0, 0, 0, 0, 1, 2, 3, 4], [0, 0, 1, 2, 3, 4, 5, 6],
        [1, 2, 3, 4, 5, 6, 7, 0], [3, 4, 5, 6, 7, 0, 0, 0]]
    ext[1].zero_()
    assert shards[0].view(-1).tolist() == [0, 1]
    assert shards[1].view(-1).tolist() == [2, 3]


@pytest.fixture(scope="module")
def decisive_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("eng") / "m.pth"
    make_decisive_checkpoint(str(path), seed=1, img_size=64)
    return str(path)


def _blob_images(seed=3, n=8, h=72, w=80):
    """Bright disks on dark noise (tests/test_torch_pipeline_e2e.py)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        for _ in range(6):
            cy, cx = rng.randint(8, h - 8), rng.randint(8, w - 8)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(3, 9) ** 2
            img[blob] = np.minimum(img[blob] + 180, 255)
        out.append(img)
    return np.stack(out)


IMGS = _blob_images()


def test_f32_engine_shard_space_matches_single_and_jax(decisive_ckpt):
    """The f32 engine on a (2, 4) mesh with shard_space: masks and tables
    equal to the single-device engine's and to the JAX engine's on its
    (2, 4) virtual-device mesh with shard_space (the f32 contract, on a
    decisive checkpoint and droplet-like images: a pixel within ~1e-6 of
    the threshold may still fall either way between ATen's and XLA's f32
    sums, as on uniform-noise images here)."""
    from unetdc_tpu.checkpoint import (load_pth_state_dict,
                                       torch_state_dict_to_variables)
    from unetdc_tpu.core.mesh import make_mesh as jax_mesh
    from unetdc_tpu.pipelines.engine import QuantifyEngine as JaxEngine
    from unetdc_tpu_torch.pipelines.engine import load_engine

    out = {}
    for name, mesh in (("single", None),
                       ("mesh", make_mesh(2, 4, devices="cpu"))):
        eng = load_engine(decisive_ckpt, mesh=mesh, fast=False,
                          device="cpu", shard_space=True)
        eng.img_size = 64
        out[name] = eng.run_batch(IMGS, (72, 80), background_radius=10)
    variables = torch_state_dict_to_variables(
        load_pth_state_dict(decisive_ckpt))
    jeng = JaxEngine(variables, compute_dtype=jnp.float32, img_size=64,
                     mesh=jax_mesh(2, 4), shard_space=True)
    ref = jeng.run_batch(IMGS, (72, 80), background_radius=10)
    assert 0 < out["mesh"]["mask"].mean() < 1
    for k in ("mask", "count", "total", "area", "sum-0-lo", "sum-0-hi",
              "sum-1-lo", "sum-1-hi"):
        if k in ref:
            np.testing.assert_array_equal(out["mesh"][k], out["single"][k],
                                          err_msg=k)
            np.testing.assert_array_equal(out["mesh"][k], ref[k], err_msg=k)


def test_engine_int8_mesh_is_data_parallel(decisive_ckpt):
    """Int8 under a mesh: the batch split over (2, 1), and the height too
    with shard_space on (1, 2) and (2, 2) (`forward_int8_spmd`: every int8
    conv on its own halo of int8 rows), each byte-equal to the unsharded
    int8 engine, with one sidecar's scales."""
    from unetdc_tpu_torch.pipelines.engine import load_engine

    outs = {}
    side = decisive_ckpt + ".mesh.int8calib.npz"
    for shape, ss in ((None, False), ((2, 1), False), ((1, 2), True),
                      ((2, 2), True)):
        mesh = shape and make_mesh(*shape, devices="cpu")
        eng = load_engine(decisive_ckpt, mesh=mesh, quantize="int8",
                          device="cpu", calib_path=side, shard_space=ss)
        eng.img_size = 32
        outs[shape] = eng.run_batch(IMGS[:4], (72, 80),
                                    background_radius=10)
        if mesh is not None:
            assert set(eng.replicas) == {torch.device("cpu")}
    assert 0 < outs[None]["mask"].mean() < 255
    for shape, out in outs.items():
        for k in outs[None]:
            np.testing.assert_array_equal(out[k], outs[None][k],
                                          err_msg=f"{shape} {k}")


def test_batch_not_dividing_over_the_mesh_raises_as_jax(decisive_ckpt):
    """--batch 8 over 3 data groups: the JAX engine's device put raises a
    ValueError naming the divisor; the port's engine raises the same kind,
    before any work."""
    from unetdc_tpu.core.mesh import make_mesh as jax_mesh
    from unetdc_tpu.pipelines.engine import load_engine as jax_load
    from unetdc_tpu_torch.pipelines.engine import load_engine

    jeng = jax_load(decisive_ckpt, mesh=jax_mesh(3), fast=False)
    jeng.img_size = 32
    with pytest.raises(ValueError, match="divisible by 3"):
        jeng.run_batch(IMGS, (72, 80))
    eng = load_engine(decisive_ckpt, mesh=make_mesh(3, devices="cpu"),
                      fast=False, device="cpu")
    eng.img_size = 32
    with pytest.raises(ValueError, match="divisible by 3"):
        eng.run_batch(IMGS, (72, 80))


def test_engine_drives_each_device_from_its_own_thread(monkeypatch):
    """Data groups on distinct devices run on one host thread per device
    (the component propagation syncs the host once per sweep, so one
    thread would serialise the cards); groups sharing a device run in
    order on its thread, and the results come back in batch order."""
    import threading
    import time
    from types import SimpleNamespace

    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    class Dev:  # two distinct stand-in devices
        type = "stand-in"

    devs = [Dev(), Dev()]
    xs = [SimpleNamespace(device=devs[g % 2], g=g) for g in range(4)]
    seen = []

    def run_group(self, x, mesh, *rest):
        seen.append((x.g, threading.get_ident(), mesh.shape))
        time.sleep(0.01)
        return {"g": x.g}

    monkeypatch.setattr(QuantifyEngine, "_run_group", run_group)
    eng = QuantifyEngine.__new__(QuantifyEngine)
    eng.mesh, eng._workers = make_mesh(4, devices="cpu"), {}
    out = eng._run((xs, 0.3, 1, 50, True), (8, 8), 16)
    assert [o["g"] for o in out] == [0, 1, 2, 3]
    tid = {g: t for g, t, _ in seen}
    assert tid[0] == tid[2] != tid[1] == tid[3]
    assert threading.get_ident() not in tid.values()
    assert all(shape == {"data": 1, "space": 1} for *_, shape in seen)
    assert [g for g, *_ in seen if tid[g] == tid[0]] == [0, 2]
    eng.close()
    assert not eng._workers


def test_mesh_engine_overflow_rerun_reuses_the_mesh(decisive_ckpt, capsys):
    """A batch whose component count passes max_labels is re-run over the
    same mesh at a larger cap; its counts and tables equal the
    single-device engine's."""
    from unetdc_tpu_torch.pipelines.engine import load_engine

    outs = []
    for mesh, cap in ((None, 4096), (make_mesh(2, 2, devices="cpu"), 1)):
        eng = load_engine(decisive_ckpt, mesh=mesh, fast=False, device="cpu",
                          max_labels=cap, shard_space=mesh is not None)
        eng.img_size = 64
        outs.append(eng.run_batch(IMGS[:4], (72, 80), background_radius=10))
    assert "re-running it at cap" in capsys.readouterr().err
    ref, got = outs
    assert int(ref["total"].max()) > 1
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["count"], ref["count"])
    n = got["area"].shape[1]
    assert n >= int(ref["count"].max())
    np.testing.assert_array_equal(got["area"], ref["area"][:, :n])

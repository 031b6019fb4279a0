"""The port's multi-device training (`models/unet.py::forward_sharded`,
`Trainer(mesh=...)`) on the CPU's logical mesh slots, against the port on
one device and against the JAX mesh trainer on its 8 virtual CPU devices:
img 32, batch 4, f32, the full-width UNetDC, seeded numpy inputs.

Tolerances are the JAX package's own (tests/test_parallel.py,
`__graft_entry__.py::dryrun_multichip`): a one-step loss within 1e-5
relative; parameters within 2.05 * lr (Adam's first step moves a
parameter by about lr whatever its gradient's size, so a near-zero
gradient whose sign differs between two summation orders moves it by up
to 2 * lr); BatchNorm running statistics within 1e-5 of each buffer's
largest magnitude; eval metrics within 1e-5, train metrics 1e-4, counts
exact; fit histories within 2e-4. The f64 tests hold the sharded
arithmetic itself (halos, phase convs, cross-shard statistics, the
gradient sum over devices) to 1e-10.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from unetdc_tpu_torch.core import mesh as M
from unetdc_tpu_torch.core.mesh import make_mesh
from unetdc_tpu_torch.models import unet as TU
from unetdc_tpu_torch.train import trainer as TT

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and full-width models on all cores in each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _seed0_weights_drawn_once():
    """Every trainer here starts from flax's initializers at seed 0: draw
    them once (their rejection sampling takes seconds for the full-width
    model) and copy them into each new model."""
    real = TT.init_flax_
    seed0 = real(TU.UNetDC(), torch.Generator().manual_seed(0)).state_dict()

    def init(model, generator):
        if isinstance(model, TU.UNetDC) and generator.initial_seed() == 0:
            model.load_state_dict(seed0)
            return model
        return real(model, generator)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "init_flax_", init)
        yield


_R = np.random.RandomState(0)
X = _R.rand(4, 32, 32, 3).astype(np.float32)
MASKS = (_R.rand(4, 32, 32, 1) > 0.5).astype(np.float32)


def _cfg(**kw):
    return TT.TrainConfig(model="unetdc", compute_dtype="f32", seed=0,
                          img_size=32, **kw)


def _step(init, mesh=None, **kw):
    """A port trainer from `init` after one step on X; (trainer, loss)."""
    t = TT.Trainer(_cfg(**kw), mesh=mesh, device="cpu")
    t.variables = init
    valid = np.ones(4, np.float32)
    met = t.train_step(torch.from_numpy(X), torch.from_numpy(MASKS),
                       torch.from_numpy(valid), valid)
    return t, float(met[0])


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _close_trees(got, ref):
    """(max parameter delta, max running-statistic delta relative to its
    buffer's largest magnitude) between two {'params', 'batch_stats'}."""
    dp = max(float(np.abs(a - b).max())
             for a, b in zip(_leaves(got["params"]), _leaves(ref["params"])))
    ds = max(float(np.abs(a - b).max() / np.abs(b).max())
             for a, b in zip(_leaves(got["batch_stats"]),
                             _leaves(ref["batch_stats"])))
    return dp, ds


@pytest.fixture(scope="module")
def jax_dp():
    """The JAX trainer's first weights, and its step on a (4, 1) mesh:
    (init, loss, variables after)."""
    from unetdc_tpu.core.mesh import batch_sharding
    from unetdc_tpu.core.mesh import make_mesh as jax_mesh
    from unetdc_tpu.train.trainer import TrainConfig, Trainer

    mesh = jax_mesh(4, 1)
    t = Trainer(TrainConfig(model="unetdc", compute_dtype="f32", seed=0,
                            img_size=32), mesh=mesh)
    init = jax.tree_util.tree_map(np.asarray, t.variables)
    params, stats, _, loss, _, _ = t._train_step(
        t.variables["params"], t.variables["batch_stats"], t.opt_state,
        jax.device_put(jnp.asarray(X), batch_sharding(mesh, 4)),
        jax.device_put(jnp.asarray(MASKS), batch_sharding(mesh, 4)),
        jax.device_put(jnp.ones(4, jnp.float32), batch_sharding(mesh, 1)))
    after = jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats})
    return init, float(loss), after


@pytest.fixture(scope="module")
def single(jax_dp):
    """The port on one device from the same weights: (variables, loss)."""
    t, loss = _step(jax_dp[0])
    return t.variables, loss


def test_dp_step_matches_single_device_and_jax_mesh(jax_dp, single):
    """One step on make_mesh(4, 1): loss within 1e-5 of the port on one
    device and of the JAX trainer's step on its (4, 1) mesh; parameters
    and running statistics within the contract of both."""
    init, jloss, jafter = jax_dp
    t, loss = _step(init, make_mesh(4, 1, devices="cpu"))
    assert t.mesh.shape == {"data": 4, "space": 1}
    np.testing.assert_allclose(loss, single[1], rtol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for ref in (single[0], jafter):
        dp, ds = _close_trees(t.variables, ref)
        assert dp <= 2.05 * LR and ds <= 1e-5, (dp, ds)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_shard_space_step_matches_single_device(jax_dp, single, shape):
    """One step with the height sharded: (2, 2) gives every 3x3 conv a
    halo from one neighbour; on (1, 4) the dilation-8 and -16 halos span
    several shards (8 rows at enc1, 1 at enc4) and enc4's pool would cut
    a seam, so enc4 is gathered and the bottleneck runs whole."""
    t, loss = _step(jax_dp[0], make_mesh(*shape, devices="cpu"),
                    shard_space=True)
    np.testing.assert_allclose(loss, single[1], rtol=1e-5)
    dp, ds = _close_trees(t.variables, single[0])
    assert dp <= 2.05 * LR and ds <= 1e-5, (dp, ds)


@pytest.fixture(scope="module")
def tiny_disk_dataset(tmp_path_factory):
    """tests/test_parallel.py's: six 40x40 pairs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mesh_data")
    r = np.random.RandomState(5)
    for sub in ("imgs", "msks"):
        (root / sub).mkdir()
    for i in range(6):
        Image.fromarray((r.rand(40, 40, 3) * 255).astype(np.uint8)).save(
            root / "imgs" / f"s{i}.png")
        Image.fromarray(((r.rand(40, 40) > 0.6) * 255).astype(np.uint8)
                        ).save(root / "msks" / f"s{i}.png")
    return str(root / "imgs"), str(root / "msks")


def _data(dirs):
    from unetdc_tpu_torch.data.dataset import SegmentationData, \
        discover_pairs

    names, masks = discover_pairs(*dirs)
    return SegmentationData(*dirs, names, masks, batch_size=4)


KW = dict(loss="focal_dice", batch_size=4, background_radius=10,
          augment=False)


def test_ragged_dp_epoch_matches_single_device(tiny_disk_dataset):
    """6 samples at batch 4: the ragged tail of 2 is padded to the (4, 1)
    mesh with 2 zero-weight replicas, which stay out of the loss, dice,
    accuracy, confusion counts and BatchNorm statistics
    (test_ragged_dp_epoch_metrics_match_single_device's contract)."""
    out = []
    for mesh in (None, make_mesh(4, 1, devices="cpu")):
        t = TT.Trainer(_cfg(**KW), mesh=mesh, device="cpu")
        data = _data(tiny_disk_dataset)
        out.append((t.run_epoch_eval(data), t.run_epoch_train(data, 0)))
    (ev0, tr0), (ev1, tr1) = out
    np.testing.assert_allclose(ev1[:2], ev0[:2], rtol=1e-5)
    assert ev1[2] == ev0[2]
    np.testing.assert_array_equal(ev1[3], ev0[3])
    np.testing.assert_allclose(tr1[:2], tr0[:2], rtol=1e-4)
    np.testing.assert_allclose(tr1[2], tr0[2], rtol=1e-5)


def test_fit_and_resume_on_dp_sp_mesh_match_single_device(
        tiny_disk_dataset, tmp_path):
    """Trainer.fit on a (2, 2) mesh with shard_space, 2 epochs (ragged
    batches), then a third resumed from `.last`, against 3 epochs on one
    device: losses and dice within 2e-4 (test_trainer_fit_multi_epoch_dp's
    contract), accuracies within 2 of the epoch's 6 * 32 * 32 pixels (a
    pixel at the 0.3 threshold may fall either way once the two runs'
    weights drift apart)."""
    def fit(mesh, epochs, resume=False, save_last=True):
        cfg = _cfg(num_epochs=epochs, resume=resume, patience=50,
                   ckpt_path=str(tmp_path / "c.msgpack"), shard_space=True,
                   save_last=save_last, **KW)
        return TT.Trainer(cfg, mesh=mesh, device="cpu").fit(
            _data(tiny_disk_dataset), _data(tiny_disk_dataset))

    ref = fit(None, 3, save_last=False)
    mesh = make_mesh(2, 2, devices="cpu")
    for p in tmp_path.glob("c.msgpack*"):
        p.unlink()
    got = fit(mesh, 2)
    h3 = fit(mesh, 3, resume=True)
    assert len(h3["train_loss"]) == 1  # only epoch 3 ran
    for p in tmp_path.glob("c.msgpack*"):  # ~0.75 GB of checkpoints
        p.unlink()
    for k, v in ref.items():
        tol = dict(atol=2 / (6 * 32 * 32)) if k.endswith("acc") else \
            dict(rtol=2e-4)
        np.testing.assert_allclose(got[k] + h3[k], v, err_msg=k, **tol)


def test_remat_under_a_mesh_equals_no_remat(jax_dp):
    """remat recomputes each double conv (all its shards, their halos and
    cross-shard statistics) in the backward: the same loss, gradients and
    running statistics as without it, on (2, 2) with shard_space and a
    sample left out."""
    valid = np.array([1, 1, 0, 1], np.float32)
    out = []
    for remat in (False, True):
        t = TT.Trainer(_cfg(remat=remat, shard_space=True),
                       mesh=make_mesh(2, 2, devices="cpu"), device="cpu")
        t.variables = jax_dp[0]
        met = t.train_step(torch.from_numpy(X), torch.from_numpy(MASKS),
                           torch.from_numpy(valid), valid)
        out.append((met, [p.grad for p in t.model.parameters()],
                    list(t.model.buffers())))
    (m0, g0, b0), (m1, g1, b1) = out
    assert torch.equal(m0, m1)
    for a, b in zip(g0 + b0, g1 + b1):
        assert torch.equal(a, b)


# ------------------------------------------------------------ float64 --
@pytest.fixture(scope="module")
def model64():
    m = TU.UNetDC(apply_sigmoid=False, compute_dtype=torch.float64)
    TU.init_flax_(m, torch.Generator().manual_seed(2))
    return m.double()


def _pre_bn_bias(name):
    p = name.split(".")
    return p[0].startswith(("enc", "bottleneck", "dec")) and \
        p[1] in ("0", "3") and p[2] == "bias"


@pytest.mark.parametrize("shape,masked", [((2, 2), True), ((1, 4), False)],
                         ids=str)
def test_f64_sharded_forward_and_gradients_equal_one_device(model64, shape,
                                                            masked):
    """f64 train mode: logits, every parameter's gradient and the running
    statistics of forward_sharded equal the module's own forward within
    1e-10 (the conv biases before a BatchNorm, whose true gradient is 0,
    are left out); then eval mode. (2, 2) with a sample left out: two data
    groups, one-neighbour halos; (1, 4): multi-shard halos and the enc4
    seam gather."""
    x = torch.from_numpy(X).double()
    keep = torch.tensor([True, False, True, True]) if masked else None
    w = torch.from_numpy(np.random.RandomState(1).randn(4, 32, 32, 1))
    ref, got = copy.deepcopy(model64).train(), copy.deepcopy(model64).train()
    yr = ref(x, sample_mask=keep)
    yg = TU.forward_sharded(got, x, make_mesh(*shape, devices="cpu"),
                            shard_space=True, sample_mask=keep)
    assert float((yg - yr).detach().abs().max()) <= 1e-10 * float(
        yr.detach().abs().max())
    assert yg.shape == (4, 32, 32, 1) and yg.dtype == torch.float64
    (yr * w).sum().backward()
    (yg * w).sum().backward()
    for (n, a), b in zip(ref.named_parameters(), got.parameters()):
        if not _pre_bn_bias(n):
            assert float((b.grad - a.grad).norm() / a.grad.norm()) <= 1e-10, n
    for a, b in zip(ref.buffers(), got.buffers()):
        assert float((b - a).abs().max()) <= 1e-10 * max(
            1.0, float(a.abs().max()))
    ref.eval(), got.eval()
    with torch.no_grad():
        er = ref(x)
        eg = TU.forward_sharded(got, x, make_mesh(*shape, devices="cpu"),
                                shard_space=True)
    assert float((eg - er).abs().max()) <= 1e-10 * float(er.abs().max())


def test_f64_cross_shard_batch_stats_and_gradients():
    """sharded_batch_stats over 2 data groups x 2 row shards (one sample
    left out) against batch_stats on the whole tensor with its keep mask:
    mean, variance and the input gradient of a functional of both within
    1e-10."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 3, 8, 5) * 2 + 1).requires_grad_()
    keep = torch.tensor([True, True, False, True])
    wm, wv = (torch.from_numpy(rng.randn(3)) for _ in range(2))
    mean, var = TU.batch_stats(x, keep)
    ((mean * wm).sum() + (var * wv).sum()).backward()
    gref, x.grad = x.grad.clone(), None
    parts = [(s, k) for xg, kg in zip(x.chunk(2), keep.chunk(2))
             for s, k in ((t, kg) for t in xg.chunk(2, 2))]
    m2, v2, cen = TU.sharded_batch_stats(parts, 3 * 8 * 5, x.device)
    ((m2 * wm).sum() + (v2 * wv).sum()).backward()
    assert float((m2 - mean).detach().abs().max()) <= 1e-10
    assert float((v2 - var).detach().abs().max()) <= 1e-10
    assert float((x.grad - gref).abs().max()) <= 1e-10
    assert len(cen) == 4 and cen[0].shape == (2, 3, 4, 5)


@pytest.mark.parametrize("d", [1, 2, 16])
def test_f64_halo_conv_matches_unsharded_conv(d):
    """A 3x3 conv at dilation d run on 4 row shards of 4 rows, each on its
    own halo of d rows (taken from several shards, zeros past the image;
    dilation 16 through the phase convs, on a height of 4 + 32 rows that
    16 does not divide): output, input and weight gradients within 1e-10
    of F.conv2d on the whole image."""
    rng = np.random.RandomState(d)
    x = torch.from_numpy(rng.randn(2, 3, 16, 32)).requires_grad_()
    w = torch.from_numpy(rng.randn(4, 3, 3, 3)).requires_grad_()
    b = torch.from_numpy(rng.randn(4))
    g = torch.from_numpy(rng.randn(2, 4, 16, 32))
    ref = F.conv2d(x, w, b, padding=d, dilation=d)
    (ref * g).sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    got = torch.cat([TU._conv3x3(h, w, b, d, halo=True)
                     for h in M.halo(list(x.chunk(4, 2)), d, 2)], 2)
    (got * g).sum().backward()
    assert float((got - ref).detach().abs().max()) <= 1e-10
    assert float((x.grad - gx).abs().max()) <= 1e-10
    assert float((w.grad - gw).abs().max()) <= 1e-10


def test_pad_to_data_axis_replicates_the_last_sample_with_weight_0():
    imgs = torch.arange(5 * 2).view(5, 2).to(torch.uint8)
    masks = torch.arange(5).to(torch.uint8)
    valid = np.array([1, 1, 1, 1, 0], np.float32)
    mesh = make_mesh(4, 1, devices="cpu")
    i2, m2, v2 = M.pad_to_data_axis(imgs, masks, valid, mesh)
    assert i2.shape == (8, 2) and torch.equal(i2[5:], imgs[-1:].expand(3, 2))
    assert m2.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    assert v2.tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    four = imgs[:4]
    assert M.pad_to_data_axis(four, masks[:4], valid[:4], mesh)[0] is four


def test_sharded_forward_raises_on_a_height_it_cannot_split(model64):
    with pytest.raises(ValueError, match="does not split"):
        TU.forward_sharded(model64, torch.zeros(2, 36, 32, 3,
                                                dtype=torch.float64),
                           make_mesh(1, 4, devices="cpu"), shard_space=True)
    with pytest.raises(ValueError, match="divisible by 4"):
        TU.forward_sharded(model64, torch.zeros(2, 32, 32, 3,
                                                dtype=torch.float64),
                           make_mesh(4, 1, devices="cpu"))


def test_dryrun_multichip_on_8_cpu_slots(capsys):
    from unetdc_tpu_torch.dryrun import dryrun_multichip

    dryrun_multichip(8, devices="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(8): mesh={'data': 4, 'space': 2}" in out
    assert "data=2,space=4:BIT-equal" in out and out.rstrip().endswith("OK")

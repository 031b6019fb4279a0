"""The port's msgpack checkpoints against flax's, on the CPU: files the JAX
package writes (`.msgpack`, `.opt`, `.last`) read by the port, files the
port writes read by `flax.serialization.msgpack_restore` (and restored into
optax's state), equal trees both ways and equal bytes; the optax adam
state against `torch.optim.Adam`'s."""

import numpy as np
import optax
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from unetdc_tpu.checkpoint import native as JN
from unetdc_tpu.models.unet import UNetDC as JUNetDC
from unetdc_tpu_torch.checkpoint import (load_optax_adam_state,
                                         optax_adam_state_dict,
                                         params_to_named,
                                         torch_state_dict_to_variables,
                                         variables_to_state_dict)
from unetdc_tpu_torch.checkpoint import native as TN
from unetdc_tpu_torch.models.unet import UNetDC


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and full-width models on all cores in each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _same(a, b, path="/"):
    """Equal trees: same keys in the same order, same leaf types, dtypes,
    shapes and bytes."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}{k}/")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b or (a != a and b != b), path


@pytest.fixture(scope="module")
def jax_state():
    """Flax variables, an adam state after one update with random
    gradients (count 1, non-zero moments), and the `.last` bundle."""
    v = JUNetDC(apply_sigmoid=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    tx = optax.adam(1e-3)
    st = tx.init(v["params"])
    r = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda p: r.randn(*p.shape).astype(np.float32), v["params"])
    _, st = tx.update(grads, st, v["params"])
    st = jax.tree_util.tree_map(np.asarray, st)
    last = {"variables": v, "opt": serialization.to_state_dict(st),
            "state": {"last_epoch": np.int64(3),
                      "val_dice": np.float64(0.61),
                      "best_metric": np.float64(np.nan),
                      "has_best": np.int64(0),
                      "patience_counter": np.int64(2),
                      "plateau_best": np.float64(np.inf),
                      "plateau_count": np.int64(0)}}
    return v, tx, st, grads, last


def test_flax_files_read_by_the_port(jax_state, tmp_path):
    v, tx, st, _, last = jax_state
    JN.save_checkpoint(str(tmp_path / "m.msgpack"), v, {"epoch": 1})
    with open(tmp_path / "m.msgpack.opt", "wb") as f:
        f.write(serialization.to_bytes(st))
    JN.save_checkpoint(str(tmp_path / "m.msgpack.last"), last)
    for name in ("m.msgpack", "m.msgpack.opt", "m.msgpack.last"):
        data = (tmp_path / name).read_bytes()
        _same(TN.load_checkpoint(str(tmp_path / name)),
              serialization.msgpack_restore(data))
    assert TN.load_metadata(str(tmp_path / "m.msgpack")) == {"epoch": 1}
    got = TN.load_checkpoint(str(tmp_path / "m.msgpack.last"))
    assert int(got["state"]["last_epoch"]) == 3
    assert np.isnan(got["state"]["best_metric"])
    for p in tmp_path.iterdir():        # ~0.75 GB of full-width files
        p.unlink()


def test_port_files_read_by_flax(jax_state, tmp_path):
    """The port's save_checkpoint writes the bytes the JAX package's does,
    and flax restores the port's optimizer file into optax's own state."""
    v, tx, st, _, last = jax_state
    for name, tree in (("m.msgpack", v),
                       ("m.msgpack.opt", serialization.to_state_dict(st)),
                       ("m.msgpack.last", last)):
        TN.save_checkpoint(str(tmp_path / ("p" + name)), tree, {"e": 1})
        JN.save_checkpoint(str(tmp_path / ("j" + name)), tree, {"e": 1})
        data = (tmp_path / ("p" + name)).read_bytes()
        assert data == (tmp_path / ("j" + name)).read_bytes(), name
        _same(serialization.msgpack_restore(data), TN.unpackb(data))
        assert TN.load_metadata(str(tmp_path / ("p" + name))) == {"e": 1}
    assert not list(tmp_path.glob("*.tmp"))
    assert not (tmp_path / "p.msgpack.opt.tmp").exists()
    restored = serialization.from_bytes(
        tx.init(v["params"]), (tmp_path / "pm.msgpack.opt").read_bytes())
    assert int(restored[0].count) == 1
    for p in tmp_path.iterdir():        # ~1.5 GB of full-width files
        p.unlink()


def test_adam_state_crosses_both_ways(jax_state):
    """optax state -> torch Adam -> optax state is exact; the next step of
    each optimizer from that state moves the weights alike (f32)."""
    v, tx, st, grads, _ = jax_state
    m = UNetDC()
    m.load_state_dict(variables_to_state_dict(v))
    names = [n for n, _ in m.named_parameters()]
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    load_optax_adam_state(opt, names, serialization.to_state_dict(st))
    back = optax_adam_state_dict(opt, names)
    _same(jax.tree_util.tree_map(np.asarray, back),
          jax.tree_util.tree_map(np.asarray,
                                 serialization.to_state_dict(st)))
    assert back["0"]["count"].dtype == np.int32
    # one more step on both sides with the same gradients
    upd, _ = tx.update(grads, st, v["params"])
    ref = params_to_named(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(v["params"], upd)))
    g = params_to_named(grads)
    for n, p in m.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(g[n]))
    opt.step()
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-6,
                                   rtol=1e-6, err_msg=n)
    inj = optax_adam_state_dict(opt, names, injected=True)
    assert set(inj) == {"count", "hyperparams", "hyperparams_states",
                        "inner_state"}
    assert int(inj["count"]) == 2


def test_model_state_round_trip_through_msgpack(tmp_path):
    """A port model's variables through the port's files and back: the
    state dict is unchanged (num_batches_tracked aside)."""
    m = UNetDC()
    TN.save_checkpoint(str(tmp_path / "x.msgpack"),
                       torch_state_dict_to_variables(m.state_dict()))
    sd = variables_to_state_dict(TN.load_checkpoint(
        str(tmp_path / "x.msgpack")))
    for k, t in m.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], t), k


def test_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(TN, "MAX_CHUNK_SIZE", 64)
    tree = {"w": {"k": np.arange(300, dtype=np.float32).reshape(10, 30)},
            "b": np.arange(5, dtype=np.int16)}
    data = serialization.msgpack_serialize(tree)
    assert TN.packb(tree) == data
    _same(TN.unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("bad", [
    {"c": np.zeros(2, np.complex64)}, {"c": 1 + 2j}, {1: np.zeros(2)},
    {"t": (1, 2)}, {"o": np.array([object()])}])
def test_unsupported_values_raise(bad):
    with pytest.raises(ValueError):
        TN.packb(bad)


def test_unsupported_payloads_raise():
    bf16 = serialization.msgpack_serialize(
        {"x": jnp.zeros(3, jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        TN.unpackb(bf16)
    cplx = serialization.msgpack_serialize({"x": 1 + 2j})
    with pytest.raises(ValueError, match="ext type 2"):
        TN.unpackb(cplx)
    with pytest.raises(ValueError, match="trailing"):
        TN.unpackb(serialization.msgpack_serialize({"a": 1}) + b"\x00")

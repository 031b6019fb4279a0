"""The port's device mesh (`unetdc_tpu_torch/core/mesh.py`), mirroring the
JAX package's mesh test (tests/test_parallel.py,
`test_mesh_construction_and_sharding_helpers`) on the CPU's logical slots,
and its split / reassembly helpers."""

import numpy as np
import pytest
import torch

from unetdc_tpu_torch.core import mesh as M


def test_make_mesh_shapes_defaults_and_errors():
    mesh = M.make_mesh(4, 2, devices="cpu")
    assert mesh.shape == {"data": 4, "space": 2}
    assert M.make_mesh(devices="cpu").shape == {"data": M.CPU_SLOTS,
                                                "space": 1}
    assert M.make_mesh(n_space=4, devices="cpu").shape == {"data": 2,
                                                           "space": 4}
    m6 = M.make_mesh(3, 2, devices="cpu")  # a sub-mesh over 6 of 8 slots
    assert m6.shape == {"data": 3, "space": 2}
    with pytest.raises(ValueError, match=r"mesh 5x2 needs 10 devices, "
                                         r"have 8"):
        M.make_mesh(5, 2, devices="cpu")
    with pytest.raises(ValueError, match="needs 0 devices"):
        M.make_mesh(0, devices="cpu")


def test_make_mesh_defaults_to_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = M.make_mesh()
    assert mesh.grid == [[torch.device("cuda", 0)], [torch.device("cuda", 1)]]
    with pytest.raises(ValueError, match="mesh 1x4 needs 4 devices, have 2"):
        M.make_mesh(1, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="have 0"):
        M.make_mesh(1)


def test_explicit_devices_may_repeat():
    one = torch.device("cuda", 0)
    mesh = M.make_mesh(2, 2, devices=[one] * 4)
    assert mesh.grid == [[one, one], [one, one]]
    assert mesh.distinct() == [one]
    assert mesh.row(1).shape == {"data": 1, "space": 2}
    # "cuda" without an index names card 0
    assert M.Mesh([["cuda"]]).first == one


def test_replicate_one_copy_per_distinct_device():
    calls = []
    mesh = M.make_mesh(2, 4, devices="cpu")
    reps = M.replicate(mesh, lambda d: calls.append(d) or {"w": d})
    assert calls == [torch.device("cpu")]
    assert list(reps) == [torch.device("cpu")]


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_split_batch_and_gather_round_trip(nd):
    x = torch.from_numpy(np.random.RandomState(nd).rand(8, 6, 5, 3))
    mesh = M.make_mesh(nd, devices="cpu")
    parts = M.split_batch(mesh, x)
    assert len(parts) == nd and all(p.shape[0] == 8 // nd for p in parts)
    assert torch.equal(M.gather(parts, 0, torch.device("cpu")), x)
    parts[0].zero_()  # parts are copies, never views of x
    assert x.abs().sum() > 0 and float(x[0].abs().sum()) > 0


@pytest.mark.parametrize("S", [2, 4, 8])
def test_split_height_round_trip(S):
    x = torch.arange(2 * 16 * 3 * 2.).view(2, 16, 3, 2)
    parts = M.split(x, S, 1, [torch.device("cpu")] * S)
    assert [p.shape[1] for p in parts] == [16 // S] * S
    assert torch.equal(M.gather(parts, 1, torch.device("cpu")), x)
    with pytest.raises(ValueError):
        M.split(x, 3, 1, [torch.device("cpu")] * 3)


def test_batch_must_divide_over_data_groups():
    mesh = M.make_mesh(3, devices="cpu")
    with pytest.raises(ValueError, match="divisible by 3"):
        M.split_batch(mesh, torch.zeros(8, 2))
    M.check_batch(mesh, 9)

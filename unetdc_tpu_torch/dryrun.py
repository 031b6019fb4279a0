"""Whole-program multi-device check of the port: the counterpart of the
JAX package's `__graft_entry__.py::dryrun_multichip`, at its tiny shapes.

    python -c "from unetdc_tpu_torch.dryrun import dryrun_multichip; \
dryrun_multichip(8, devices='cpu')"

On an (n/2, 2) mesh (or (n, 1) for n < 4 or odd n):
1. one Trainer step (preprocess with a rolling ball of radius 10, the
   full-width UNetDC forward and backward, Adam), f32 at 32x32, on the
   mesh (batch over 'data', height over 'space') and on one device: loss
   within 1e-4 relative, every parameter within 2.05 * lr (the JAX
   contract: the cross-shard sums add in another order, and Adam's first
   step moves a parameter by about lr whatever its gradient's size, so a
   near-zero gradient whose sign flips moves it by up to 2 * lr), and
   every BatchNorm running statistic within 1e-5 of its buffer's largest
   magnitude;
2. the f32 QuantifyEngine megastep, batch- and height-sharded, against
   one device: every output bit-equal;
3. the megastep on 128x128 images over the (n, 1), (n/4, 4) and (1, n)
   meshes: bit-equal to one device.
`devices`: "cpu" (n logical slots of the CPU), "cuda" (the visible cards)
or a list of devices, which may repeat one card. Prints `... OK`; any
failed check raises.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from unetdc_tpu_torch.core.mesh import make_mesh, norm_device, \
    visible_devices
from unetdc_tpu_torch.device import resolve_device


def _devices(n: int, devices) -> list:
    if devices is None or devices == "cuda":
        devs = visible_devices("cuda")
    elif devices == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        devs = [norm_device(d) for d in devices]
    if len(devs) < n:
        raise RuntimeError(f"dryrun_multichip({n}): only {len(devs)} "
                           f"device(s) given")
    for d in set(devs):
        resolve_device(d)
    return devs[:n]


def _check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k], np.int64)
                            - np.asarray(b[k], np.int64)).max())
               for k in sorted(b))


def dryrun_multichip(n_devices: int,
                     devices: Union[None, str, Sequence] = None) -> None:
    """Run the sharded train step and the sharded megasteps on
    `n_devices` devices against one device (module docstring)."""
    from unetdc_tpu_torch.models.unet import UNetDC, init_flax_
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    devs = _devices(n_devices, devices)
    n_space = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_space
    mesh = make_mesh(n_data, n_space, devices=devs)
    b = max(n_data, 2)

    # --- sharded train step -------------------------------------------
    cfg = TrainConfig(model="unetdc", loss="focal_dice", batch_size=b,
                      img_size=32, compute_dtype="f32", background_radius=10,
                      augment=False, seed=0, shard_space=n_space > 1)
    rs = np.random.RandomState(0)
    imgs_u8 = (rs.rand(b, 32, 32, 3) * 255).astype(np.uint8)
    masks_u8 = (rs.rand(b, 32, 32) > 0.5).astype(np.uint8)

    def train(use_mesh):
        t = Trainer(cfg, mesh=mesh if use_mesh else None, device=devs[0])
        x, m = t.preprocess(torch.from_numpy(imgs_u8).to(t.device),
                            torch.from_numpy(masks_u8).to(t.device))
        loss = float(t.train_step(x, m[..., None],
                                  torch.ones(b, device=t.device))[0])
        return ([p.detach().cpu() for p in t.model.parameters()],
                [s.cpu() for s in t.model.buffers() if s.is_floating_point()],
                loss)

    params_n, stats_n, loss = train(True)
    _check(np.isfinite(loss), "non-finite loss in the dryrun train step")
    params_1, stats_1, loss_1 = train(False)
    train_maxdiff = max(float((a - c).abs().max())
                        for a, c in zip(params_n, params_1))
    stats_maxdiff = max(float((a - c).abs().max() / c.abs().max())
                        for a, c in zip(stats_n, stats_1))
    _check(abs(loss - loss_1) <= 1e-4 * abs(loss_1),
           f"sharded train loss diverged: {loss} vs {loss_1}")
    _check(train_maxdiff <= 2.05 * cfg.lr,
           f"sharded train step diverged: max param delta {train_maxdiff}")
    _check(stats_maxdiff <= 1e-5,
           f"sharded BatchNorm statistics diverged: {stats_maxdiff}")

    # --- sharded inference megastep -----------------------------------
    model = UNetDC()
    init_flax_(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    imgs = (rs.rand(b, 64, 64, 3) * 255).astype(np.uint8)

    def megastep(m, ns, batch, out_hw, max_labels):
        eng = QuantifyEngine(sd, compute_dtype=torch.float32,
                             max_labels=max_labels, img_size=64,
                             device=devs[0], mesh=m,
                             shard_space=m is not None and ns > 1)
        try:
            return eng.run_batch(batch, out_hw, background_radius=10)
        finally:
            eng.close()

    out = megastep(mesh, n_space, imgs, (64, 64), 256)
    counts = np.asarray(out["count"])
    _check(out["mask"].shape == (b, 64, 64)
           and (counts >= 0).all() and (counts <= 256).all(),
           f"megastep outputs: mask {out['mask'].shape}, counts {counts}")
    inf_maxdiff = _max_diff(out, megastep(None, 1, imgs, (64, 64), 256))
    _check(inf_maxdiff == 0.0, f"sharded megastep diverged: {inf_maxdiff}")

    # --- large-image megastep across mesh shapes ----------------------
    big = (rs.rand(max(n_devices, 2), 128, 128, 3) * 255).astype(np.uint8)
    shapes = [(n_devices, 1)]
    if n_devices % 4 == 0:
        shapes.append((n_devices // 4, 4))
    shapes.append((1, n_devices))
    big_ref = megastep(None, 1, big, (128, 128), 512)
    reports = []
    for nd, ns in shapes:
        got = megastep(make_mesh(nd, ns, devices=devs), ns, big,
                       (128, 128), 512)
        d = _max_diff(got, big_ref)
        _check(d == 0.0, f"large-image megastep diverged on data={nd},"
               f"space={ns}: {d}")
        reports.append(f"data={nd},space={ns}:BIT-equal")

    print(f"dryrun_multichip({n_devices}): mesh={dict(mesh.shape)} "
          f"devices={sorted({str(d) for d in devs})} "
          f"train loss={loss:.4f} "
          f"megastep counts={counts.tolist()} "
          f"sharded-vs-1dev: inference max|diff|={inf_maxdiff} (BIT-equal) "
          f"train max param delta={train_maxdiff:.2e} (<=2.05*lr) "
          f"BatchNorm statistics rel diff={stats_maxdiff:.2e} "
          f"large-image megastep [{' '.join(reports)}] OK")

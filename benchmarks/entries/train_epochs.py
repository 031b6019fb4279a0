"""Entry kind `train_epochs`: `Trainer.run_epoch_train` of
`unetdc_tpu_torch.train.trainer`, repeated, as the trainer CLIs run their
epochs (validation and checkpoint saves left out). One unit is one epoch
over the training pairs that set-up wrote to disk.

Set-up builds one Trainer, loads the benchmark's seeded initial weights
into it and runs its first epoch (epoch 0), which fills the dataset's
decode cache, the trainer's device sample bank and cuDNN's algorithm
choices. It then loads the initial weights again, gives Adam a fresh
state and runs epoch 1 through the same call, as the window runs every
later epoch: from the sample bank, with epoch 1's shuffle and augmentation
draws. The first three steps of epoch 1 are captured on the way (each
step's loss, the first gradient as Adam's state holds it after step 1,
the parameters after step 3), and the window goes on from epoch 2 with
the same object. The check replays those three steps with the plain
float64 reference from the same files, the same initial weights and the
same random draws, and compares:
  - loss_gap: each step's |loss - reference| / |reference|, the largest;
  - grad_gap: per parameter leaf |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the
    median leaf's ‖g_ref‖), the worst leaf's;
  - update_gap: the same for the change of the parameters over the
    three steps, the worst leaf's.
Leaves whose reference gradient norm is under a thousandth of the median
leaf's move by round-off alone and are left out (`gaps`): in float64 that
rule takes the 18 conv biases in front of train-mode BatchNorm, whose
gradient is zero in the mathematics, and any other leaf that reads under
it; each run's stderr names them.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import core
from harness.weights import train_state_dict
from reference import train as ref_train
from traffic import droplet_pairs

CAPTURED_STEPS = 3
CAPTURED_EPOCH = 1


def _train_seed(ctx) -> int:
    return core.sub_seed(ctx.seed, 3) % (1 << 31)


def setup(ctx):
    from unetdc_tpu_torch.data.dataset import SegmentationData
    from unetdc_tpu_torch.train.trainer import Trainer, TrainConfig

    wl, cfg = ctx.workload, ctx.config
    tcfg = cfg["training"]
    p = wl["traffic"]["pairs"]
    img_dir, mask_dir, names = droplet_pairs.write_pairs(
        str(ctx.tmp / "train"), p, core.sub_seed(ctx.seed, 2))
    seed = _train_seed(ctx)
    bs = wl["traffic"]["batch"]
    data = SegmentationData(img_dir, mask_dir, names, names, batch_size=bs,
                            shuffle=True, seed=seed)
    tr = Trainer(TrainConfig(
        model=cfg["model"], loss=tcfg["loss"], batch_size=bs,
        img_size=cfg["input_size"], compute_dtype=tcfg["compute_dtype"],
        augment=True, seed=seed, lr=tcfg["lr"], save_last=False,
        ckpt_path=str(ctx.tmp / "ckpt.msgpack")), device=ctx.device)
    sd0 = train_state_dict(core.sub_seed(ctx.seed, 1), ctx.device)
    missing, unexpected = tr.model.load_state_dict(sd0, strict=False)
    if unexpected or any(not k.endswith(("running_mean", "running_var",
                                         "num_batches_tracked"))
                         for k in missing):
        raise RuntimeError(f"weights do not fit the model: {missing} "
                           f"{unexpected}")
    names_p = [n for n, _ in tr.model.named_parameters()]
    ctx.keep.update(p0={k: v.cpu() for k, v in sd0.items()},
                    img_dir=img_dir, mask_dir=mask_dir, names=names,
                    seed=seed, batch=bs, losses=[])
    tr.run_epoch_train(data, 0)
    # back to the initial weights with a fresh Adam; the decode cache, the
    # sample bank and cuDNN's choices stay, as they do for every later epoch
    tr.model.load_state_dict(sd0, strict=False)
    tr.opt.state.clear()
    del sd0
    orig = tr.train_step
    count = [0]

    def train_step(x, m, valid, valid_np=None):
        out = orig(x, m, valid, valid_np)
        count[0] += 1
        ctx.keep["losses"].append(float(out[0]))
        if count[0] == 1:
            # the first gradient as Adam holds it: exp_avg = (1 - beta1) g;
            # a parameter the step left out of Adam's state got none
            params = dict(tr.model.named_parameters())
            ctx.keep["g1"] = {
                n: (tr.opt.state[params[n]]["exp_avg"] / 0.1).cpu()
                if "exp_avg" in tr.opt.state[params[n]]
                else torch.zeros_like(params[n], device="cpu")
                for n in names_p}
        if count[0] == CAPTURED_STEPS:
            ctx.keep["p3"] = {n: v.detach().to("cpu", copy=True) for n, v in
                              tr.model.named_parameters()}
            del tr.train_step  # back to the class's method
        return out

    tr.train_step = train_step
    tr.run_epoch_train(data, CAPTURED_EPOCH)
    return {"tr": tr, "data": data, "epoch": CAPTURED_EPOCH + 1, "undo": [],
            "waits": []}


def instrument(ctx, state):
    """Time each next() of the trainer's batch iterator (the wait for
    input), and span each epoch's steps."""
    from unetdc_tpu_torch.train import trainer as trainer_mod

    base = trainer_mod.Prefetcher
    waits = state["waits"]

    class TimedPrefetcher(base):
        def __next__(self):
            t0 = time.perf_counter()
            try:
                return super().__next__()
            finally:
                waits.append(time.perf_counter() - t0)

    trainer_mod.Prefetcher = TimedPrefetcher
    state["undo"].append(lambda: setattr(trainer_mod, "Prefetcher", base))


def unit(ctx, state):
    n_waits = len(state["waits"])
    with ctx.spans.span("epoch"):
        state["tr"].run_epoch_train(state["data"], state["epoch"])
    state["epoch"] += 1
    n = len(state["data"].image_list)
    steps = len(state["data"])
    waits = state["waits"][n_waits:]
    return {"attempted": n, "failed": 0, "images": n, "steps": steps,
            "input_waits": waits[:steps]}


def release(ctx, state):
    for undo in reversed(state["undo"]):
        undo()
    state.clear()


def reference_batches(ctx, n_steps: int, epoch: int = CAPTURED_EPOCH):
    """The first n_steps batches of `epoch`: files in that epoch's
    shuffled order (RandomState(seed + epoch)), each with its augmentation
    generator."""
    from PIL import Image

    k = ctx.keep
    order = np.arange(len(k["names"]))
    np.random.RandomState(k["seed"] + epoch).shuffle(order)
    gens = ref_train.augment.batch_generators(k["seed"], epoch, n_steps)
    out = []
    for s in range(n_steps):
        idx = order[s * k["batch"]:(s + 1) * k["batch"]]
        imgs = np.stack([np.array(Image.open(
            f"{k['img_dir']}/{k['names'][i]}").convert("RGB")) for i in idx])
        masks = np.stack([(np.array(Image.open(
            f"{k['mask_dir']}/{k['names'][i]}").convert("L")) > 0
        ).astype(np.uint8) for i in idx])
        out.append({"images": imgs, "masks": masks, "gen": gens[s]})
    return out


def gaps(ref, prog, p0) -> dict:
    """The numbers from (losses, g1, p3) of the reference and of the side
    judged, both started from the parameters p0. Per leaf, a gap of norms
    is |‖a‖ - ‖b‖| / max(‖b‖, the median leaf's ‖b‖), b the reference's;
    the leaves kept are those whose reference gradient norm is at least a
    thousandth of the median leaf's. grad_gap and update_gap are the
    worst leaf's gap, *_median the median leaf's (for the record)."""
    (l_r, g_r, p_r), (l_p, g_p, p_p) = ref, prog
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_p, l_r))
    gn = {k: float(g_r[k].double().norm()) for k in g_r}
    med = float(np.median(list(gn.values())))
    live = [k for k in gn if gn[k] >= 1e-3 * med]

    def leaf_gaps(a, b):
        na = {k: float(a[k].double().norm()) for k in live}
        nb = {k: float(b[k].double().norm()) for k in live}
        m = float(np.median(list(nb.values())))
        return [abs(na[k] - nb[k]) / max(nb[k], m) for k in live]

    gg = leaf_gaps(g_p, g_r)
    ug = leaf_gaps({k: p_p[k].double() - p0[k].double() for k in live},
                   {k: p_r[k].double() - p0[k].double() for k in live})
    worst_g = live[int(np.argmax(gg))]
    worst_u = live[int(np.argmax(ug))]
    return {"loss_gap": loss_gap,
            "grad_gap": max(gg), "grad_gap_median": float(np.median(gg)),
            "update_gap": max(ug), "update_gap_median": float(np.median(ug)),
            "left_out": ",".join(k for k in gn if k not in live),
            "worst_grad_leaf": worst_g, "worst_update_leaf": worst_u}


def reference_steps(ctx, quant=None, batches=None, dtype=torch.float64):
    """The reference's three steps: the judge in float64; a control or a
    fault in the program's place in float32."""
    cfg = ctx.config
    batches = batches or reference_batches(ctx, CAPTURED_STEPS)
    losses, g1, p3 = ref_train.first_steps(
        ctx.keep["p0"], cfg["dilations"], cfg["training"]["loss"], batches,
        cfg["input_size"], ctx.device, quant=quant, dtype=dtype)
    return losses, {k: v.cpu() for k, v in g1.items()}, \
        {k: v.cpu() for k, v in p3.items()}


def compare(ctx) -> dict:
    k = ctx.keep
    ref = reference_steps(ctx)
    prog = (k["losses"][:CAPTURED_STEPS], k["g1"], k["p3"])
    return gaps(ref, prog, k["p0"])


def check(ctx):
    vals = compare(ctx)
    print("info grad_gap_median {grad_gap_median!r} update_gap_median "
          "{update_gap_median!r} left_out {left_out} worst_grad_leaf "
          "{worst_grad_leaf} worst_update_leaf {worst_update_leaf}".format(
              **vals), file=sys.stderr)
    limits = ctx.workload["limits"]
    return {k: {"value": vals[k], "limit": limits[k]} for k in limits}


def _reference_inputs(ctx):
    """Set-up's files and initial weights, without the program."""
    p = ctx.workload["traffic"]["pairs"]
    img_dir, mask_dir, names = droplet_pairs.write_pairs(
        str(ctx.tmp / "train"), p, core.sub_seed(ctx.seed, 2))
    sd0 = train_state_dict(core.sub_seed(ctx.seed, 1), ctx.device)
    ctx.keep.update(p0={k: v.cpu() for k, v in sd0.items()},
                    img_dir=img_dir, mask_dir=mask_dir, names=names,
                    seed=_train_seed(ctx),
                    batch=ctx.workload["traffic"]["batch"])


def control(ctx, quant):
    """The check's numbers with the reference at `quant` (conv operands
    rounded to fp8) in the program's place; no program run."""
    _reference_inputs(ctx)
    ref = reference_steps(ctx)
    low = reference_steps(ctx, quant=quant, dtype=torch.float32)
    return gaps(ref, low, ctx.keep["p0"])


def half_batch(ctx):
    """The check's numbers with half of each batch left out of the steps
    (the loss the mean over the rest), in the program's place."""
    _reference_inputs(ctx)
    ref = reference_steps(ctx)
    batches = reference_batches(ctx, CAPTURED_STEPS)
    h = ctx.keep["batch"] // 2
    for b in batches:
        b["images"], b["masks"] = b["images"][:h], b["masks"][:h]
    return gaps(ref, reference_steps(ctx, batches=batches,
                                     dtype=torch.float32), ctx.keep["p0"])

"""Training: the port's train step on batches already on the card.

`train.step.make_train_step(model, LossConfig, SGD)` with the cell's
hyper-parameters (bf16 autocast over float32 parameters, SGD with Nesterov
momentum, the EMA), on a pool of `pool_batches` seeded batches of `batch`
uint8 `imgsz` frames with `boxes` labels an image (every seed has the same
counts, in another order), cycled. There is no loader.

Set-up builds the step once and drives it from the seed through its first
`checked_steps` steps, on batches whose rows all differ, and hands the same
step to the window. End to end: `train_img_s`, the images of every step of
the window over the window, synchronised at its end. Counters: the steps,
K3's launches. Traced: `trace_steps` more steps.

Check: the plain reference (reference/train.py, float32, TF32 off) follows
the first `checked_steps` steps from the same weights and batches; compared
are each step's loss, the first gradient as the optimizer got it (read from
its momentum buffers after one step) and the parameters' change after the
checked steps, leaf by leaf (harness/compare.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, program
from harness.core import derived_seed, generator, steady_host
from harness.trace import traced
from harness.weights import make_weights
from reference.model import Net, strict_f32
from reference.train import Trainer, group_of


def make_batches(run, net):
    """[(imgs (B, S, S, 3) uint8, targets (B, M, 5), mask (B, M))] on the device."""
    wl, dev = run.workload, run.device
    P, B, S, M = wl["pool_batches"], wl["batch"], wl["imgsz"], wl["max_labels"]
    lo, hi = wl["boxes"]
    g = generator(run.seed, "batches", dev)
    imgs = torch.randint(0, 256, (P, B, S, S, 3), generator=g, device=dev, dtype=torch.uint8)
    counts = np.resize(np.arange(lo, hi + 1), P * B)  # the same counts for every seed
    counts = np.random.default_rng(derived_seed(run.seed, "boxes")).permutation(counts).reshape(P, B)
    u = torch.rand((P, B, M, 5), generator=g, device=dev)
    targets = torch.stack([(u[..., 0] * net.nc).floor().clamp(max=net.nc - 1), 0.1 + 0.8 * u[..., 1],
                           0.1 + 0.8 * u[..., 2], 0.04 + 0.46 * u[..., 3], 0.04 + 0.46 * u[..., 4]], -1)
    mask = torch.arange(M, device=dev)[None, None, :] < torch.as_tensor(counts, device=dev)[..., None]
    targets = targets * mask[..., None]
    return [(imgs[i], targets[i], mask[i]) for i in range(P)]


def build(run, p):
    from yolov3_tpu_torch.train.loss import LossConfig
    from yolov3_tpu_torch.train.optim import build_optimizer
    from yolov3_tpu_torch.train.step import make_train_step

    wl = run.workload
    model = program.build_model(run.config, p, run.device, wl.get("model"))
    optimizer, _, accumulate = build_optimizer("sgd", model, wl["hyp"], epochs=wl["epochs"],
                                               steps_per_epoch=wl["steps_per_epoch"], batch_size=wl["batch"],
                                               nbs=wl["nbs"], min_warmup_steps=wl["min_warmup_steps"])
    if accumulate != 1:
        raise ValueError(f"the train cell's batch {wl['batch']} accumulates {accumulate} batches an update")
    return model, optimizer, make_train_step(model, LossConfig.from_model(model.spec, wl["hyp"]), optimizer)


def drive(run):
    wl, dev = run.workload, run.device
    net = Net(wl.get("model") or run.config["model"])
    p0 = make_weights(net, run.seed, dev)
    batches = make_batches(run, net)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, optimizer, step = build(run, p0)
    params = dict(model.named_parameters())
    wd = optimizer.optimizer.param_groups[0]["weight_decay"]

    # the first steps, through the window's own call, on batches whose rows all differ
    losses, grad_norms = [], {}
    for i in range(wl["checked_steps"]):
        metrics = step(*batches[i % len(batches)])
        losses.append(float(metrics["loss"]))
        if i == 0:  # the gradient the optimizer got: its momentum buffer after one update, less the decay
            total = float(metrics["grad_norm"])
            state = optimizer.optimizer.state
            for k, v in params.items():
                g = state[v]["momentum_buffer"] - (wd * p0[k] if group_of(k) == "weight" else 0.0)
                grad_norms[k] = float(torch.linalg.vector_norm(g))
    deltas = {k: float(torch.linalg.vector_norm(v.detach() - p0[k])) for k, v in params.items()}
    steady_host()
    run.setup_s = time.perf_counter() - run.t_start

    before = program.kernel_counters()
    n, i = 0, wl["checked_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        step(*batches[i % len(batches)])
        i += 1
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    after = program.kernel_counters()
    run.attempted, run.failed = n * wl["batch"], 0
    run.e2e["train_img_s"] = n * wl["batch"] / elapsed
    run.counters.update(steps=n, launches={k: after[k] - before[k] for k in after})
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    run.note(f"window: {n} steps of {wl['batch']} in {elapsed:.3f} s, launches {run.counters['launches']}; "
             f"set-up losses {losses}")

    with traced(run):
        before = program.kernel_counters()
        for j in range(wl["trace_steps"] if run.trace_on else 0):
            step(*batches[(i + j) % len(batches)])
        after = program.kernel_counters()
    run.counters["traced"] = dict(steps=wl["trace_steps"] if run.trace_on else 0,
                                  launches={k: after[k] - before[k] for k in after})

    del step, optimizer, model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(p0, net, batches, wl)
    check_steps(run, dict(losses=losses, grad_norms=grad_norms, deltas=deltas, total=total), want)


def reference_steps(p0, net, batches, wl, precision="f32", batch_rows=None):
    """The reference's losses, first gradient norms and parameter changes over the checked steps."""
    ref = Trainer(p0, net, wl)
    losses, grad_norms, total = [], {}, None
    with strict_f32():
        for i in range(wl["checked_steps"]):
            loss, grads, norm = ref.step(*batches[i % len(batches)], precision=precision, batch_rows=batch_rows)
            losses.append(loss)
            if i == 0:
                grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
                total = norm
    deltas = {k: float(torch.linalg.vector_norm(ref.p[k].detach() - p0[k])) for k in ref.leaves}
    return dict(losses=losses, grad_norms=grad_norms, deltas=deltas, total=total)


def step_gaps(got, want):
    keep = compare.moving_leaves(want["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    out = dict(loss_gap=loss_gap, leaves=len(keep), of=len(want["grad_norms"]),
               clip_norm_gap=abs(got["total"] - want["total"]) / want["total"])
    for name, key in (("grad", "grad_norms"), ("step", "deltas")):
        gaps = compare.leaf_gaps(got[key], want[key], keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)
        out.update({f"{name}_gap": gaps[worst[0]], f"{name}_gap_median": float(np.median(list(gaps.values()))),
                    f"{name}_worst": [(n, round(gaps[n], 5), want[key][n]) for n in worst[:4]],
                    f"{name}_median_norm": float(np.median([want[key][n] for n in keep]))})
    return out


def check_steps(run, got, want):
    gaps = step_gaps(got, want)
    run.note(f"losses {got['losses']} against the reference's {want['losses']}: {gaps}")
    return compare.check(run, gaps)


def control(run, precision="fp8"):
    """The compared numbers of the reference in `precision` put in the program's place."""
    net = Net(run.workload.get("model") or run.config["model"])
    p0 = make_weights(net, run.seed, run.device)
    batches = make_batches(run, net)
    want = reference_steps(p0, net, batches, run.workload)
    return check_steps(run, reference_steps(p0, net, batches, run.workload, precision), want)


def half_batch(run):
    """The compared numbers of a step that leaves out half of each batch (the mean over the rest)."""
    net = Net(run.workload.get("model") or run.config["model"])
    p0 = make_weights(net, run.seed, run.device)
    batches = make_batches(run, net)
    want = reference_steps(p0, net, batches, run.workload)
    rows = list(range(run.workload["batch"] // 2))
    return check_steps(run, reference_steps(p0, net, batches, run.workload, batch_rows=rows), want)

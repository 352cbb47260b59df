"""Optimizer, LR/momentum schedules and EMA (yolov3_tpu/train/optim.py).

The JAX package folds everything into optax transforms of a parameter tree;
here it is `torch.optim` with three parameter groups:

 - `weight` (conv and Detect kernels): weight decay applies;
 - `bn` (BatchNorm scales): no decay;
 - `bias` (every bias): no decay, and its own warm-up learning rate.

`ScheduledOptimizer.step()` is called once per loader batch, after
`backward()`. Gradients of `accumulate` consecutive batches add up in
`.grad`; on the last of them it sets each group's lr (and SGD's momentum) from
the schedules, clips the summed gradient at global norm 10 and steps. The
schedules are functions of the loader step, so the k-th update reads them at
loader step k * accumulate.

Under a process group the train step sets `reduce_grads`, so the gradient is
summed over the ranks before the clip (the norm clipped is the global
gradient's), and the caller builds the optimizer with the total batch,
batch_size x world size, as the JAX package does (loop.py:236-239). Every
rank then takes the same update, and the EMA stays the same on every rank.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from yolov3_tpu_torch.utils.general import LOGGER, one_cycle

GRAD_CLIP_NORM = 10.0


def param_label(name: str) -> str:
    """'bias' | 'bn' | 'weight' for a state-dict key."""
    if name.endswith(".bias"):
        return "bias"
    if name.endswith("bn.weight"):
        return "bn"
    return "weight"


class Schedules(NamedTuple):
    lr: Any  # loader step -> learning rate of the weight and bn groups
    bias_lr: Any  # loader step -> learning rate of the bias group
    momentum: Any  # loader step -> SGD momentum


def build_schedules(hyp, epochs, steps_per_epoch, batch_size, nbs=64, cos_lr=False, min_warmup_steps=100):
    """Functions of the global LOADER step (one per data batch): warm-up of lr
    and momentum over max(warmup_epochs, min_warmup_steps), then the linear or
    one-cycle cosine decay per epoch. A caller that steps once per optimizer
    update converts: loader_step = update * accumulate."""
    lr0 = hyp.get("lr0", 0.01)
    lrf = hyp.get("lrf", 0.01)
    warmup_epochs = hyp.get("warmup_epochs", 3.0)
    warmup_momentum = hyp.get("warmup_momentum", 0.8)
    warmup_bias_lr = hyp.get("warmup_bias_lr", 0.1)
    momentum = hyp.get("momentum", 0.937)

    nw = max(round(warmup_epochs * steps_per_epoch), min_warmup_steps, 1)  # warm-up steps

    def lf(epoch):  # epoch -> decay fraction
        if cos_lr:
            return one_cycle(1.0, lrf, epochs)(epoch)
        return (1 - epoch / epochs) * (1.0 - lrf) + lrf

    def lr_at(step, warmup_start):
        epoch = min(max(math.floor(step / steps_per_epoch), 0), epochs)
        base = lr0 * lf(epoch)
        if step >= nw:
            return base
        return warmup_start + (base - warmup_start) * min(max(step / nw, 0.0), 1.0)

    def mom(step):
        if step >= nw:
            return momentum
        return warmup_momentum + (momentum - warmup_momentum) * min(max(step / nw, 0.0), 1.0)

    return Schedules(lr=lambda step: lr_at(step, 0.0), bias_lr=lambda step: lr_at(step, warmup_bias_lr),
                     momentum=mom)


def frozen_names(names, freeze):
    """The parameter names under frozen top-level layers ('model.{i}.' prefix)."""
    prefixes = tuple(f"model.{i}." for i in freeze)
    return {n for n in names if n.startswith(prefixes)} if prefixes else set()


class ScheduledOptimizer:
    """A `torch.optim` optimizer stepped under the schedules, with gradient
    accumulation and clipping (see the module docstring).

    `updates` counts optimizer updates, `micro` the batches accumulated since
    the last one. Frozen parameters are in no group and never move, but their
    gradients count in the clipped norm, as in the JAX package, where the
    freeze mask zeroes the update after the clip."""

    def __init__(self, optimizer, schedules, accumulate, params, sets_momentum):
        self.optimizer = optimizer
        self.schedules = schedules
        self.accumulate = accumulate
        self.params = list(params)  # every parameter whose gradient is clipped
        self.sets_momentum = sets_momentum
        self.updates = 0
        self.micro = 0
        # called with the gradients on an update, before the clip: the train step
        # under a process group sets the sum over the ranks (train/step.py)
        self.reduce_grads = None

    def step(self):
        """Count one loader batch; on the accumulate-th, update. Returns the
        clipped gradient's pre-clip global norm on an update, else None."""
        self.micro += 1
        if self.micro < self.accumulate:
            return None
        loader_step = self.updates * self.accumulate
        for group in self.optimizer.param_groups:
            sch = self.schedules.bias_lr if group["label"] == "bias" else self.schedules.lr
            group["lr"] = sch(loader_step)
            if self.sets_momentum:
                group["momentum"] = self.schedules.momentum(loader_step)
        if self.reduce_grads is not None:
            self.reduce_grads([p.grad for p in self.params])
        norm = torch.nn.utils.clip_grad_norm_(self.params, GRAD_CLIP_NORM)
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        self.micro = 0
        return norm

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(), "updates": self.updates, "micro": self.micro}

    def load_state_dict(self, sd):
        self.optimizer.load_state_dict(sd["optimizer"])
        self.updates, self.micro = sd["updates"], sd["micro"]


def build_optimizer(name, model, hyp, epochs, steps_per_epoch, batch_size, nbs=64, cos_lr=False,
                    min_warmup_steps=100, freeze=()):
    """SGD (nesterov) / Adam / AdamW / RMSprop with grouped decay over
    `model`'s parameters (an `nn.Module`, or a {name: parameter} dict).

    Weight decay is scaled by batch_size * accumulate / nbs, accumulate =
    max(round(nbs / batch_size), 1). Adam and RMSprop add the decay to the
    gradient (L2); AdamW decouples it. RMSprop is `torch.optim.RMSprop`, which
    adds eps to the root of the second moment; optax, in the JAX package, adds
    it under the root, so the two part only where |g| is about 1e-3 or less.
    Returns (ScheduledOptimizer, Schedules, accumulate)."""
    accumulate = max(round(nbs / batch_size), 1)
    weight_decay = hyp.get("weight_decay", 0.0005) * batch_size * accumulate / nbs
    sch = build_schedules(hyp, epochs, steps_per_epoch, batch_size, nbs, cos_lr, min_warmup_steps)

    named = dict(model.named_parameters()) if isinstance(model, torch.nn.Module) else dict(model)
    frozen = frozen_names(named, freeze)
    if frozen:
        LOGGER.info(f"freezing {len(frozen)} parameter tensors in layers {sorted(freeze)}")
    groups = {label: {"params": [], "label": label, "weight_decay": weight_decay if label == "weight" else 0.0}
              for label in ("weight", "bn", "bias")}
    for pname, p in named.items():
        if pname not in frozen:
            groups[param_label(pname)]["params"].append(p)
    groups = [g for g in groups.values() if g["params"]]

    lr0 = hyp.get("lr0", 0.01)
    beta1 = hyp.get("momentum", 0.937)
    kind = name.lower()
    if kind in ("sgd", ""):
        opt = torch.optim.SGD(groups, lr=lr0, momentum=beta1, nesterov=True)
    elif kind == "adam":
        opt = torch.optim.Adam(groups, lr=lr0, betas=(beta1, 0.999), eps=1e-8)
    elif kind == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=(beta1, 0.999), eps=1e-8)
    elif kind == "rmsprop":
        opt = torch.optim.RMSprop(groups, lr=lr0, alpha=0.99, eps=1e-8, momentum=beta1)
    else:
        raise NotImplementedError(f"Optimizer {name} not implemented")
    return ScheduledOptimizer(opt, sch, accumulate, named.values(), kind in ("sgd", "")), sch, accumulate


class EMA:
    """Exponential moving average of a model's parameters and BatchNorm
    statistics with a ramped decay, d = decay * (1 - exp(-updates / tau)).

    `ema` is a state dict of copies; integer buffers (BatchNorm's batch
    counters) are copied, not averaged."""

    def __init__(self, model, decay=0.9999, tau=2000.0):
        self.decay = decay
        self.tau = tau
        self.updates = 0
        self.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}

    @torch.no_grad()
    def update(self, model, decay=None):
        self.updates += 1
        d = (self.decay if decay is None else decay) * (1.0 - math.exp(-self.updates / self.tau))
        sd = model.state_dict()
        avg, cur, counters, counts = [], [], [], []
        for k, e in self.ema.items():
            if e.is_floating_point():
                avg.append(e)
                cur.append(sd[k].detach().to(e.dtype))
            else:
                counters.append(e)
                counts.append(sd[k])
        torch._foreach_mul_(avg, d)
        torch._foreach_add_(avg, cur, alpha=1.0 - d)
        if counters:
            torch._foreach_copy_(counters, counts)


class EarlyStopping:
    """Patience-based stopper on fitness."""

    def __init__(self, patience=100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")
        self.possible_stop = False

    def __call__(self, epoch, fitness):
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        delta = epoch - self.best_epoch
        self.possible_stop = delta >= (self.patience - 1)
        return delta >= self.patience

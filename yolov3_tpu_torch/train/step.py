"""The train step: forward, loss, backward, optimizer, EMA (yolov3_tpu/train/step.py).

The JAX package compiles the step into one program over a state pytree that
it returns anew. Here the step runs eagerly and updates a `TrainState` in
place: the model's f32 parameters and BatchNorm buffers, the optimizer's
state, the EMA copy, the step counter and (autobalance) the per-scale
objectness weights.

Precision: f32 parameters, bf16 compute through
`torch.autocast(device, torch.bfloat16)`, f32 loss math after the loss's
gather; bf16 keeps f32's exponent range, so there is no GradScaler. In train
mode the stride-1 3x3 convs take their BatchNorm statistics from
`conv3x3_bn_stats` (nn/modules.py), on the card the kernel of csrc/conv_bn.cu.

`remat`, `remat_segment` and `remat_until` checkpoint the forward in
segments (DetectionModel.forward), as the JAX step's do; the recomputed
forward updates no BatchNorm statistic.

`mesh=torch.distributed.group.WORLD` (the process group, one process per
card; None without one) is the JAX step's sharded form: the step computes
what the JAX step computes on the global batch, each rank holding its rows
of it. The model's parameters and
buffers and the EMA are broadcast from rank 0 when the step is built. Each
call computes the rank's share of the global-batch loss with BatchNorm
statistics over the global batch (`synchronized_statistics`), and on an
update the optimizer sums the shares' gradients over the ranks, in one
all-reduce of the flat gradients after `backward()`, before the clip: the
gradient of the global loss, not DDP's mean of the ranks' full-loss
gradients. DistributedDataParallel is not used: its bucket all-reduces run
as gradients become ready, on a stream of their own, interleaved with the
statistics' backward all-reduces on the same group, and an activation
checkpoint's recompute reruns the forward's all-reduces inside the
backward; one reduction after `backward()` keeps every rank's collectives in
one order. The metrics are the global batch's (one small all-reduce).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
from yolov3_tpu_torch.parallel.mesh import all_reduce_sum_, all_reduce_tensors_, replicate, synchronized_statistics
from yolov3_tpu_torch.train.loss import LossConfig, compute_loss, update_balance
from yolov3_tpu_torch.train.optim import EMA, ScheduledOptimizer
from yolov3_tpu_torch.utils.tracing import span


@dataclass
class TrainState:
    """Everything a train step reads and updates in place."""

    model: torch.nn.Module  # f32 parameters and BatchNorm buffers
    optimizer: ScheduledOptimizer
    ema: EMA
    step: int = 0
    balance: torch.Tensor | None = None  # (nl,) objectness weights under autobalance


def normalize_images(imgs, dtype=torch.float32):
    """uint8 NHWC -> [0, 1] in the compute dtype, on the device the images
    are on. uint8 values are exact in bf16 (8 significand bits)."""
    return imgs.to(dtype) / 255.0


def init_train_state(model, optimizer, loss_cfg: LossConfig | None = None) -> TrainState:
    """The initial state around a model and its optimizer: the EMA starts as
    a copy of the model, the balance at the config's table."""
    balance = None
    if loss_cfg is not None and loss_cfg.autobalance:
        balance = torch.tensor(loss_cfg.balance, dtype=torch.float32, device=model.device)
    return TrainState(model=model, optimizer=optimizer, ema=EMA(model), balance=balance)


def make_train_step(model, loss_cfg: LossConfig, optimizer, state: TrainState | None = None,
                    ema_decay=0.9999, loss_scale=1.0, compute_dtype=torch.bfloat16,
                    bn_stats_fn=conv3x3_bn_stats, remat=False, remat_segment=None, remat_until=None, mesh=None):
    """Build the train step over `state` (made by `init_train_state` when not given).

    Returns step_fn(imgs_u8, targets, mask) -> metrics, with `step_fn.state`
    the state it updates. imgs_u8: (B, H, W, 3) uint8; targets: (B, M, 5)
    padded labels [cls, x, y, w, h]; mask: (B, M). The metrics `loss`, `lbox`,
    `lobj`, `lcls` (and `grad_norm` on a call that updated the parameters) are
    0-dim tensors on the model's device, not synchronised with the host.

    The forward, the loss, the backward, the optimizer and the EMA are
    spans (utils/tracing.py) named `train_step/forward`, `/loss`,
    `/backward`, `/optimizer` and `/ema`: ranges of a profile of the step,
    and rows of the span table.

    Every call counts one loader batch: the optimizer accumulates and updates
    on its own cadence, the EMA moves on every call.
    `loss_scale`: total-loss multiplier (4.0 for a quad collate).
    `compute_dtype`: torch.bfloat16 (autocast) or torch.float32.
    `bn_stats_fn`: the conv+BN-statistics function of the train-mode convs:
    the kernel wrapper, or its plain version to compare the two.
    `remat`: activation checkpointing of the forward in segments of
    `remat_segment` layers (default 6), over the layers below `remat_until`
    (default: the whole body); the backward recomputes each segment once,
    which launches its conv+statistics kernels once more.
    `mesh`: torch.distributed.group.WORLD, the group of
    parallel.mesh.initialize_distributed (the module docstring); every rank
    builds the step and calls it with its own rows, an equal number of them.
    """
    if mesh is not None and mesh is not dist.group.WORLD:
        raise TypeError(f"make_train_step: mesh is {mesh!r}; training runs one process per card over the "
                        "default process group: pass torch.distributed.group.WORLD")
    mesh = mesh is not None
    if state is None:
        state = init_train_state(model, optimizer, loss_cfg)
    if mesh:  # every rank starts from rank 0's state
        replicate(model)
        replicate(state.ema.ema)
        if state.balance is not None:
            replicate(state.balance)
        optimizer.reduce_grads = all_reduce_tensors_
    autobalance = loss_cfg.autobalance
    ssi = loss_cfg.strides.index(16) if (autobalance and 16 in loss_cfg.strides) else 0
    autocast = compute_dtype != torch.float32
    remat_kw = {}
    if remat:
        remat_kw = dict(remat=True, remat_segment=6 if remat_segment is None else int(remat_segment),
                        remat_until=-1 if remat_until is None else int(remat_until))

    def step_fn(imgs, targets, mask):
        device = model.device
        model.train()
        model.set_bn_stats_fn(bn_stats_fn)
        imgs = torch.as_tensor(imgs, device=device)
        with synchronized_statistics(mesh):
            with span("train_step/forward"), \
                    torch.autocast(device.type, dtype=compute_dtype if autocast else None, enabled=autocast):
                # without autocast the images are normalised in the model's own dtype, as in the JAX step
                feats = model(normalize_images(imgs, compute_dtype if autocast else model.dtype), **remat_kw)
            with span("train_step/loss"):
                loss, comps, obj_pl = compute_loss(feats, targets, mask, loss_cfg,
                                                   balance=state.balance if autobalance else None,
                                                   return_per_layer_obj=True)
                loss = loss * loss_scale
            with span("train_step/backward"):
                loss.backward()
        loss = loss.detach()
        if mesh:  # the shares' sums: the global batch's loss, components and obj losses
            shares = all_reduce_sum_(torch.cat([loss.reshape(1).to(comps.dtype), comps, obj_pl.to(comps.dtype)]))
            loss, comps, obj_pl = shares[0].to(loss.dtype), shares[1:4], shares[4:].to(obj_pl.dtype)
        with span("train_step/optimizer"):
            grad_norm = state.optimizer.step()
        with span("train_step/ema"):
            state.ema.update(model, decay=ema_decay)
        state.step += 1
        if autobalance:
            state.balance = update_balance(state.balance, obj_pl, ssi)
        metrics = {"loss": loss, "lbox": comps[0], "lobj": comps[1], "lcls": comps[2]}
        if grad_norm is not None:
            metrics["grad_norm"] = grad_norm
        return metrics

    step_fn.state = state
    return step_fn

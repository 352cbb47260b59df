"""Training engine: `train(...)` (yolov3_tpu/train/loop.py, reference train.py:105-530).

Flow: run directory -> dataset YAML -> model (fresh, from `weights=`, or
resumed) -> datasets and loaders -> autoanchor -> optimizer, schedules and
the train step -> epochs (train, EMA validation, fitness, checkpoints,
early stop) -> the `last` and `best` checkpoints stripped for inference.

    from yolov3_tpu_torch.train.loop import train
    best_fitness, results, save_dir = train(data="dataset.yaml", cfg="yolov3", imgsz=640, epochs=100)

On the card, every train step runs the conv+BatchNorm-statistics kernel in
its stride-1 3x3 convs and every validation batch the NMS kernel (through
eval.validator.run, at K = 30000). The loader's numpy batches go to the card
from pinned memory without blocking the host.

Randomness: `init_seeds(seed)` gives the run's random.Random and
np.random.RandomState; the train dataset's augmentations and autoanchor
draw from them in the order the JAX package draws from its global
generators (with `workers=1`; more workers interleave their draws), and the
loader shuffles with np.random.default_rng(seed), as there. A resumed run's
loader starts its shuffle from `seed` again: a resume restores the state
exactly, not the data order an uninterrupted run would have seen.

`remat=True` checkpoints the train step's forward in segments
(train/step.py); the recompute updates no BatchNorm statistic.

Not ported (each raises NotImplementedError): `s2d_stem` (ROADMAP.md queue
1 item 9), `sync_bn` and multi-process runs (item 8), `upload_dataset` and
`entity` (item 7) and plots: `noplots` defaults to True here, and
`noplots=False` raises (item 5).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from yolov3_tpu_torch.data.dataset_yaml import check_dataset
from yolov3_tpu_torch.data.datasets import DataLoader, DetectionDataset
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.eval.metrics import fitness
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.optim import EarlyStopping, build_optimizer
from yolov3_tpu_torch.train.step import make_train_step
from yolov3_tpu_torch.utils.callbacks import Callbacks
from yolov3_tpu_torch.utils.checkpoint import (load_checkpoint, load_model_from_checkpoint, restore_train_state,
                                               save_checkpoint, strip_checkpoint)
from yolov3_tpu_torch.utils.general import (LOGGER, colorstr, increment_path, init_seeds,
                                           labels_to_class_weights, labels_to_image_weights, select_device,
                                           yaml_load, yaml_save)
from yolov3_tpu_torch.utils.loggers import Loggers

HYPS = Path(__file__).resolve().parents[1] / "data" / "hyps"


def _refuse(**options):
    items = {"s2d_stem": "the space-to-depth stem (ROADMAP.md queue 1 item 9)",
             "sync_bn": "SyncBatchNorm and multi-process training (ROADMAP.md queue 1 item 8)",
             "upload_dataset": "dataset upload to W&B (ROADMAP.md queue 1 item 7)",
             "entity": "the W&B entity (ROADMAP.md queue 1 item 7)",
             "plots": "plots; pass noplots=True (ROADMAP.md queue 1 item 5)"}
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"train: {items[name]} is not ported yet")


def _to_device(a, device):
    """A numpy batch array on `device`; to the card from pinned memory, without blocking."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def train(
    data,
    cfg="yolov3-tiny",
    hyp=None,
    weights=None,
    epochs=100,
    batch_size=16,
    imgsz=640,
    optimizer="sgd",
    cos_lr=False,
    noautoanchor=False,
    noval=False,
    nosave=False,
    single_cls=False,
    patience=100,
    save_dir=None,
    project="runs/train",
    name="exp",
    exist_ok=False,
    seed=0,
    max_labels=300,
    callbacks=None,
    resume=False,
    save_period=-1,
    rect_val=True,
    image_weights=False,
    multi_scale=False,
    freeze=(),
    quad=False,
    workers=2,
    cache_images=None,
    remat=False,
    s2d_stem=False,
    noplots=True,
    rect=False,
    label_smoothing=0.0,
    sync_bn=False,
    half=None,
    entity=None,
    upload_dataset=False,
    bbox_interval=-1,
    device=None,
):
    """Train a detection model. Returns (best_fitness, results, save_dir).

    The arguments are the JAX `train`'s, plus `device` (None means "cuda"
    and raises without one; the CPU only when asked for). `bbox_interval`
    paces image logging, which is not ported, and is accepted unused.
    `half=None` means bf16 autocast on the card and float32 on the CPU.
    `noplots` defaults to True because plots are not ported; `s2d_stem`,
    `sync_bn`, `upload_dataset`, `entity` and `noplots=False` raise
    NotImplementedError (see the module docstring). `resume=True`
    continues the run in `save_dir` from weights/last, full or stripped.
    """
    _refuse(s2d_stem=s2d_stem, sync_bn=sync_bn, upload_dataset=upload_dataset, entity=entity, plots=not noplots)
    device = select_device(device)
    callbacks = callbacks or Callbacks()
    t_start = time.time()

    # dirs + config snapshot (reference train.py:157-172)
    save_dir = Path(save_dir) if save_dir else increment_path(Path(project) / name, exist_ok=exist_ok)
    wdir = save_dir / "weights"
    wdir.mkdir(parents=True, exist_ok=True)
    if isinstance(hyp, (str, Path)):
        hyp = yaml_load(hyp)
    hyp = dict(hyp or yaml_load(HYPS / "scratch-low.yaml"))
    if label_smoothing:
        hyp["label_smoothing"] = label_smoothing
    yaml_save(save_dir / "hyp.yaml", hyp)
    rng, np_rng = init_seeds(seed)
    Loggers(save_dir=save_dir).attach(callbacks)
    callbacks.run("on_pretrain_routine_start")

    data_dict = check_dataset(data)
    names = data_dict["names"]
    nc = 1 if single_cls else data_dict["nc"]
    # labels are checked against the dataset's classes and single_cls collapses them to 0 after;
    # checking them against nc = 1 would drop every image with another class (the JAX package's
    # train() does, unless a label cache of the dataset already exists)
    data_nc = data_dict["nc"]

    # model (reference train.py:199-213)
    if resume:
        model, start_epoch, best_fitness = _resume_model(save_dir, device)
    elif weights:
        model = load_model_from_checkpoint(weights, device=device)
        if model.spec.nc != nc:
            LOGGER.info(f"Overriding checkpoint nc={model.spec.nc} with nc={nc}: re-init Detect head")
            model = _transfer_to_nc(model, cfg, nc, seed)
        start_epoch, best_fitness = 0, 0.0
    else:
        model = DetectionModel.from_config(cfg, seed=seed, device=device, nc=nc)
        start_epoch, best_fitness = 0, 0.0
    model.names = names
    if half is None:
        half = device.type == "cuda"
    compute_dtype = torch.bfloat16 if half else torch.float32
    stride = int(max(model.spec.strides))
    nl = model.spec.nl
    if batch_size == -1:  # AutoBatch (reference train.py:230-232)
        from yolov3_tpu_torch.utils.autobatch import check_train_batch_size

        batch_size = check_train_batch_size(model, imgsz=imgsz, compute_dtype=compute_dtype)

    # datasets
    if rect:
        # rect batches turn mosaic and shuffling off (the dataset and loader see to it)
        assert not multi_scale, "--rect and --multi-scale are incompatible"
        LOGGER.info("rect training: mosaic+shuffle off")
    train_ds = DetectionDataset(
        data_dict["train"], imgsz=imgsz, augment=True, hyp=hyp, rect=rect, stride=stride,
        batch_size=batch_size, num_cls=data_nc, max_labels=max_labels, single_cls=single_cls,
        cache_images=cache_images, rng=rng, np_rng=np_rng,
    )
    train_loader = DataLoader(train_ds, batch_size=batch_size, shuffle=not rect, max_labels=max_labels,
                              seed=seed, drop_last=True, quad=quad, workers=workers, label_buckets=True)
    steps_per_epoch = max(len(train_loader), 1)
    if multi_scale:
        # 5 fixed square sizes over [0.5, 1.5] x imgsz, one drawn every 10 batches, resized in the workers
        buckets = sorted({max(round(imgsz * f / stride), 1) * stride for f in (0.5, 0.75, 1.0, 1.25, 1.5)})
        train_loader.set_multi_scale(buckets, seed=seed)

    val_loader = None
    if not noval:
        val_ds = DetectionDataset(
            data_dict.get("val") or data_dict["train"], imgsz=imgsz, augment=False, rect=rect_val,
            stride=stride, pad=0.5, batch_size=batch_size, num_cls=data_nc, max_labels=max_labels,
            single_cls=single_cls,
        )
        val_loader = DataLoader(val_ds, batch_size=batch_size, shuffle=False, max_labels=max_labels)

    # autoanchor (reference train.py:314-316)
    if not noautoanchor and not resume:
        from yolov3_tpu_torch.utils.autoanchor import check_anchors

        new_anchors = check_anchors(train_ds, model.spec, thr=hyp.get("anchor_t", 4.0), imgsz=imgsz,
                                    np_rng=np_rng)
        if new_anchors is not None:
            _with_new_anchors(model, new_anchors)

    # hyp gain scaling (reference train.py:327-329)
    hyp = dict(hyp)
    hyp["box"] = hyp.get("box", 0.05) * 3 / nl
    hyp["cls"] = hyp.get("cls", 0.5) * nc / 80 * 3 / nl
    hyp["obj"] = hyp.get("obj", 1.0) * (imgsz / 640) ** 2 * 3 / nl
    loss_cfg = LossConfig.from_model(model.spec, hyp)

    # optimizer + schedules + step
    freeze_layers = list(range(freeze[0])) if len(freeze) == 1 else list(freeze)
    opt, schedules, _ = build_optimizer(optimizer, model, hyp, epochs, steps_per_epoch, batch_size, cos_lr=cos_lr,
                                        freeze=freeze_layers)
    step_fn = make_train_step(model, loss_cfg, opt, loss_scale=4.0 if quad else 1.0, compute_dtype=compute_dtype,
                              remat=remat)
    state = step_fn.state
    if resume:
        sd, _ = load_checkpoint(wdir / "last")
        restore_train_state(state, sd)  # a stripped `last` restores weights + EMA, the optimizer starts fresh

    if train_ds.labels:
        all_labels = np.concatenate([lb for lb in train_ds.labels if len(lb)], 0) if any(
            len(lb) for lb in train_ds.labels) else np.zeros((0, 5), np.float32)
        callbacks.run("on_pretrain_routine_end", labels=all_labels, names=names)

    stopper = EarlyStopping(patience=patience)
    ema_model = copy.deepcopy(model).eval() if val_loader is not None else None
    LOGGER.info(f"Image sizes {imgsz} train/val, {device}, {compute_dtype}, "
                f"logging to {colorstr('bold', str(save_dir))}, starting training for {epochs} epochs...")
    callbacks.run("on_train_start")

    final_epoch = start_epoch
    results = (0, 0, 0, 0, 0, 0, 0)
    maps = np.zeros(nc)
    for epoch in range(start_epoch, epochs):
        final_epoch = epoch
        callbacks.run("on_train_epoch_start")
        if image_weights:
            # resample dataset indices by (1 - per-class mAP)^2 (reference train.py:360-363)
            cw = labels_to_class_weights(train_ds.labels, nc) * (1 - maps) ** 2 / nc
            iw = labels_to_image_weights(train_ds.labels, nc=nc, class_weights=cw)
            rng_iw = np.random.default_rng(seed + epoch)
            train_loader.set_indices(rng_iw.choice(len(train_ds), size=len(train_ds), p=iw / iw.sum()))
        mloss = np.zeros(3)
        nb = 0
        epoch_metrics = []
        t_epoch = time.time()
        train_loader.ms_offset = epoch * steps_per_epoch  # multi-scale draws anchored to the global step
        for imgs, targets, mask, _ in train_loader:
            callbacks.run("on_train_batch_start")
            metrics = step_fn(_to_device(imgs, device), _to_device(targets, device), _to_device(mask, device))
            epoch_metrics.append(torch.stack([metrics["lbox"], metrics["lobj"], metrics["lcls"]]))
            ni = epoch * steps_per_epoch + nb  # global batch counter
            nb += 1
            if ni < 3:
                callbacks.run("on_train_batch_end", ni=ni, imgs=imgs, targets=targets, mask=mask)
            else:
                callbacks.run("on_train_batch_end", ni=ni)
        if epoch_metrics:  # one device->host fetch an epoch, not one a step
            mloss = torch.stack(epoch_metrics).float().mean(0).cpu().numpy()
        lr_now = float(schedules.lr(state.step))
        LOGGER.info(f"epoch {epoch + 1}/{epochs}: box {mloss[0]:.4f} obj {mloss[1]:.4f} cls {mloss[2]:.4f} "
                    f"lr {lr_now:.5f} ({time.time() - t_epoch:.1f}s)")
        callbacks.run("on_train_epoch_end", epoch=epoch)

        # per-epoch validation with the EMA weights (reference train.py:446-459)
        fi = 0.0
        if val_loader is not None:
            ema_model.load_state_dict(state.ema.ema)
            results, maps, _ = validator.run(
                data_dict, model=ema_model, batch_size=batch_size, imgsz=imgsz, dataloader=val_loader,
                loss_cfg=loss_cfg, compute_loss_flag=True, names=names, single_cls=single_cls,
                save_dir=save_dir, callbacks=callbacks,
            )
            fi = float(fitness(np.array(results).reshape(1, -1))[0])
            callbacks.run("on_val_end", epoch=epoch)
        vals = [*mloss, *[float(v) for v in (list(results) + [0.0] * 7)[:7]], lr_now, lr_now, lr_now]
        callbacks.run("on_fit_epoch_end", epoch=epoch, fitness=fi, vals=vals)

        # checkpoints (reference train.py:469-489)
        if not nosave:
            meta = {"epoch": epoch, "best_fitness": max(best_fitness, fi),
                    "names": {int(k): v for k, v in names.items()}, "hyp": hyp,
                    "results": [float(x) for x in results]}
            save_checkpoint(wdir / "last", state, spec=model.spec, meta=meta)
            if fi >= best_fitness:
                best_fitness = fi
                save_checkpoint(wdir / "best", state, spec=model.spec, meta=meta)
            if save_period > 0 and epoch % save_period == 0:
                save_checkpoint(wdir / f"epoch{epoch}", state, spec=model.spec, meta=meta)
            callbacks.run("on_model_save", epoch=epoch, last=str(wdir / "last"), fitness=float(fi),
                          best=bool(fi >= best_fitness), final=epoch == epochs - 1, save_period=save_period)

        if stopper(epoch, fi):
            LOGGER.info(f"EarlyStopping: no improvement in {patience} epochs, stopping at epoch {epoch}")
            break

    # finalise (reference train.py:502-527)
    if not nosave:
        for f in (wdir / "last", wdir / "best"):
            if f.exists():
                strip_checkpoint(f)
    LOGGER.info(f"\n{final_epoch - start_epoch + 1} epochs completed in {(time.time() - t_start) / 3600:.3f} hours.")
    callbacks.run("on_train_end")
    callbacks.run("teardown")
    return best_fitness, results, save_dir


def _resume_model(save_dir, device):
    """The model of save_dir/weights/last, its next epoch and best fitness (reference train.py:642-654)."""
    last = Path(save_dir) / "weights" / "last"
    assert last.exists(), f"resume checkpoint not found at {last}"
    model = load_model_from_checkpoint(last, device=device)
    meta = yaml_load(last / "checkpoint.yaml")
    start_epoch = int(meta.get("epoch", -1)) + 1
    best_fitness = float(meta.get("best_fitness", 0.0))
    LOGGER.info(f"Resuming training from {last} at epoch {start_epoch}")
    return model, start_epoch, best_fitness


def _with_new_anchors(model, anchors_px):
    """Swap the spec's anchors (pixel units) in place; the weights stay."""
    nl, na = model.spec.nl, model.spec.na
    new_anchors = tuple(tuple(float(v) for v in anchors_px.reshape(nl, na * 2)[i]) for i in range(nl))
    model.spec = dataclasses.replace(model.spec, anchors=new_anchors)
    return model


@torch.no_grad()
def _transfer_to_nc(model, cfg, nc, seed=0):
    """Partial transfer: the backbone's weights kept, the Detect head
    re-initialised for a new class count (reference train.py:207-211
    intersect_dicts: every tensor whose name and shape match is kept)."""
    new = DetectionModel.from_config(cfg or model.spec.name, seed=seed, device=model.device, nc=nc)
    old = model.state_dict()
    sd = new.state_dict()
    for k, v in sd.items():
        if k in old and old[k].shape == v.shape:
            v.copy_(old[k])
    return new

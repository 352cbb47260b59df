"""Loggers: the training run's fan-out to results.csv, the console, the
plots and the tracker sinks (yolov3_tpu/utils/loggers/__init__.py,
reference utils/loggers/__init__.py:63-420).

`Loggers` exposes the callback hooks. results.csv and the console line are
always on. TensorBoard (torch.utils.tensorboard, else TensorFlow's summary
writer), W&B, ClearML and Comet are on when their package imports and, for
W&B and Comet, when their API key is set, as in the JAX package: a sink
whose package is missing is off. Each SDK is imported inside its sink, and
a sink that fails logs a warning; training goes on. Image files go to the
sinks through the in-tree decoder (data/image_ops.py), never cv2.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.utils import plots as plot_fns
from yolov3_tpu_torch.utils.general import LOGGER, colorstr

LOGGERS = ("csv", "tb", "wandb", "clearml", "comet")

KEYS = (
    "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss", "x/lr0", "x/lr1", "x/lr2",
)  # fmt: skip


def _tensorboard(save_dir):
    """torch.utils.tensorboard's SummaryWriter, else TensorFlow's writer, else None."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb = SummaryWriter(str(save_dir))
        LOGGER.info(f"{colorstr('TensorBoard:')} start with 'tensorboard --logdir {Path(save_dir).parent}'")
        return tb
    except Exception:  # noqa: BLE001 — tensorboard missing or broken: the TF writer, else off
        try:
            import tensorflow as tf

            return _TFSummaryWriter(tf, str(save_dir))
        except Exception:  # noqa: BLE001
            return None


def _wandb(opt, hyp):
    """A W&B run (reference wandb_utils.py:64-73): project from --project's
    stem unless the default, name unless "exp", resume by run id
    ("wandb-run://<id>" in --resume, or WANDB_RUN_ID)."""
    import wandb

    project = getattr(opt, "project", None)
    project = Path(project).stem if project and Path(project).stem not in ("train", "runs") else "yolov3_tpu"
    name = getattr(opt, "name", None)
    run_id = os.environ.get("WANDB_RUN_ID")
    resume = getattr(opt, "resume", None)
    if isinstance(resume, str) and resume.startswith("wandb-run://"):
        run_id = resume[len("wandb-run://"):]
    return wandb.init(project=project, entity=getattr(opt, "entity", None),
                      name=None if name in (None, "exp") else name, id=run_id, resume="allow",
                      allow_val_change=True, config={"opt": opt, "hyp": hyp})


class Loggers:
    """The logging sinks behind the callback hooks. With `plots`, the label
    plots at the start, the first three train batches' mosaics and
    results.png at the end (reference loggers/__init__.py:112-136, 240); a
    plot that fails logs a warning and the run goes on. `opt` carries the
    fields the trackers read (project, name, entity, resume, epochs,
    bbox_interval, upload_dataset)."""

    def __init__(self, save_dir=None, opt=None, hyp=None, include=LOGGERS, plots=True):
        self.save_dir = Path(save_dir or ".")
        self.opt = opt
        self.hyp = hyp
        self.plots = plots
        self.keys = KEYS
        self.csv_file = self.save_dir / "results.csv"
        self.tb = self.wandb = self.clearml = self.comet = None
        # val mosaics go to the trackers every bbox_interval epochs; -1 means epochs // 10 (at least 1)
        # (reference wandb_utils.py:89-93)
        epochs = int(getattr(opt, "epochs", 0) or 0) if opt else 0
        self.bbox_interval = int(getattr(opt, "bbox_interval", -1) or -1) if opt else -1
        if self.bbox_interval == -1:
            self.bbox_interval = max(1, epochs // 10) if epochs > 10 else 1

        if "tb" in include:
            self.tb = _tensorboard(self.save_dir)
        if "wandb" in include and os.environ.get("WANDB_API_KEY"):
            self.wandb = self._sink("W&B", _wandb, opt, hyp)
        if "clearml" in include:
            self.clearml = self._sink("ClearML", lambda: __import__("clearml").Task.init(
                project_name="yolov3_tpu", task_name=str(self.save_dir.name)))
        if "comet" in include and os.environ.get("COMET_API_KEY"):
            self.comet = self._sink("Comet", lambda: __import__("comet_ml").Experiment(project_name="yolov3_tpu"))
        # per-image prediction logging (reference comet/__init__.py) and the epoch a val belongs to
        self._comet_pred_state = {}
        self._clearml_logged_images = 0
        self._epoch = 0

    @staticmethod
    def _sink(name, make, *args):
        """A tracker's run, or None when its package is missing or it fails to start."""
        try:
            return make(*args)
        except ImportError:
            return None
        except Exception as e:  # noqa: BLE001 — a tracker that fails to start is off, as in the JAX package
            LOGGER.warning(f"{name} logging is off: {e!r}")
            return None

    # -- hooks ---------------------------------------------------------------
    def on_pretrain_routine_end(self, labels=None, names=()):
        """labels.png and labels_correlogram.jpg of the train split's (n, 5) labels, sent to the sinks."""
        if labels is None or not len(labels) or not self.plots:
            return
        try:
            plot_fns.plot_labels(labels, names, self.save_dir)
            plot_fns.plot_labels_correlogram(labels, self.save_dir)
            self._log_image_files(sorted(self.save_dir.glob("labels*.jpg")) +
                                  sorted(self.save_dir.glob("labels*.png")), "Labels", 0)
        except Exception as e:  # noqa: BLE001 — a plot never stops a training run
            LOGGER.warning(f"label plots failed: {e!r}")

    def on_train_batch_end(self, ni, imgs=None, targets=None, mask=None):
        """train_batch{ni}.jpg of the first three batches; the three go to the sinks after the third."""
        if imgs is None or ni >= 3 or not self.plots:
            return
        try:
            plot_fns.plot_images(imgs, targets, masks=mask, fname=self.save_dir / f"train_batch{ni}.jpg")
            if ni == 2:
                self._log_image_files(sorted(self.save_dir.glob("train_batch*.jpg")), "Mosaics", 0)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"train batch mosaic failed: {e!r}")

    def on_val_image_end(self, predn, path, names, labelsn=None):
        """One validated image's detections in its own pixels: Comet gets the
        image and its matched boxes (reference comet/__init__.py:258-296),
        ClearML the drawn boxes, at most 16 images an epoch."""
        names = names if isinstance(names, dict) else dict(enumerate(names or ()))
        if self.comet:
            from yolov3_tpu_torch.utils.loggers.comet_utils import log_predictions

            log_predictions(self.comet, predn, labelsn, path, names, self._comet_pred_state, curr_epoch=self._epoch)
        if self.clearml and self._clearml_logged_images < 16 and len(predn):
            from yolov3_tpu_torch.utils.loggers.clearml_utils import log_image_with_boxes

            log_image_with_boxes(self.clearml, path, predn, names, iteration=self._epoch)
            self._clearml_logged_images += 1

    def on_val_end(self, epoch=0):
        """The val plots to the image sinks; the val mosaics every bbox_interval epochs."""
        files = [self.save_dir / n for n in
                 ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png", "confusion_matrix.png")]
        if self.bbox_interval > 0 and (epoch + 1) % self.bbox_interval == 0:
            files += sorted(self.save_dir.glob("val_batch*.jpg"))
        files = [f for f in files if f.exists()]
        self._log_image_files(files, "Validation", epoch)
        if self.clearml and files:
            try:
                from yolov3_tpu_torch.utils.loggers.clearml_utils import log_debug_samples

                log_debug_samples(self.clearml, files, "Validation")
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"ClearML debug samples failed: {e!r}")

    def on_fit_epoch_end(self, vals, epoch):
        """The epoch's 13 standard keys: a row of results.csv, the console line and every scalar sink."""
        self._epoch = epoch
        self._clearml_logged_images = 0  # the debug-image cap is per epoch
        x = dict(zip(self.keys, list(vals) + [0.0] * (len(self.keys) - len(vals))))
        new = not self.csv_file.exists()
        with open(self.csv_file, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["epoch", *self.keys])
            w.writerow([epoch, *[f"{float(v):.6f}" for v in x.values()]])
        LOGGER.info(f"epoch {epoch}: " + " ".join(f"{k.split('/')[-1]} {float(v):.5g}" for k, v in x.items()))
        if self.tb:
            for k, v in x.items():
                self.tb.add_scalar(k, float(v), epoch)
        if self.wandb:
            self._wandb_log({**x, "epoch": epoch})
        if self.comet:
            self.comet.log_metrics(x, epoch=epoch)

    def on_model_save(self, last=None, epoch=0, final=False, fitness=0.0, best=False, save_period=-1):
        """The checkpoint directory to W&B and Comet as a model artifact, on
        the final epoch and every `save_period` epochs only (reference
        loggers/__init__.py:178-190)."""
        if not last or not (final or (save_period > 0 and epoch % save_period == 0)):
            return
        if self.wandb:
            try:
                from yolov3_tpu_torch.utils.loggers.wandb_utils import log_model

                self.wandb.log({"model/checkpoint": str(last), "epoch": epoch})
                log_model(self.wandb, last, epoch=epoch, fitness=fitness, best=best or final)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"W&B model artifact failed: {e!r}")
        if self.comet:
            try:
                from yolov3_tpu_torch.utils.loggers.comet_utils import log_model

                self.comet.log_other(f"checkpoint_epoch_{epoch}", str(last))
                log_model(self.comet, last, epoch=epoch, fitness=fitness, best=best or final)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"Comet model artifact failed: {e!r}")

    def on_train_end(self, results_csv=None):
        """results.png, the final push of it and the val mosaics, the Comet
        prediction metadata (image-metadata.json), then the sinks closed."""
        if self.comet and self._comet_pred_state.get("metadata"):
            try:
                from yolov3_tpu_torch.utils.loggers.comet_utils import flush_prediction_metadata

                flush_prediction_metadata(self.comet, self._comet_pred_state, self._epoch)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"Comet prediction metadata flush failed: {e!r}")
        results_csv = Path(results_csv or self.csv_file)
        if self.plots and results_csv.exists():
            try:
                plot_fns.plot_results(results_csv)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"results plot failed: {e!r}")
        finals = [self.save_dir / "results.png"] + sorted(self.save_dir.glob("val_batch*.jpg"))
        self._log_image_files([f for f in finals if f.exists()], "Results", 0)
        if self.tb and hasattr(self.tb, "flush"):
            self.tb.flush()
        if self.wandb:
            self.wandb.finish()

    def log_model_graph(self, model, imgsz=640):
        """The model to TensorBoard as text: its module tree, and the input
        size its graph is logged for (the JAX package logs its forward's
        StableHLO text under model/stablehlo; reference add_graph,
        loggers/__init__.py:242-244). Nothing is traced, so it costs no
        device time."""
        if not self.tb:
            return
        try:
            text = f"input (1, {int(imgsz)}, {int(imgsz)}, 3) NHWC\n{model}"
            self.tb.add_text("model/graph", f"```\n{text[:100_000]}\n```", 0)
            LOGGER.info(f"TensorBoard: logged the model graph ({len(text)} chars)")
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"model graph logging failed: {e!r}")

    def log_dataset_artifact(self, data_dict):
        """--upload_dataset: the dataset as a W&B artifact, the resolved data
        dict as its metadata and the split directories or list files as its
        entries; a split name ("val") uploads that split only."""
        if not self.wandb:
            return
        which = getattr(self.opt, "upload_dataset", True) if self.opt else True
        try:
            import wandb

            meta = {k: str(v) for k, v in data_dict.items() if k != "names"}
            meta["nc"] = int(data_dict.get("nc", len(data_dict.get("names", {}))))
            art = wandb.Artifact(name=data_dict.get("dataset_name", "yolov3-dataset"), type="dataset", metadata=meta)
            for split in ("train", "val", "test"):
                if isinstance(which, str) and split != which:
                    continue
                p = data_dict.get(split)
                for one in (p if isinstance(p, list) else [p] if p else []):
                    one = Path(one)
                    if one.is_dir() and hasattr(art, "add_dir"):
                        art.add_dir(str(one), name=split)
                    elif one.is_file():
                        art.add_file(str(one), name=f"{split}/{one.name}")
            self.wandb.log_artifact(art)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"dataset artifact upload failed: {e!r}")

    def _wandb_log(self, payload):
        """A W&B error warns, finishes the run and turns the sink off; training
        goes on (reference wandb_utils.py:137-151)."""
        try:
            self.wandb.log(payload)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"An error occurred in wandb; training will proceed without it. {e!r}")
            try:
                self.wandb.finish()
            except Exception:  # noqa: BLE001 — the run is being dropped either way
                pass
            self.wandb = None

    def _log_image_files(self, files, name, step):
        """Image files to TensorBoard (decoded in-tree, as RGB), W&B and Comet."""
        for f in map(Path, files):
            try:
                if self.tb and hasattr(self.tb, "add_image"):
                    self.tb.add_image(f"{name}/{f.stem}", image_ops.imread(f)[:, :, ::-1], step, dataformats="HWC")
                if self.wandb:
                    import wandb

                    self.wandb.log({f"{name}/{f.stem}": wandb.Image(str(f))})
                if self.comet:
                    self.comet.log_image(str(f), name=f"{name}/{f.stem}", step=step)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"image logging failed for {f}: {e!r}")

    def attach(self, callbacks):
        """Register every hook on a Callbacks bus (reference loggers/__init__.py:112-240)."""
        callbacks.register_action("on_pretrain_routine_end", "loggers",
                                  lambda labels=None, names=(), **_: self.on_pretrain_routine_end(labels, names))
        callbacks.register_action("on_train_batch_end", "loggers",
                                  lambda ni=3, imgs=None, targets=None, mask=None, **_:
                                  self.on_train_batch_end(ni, imgs, targets, mask))
        callbacks.register_action("on_fit_epoch_end", "loggers",
                                  lambda epoch=0, fitness=0.0, vals=(), **_: self.on_fit_epoch_end(vals or [fitness],
                                                                                                   epoch))
        callbacks.register_action("on_train_epoch_end", "loggers", lambda epoch=0, **_: setattr(self, "_epoch", epoch))
        callbacks.register_action("on_val_image_end", "loggers",
                                  lambda predn=None, path=None, names=(), labelsn=None, **_:
                                  self.on_val_image_end(predn, path, names, labelsn))
        callbacks.register_action("on_val_end", "loggers", lambda epoch=0, **_: self.on_val_end(epoch))
        callbacks.register_action("on_model_save", "loggers",
                                  lambda last=None, epoch=0, final=False, fitness=0.0, best=False, save_period=-1, **_:
                                  self.on_model_save(last, epoch, final, fitness, best, save_period))
        callbacks.register_action("on_train_end", "loggers", lambda **_: self.on_train_end(self.csv_file))
        return callbacks


class _TFSummaryWriter:
    """The TensorBoard sink on tf.summary, where torch.utils.tensorboard is missing."""

    def __init__(self, tf, logdir):
        self._tf = tf
        self._writer = tf.summary.create_file_writer(logdir)

    def add_scalar(self, tag, value, step):
        with self._writer.as_default():
            self._tf.summary.scalar(tag, value, step=step)

    def add_image(self, tag, img_hwc, step, dataformats="HWC"):
        with self._writer.as_default():
            self._tf.summary.image(tag, img_hwc[None], step=step)

    def add_text(self, tag, text, step=0):
        with self._writer.as_default():
            self._tf.summary.text(tag, text, step=step)

    def flush(self):
        self._writer.flush()


class GenericLogger:
    """results.csv and TensorBoard for a run that is not a training run (reference loggers GenericLogger)."""

    def __init__(self, save_dir, include=("csv", "tb")):
        self.inner = Loggers(save_dir=save_dir, include=include)

    def log_metrics(self, metrics: dict, epoch: int):
        self.inner.on_fit_epoch_end(list(metrics.values()), epoch)

    def log_images(self, files, name="Images", epoch=0):
        self.inner._log_image_files([Path(f) for f in files], name, epoch)


def read_results(csv_file):
    """results.csv as a list of {column: float} rows."""
    with open(csv_file, newline="") as f:
        return [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]

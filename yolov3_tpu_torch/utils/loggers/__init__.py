"""Loggers: the training run's results.csv, console line and plots
(yolov3_tpu/utils/loggers/__init__.py, the CSV sink and the plot hooks).

The JAX package also fans out to TensorBoard, W&B, ClearML and Comet; those
sinks are not ported (ROADMAP.md queue 1, "Logger sinks and dataset tools").
"""

from __future__ import annotations

import csv
from pathlib import Path

from yolov3_tpu_torch.utils import plots as plot_fns
from yolov3_tpu_torch.utils.general import LOGGER

KEYS = (
    "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss", "x/lr0", "x/lr1", "x/lr2",
)  # fmt: skip


class Loggers:
    """results.csv (one row of the 13 standard keys per epoch) and a console
    line, behind the callback hooks; with `plots`, the label plots at the
    start, the first three train batches' mosaics and results.png at the end
    (reference loggers/__init__.py:112-136, 240). A plot that fails logs a
    warning and the run goes on."""

    def __init__(self, save_dir=None, plots=True):
        self.save_dir = Path(save_dir or ".")
        self.plots = plots
        self.keys = KEYS
        self.csv_file = self.save_dir / "results.csv"

    def on_pretrain_routine_end(self, labels=None, names=()):
        """labels.png and labels_correlogram.png of the train split's (n, 5) labels."""
        if labels is None or not len(labels) or not self.plots:
            return
        try:
            plot_fns.plot_labels(labels, names, self.save_dir)
            plot_fns.plot_labels_correlogram(labels, self.save_dir)
        except Exception as e:  # noqa: BLE001 — a plot never stops a training run
            LOGGER.warning(f"label plots failed: {e!r}")

    def on_train_batch_end(self, ni, imgs=None, targets=None, mask=None):
        """train_batch{ni}.png of the first three batches."""
        if imgs is None or ni >= 3 or not self.plots:
            return
        try:
            plot_fns.plot_images(imgs, targets, masks=mask, fname=self.save_dir / f"train_batch{ni}.png")
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"train batch mosaic failed: {e!r}")

    def on_fit_epoch_end(self, vals, epoch):
        """Append the epoch's 13 standard keys to results.csv and log them."""
        x = dict(zip(self.keys, list(vals) + [0.0] * (len(self.keys) - len(vals))))
        new = not self.csv_file.exists()
        with open(self.csv_file, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["epoch", *self.keys])
            w.writerow([epoch, *[f"{float(v):.6f}" for v in x.values()]])
        LOGGER.info(f"epoch {epoch}: " + " ".join(f"{k.split('/')[-1]} {float(v):.5g}" for k, v in x.items()))

    def on_train_end(self):
        """results.png from results.csv."""
        if not (self.plots and self.csv_file.exists()):
            return
        try:
            plot_fns.plot_results(self.csv_file)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"results plot failed: {e!r}")

    def attach(self, callbacks):
        callbacks.register_action("on_pretrain_routine_end", "loggers",
                                  lambda labels=None, names=(), **_: self.on_pretrain_routine_end(labels, names))
        callbacks.register_action("on_train_batch_end", "loggers",
                                  lambda ni=3, imgs=None, targets=None, mask=None, **_:
                                  self.on_train_batch_end(ni, imgs, targets, mask))
        callbacks.register_action("on_fit_epoch_end", "loggers",
                                  lambda vals, epoch, **_: self.on_fit_epoch_end(vals, epoch))
        callbacks.register_action("on_train_end", "loggers", lambda **_: self.on_train_end())


def read_results(csv_file):
    """results.csv as a list of {column: float} rows."""
    with open(csv_file, newline="") as f:
        return [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]

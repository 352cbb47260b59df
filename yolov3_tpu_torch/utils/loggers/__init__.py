"""Loggers: the training run's results.csv and console line
(yolov3_tpu/utils/loggers/__init__.py, the CSV sink only).

The JAX package also fans out to TensorBoard, W&B, ClearML and Comet and
draws plots; those sinks are not ported (ROADMAP.md queue 1 items 7 and 5).
"""

from __future__ import annotations

import csv
from pathlib import Path

from yolov3_tpu_torch.utils.general import LOGGER

KEYS = (
    "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss", "x/lr0", "x/lr1", "x/lr2",
)  # fmt: skip


class Loggers:
    """results.csv (one row of the 13 standard keys per epoch) and a console
    line, behind the callback hooks."""

    def __init__(self, save_dir=None):
        self.save_dir = Path(save_dir or ".")
        self.keys = KEYS
        self.csv_file = self.save_dir / "results.csv"

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

    def attach(self, callbacks):
        callbacks.register_action("on_fit_epoch_end", "loggers",
                                  lambda vals, epoch, **_: self.on_fit_epoch_end(vals, epoch))


def read_results(csv_file):
    """results.csv as a list of {column: float} rows."""
    with open(csv_file, newline="") as f:
        return [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]

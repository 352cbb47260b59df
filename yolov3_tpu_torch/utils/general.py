"""General helpers: logger, YAML loading, channel rounding, device choice,
timer, COCO class ids (the parts of yolov3_tpu/utils/general.py the port
needs, kept as its own copy)."""

from __future__ import annotations

import contextlib
import logging
import math
import time

import torch
import yaml


def set_logging(name="yolov3_tpu_torch"):
    """Configure and return the package logger."""
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        log.addHandler(handler)
        log.propagate = False
    return log


LOGGER = set_logging()


def yaml_load(file="data.yaml"):
    """Load a YAML file into a dict."""
    with open(file, errors="ignore") as f:
        return yaml.safe_load(f)


def make_divisible(x, divisor):
    """Round up x to the nearest multiple of divisor."""
    return math.ceil(x / divisor) * divisor


def select_device(device=None) -> torch.device:
    """Resolve an entry point's `device` argument.

    None means "cuda". Without a CUDA device that raises: the port never
    drops to the CPU on its own; a caller that wants the CPU says so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
        device = "cuda"
    return torch.device(device)


class Profile(contextlib.ContextDecorator):
    """Accumulating wall-clock timer. Given a CUDA device it synchronises that
    device on exit, so the time covers the work the block queued (the
    reference's CUDA-synchronised Profile)."""

    def __init__(self, t=0.0, device=None):
        self.t = t
        self.dt = 0.0
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.device = device

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.dt = time.perf_counter() - self.start
        self.t += self.dt


def coco80_to_coco91_class():
    """Map COCO 80-class contiguous ids to the 91-class paper ids (for COCO JSON eval)."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33,
        34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
        62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]  # fmt: skip

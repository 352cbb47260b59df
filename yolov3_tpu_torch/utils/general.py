"""General helpers: logger, YAML loading, channel rounding, device choice
(the parts of yolov3_tpu/utils/general.py the port needs, kept as its own copy)."""

from __future__ import annotations

import logging
import math

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

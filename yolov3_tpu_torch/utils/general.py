"""General helpers: logger, YAML files, seeds, run directories, channel
rounding, device choice, timer, class weights, COCO class ids, git
provenance and the CLIs' checks (the parts of yolov3_tpu/utils/general.py
the port needs, kept as its own copy)."""

from __future__ import annotations

import contextlib
import glob
import logging
import math
import os
import random
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parents[2]  # the repository
# where a dataset YAML's relative `path` is resolved (the JAX package's default)
DATASETS_DIR = Path(os.getenv("YOLOV3_TPU_DATASETS_DIR", ROOT.parent / "datasets"))


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


def colorstr(*input):
    """Colourise a string for the terminal, e.g. colorstr('blue', 'hello')."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
        "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m", "bright_green": "\033[92m",
        "bright_yellow": "\033[93m", "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m",
    }  # fmt: skip
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def yaml_load(file="data.yaml"):
    """Load a YAML file into a dict."""
    with open(file, errors="ignore") as f:
        return yaml.safe_load(f)


def yaml_save(file="data.yaml", data=None):
    """Save a dict to a YAML file, Paths as strings."""
    with open(file, "w") as f:
        yaml.safe_dump({k: str(v) if isinstance(v, Path) else v for k, v in (data or {}).items()}, f, sort_keys=False)


def init_seeds(seed=0):
    """The host random generators of one run, seeded with `seed`, and torch's.

    Returns (random.Random(seed), np.random.RandomState(seed)). The JAX
    package seeds the global `random` and `np.random` instead
    (yolov3_tpu/utils/general.py init_seeds); these two replay the same
    draws, so a caller that passes them where the JAX package reads the
    globals, in the same order, gets the same numbers."""
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return random.Random(seed), np.random.RandomState(seed)


def increment_path(path, exist_ok=False, sep="", mkdir=False):
    """Increment a run path, e.g. runs/exp -> runs/exp2, runs/exp3, ..."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                break
        path = Path(p)
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def make_divisible(x, divisor):
    """Round up x to the nearest multiple of divisor."""
    return math.ceil(x / divisor) * divisor


def check_img_size(imgsz, s=32, floor=0):
    """Image size(s) rounded up to a multiple of the stride s (at least `floor`)."""
    if isinstance(imgsz, int):
        new_size = max(make_divisible(imgsz, int(s)), floor)
    else:
        imgsz = list(imgsz)
        new_size = [max(make_divisible(x, int(s)), floor) for x in imgsz]
    if new_size != imgsz:
        LOGGER.warning(f"--img-size {imgsz} must be multiple of max stride {s}, updating to {new_size}")
    return new_size


def check_suffix(file="model.ckpt", suffix=(".ckpt",), msg=""):
    """Assert file(s) have an acceptable suffix."""
    if file and suffix:
        if isinstance(suffix, str):
            suffix = [suffix]
        for f in file if isinstance(file, (list, tuple)) else [file]:
            s = Path(f).suffix.lower()
            if len(s):
                assert s in suffix, f"{msg}{f} acceptable suffix is {suffix}"


def check_yaml(file, suffix=(".yaml", ".yml")):
    """A YAML file's path, searched for as `check_file` does."""
    return check_file(file, suffix)


def check_file(file, suffix=""):
    """`file` if it exists, else the one file of that name in the package's
    config directories; a local search only (nothing is downloaded)."""
    check_suffix(file, suffix)
    file = str(file)
    if Path(file).is_file() or not file:
        return file
    files = []
    for d in ("yolov3_tpu_torch/models/configs", "yolov3_tpu_torch/data", "yolov3_tpu_torch/data/hyps", "data"):
        files.extend(glob.glob(str(ROOT / d / "**" / Path(file).name), recursive=True))
    assert len(files), f"File not found: {file}"
    assert len(files) == 1, f"Multiple files match '{file}', specify exact path: {files}"
    return files[0]


def file_size(path):
    """Size of a file or directory in MB."""
    mb = 1 << 20
    path = Path(path)
    if path.is_file():
        return path.stat().st_size / mb
    if path.is_dir():
        return sum(f.stat().st_size for f in path.glob("**/*") if f.is_file()) / mb
    return 0.0


def print_args(args: dict | None = None, show_file=True):
    """Log a dict of arguments (CLI echo)."""
    s = ", ".join(f"{k}={v}" for k, v in (args or {}).items())
    LOGGER.info(colorstr("args: ") + s)


def clean_str(s):
    """Sanitize a string to be a safe filename component."""
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)


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


def labels_to_class_weights(labels, nc=80):
    """Inverse-frequency class weights from a list of (n,5) label arrays."""
    if not len(labels):
        return np.ones(nc) / nc
    classes = np.concatenate([lb[:, 0] for lb in labels], 0).astype(int)
    weights = np.bincount(classes, minlength=nc).astype(float)
    weights[weights == 0] = 1
    weights = 1 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc=80, class_weights=None):
    """Per-image sampling weights from per-class weights (image-weighted training)."""
    if class_weights is None:
        class_weights = np.ones(nc)
    counts = np.array([np.bincount(lb[:, 0].astype(int), minlength=nc) for lb in labels])
    return (class_weights.reshape(1, nc) * counts).sum(1)


def check_git_info(path="."):
    """{remote, branch, commit} of a git repository, or Nones outside one (a checkpoint's provenance)."""

    def _git(*args):
        try:
            r = subprocess.run(["git", "-C", str(path), *args], capture_output=True, text=True, timeout=5)
            return r.stdout.strip() or None if r.returncode == 0 else None
        except (OSError, subprocess.TimeoutExpired):
            return None

    return {
        "remote": _git("config", "--get", "remote.origin.url"),
        "branch": _git("rev-parse", "--abbrev-ref", "HEAD"),
        "commit": _git("rev-parse", "--short", "HEAD"),
    }

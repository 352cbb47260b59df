"""The harness's frame: files found by name, seeds, the state of one run and
its result line.

A run is one process: `run.py` builds a `Run`, hands it to the cell's
traffic driver (`traffic/<driver>.py`, whose `drive(run)` sets up, warms
up, measures for `run.seconds` and checks the outputs against the plain
reference), then reads the cell's per-layer metrics (`metrics/<name>.py`)
and prints the result line.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov3_tpu")  # top-level module names no run may load


def load_json(kind, name):
    """h100bench/<kind>/<name>.json, e.g. ("workloads", "yolov3-serve-b32")."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_module(kind, name):
    """The module of h100bench/<kind>/<name>.py: `kind.name` where the name is
    an identifier (the traffic drivers), else loaded from its file (metric
    names hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r}: {path} is missing")
    if name.isidentifier():
        return importlib.import_module(f"{kind}.{name}")
    mod_name = f"h100bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def derived_seed(seed, purpose):
    """A seed for one purpose of a run (weights, frames, arrivals, ...), the
    same for the same (seed, purpose) in every process."""
    return int(hashlib.sha256(f"{int(seed)}/{purpose}".encode()).hexdigest()[:15], 16)


def generator(seed, purpose, device):
    return torch.Generator(device=device).manual_seed(derived_seed(seed, purpose))


def steady_host():
    """Before a window: collect, then freeze every object the set-up made, so
    the collector's full passes in the window scan only what the window makes
    (a full pass over the set-up's objects stalls every thread for tens of
    milliseconds)."""
    gc.collect()
    gc.freeze()


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is in FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """One run of one cell. The driver fills in `setup_s`, `e2e`, `counters`,
    `attempted`, `failed`, `memory_peak`, `trace` (traced runs) and the
    compared numbers through `check`."""

    cell: str
    seed: int
    seconds: float
    trace_on: bool
    device: torch.device
    t_start: float
    workload: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    setup_s: float | None = None
    e2e: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: dict | None = None
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    notes: list = field(default_factory=list)

    def check(self, name, value, limit):
        """A compared number and its limit; the run is correct when every
        number is finite and at most its limit."""
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self):
        return bool(self.checks) and self.failed == 0 and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)

    def note(self, line):
        self.notes.append(line)
        print(line, file=sys.stderr, flush=True)


def result(run, metrics, units, breakdown=None):
    """The result line: `metrics` {name: value} with `units` {name: unit};
    the compared numbers come last, each beside its limit."""
    if run.device.type == "cuda":
        device = dict(platform="gpu", kind=torch.cuda.get_device_name(run.device), count=1,
                      memory_peak_bytes=int(run.memory_peak))
    else:
        device = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=int(run.memory_peak))
    if run.trace_on and run.trace is not None:
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    line = dict(correct=run.correct, attempted=int(run.attempted), failed=int(run.failed),
                metrics={k: dict(value=v, unit=units[k]) for k, v in metrics.items()}, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: dict(value=v, limit=lim) for n, v, lim in run.checks}
    return line

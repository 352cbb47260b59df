"""Narrow configurations and small runs for the CPU tests: the published
layer graphs with every width divided by 8 (16 channels at least), and the
cells' workloads at small sizes."""

from __future__ import annotations

import copy
import json
import time

import torch

from harness import core
from harness.core import ROOT

SMALL = {  # per traffic driver: what a CPU run of a cell changes
    "batch": dict(batch=2, imgsz=64, pool_batches=2, trace_batches=1, warmup_batches=1),
    "stream": dict(imgsz=64, sizes=[[48, 64], [72, 128], [64, 64], [38, 50]], pool_per_size=2, rate=40.0,
                   sample=8, workers=4, max_batch=4, trace_seconds=0.2),
    "train": dict(batch=4, imgsz=64, pool_batches=4, nbs=4),
    "val": dict(batch=2, imgsz=64, pool_batches=2, max_nms=3000, trace_batches=1),
}


def narrow_model(name):
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    m = copy.deepcopy(cfg["model"])
    for row in m["layers"]:
        if row[2] in ("Conv", "Bottleneck", "SPP"):
            row[3][0] = max(16, row[3][0] // 8)
    return cfg, m


def small_run(cell, seed=3, seconds=0.3, **over):
    """A Run of `cell` on the CPU at its narrow configuration and small sizes."""
    wl = core.load_json("workloads", cell)
    cfg, m = narrow_model(wl["config"])
    wl.update(SMALL[wl["traffic"]], model=m, **over)
    return core.Run(cell=cell, seed=seed, seconds=seconds, trace_on=False, device=torch.device("cpu"),
                    t_start=time.perf_counter(), workload=wl, config=cfg)


def drive(run):
    core.load_module("traffic", run.workload["traffic"]).drive(run)
    return run

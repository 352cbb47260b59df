"""Narrow configurations and small runs for the CPU tests: the published
layer graphs with every width divided by 8 (16 channels at least), and the
cells' workloads at small sizes. Besides the benchmark's configurations, two
YOLOv5 v6 models as ultralytics/yolov5 publishes them, in the port's
spelling (`backbone` and `head`): yolov5s (models/yolov5s.yaml, 7,235,389
parameters) and the P6 yolov5x6 (models/hub/yolov5x6.yaml, 140.7 M)."""

from __future__ import annotations

import copy
import json
import time

import torch

from harness import core
from harness.core import ROOT
from reference.model import WIDTH_OPS, Net

SMALL = {  # per traffic driver: what a CPU run of a cell changes
    "batch": dict(batch=2, imgsz=64, pool_batches=2, trace_batches=1, warmup_batches=1),
    "stream": dict(imgsz=64, sizes=[[48, 64], [72, 128], [64, 64], [38, 50]], pool_per_size=2, rate=40.0,
                   sample=8, workers=4, max_batch=4, trace_seconds=0.2),
    "train": dict(batch=4, imgsz=64, pool_batches=4, nbs=4),
    "val": dict(batch=2, imgsz=64, pool_batches=2, max_nms=3000, trace_batches=1),
}


YOLOV5S = {
    "nc": 80, "depth_multiple": 0.33, "width_multiple": 0.50,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]],
    "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 3, "C3", [128]],
                 [-1, 1, "Conv", [256, 3, 2]], [-1, 6, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
                 [-1, 9, "C3", [512]], [-1, 1, "Conv", [1024, 3, 2]], [-1, 3, "C3", [1024]],
                 [-1, 1, "SPPF", [1024, 5]]],
    "head": [[-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 6], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 4], 1, "Concat", [1]], [-1, 3, "C3", [256, False]],
             [-1, 1, "Conv", [256, 3, 2]], [[-1, 14], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [512, 3, 2]], [[-1, 10], 1, "Concat", [1]], [-1, 3, "C3", [1024, False]],
             [[17, 20, 23], 1, "Detect", ["nc", "anchors"]]],
}
YOLOV5X6 = {
    "nc": 80, "depth_multiple": 1.33, "width_multiple": 1.25,
    "anchors": [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137], [140, 301, 303, 264, 238, 542],
                [436, 615, 739, 380, 925, 792]],
    "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 3, "C3", [128]],
                 [-1, 1, "Conv", [256, 3, 2]], [-1, 6, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
                 [-1, 9, "C3", [512]], [-1, 1, "Conv", [768, 3, 2]], [-1, 3, "C3", [768]],
                 [-1, 1, "Conv", [1024, 3, 2]], [-1, 3, "C3", [1024]], [-1, 1, "SPPF", [1024, 5]]],
    "head": [[-1, 1, "Conv", [768, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 8], 1, "Concat", [1]], [-1, 3, "C3", [768, False]],
             [-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 6], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 4], 1, "Concat", [1]], [-1, 3, "C3", [256, False]],
             [-1, 1, "Conv", [256, 3, 2]], [[-1, 20], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [512, 3, 2]], [[-1, 16], 1, "Concat", [1]], [-1, 3, "C3", [768, False]],
             [-1, 1, "Conv", [768, 3, 2]], [[-1, 12], 1, "Concat", [1]], [-1, 3, "C3", [1024, False]],
             [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]]],
}
MODELS = {"yolov5s": YOLOV5S, "yolov5x6": YOLOV5X6}


def config_of(name):
    """A configuration of the benchmark (configs/<name>.json), else one of MODELS."""
    path = ROOT / "configs" / f"{name}.json"
    if path.is_file():
        return json.loads(path.read_text())
    return dict(name=name, nc=MODELS[name]["nc"], model=MODELS[name])


def narrow_model(name):
    cfg = config_of(name)
    m = copy.deepcopy(cfg["model"])
    for row in m["layers"] if "layers" in m else m["backbone"] + m["head"]:
        if row[2] in WIDTH_OPS:
            row[3][0] = max(16, row[3][0] // 8)
    return cfg, m


def frame_size(m):
    """The smallest frames of the CPU tests for a `model` block, 64 px or two
    cells of its coarsest level: a 1x1 map settles each BatchNorm of a
    stride-64 level to two values a batch, and rounding then grows layer by
    layer (narrow yolov5x6 at 64 px: 2e-3 to 8e-2 between the port's own
    float32 and float64 heads)."""
    return max(64, 2 * max(Net(m).strides))


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

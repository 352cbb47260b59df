#!/usr/bin/env python3
"""The knee of a stream cell: each rate offered in turn after one set-up.

    python3 h100bench/tools/sweep_stream.py --workload yolov3-tiny-stream --seed 5 --seconds 5 \
        --rates 100,200,400,600,800

Prints a row a rate (requests offered, completed a second, p50 / p95 / p99
latency, the generator's p99 lateness, how long the queue took to drain
after the last send, requests a device call). The highest rate completed
without a growing backlog is the knee; the cell's `rate` is set at about
four fifths of it. Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def main():
    import torch

    from harness import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="yolov3-tiny-stream")
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rates", default="100,200,400,600,800")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    wl = core.load_json("workloads", a.workload)
    run = core.Run(cell=a.workload, seed=a.seed, seconds=a.seconds, trace_on=False, device=torch.device("cuda", 0),
                   t_start=time.perf_counter(), workload=wl, config=core.load_json("configs", wl["config"]))
    rows = core.load_module("traffic", wl["traffic"]).sweep(run, [float(r) for r in a.rates.split(",")], a.seconds)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

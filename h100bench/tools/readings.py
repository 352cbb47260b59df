#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, at a cell's own size.

    python3 h100bench/tools/readings.py --workload yolov3-serve-b32 --seeds 1-12 --seconds 3 \
        --control-seeds 101-103 [--faults] --out readings.json

In one process: the program's compared numbers on each of --seeds (a whole
run of the cell at --seconds, its check included), then the control's (the
plain reference in the next lower precision in the program's place, the
traffic driver's `control`) on each of --control-seeds, and with --faults the
training cell's planted faults (`half_batch`). Each line printed and the
JSON written hold every number with the limit the cell has now. Needs a
CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main():
    import torch

    from harness import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    wl = core.load_json("workloads", a.workload)
    config = core.load_json("configs", wl["config"])
    driver = core.load_module("traffic", wl["traffic"])
    rows = []

    def run_of(seed, seconds=0.0):
        torch.cuda.empty_cache()
        return core.Run(cell=a.workload, seed=seed, seconds=seconds, trace_on=False, device=torch.device("cuda", 0),
                        t_start=time.perf_counter(), workload=wl, config=config)

    kinds = [("program", s, lambda r: driver.drive(r)) for s in a.seeds]
    kinds += [("control", s, lambda r: driver.control(r)) for s in a.control_seeds]
    if a.faults:
        kinds += [("half_batch", s, lambda r: driver.half_batch(r)) for s in a.control_seeds]
    for kind, seed, fn in kinds:
        run = run_of(seed, a.seconds if kind == "program" else 0.0)
        t0 = time.perf_counter()
        fn(run)
        row = dict(kind=kind, seed=seed, s=time.perf_counter() - t0, setup_s=run.setup_s, e2e=run.e2e,
                   checks={n: v for n, v, _ in run.checks}, correct=run.correct, note=run.notes[-1])
        rows.append(row)
        print("READING " + json.dumps(row), flush=True)
    for name in rows[0]["checks"] if rows else []:
        for kind in ("program", "control", "half_batch"):
            vals = [r["checks"][name] for r in rows if r["kind"] == kind]
            if vals:
                print(f"{name} {kind}: max {max(vals)!r} min {min(vals)!r} over {len(vals)} seeds "
                      f"(limit now {wl['check'][name]})", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The benchmark of yolov3_tpu_torch on an NVIDIA H100: one run of one cell.

    python3 h100bench/run.py --workload yolov3-serve-b32 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout that holds the program (yolov3_tpu_torch/)
and BENCHMARK.json. The cell's file (workloads/<cell>.json) names its
configuration (configs/<config>.json) and its traffic driver
(traffic/<driver>.py), which makes the weights and inputs from --seed, warms
up, measures for --seconds and compares what the timed path produced with
the plain reference (reference/). With --trace 0 the result line holds the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, each read
by metrics/<name>.py. The compared numbers and their limits are the last
lines on standard error and the last key of the result line, which is the
last line on standard output.

Exit codes: 0 with a result line; 2 without a card (or fewer than the cell
asks for); 3 when a module of JAX or of the JAX package was loaded; 1 on an
error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"  # fixed directories inside the checkout: only a cell's first run there builds
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))  # the program, from the checkout's root


def cell_metrics(bench, cell, trace):
    """(metric entries to report, {name: unit}) of `cell`: its end-to-end
    metrics with trace off, its per-layer metrics with trace on."""
    def applies(m, reported):
        return cell in m["workloads"] if "workloads" in m else (reported is None or m["moves"] in reported)

    e2e = [m for m in bench["end_to_end"] if applies(m, None)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if applies(m, names)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from harness import core

    bench = core.benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if a.workload not in cells:
        print(f"run.py: BENCHMARK.json has no cell {a.workload!r}", file=sys.stderr)
        return 1
    chips = cells[a.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell {a.workload} needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    workload = core.load_json("workloads", a.workload)
    run = core.Run(cell=a.workload, seed=a.seed, seconds=a.seconds, trace_on=bool(a.trace),
                   device=torch.device("cuda", 0), t_start=T0, workload=workload,
                   config=core.load_json("configs", workload["config"]))
    core.load_module("traffic", workload["traffic"]).drive(run)

    bad = core.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}, which no run of the port may load", file=sys.stderr)
        return 3
    values, units = {}, {}
    for m in cell_metrics(bench, a.workload, a.trace):
        if m["name"] == "setup_s":
            v = run.setup_s
        elif a.trace:
            v = core.load_module("metrics", m["name"]).read(run)
        else:
            v = run.e2e.get(m["name"])
        if v is None and not a.trace:
            raise RuntimeError(f"the {workload['traffic']} driver gave no {m['name']}")
        if v is not None:
            values[m["name"]], units[m["name"]] = v, m["unit"]
    breakdown = run.trace["breakdown"] if a.trace and run.trace is not None else None
    line = core.result(run, values, units, breakdown)
    for n, v, lim in run.checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

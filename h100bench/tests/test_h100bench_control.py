"""The control, the plain reference in the next lower precision put in the
program's place, comes out not correct under each cell's limits: here at
the narrow CPU sizes; with a card (marked `card`), at the cell's own size on
three seeds, as the limits were set."""

import time

import pytest
import torch

from h100bench_support import small_run
from harness import core

CELLS = [c["name"] for c in core.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_narrow_size(cell):
    run = small_run(cell)
    core.load_module("traffic", run.workload["traffic"]).control(run)
    assert not run.correct, run.checks


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell, seed):
    wl = core.load_json("workloads", cell)
    run = core.Run(cell=cell, seed=seed, seconds=0.0, trace_on=False, device=card, t_start=time.perf_counter(),
                   workload=wl, config=core.load_json("configs", wl["config"]))
    core.load_module("traffic", wl["traffic"]).control(run)
    torch.cuda.empty_cache()
    assert not run.correct, run.checks

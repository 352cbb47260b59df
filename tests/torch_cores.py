"""Torch's CPU threads in the port's tests: a module's share of the cores.

Under pytest-xdist every worker's torch starts as many threads as the
machine has cores, so six workers on eight cores run some fifty threads.
The ops of the port's plain loops (the greedy NMS of validation takes
hundreds of small ops a batch) then wait on each other's threads: one
`cli.val.run` over 12 frames took 183 s under such load and 9 s with one
thread. Each port test module imports `share_cores`, an autouse fixture
that gives torch the cores divided by the number of workers while the
module runs; a run without xdist keeps torch's default.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)

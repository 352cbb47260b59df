"""The metrics that read the port's spans (harness/spans.py): their values
from a traced window's ranges, None where the program has no such span, and
the port's own spans read through harness/trace.py's summary on the CPU."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from h100bench_support import small_run
from harness import core, program
from harness.trace import WINDOW, summarize
from harness.weights import make_weights
from reference.model import Net
from traffic.batch import frames_pool
from traffic.val import Loader


def read(metric, run):
    return core.load_module("metrics", metric).read(run)


def traced_run(cell, ranges, window_s=2.0, batches=4):
    run = small_run(cell)
    run.trace = dict(busy_s=1.0, window_s=window_s, kernels=[], ranges=ranges, breakdown={})
    run.counters["traced"] = dict(batches=batches)
    return run


def test_values_from_the_ranges():
    serve = {"serve/copy_in": [0.001] * 4, "serve/forward": [0.002] * 4, "serve/decode": [0.0005] * 4,
             "serve/nms": [0.0005] * 4, "serve/fetch": [0.03] * 4, "h100bench/window": [2.0]}
    assert read("enqueue_ms.serve", traced_run("yolov3-serve-b32", serve)) == pytest.approx(4.0)
    assert read("enqueue_ms.tiny_serve", traced_run("yolov3-tiny-serve-b32", serve, batches=2)) == pytest.approx(8.0)
    val = {"val/match": [0.1, 0.1, 0.2, 0.1], "val/map": [0.5], "val/forward": [0.3] * 4}
    assert read("host_loop.val", traced_run("yolov3-val-b32", val)) == pytest.approx(50.0)


@pytest.mark.parametrize("metric,cell", [("enqueue_ms.serve", "yolov3-serve-b32"),
                                         ("enqueue_ms.tiny_serve", "yolov3-tiny-serve-b32"),
                                         ("host_loop.val", "yolov3-val-b32")])
def test_none_without_the_spans(metric, cell):
    run = small_run(cell)
    assert read(metric, run) is None  # not traced
    # a program without the spans: the train step's ranges alone, or a stage missing
    assert read(metric, traced_run(cell, {"train_step/forward": [0.1]})) is None
    partial = {"serve/copy_in": [0.001], "serve/forward": [0.002], "val/match": [0.1]}
    assert read(metric, traced_run(cell, partial)) is None
    assert read(metric, traced_run(cell, {"serve/copy_in": [0.1], "serve/forward": [0.1], "serve/decode": [0.1],
                                          "serve/nms": [0.1]}, batches=0)) is None


def test_the_ports_val_spans_through_the_summary():
    """A narrow model's validator.run profiled on the CPU: the summary's
    ranges hold the port's val/ spans, and host_loop.val reads them."""
    from yolov3_tpu_torch.eval import validator

    run = small_run("yolov3-val-b32")
    wl = run.workload
    net = Net(wl["model"])
    p = make_weights(net, run.seed, run.device)
    model = program.build_model(run.config, p, run.device, wl["model"])
    frames = frames_pool(run, 4, wl["imgsz"])
    targets, mask = np.zeros((2, 1, 5), np.float32), np.ones((2, 1), bool)
    targets[:, 0] = [0, 0.5, 0.5, 0.3, 0.3]
    batches = [(frames[k * 2:(k + 1) * 2], targets, mask, [None, None]) for k in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            validator.run(model=model, dataloader=Loader(batches, count=2), batch_size=2, imgsz=wl["imgsz"],
                          max_nms=wl["max_nms"])
    run.trace = summarize(prof.events())
    assert len(run.trace["ranges"]["val/match"]) == 2 and len(run.trace["ranges"]["val/map"]) == 1
    share = read("host_loop.val", run)
    assert 0 < share < 100

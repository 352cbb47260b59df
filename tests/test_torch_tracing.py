"""The port's span helper (utils/tracing.py) and the spans of its stages, on the CPU.

1. `span` and `record` fill the process-wide table (count, total, last
   durations) across nesting and across threads; `stats` and `reset`.
2. Under `torch.profiler.profile` every span is a user annotation of its
   exact name; with no profiler recording, `record_function` is never entered.
3. The stages: `validator.run` emits each `val/*` span once a batch and
   `val/map` once a run; the fast path `serve/copy_in` ... `serve/fetch`
   (`serve/fallback` on an overflow, `serve/full` with fast=False);
   `MicroBatcher` the `batcher/*` spans, `build_pipeline` the `pipeline/*`
   ones, and the HTTP server's `/health` reports them as `stages`; a train
   step `train_step/forward` ... `train_step/ema`, the backward included.
"""

import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.utils import tracing

MICRO = {  # two head levels at strides 16 and 32
    "nc": 2,
    "anchors": [[12, 12, 20, 20, 32, 32], [48, 48, 64, 64, 96, 96]],
    "layers": [
        {"from": -1, "n": 1, "op": "Conv", "args": [8, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": [3, 4], "n": 1, "op": "Detect", "args": ["nc", "anchors"]},
    ],
}
IMGSZ = 64
SERVE_SPANS = ("serve/copy_in", "serve/forward", "serve/decode", "serve/nms", "serve/fetch")
VAL_BATCH_SPANS = ("val/copy_in", "val/forward", "val/decode", "val/nms", "val/fetch", "val/match")
BATCHER_SPANS = ("batcher/wait", "batcher/assemble", "batcher/call", "batcher/fetch", "batcher/scatter")
STEP_SPANS = ("train_step/forward", "train_step/loss", "train_step/backward", "train_step/optimizer",
              "train_step/ema")


@pytest.fixture(autouse=True)
def empty_table():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def model():
    return DetectionModel.from_config(dict(MICRO), seed=0, device="cpu")


def counts(prefix=""):
    return {k: v["count"] for k, v in tracing.stats(prefix).items()}


def frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, IMGSZ, IMGSZ, 3), dtype=np.uint8)


def annotations(prof):
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation]


def test_span_and_record_fill_the_table():
    @tracing.span("t/decorated")
    def work(x):
        time.sleep(0.002)
        return x + 1

    with tracing.span("t/outer"):
        with tracing.span("t/inner"):
            time.sleep(0.003)
        assert work(1) == 2 and work.__name__ == "work"
        with tracing.span("t/inner"):
            pass
    tracing.record("t/queued", 0.25)
    tracing.record("t/queued", 0.75)
    s = tracing.stats()
    assert set(s) == {"t/outer", "t/inner", "t/decorated", "t/queued"}
    assert {k: v["count"] for k, v in s.items()} == {"t/outer": 1, "t/inner": 2, "t/decorated": 1, "t/queued": 2}
    assert set(s["t/inner"]) == {"count", "total_s", "p50_ms", "p95_ms"}
    assert s["t/outer"]["total_s"] >= s["t/inner"]["total_s"] + s["t/decorated"]["total_s"]
    assert s["t/inner"]["total_s"] >= 0.003 and s["t/decorated"]["total_s"] >= 0.002
    assert s["t/queued"]["total_s"] == pytest.approx(1.0)
    assert s["t/queued"]["p50_ms"] == pytest.approx(500.0) and s["t/queued"]["p95_ms"] == pytest.approx(725.0)
    assert set(tracing.stats("t/q")) == {"t/queued"} and set(tracing.stats(("t/i", "t/o"))) == {"t/inner", "t/outer"}
    with pytest.raises(ValueError):  # a span that raises is still recorded, and the error passes
        with tracing.span("t/raises"):
            raise ValueError("passes through")
    assert counts("t/raises") == {"t/raises": 1}
    tracing.reset()
    assert tracing.stats() == {}


def test_the_table_keeps_the_last_durations():
    for i in range(tracing.KEEP + 500):
        tracing.record("t/many", 1.0 if i < 500 else 0.001)
    s = tracing.stats()["t/many"]
    assert s["count"] == tracing.KEEP + 500 and s["total_s"] == pytest.approx(500 + tracing.KEEP * 0.001)
    assert s["p50_ms"] == pytest.approx(1.0) and s["p95_ms"] == pytest.approx(1.0)  # the first 500 are gone


def test_the_table_across_threads():
    n, barrier = 2000, threading.Barrier(4)

    def worker(k):
        barrier.wait()
        for _ in range(n):
            with tracing.span("t/shared"):
                with tracing.span(f"t/thread{k}"):
                    pass
            tracing.record("t/recorded", 0.001)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update of the table would show in the counts
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    c = counts("t/")
    assert c == {"t/shared": 4 * n, "t/recorded": 4 * n, **{f"t/thread{k}": n for k in range(4)}}
    assert tracing.stats("t/recorded")["t/recorded"]["total_s"] == pytest.approx(4 * n * 0.001)


def test_spans_are_profiler_ranges_only_while_it_records(monkeypatch):
    entered = []
    real = tracing.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    with tracing.span("t/off"):
        torch.ones(4).sum()
    assert entered == [] and counts() == {"t/off": 1}

    @tracing.span("t/decorated")
    def work():
        return torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("t/outer"):
            with tracing.span("t/inner"):
                torch.ones(4).sum()
            work()
    assert entered == ["t/outer", "t/inner", "t/decorated"]
    assert sorted(annotations(prof)) == ["t/decorated", "t/inner", "t/outer"]
    with tracing.span("t/off"):
        pass
    assert len(entered) == 3 and counts() == {"t/off": 2, "t/outer": 1, "t/inner": 1, "t/decorated": 1}


def test_validator_spans_once_a_batch(model):
    from yolov3_tpu_torch.eval import validator

    targets = np.zeros((2, 3, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]
    mask = np.zeros((2, 3), bool)
    mask[:, 0] = True
    batches = [(frames(2, seed=k), targets, mask, [None, None]) for k in range(2)]
    _, _, speeds = validator.run(model=model, dataloader=batches, conf_thres=0.001, max_nms=3000)
    assert len(speeds) == 3
    assert counts("val/") == {**{n: 2 for n in VAL_BATCH_SPANS}, "val/map": 1}
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        validator.run(model=model, dataloader=batches[:1], conf_thres=0.001, max_nms=3000)
    names = annotations(prof)
    assert sorted(n for n in names if n.startswith("val/")) == sorted([*VAL_BATCH_SPANS, "val/map"])


def test_fast_path_spans(model):
    from yolov3_tpu_torch.serve import build_batched_infer

    infer = build_batched_infer(model, conf_thres=0.25)
    for _ in range(3):
        infer(frames(2))
    assert infer.fallbacks == 0 and counts("serve/") == {n: 3 for n in SERVE_SPANS}
    tracing.reset()
    dense = build_batched_infer(model, conf_thres=0.0, k_per_scale=(1, 1))  # every cell a candidate: overflow
    dense(frames(2))
    assert dense.fallbacks == 1 and counts("serve/") == {**{n: 1 for n in SERVE_SPANS}, "serve/fallback": 1}
    tracing.reset()
    full = build_batched_infer(model, conf_thres=0.25, fast=False)
    dets, n = full(frames(2))
    assert dets.shape[0] == 2 and counts("serve/") == {"serve/full": 1}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        infer(frames(2))
    assert sorted(n for n in annotations(prof) if n.startswith("serve/")) == sorted(SERVE_SPANS)


def test_microbatcher_spans(model):
    from yolov3_tpu_torch.serve import MicroBatcher, build_batched_infer

    batcher = MicroBatcher(build_batched_infer(model, conf_thres=0.25), max_batch=4, batch_wait_ms=30.0)
    results = [None] * 4

    def client(i):
        results[i] = batcher.submit(frames(1, seed=i)[0])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None for r in results) and batcher.requests == 4
    c = counts("batcher/")
    assert c == {n: batcher.calls for n in BATCHER_SPANS}
    assert counts("serve/") == {n: batcher.calls for n in SERVE_SPANS}
    # the oldest request of a call waits at least the coalescing window, unless the call filled up first
    assert tracing.stats("batcher/wait")["batcher/wait"]["total_s"] > 0


def test_pipeline_and_health_stages(model, tmp_path):
    from yolov3_tpu_torch.serve import RemoteModel, make_server
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = save_checkpoint(tmp_path / "best", {"model": model.state_dict()}, spec=model.spec)
    server = make_server(ckpt, host="127.0.0.1", port=0, imgsz=IMGSZ, max_batch=2, batch_wait_ms=5.0,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        tracing.reset()  # the warm-up's spans
        remote = RemoteModel(url)
        rng = np.random.default_rng(1)
        for h, w in ((48, 64), (64, 40), (64, 64)):
            assert remote(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).shape[1] == 6
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    stages = health["stages"]
    calls = health["batching"]["device_calls"]
    assert {k: v["count"] for k, v in stages.items() if k.startswith("pipeline/")} == \
        {"pipeline/letterbox": 3, "pipeline/scale_back": 3}
    assert {k: v["count"] for k, v in stages.items() if k.startswith("batcher/")} == \
        {n: 3 for n in BATCHER_SPANS}  # one request a call: each waits out the window alone
    assert calls >= 3 and all(stages[n]["count"] == 3 for n in SERVE_SPANS)
    assert all(set(v) == {"count", "total_s", "p50_ms", "p95_ms"} and v["total_s"] >= 0 for v in stages.values())
    assert stages["batcher/wait"]["p50_ms"] >= 4.0  # the 5 ms coalescing window of a lone request


def test_train_step_spans():
    from yolov3_tpu_torch.train.loss import LossConfig
    from yolov3_tpu_torch.train.optim import build_optimizer
    from yolov3_tpu_torch.train.step import make_train_step

    model = DetectionModel.from_config(dict(MICRO), seed=0, device="cpu")
    hyp = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.9, "weight_decay": 0.0005, "warmup_epochs": 0.0}
    optimizer, _, _ = build_optimizer("sgd", model, hyp, epochs=1, steps_per_epoch=2, batch_size=2, nbs=2,
                                      min_warmup_steps=0)
    step = make_train_step(model, LossConfig.from_model(model.spec, hyp), optimizer, compute_dtype=torch.float32)
    targets = np.zeros((2, 2, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    mask = np.zeros((2, 2), bool)
    mask[:, 0] = True
    metrics = step(frames(2), torch.from_numpy(targets), torch.from_numpy(mask))
    assert torch.isfinite(metrics["loss"])
    assert counts("train_step/") == {n: 1 for n in STEP_SPANS}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(frames(2), torch.from_numpy(targets), torch.from_numpy(mask))
    assert sorted(n for n in annotations(prof) if n.startswith("train_step/")) == sorted(STEP_SPANS)
    assert counts("train_step/") == {n: 2 for n in STEP_SPANS}

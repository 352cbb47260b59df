"""The plain reference agrees with the port at a narrow width on the CPU: the
benchmark's configurations and the YOLOv5 v6 layer set (padded stem, C3, SPPF,
nn.Upsample, a four-level head)."""

import functools

import pytest
import torch

from h100bench_support import drive, frame_size, narrow_model, small_run
from harness import plant, program
from harness.weights import make_weights
from reference.model import Net, forward, strict_f32

MODELS = ["yolov3", "yolov3-tiny", "yolov5s", "yolov5x6"]


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_the_port(name):
    cfg, m = narrow_model(name)
    net = Net(m)
    p = make_weights(net, 5, "cpu")
    size = frame_size(m)
    frames = torch.randint(0, 256, (2, size, size, 3), generator=torch.Generator().manual_seed(0), dtype=torch.uint8)
    plant.settle(p, net, frames, "cpu")
    model = program.build_model(cfg, p, torch.device("cpu"), m)
    x = frames.float() / 255.0
    with torch.no_grad(), strict_f32():
        got, want = model(x), forward(p, net, x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_float32_train_steps_match_the_port(monkeypatch, name):
    import yolov3_tpu_torch.train.step as step

    from traffic import train

    monkeypatch.setattr(step, "make_train_step", functools.partial(step.make_train_step, compute_dtype=torch.float32))
    seen = []
    monkeypatch.setattr(train, "check_steps", lambda run, got, want: seen.append(train.step_gaps(got, want)))
    cfg, m = narrow_model(name)
    run = small_run("yolov3-train-b64", imgsz=frame_size(m))
    run.config, run.workload["model"] = cfg, m
    drive(run)
    gaps = seen[0]
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-3 and gaps["step_gap"] < 1e-3
    assert gaps["leaves"] == gaps["of"]


def test_float32_validation_matches_the_port(monkeypatch):
    from traffic import val

    seen = []
    real = val.check_val
    monkeypatch.setattr(val, "check_val", lambda *a: seen.append(real(*a)))
    run = drive(small_run("yolov3-val-b32"))
    gaps = seen[0]
    assert gaps["map50_gap"] == 0.0 and gaps["map_gap"] == 0.0 and gaps["unmatched"] == 0.0
    assert gaps["conf_gap"] < 1e-3 and run.correct

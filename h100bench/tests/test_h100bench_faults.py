"""`correct` comes out false when the timed path is broken underneath, once for
each fault a cell can have (on the CPU, at narrow sizes, past the look for a
card): an answer altered where it is produced, a train step that returns its
state unchanged, and one that leaves out half of the batch. No cell spans
chips, so none can leave out an exchange between them."""

import pytest
import torch

from h100bench_support import drive, small_run


def shifted(dets, px=40.0):
    out = dets.clone() if isinstance(dets, torch.Tensor) else dets.copy()
    out[0, :, :4] += px
    return out


def test_serve_answer_altered(monkeypatch):
    import yolov3_tpu_torch.serve as serve

    real = serve.build_batched_infer

    def broken(*a, **k):
        infer = real(*a, **k)

        def wrong(imgs):
            dets, n = infer(imgs)
            return shifted(dets), n

        wrong.fallbacks = 0
        return wrong

    monkeypatch.setattr(serve, "build_batched_infer", broken)
    run = drive(small_run("yolov3-serve-b32"))
    assert not run.correct and dict((n, v) for n, v, _ in run.checks)["unmatched"] > 0.1


def test_stream_answer_altered(monkeypatch):
    import yolov3_tpu_torch.serve as serve

    real = serve.build_pipeline

    def broken(*a, **k):
        predict = real(*a, **k)

        def wrong(im):
            d = predict(im)
            d[:, :4] += 40.0  # every answer's boxes moved where they are produced
            return d

        wrong.batcher = predict.batcher
        return wrong

    monkeypatch.setattr(serve, "build_pipeline", broken)
    run = drive(small_run("yolov3-tiny-stream", seconds=0.5))
    assert not run.correct


def test_val_answer_altered(monkeypatch):
    import yolov3_tpu_torch.eval.validator as validator

    real = validator.batched_nms
    monkeypatch.setattr(validator, "batched_nms", lambda *a, **k: (lambda d, n: (shifted(d), n))(*real(*a, **k)))
    run = drive(small_run("yolov3-val-b32"))
    assert not run.correct


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch"])
def test_train_step_faults(monkeypatch, fault):
    import yolov3_tpu_torch.train.step as step

    real = step.make_train_step

    def broken(model, *a, **k):
        fn = real(model, *a, **k)

        def wrong(imgs, targets, mask):
            if fault == "half the batch":
                h = imgs.shape[0] // 2
                return fn(imgs[:h], targets[:h], mask[:h])
            before = {n: v.detach().clone() for n, v in model.named_parameters()}
            out = fn(imgs, targets, mask)
            with torch.no_grad():
                for n, v in model.named_parameters():
                    v.copy_(before[n])
            return out

        wrong.state = fn.state
        return wrong

    monkeypatch.setattr(step, "make_train_step", broken)
    run = drive(small_run("yolov3-train-b64", seconds=0.1))
    assert not run.correct

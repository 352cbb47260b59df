"""The program under test, yolov3_tpu_torch, built from the benchmark's weights.

The model is the port's `DetectionModel` of the configuration's `cfg` (its
own models/configs/<cfg>.yaml, the path every entry point takes), with the
benchmark's seeded state dict copied in. Only this module and the traffic
drivers import the program; the reference never does.
"""

from __future__ import annotations

import torch


def build_model(config, weights, device, model_cfg=None):
    """The port's model of `config` holding a copy of `weights`, in eval mode,
    channels_last, on `device`. `model_cfg` (a `model` block) replaces the
    configuration's cfg name: the CPU tests' narrow models."""
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.models.spec import parse_spec

    spec = parse_spec(dict(model_cfg, name=config["name"]) if model_cfg is not None else config["cfg"])
    with torch.device("meta"):
        model = DetectionModel(spec)
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def kernel_counters():
    """The port's launch counters of K1, K2 and K3."""
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores

    return {"greedy_nms": greedy_nms.launches, "masked_scores": masked_scores.launches,
            "conv3x3_bn_stats": conv3x3_bn_stats.launches}

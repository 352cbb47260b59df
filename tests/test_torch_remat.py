"""Activation checkpointing of the port's train step (`remat`, `remat_segment`,
`remat_until`; models/detection.py, train/step.py), on the CPU.

1. Remat on against remat off from one state, one step each: the same loss,
   the same gradients (SGD's first momentum buffer is the gradient), the same
   parameters after the update and the same BatchNorm running statistics,
   with `num_batches_tracked` advanced once: the recomputed forward updates
   no statistic. Whole-body remat, shorter segments, `remat_until`, and the
   bf16 autocast step (the recompute keeps autocast). The conv+statistics
   function runs once more for each routed conv in a recomputed segment.
2. The port's remat step against the JAX `make_train_step(remat=True)` over
   5 steps: loss rtol 1e-3, state atol 1e-4 (the bars of
   tests/test_torch_train_step.py).
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_train_step import HYP, OPT_ARGS, SPEC, assert_states_match, make_batch

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolov3_tpu.train.step import init_train_state as jax_init_train_state
from yolov3_tpu.train.step import make_train_step as jax_make_train_step
from yolov3_tpu_torch.models.convert import flatten_train_state, load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.nn.modules import Conv
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.optim import build_optimizer
from yolov3_tpu_torch.train.step import make_train_step

# (remat kwargs, compute dtype, the body layers recomputed in the backward)
CASES = {
    "whole-body": (dict(remat=True), torch.float32, range(9)),
    "segment-2": (dict(remat=True, remat_segment=2), torch.float32, range(9)),
    "until-5": (dict(remat=True, remat_until=5), torch.float32, range(5)),
    "segment-3-until-7-bf16": (dict(remat=True, remat_segment=3, remat_until=7), torch.bfloat16, range(7)),
}


def routed_layers(model):
    """Top-level layer index of every Conv that takes the conv+statistics route."""
    return [int(n.split(".")[1]) for n, m in model.named_modules() if isinstance(m, Conv) and m.stats_route]


def one_step(model, compute_dtype, **remat):
    """One train step of `model` (in place); returns (metrics, state dict,
    flat train state, calls of the conv+statistics function)."""
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    calls = []

    def counting(x, w):
        calls.append(tuple(x.shape))
        return conv3x3_bn_stats(x, w)

    step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer, compute_dtype=compute_dtype,
                           bn_stats_fn=counting, **remat)
    metrics = step(*make_batch())
    return metrics, copy.deepcopy(model.state_dict()), flatten_train_state(step.state), calls


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_equals_plain_step(case):
    remat, dtype, recomputed = CASES[case]
    base = DetectionModel.from_config(SPEC, seed=0, device="cpu")
    m_off, sd_off, flat_off, calls_off = one_step(copy.deepcopy(base), dtype)
    m_on, sd_on, flat_on, calls_on = one_step(copy.deepcopy(base), dtype, **remat)

    for key in ("loss", "lbox", "lobj", "lcls", "grad_norm"):
        torch.testing.assert_close(m_on[key], m_off[key], rtol=1e-6, atol=0, msg=key)
    assert float(m_on["grad_norm"]) > 0
    for k, v in sd_off.items():  # BatchNorm statistics (and counters) updated once, parameters the same
        if "running" in k or k.endswith("num_batches_tracked"):
            assert torch.equal(sd_on[k], v), k
        else:
            torch.testing.assert_close(sd_on[k], v, rtol=1e-6, atol=1e-7, msg=k)
    for k, v in flat_off.items():  # momentum buffers: the gradients; the EMA
        if k.startswith(("momentum/", "ema/")):
            torch.testing.assert_close(flat_on[k], v, rtol=1e-5, atol=1e-7, msg=k)
    counters = [k for k in sd_on if k.endswith("num_batches_tracked")]
    assert counters and all(int(sd_on[k]) == 1 for k in counters)
    moved = [k for k in sd_on if "running_mean" in k and not torch.equal(sd_on[k], base.state_dict()[k])]
    assert len(moved) == len([k for k in sd_on if "running_mean" in k])

    routed = routed_layers(base)
    assert len(calls_off) == len(routed)
    assert len(calls_on) == len(routed) + sum(i in recomputed for i in routed)


def test_remat_needs_autograd():
    """Without autograd (eval, validation) remat changes nothing and checkpoints nothing."""
    model = DetectionModel.from_config(SPEC, seed=0, device="cpu").train()
    x = torch.rand(2, 64, 64, 3)
    with torch.no_grad():
        a = model(x, remat=True, remat_segment=2)
        b = model(x)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def build_remat_pair():
    ref = JaxModel.from_config(SPEC, imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)
    tx, _, _ = jax_build_optimizer("sgd", ref.params, HYP, **OPT_ARGS)
    ref_cfg = JaxLossConfig.from_model(ref.spec, HYP)
    ref_step = jax_make_train_step(ref.module, ref_cfg, tx, remat=True, remat_segment=3)
    ref_state = jax_init_train_state(ref, tx, loss_cfg=ref_cfg)

    model = load_jax_variables(DetectionModel(parse_spec(SPEC)), variables)
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    cfg = dataclasses.replace(LossConfig.from_model(model.spec, HYP))
    step = make_train_step(model, cfg, optimizer, compute_dtype=torch.float32, remat=True, remat_segment=3)
    return (ref_step, ref_state), step


def test_remat_trajectory_matches_jax():
    (ref_step, ref_state), step = build_remat_pair()
    batch = make_batch()
    assert_states_match(step.state, ref_state, atol=0)
    for i in range(5):
        ref_state, ref_metrics = ref_step(ref_state, *batch)
        metrics = step(*batch)
        for key in ("loss", "lbox", "lobj", "lcls"):
            np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), rtol=1e-3, err_msg=f"{key} {i}")
    end = assert_states_match(step.state, ref_state)
    assert end["step"] == end["ema/updates"] == end["optimizer/updates"] == 5
    assert all(int(v) == 5 for k, v in step.state.model.state_dict().items() if k.endswith("num_batches_tracked"))

"""Train steps of narrowed yolov5s and yolov5s-transformer (width 0.125,
depth 0.33, 128 px) in the port against the JAX package's step, as
tests/test_torch_train_step.py::test_five_step_trajectory_matches_jax holds
yolov3's: loss rtol 1e-3, state atol 1e-4, in float64 (why float64 is in
the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_train_step import assert_states_match
from test_torch_zoo_models import IMGSZ, MODELS, jax_variables, narrow
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolov3_tpu.train.step import init_train_state as jax_init_train_state
from yolov3_tpu.train.step import make_train_step as jax_make_train_step
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.optim import build_optimizer
from yolov3_tpu_torch.train.step import make_train_step

HYP = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.9, "weight_decay": 0.0005, "warmup_epochs": 0.0}
OPT_ARGS = dict(epochs=10, steps_per_epoch=10, batch_size=64, min_warmup_steps=0)  # nbs 64: no accumulation


def make_batch(nc=80):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    targets = np.zeros((2, 4, 5), np.float32)
    targets[:, 0] = [0, 0.5, 0.5, 0.4, 0.4]
    targets[:, 1] = [nc - 1, 0.25, 0.25, 0.2, 0.3]
    mask = np.zeros((2, 4), bool)
    mask[:, :2] = True
    return imgs, targets, mask


@pytest.mark.parametrize("name", MODELS)
def test_five_step_trajectory_matches_jax(name):
    """Five SGD steps of both packages from the same state, in float64: every
    step's loss and its parts at rtol 1e-3, the state (parameters, momentum,
    EMA, BatchNorm statistics, counters) at atol 1e-4 after every step.

    Not float32: these narrowed models amplify any rounding difference 3-20x
    a step. The port against itself, float32 against float64 from one state,
    differs in its state by 2.0e-3 (yolov5s) and 4.8e-2 (yolov5s-transformer)
    after five steps, so no two float32 implementations meet 1e-4 there. The
    float64 JAX step keeps float32 pieces of its own (the head's output is
    cast to float32, so the box and objectness losses run in float32), which
    the port's float64 step computes alike; after five steps the states stand
    5e-5 (yolov5s-transformer) and 2e-5 (yolov5s) apart."""
    cfg = narrow(name)
    with jax.enable_x64(True):
        spec = jax_parse_spec(cfg)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), jax_variables(spec))
        ref = JaxModel(spec, variables, dtype=jnp.float64)
        tx, _, _ = jax_build_optimizer("sgd", ref.params, HYP, **OPT_ARGS)
        ref_cfg = JaxLossConfig.from_model(ref.spec, HYP)
        ref_step = jax_make_train_step(ref.module, ref_cfg, tx)
        ref_state = jax_init_train_state(ref, tx, loss_cfg=ref_cfg)

        model = load_jax_variables(DetectionModel(parse_spec(cfg)), variables).double()
        optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
        calls = []

        def counting(x, w):
            calls.append(tuple(x.shape))
            return conv3x3_bn_stats(x, w)

        # compute_dtype float32 means no autocast; the model casts its input to its own float64
        step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer,
                               compute_dtype=torch.float32, bn_stats_fn=counting)
        batch = make_batch()
        start = assert_states_match(step.state, ref_state, atol=0)  # the carried-across init is exact
        start = {k: v.clone() for k, v in start.items() if not isinstance(v, int)}
        for i in range(5):
            ref_state, ref_metrics = ref_step(ref_state, *batch)
            metrics = step(*batch)
            for key in ("loss", "lbox", "lobj", "lcls"):
                np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), rtol=1e-3,
                                           err_msg=f"{key} {i}")
            end = assert_states_match(step.state, ref_state)
    assert len(calls) == 5 * chip_smoke.YOLOV5_K3_CONVS[name] and calls[0][0] == 2
    assert step.state.step == step.state.ema.updates == optimizer.updates == 5
    for key, v in start.items():  # the comparison is not vacuous: everything moved
        assert not torch.equal(v, end[key]), key

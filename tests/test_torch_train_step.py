"""The port's train step (train/step.py) against the JAX package's
`make_train_step` on the same weights and the same batch, in f32 on the CPU.

The spec is narrow but has what yolov3 has on the train path: a stride-1 3x3
stem with Cin = 3, Bottlenecks (1x1 + stride-1 3x3 with a residual), a
repeated Bottleneck layer, stride-2 convs and a plain stride-1 3x3 conv, so
the conv+BN-statistics route is taken next to nn.BatchNorm2d.
(tests/test_train_step.py's spec has only stride-2 convs and would bypass it.)

Tolerances: loss per step rtol 1e-3; parameters, momentum buffers, EMA and
BatchNorm statistics atol 1e-4 after 5 steps (f32 sums in another order,
compounded over the steps).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolov3_tpu.train.step import init_train_state as jax_init_train_state
from yolov3_tpu.train.step import make_train_step as jax_make_train_step
from yolov3_tpu_torch.models.convert import (flatten_train_state, from_jax_train_state, load_jax_train_state,
                                             load_jax_variables)
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.nn.modules import Conv
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.optim import build_optimizer
from yolov3_tpu_torch.train.step import init_train_state, make_train_step, normalize_images

SPEC = {
    "nc": 2,
    "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
    "layers": [
        {"from": -1, "n": 1, "op": "Conv", "args": [8, 3, 1]},  # 0: stem, stride 1, Cin 3
        {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
        {"from": -1, "n": 1, "op": "Bottleneck", "args": [16]},
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": -1, "n": 2, "op": "Bottleneck", "args": [32]},  # 4: two repeats
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": -1, "n": 1, "op": "Bottleneck", "args": [32, False]},  # 6: P3/8
        {"from": -1, "n": 1, "op": "Conv", "args": [64, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [64, 3, 1]},  # 8: P4/16, plain stride-1 3x3
        {"from": [6, 8], "n": 1, "op": "Detect", "args": ["nc", "anchors"]},
    ],
}
HYP = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.9, "weight_decay": 0.0005, "warmup_epochs": 0.0}
OPT_ARGS = dict(epochs=10, steps_per_epoch=10, batch_size=64, min_warmup_steps=0)  # nbs 64: no accumulation
N_ROUTED = 6  # the stem, 4 Bottleneck cv2, layer 8


def make_batch():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(2, 64, 64, 3), dtype=np.uint8)
    targets = np.zeros((2, 4, 5), np.float32)
    targets[:, 0] = [0, 0.5, 0.5, 0.4, 0.4]
    targets[:, 1] = [1, 0.25, 0.25, 0.2, 0.3]
    mask = np.zeros((2, 4), bool)
    mask[:, :2] = True
    return imgs, targets, mask


def build_pair(autobalance=False):
    """(JAX step, JAX state), (port step with its state): same weights, same optimizer settings."""
    ref = JaxModel.from_config(SPEC, imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)  # the JAX step donates its state's buffers
    tx, _, _ = jax_build_optimizer("sgd", ref.params, HYP, **OPT_ARGS)
    ref_cfg = dataclasses.replace(JaxLossConfig.from_model(ref.spec, HYP), autobalance=autobalance)
    ref_step = jax_make_train_step(ref.module, ref_cfg, tx)
    ref_state = jax_init_train_state(ref, tx, loss_cfg=ref_cfg)

    model = load_jax_variables(DetectionModel(parse_spec(SPEC)), variables)
    optimizer, _, accumulate = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    assert accumulate == 1
    cfg = dataclasses.replace(LossConfig.from_model(model.spec, HYP), autobalance=autobalance)
    step = make_train_step(model, cfg, optimizer, compute_dtype=torch.float32)
    return (ref_step, ref_state), step


def assert_states_match(state, ref_state, atol=1e-4):
    got, want = flatten_train_state(state), from_jax_train_state(ref_state)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w, key
        else:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=atol, err_msg=key)
    return got


def test_spec_takes_the_stats_route():
    model = DetectionModel(parse_spec(SPEC))
    routed = [n for n, m in model.named_modules() if isinstance(m, Conv) and m.stats_route]
    assert routed == ["model.0", "model.2.cv2", "model.4.0.cv2", "model.4.1.cv2", "model.6.cv2", "model.8"]
    assert len(routed) == N_ROUTED


def test_five_step_trajectory_matches_jax():
    (ref_step, ref_state), step = build_pair()
    calls = []
    real = step.state.model.model[0].bn_stats_fn

    def counting(x, w):
        calls.append(tuple(x.shape))
        return real(x, w)

    step_counted = make_train_step(step.state.model, LossConfig.from_model(step.state.model.spec, HYP),
                                   step.state.optimizer, state=step.state, compute_dtype=torch.float32,
                                   bn_stats_fn=counting)
    batch = make_batch()
    start = assert_states_match(step.state, ref_state, atol=0)  # the carried-across init is exact
    start = {k: v.clone() for k, v in start.items() if not isinstance(v, int)}
    for i in range(5):
        ref_state, ref_metrics = ref_step(ref_state, *batch)
        metrics = step_counted(*batch)
        for key in ("loss", "lbox", "lobj", "lcls"):
            np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), rtol=1e-3, err_msg=f"{key} {i}")
    assert len(calls) == 5 * N_ROUTED and calls[0] == (2, 64, 64, 3)
    end = assert_states_match(step.state, ref_state)
    assert end["step"] == end["ema/updates"] == end["optimizer/updates"] == 5
    # the comparison is not vacuous: everything moved
    for key, v in start.items():
        assert not torch.equal(v, end[key]), key


def test_train_state_carries_across_mid_run():
    """Two JAX steps, the state loaded into the port (momentum buffers, EMA,
    counters), then three more steps on both sides."""
    (ref_step, ref_state), step = build_pair()
    batch = make_batch()
    for _ in range(2):
        ref_state, _ = ref_step(ref_state, *batch)
    load_jax_train_state(step.state, jax.tree.map(np.asarray, ref_state))
    assert_states_match(step.state, ref_state, atol=0)
    assert step.state.step == 2 and step.state.optimizer.updates == 2 and step.state.ema.updates == 2
    for i in range(3):
        ref_state, ref_metrics = ref_step(ref_state, *batch)
        metrics = step(*batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(ref_metrics["loss"]), rtol=1e-3, err_msg=str(i))
    assert_states_match(step.state, ref_state)


def test_autobalance_trajectory_matches_jax():
    (ref_step, ref_state), step = build_pair(autobalance=True)
    batch = make_batch()
    for _ in range(2):
        ref_state, ref_metrics = ref_step(ref_state, *batch)
        metrics = step(*batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(ref_metrics["loss"]), rtol=1e-3)
    got = assert_states_match(step.state, ref_state)
    assert abs(float(got["balance"][1]) - 1.0) < 1e-5  # normalized by the stride-16 scale


def test_loss_decreases_over_15_steps():
    model = DetectionModel.from_config(SPEC, seed=0, device="cpu")
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer, compute_dtype=torch.float32)
    batch = make_batch()
    losses = [float(step(*batch)["loss"]) for _ in range(15)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, f"no learning: {losses[0]:.4f} -> {losses[-1]:.4f}"
    assert step.state.step == 15 and step.state.ema.updates == 15 and optimizer.updates == 15
    # after one more update the EMA, at a ramped decay near 0, sits on the parameters
    p = dict(model.named_parameters())["model.0.conv.weight"].detach()
    np.testing.assert_allclose(step.state.ema.ema["model.0.conv.weight"].numpy(), p.numpy(), atol=1e-2)


def test_accumulating_step_updates_every_fourth_batch():
    """batch_size 16 of nbs 64: parameters move on every 4th call, the EMA and
    the BatchNorm statistics on every call."""
    model = DetectionModel.from_config(SPEC, seed=0, device="cpu")
    optimizer, _, accumulate = build_optimizer("sgd", model, HYP, epochs=10, steps_per_epoch=10, batch_size=16,
                                               min_warmup_steps=0)
    assert accumulate == 4
    step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer, compute_dtype=torch.float32)
    batch = make_batch()
    bias = model.model[-1].m[0].bias
    before = bias.detach().clone()
    for i in range(8):
        metrics = step(*batch)
        assert ("grad_norm" in metrics) == (i % 4 == 3)
        if i == 2:
            assert torch.equal(bias.detach(), before)
    assert not torch.equal(bias.detach(), before)
    assert optimizer.updates == 2 and step.state.step == 8 and step.state.ema.updates == 8
    assert int(model.model[0].bn.num_batches_tracked) == 8


def test_bf16_autocast_step_keeps_f32_parameters():
    model = DetectionModel.from_config(SPEC, seed=0, device="cpu")
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer)  # bf16 compute
    seen = []
    handle = model.model[-1].register_forward_hook(lambda mod, args, out: seen.append([o.dtype for o in out]))
    metrics = [step(*make_batch()) for _ in range(2)]
    handle.remove()
    assert seen[0] == [torch.bfloat16, torch.bfloat16]  # head maps stay in the compute dtype
    assert all(m["loss"].dtype == torch.float32 and np.isfinite(float(m["loss"])) for m in metrics)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in step.state.ema.ema.values() if v.is_floating_point())


def test_normalize_images():
    imgs = torch.arange(0, 256, dtype=torch.uint8).reshape(1, 16, 16, 1)
    out = normalize_images(imgs, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # uint8 values are exact in bf16; the quotient is rounded once
    torch.testing.assert_close(out.float(), (imgs.float() / 255.0).bfloat16().float(), rtol=0, atol=0)


def test_init_train_state():
    model = DetectionModel.from_config(SPEC, seed=0, device="cpu")
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    cfg = dataclasses.replace(LossConfig.from_model(model.spec, HYP), autobalance=True)
    state = init_train_state(model, optimizer, cfg)
    assert state.step == 0 and state.ema.updates == 0 and state.model is model
    assert state.balance.tolist() == pytest.approx([4.0, 1.0])  # two scales of the P3-P7 table
    for k, v in model.state_dict().items():
        assert torch.equal(state.ema.ema[k], v) and state.ema.ema[k].data_ptr() != v.data_ptr()
    assert init_train_state(model, optimizer).balance is None


@pytest.mark.parametrize("missing", ["mesh"])
def test_unported_arguments_are_rejected(missing):
    model = DetectionModel.from_config(SPEC, seed=0, device="cpu")
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    with pytest.raises(TypeError):
        make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer, **{missing: True})

"""Adam, AdamW and RMSprop optimizer states carried from the JAX package
into the port (models/convert.py), on the CPU.

1. The optimizer alone: two updates of the JAX optax chain on seeded
   gradients, the state loaded into the port's optimizer (equal slot by slot:
   exp_avg / exp_avg_sq / square_avg / momentum_buffer and the step count),
   then one more update in each package from the same gradients: parameters
   at the bars of tests/test_torch_optim.py (rtol 1e-5, atol 1e-6; RMSprop
   atol 2e-5 with |g| >= 1, for its eps placement).
2. A whole train state: two JAX train steps with each optimizer, loaded into
   a port TrainState (exactly), saved as a port checkpoint and restored by
   `utils/checkpoint.restore_train_state` (exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_optim import HYP, RTOL, assert_params_match, jax_tree, make_port_params, to_port
from test_torch_train_step import OPT_ARGS, SPEC, make_batch

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.train import optim as jax_optim
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.train.step import init_train_state as jax_init_train_state
from yolov3_tpu.train.step import make_train_step as jax_make_train_step
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.convert import (flatten_optimizer, flatten_train_state, from_jax_opt_state,
                                             from_jax_train_state, load_jax_opt_state, load_jax_train_state,
                                             load_jax_variables)
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.train import optim as port_optim
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.step import init_train_state
from yolov3_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state, save_checkpoint

SLOTS = {"adam": ("exp_avg", "exp_avg_sq"), "adamw": ("exp_avg", "exp_avg_sq"),
         "rmsprop": ("square_avg", "momentum")}


def draw_grads(rng, tree, floor):
    def draw(p):
        g = rng.normal(size=p.shape)
        return (g + np.sign(g) * floor).astype(np.float32)

    return jax.tree.map(draw, tree)


@pytest.mark.parametrize("batch_size", [64, 16], ids=["update-every-batch", "accumulate-4"])
@pytest.mark.parametrize("name", ["adam", "adamw", "rmsprop"])
def test_optimizer_state_carries_across(name, batch_size):
    rms = name == "rmsprop"
    rng = np.random.default_rng(0)
    tree = jax_tree(rng)
    params = jax.tree.map(jnp.asarray, tree)
    args = dict(epochs=3, steps_per_epoch=8, batch_size=batch_size, min_warmup_steps=3)
    tx, _, accumulate = jax_optim.build_optimizer(name, params, HYP, **args)
    state = tx.init(params)
    for _ in range(2 * accumulate):  # two updates, no accumulation left open
        grads = draw_grads(rng, tree, 1.0 if rms else 0.0)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)

    port_params = make_port_params(jax.tree.map(np.asarray, params))
    opt, _, _ = port_optim.build_optimizer(name, port_params, HYP, **args)
    load_jax_opt_state(opt, port_params.items(), state)
    kind, want, updates = from_jax_opt_state(state)
    assert updates == opt.updates == 2 and opt.micro == 0
    got = flatten_optimizer(opt, port_params.items())
    assert set(got) == set(want) | {"optimizer/updates"} and len(want) == len(SLOTS[name]) * len(port_params)
    for key, w in want.items():
        assert key.split("/")[0] in SLOTS[name]
        assert torch.equal(got[key], w), key
        assert w.abs().sum() > 0, key
    for st in opt.optimizer.state.values():
        assert float(st["step"]) == 2.0

    for _ in range(accumulate):  # one more update in each package from the same gradients
        grads = draw_grads(rng, tree, 1.0 if rms else 0.0)
        updates_, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates_)
        for k, g in to_port(grads).items():
            g = torch.tensor(g)
            port_params[k].grad = g if port_params[k].grad is None else port_params[k].grad + g
        opt.step()
    assert opt.updates == 3
    assert_params_match(port_params, params, f"{name} after the carried state", atol=2e-5 if rms else 1e-6)
    if not rms:  # the slots moved alike too (RMSprop's trace carries the eps difference before the lr)
        _, after, _ = from_jax_opt_state(state)
        for key, w in after.items():
            np.testing.assert_allclose(flatten_optimizer(opt, port_params.items())[key].numpy(), w.numpy(),
                                       rtol=RTOL, atol=1e-6, err_msg=key)


def test_loading_into_another_kind_raises():
    rng = np.random.default_rng(0)
    tree = jax_tree(rng)
    tx, _, _ = jax_optim.build_optimizer("adam", tree, HYP, epochs=3, steps_per_epoch=4, batch_size=64)
    port_params = make_port_params(tree)
    opt, _, _ = port_optim.build_optimizer("sgd", port_params, HYP, epochs=3, steps_per_epoch=4, batch_size=64)
    with pytest.raises(ValueError, match="adam"):
        load_jax_opt_state(opt, port_params.items(), tx.init(tree))


@pytest.mark.parametrize("name", ["adam", "adamw", "rmsprop"])
def test_train_state_round_trip(name, tmp_path):
    ref = JaxModel.from_config(SPEC, imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)
    tx, _, _ = jax_optim.build_optimizer(name, ref.params, HYP, **OPT_ARGS)
    ref_cfg = JaxLossConfig.from_model(ref.spec, HYP)
    ref_step = jax_make_train_step(ref.module, ref_cfg, tx)
    ref_state = jax_init_train_state(ref, tx, loss_cfg=ref_cfg)
    for _ in range(2):
        ref_state, _ = ref_step(ref_state, *make_batch())
    ref_state = jax.tree.map(np.asarray, ref_state)

    def fresh_state():
        model = load_jax_variables(DetectionModel(parse_spec(SPEC)), variables)
        optimizer, _, _ = port_optim.build_optimizer(name, model, HYP, **OPT_ARGS)
        return init_train_state(model, optimizer, dataclasses.replace(LossConfig.from_model(model.spec, HYP)))

    state = load_jax_train_state(fresh_state(), ref_state)
    got, want = flatten_train_state(state), from_jax_train_state(ref_state)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w, key
        else:
            assert torch.equal(got[key], w), key
    assert got["optimizer/updates"] == 2 and got["step"] == 2

    save_checkpoint(tmp_path / "last", state, spec=state.model.spec)
    sd, _ = load_checkpoint(tmp_path / "last")
    restored = restore_train_state(fresh_state(), sd)
    again = flatten_train_state(restored)
    assert set(again) == set(got)
    for key, v in got.items():
        assert (again[key] == v) if isinstance(v, int) else torch.equal(again[key], v), key

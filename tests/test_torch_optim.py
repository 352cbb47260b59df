"""The port's schedules, optimizers, accumulation, freeze and EMA
(train/optim.py) against the JAX package's optax transforms, fed the same
numpy parameters and gradients. f32 on the CPU; parameters after every update
at rtol 1e-5 / atol 1e-6 (the two frameworks round in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov3_tpu.train import optim as jax_optim
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.convert import from_jax_variables
from yolov3_tpu_torch.train import optim as port_optim

HYP = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.9, "weight_decay": 0.05, "warmup_epochs": 0.0,
       "warmup_momentum": 0.8, "warmup_bias_lr": 0.1}
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("cos_lr", [False, True], ids=["linear", "cosine"])
def test_schedules_match_jax_over_a_sweep(cos_lr):
    hyp = dict(HYP, warmup_epochs=2.0)
    args = dict(epochs=10, steps_per_epoch=100, batch_size=16, cos_lr=cos_lr)
    ref = jax_optim.build_schedules(hyp, **args)
    sch = port_optim.build_schedules(hyp, **args)
    steps = [0, 1, 7, 50, 199, 200, 201, 250, 499, 500, 777, 999, 1000, 1500]
    for s in steps:
        for name in ("lr", "bias_lr", "momentum"):
            want = float(getattr(ref, name)(np.float32(s)))
            assert getattr(sch, name)(s) == pytest.approx(want, rel=1e-5, abs=1e-9), (name, s)
    assert sch.lr(0) == 0.0 and sch.bias_lr(0) == pytest.approx(0.1) and sch.momentum(0) == pytest.approx(0.8)
    # min_warmup_steps floors the warm-up length
    short = port_optim.build_schedules(dict(HYP, warmup_epochs=0.1), epochs=10, steps_per_epoch=8, batch_size=16)
    ref_short = jax_optim.build_schedules(dict(HYP, warmup_epochs=0.1), epochs=10, steps_per_epoch=8, batch_size=16)
    for s in (0, 10, 99, 100):
        assert short.lr(s) == pytest.approx(float(ref_short.lr(np.float32(s))), rel=1e-5, abs=1e-9)


def jax_tree(rng):
    """A two-layer parameter tree in the JAX package's naming: a Conv (kernel, BN
    scale and bias) and a Detect conv (kernel, bias)."""
    n = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"l0": {"conv": {"kernel": n(3, 3, 4, 6)}, "bn": {"scale": n(6), "bias": n(6)}},
            "l1": {"m0": {"kernel": n(1, 1, 6, 5), "bias": n(5)}}}


def to_port(tree):
    """{port key: OIHW / vector numpy array} of a JAX parameter tree."""
    return {k: v.numpy() for k, v in from_jax_variables({"params": tree}).items()}


def make_port_params(tree):
    return {k: torch.nn.Parameter(torch.tensor(v)) for k, v in to_port(tree).items()}


def assert_params_match(port_params, jax_params, msg="", atol=ATOL):
    for k, want in to_port(jax_params).items():
        np.testing.assert_allclose(port_params[k].detach().numpy(), want, rtol=RTOL, atol=atol, err_msg=f"{msg} {k}")


def run_both(name, batch_size, n_steps, freeze=(), grad_scale=1.0, grad_floor=0.0, seed=0, atol=ATOL, **kw):
    """Drive both optimizers with the same gradients for n_steps loader
    batches; compare the parameters after every one. |gradient| >= grad_floor."""
    rng = np.random.default_rng(seed)
    tree = jax_tree(rng)
    params = jax.tree.map(jnp.asarray, tree)
    port_params = make_port_params(tree)
    args = dict(epochs=3, steps_per_epoch=4, batch_size=batch_size, min_warmup_steps=3, freeze=freeze, **kw)
    tx, _, acc_j = jax_optim.build_optimizer(name, params, HYP, **args)
    opt, _, acc = port_optim.build_optimizer(name, port_params, HYP, **args)
    assert acc == acc_j
    state = tx.init(params)
    for step in range(n_steps):
        def draw(p):
            g = rng.normal(size=p.shape) * grad_scale
            return (g + np.sign(g) * grad_floor).astype(np.float32)

        grads = jax.tree.map(draw, tree)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for k, g in to_port(grads).items():
            g = torch.tensor(g)
            port_params[k].grad = g if port_params[k].grad is None else port_params[k].grad + g
        opt.step()
        assert_params_match(port_params, params, f"{name} step {step}", atol)
    return opt, port_params, tree


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "rmsprop"])
def test_optimizer_updates_match_jax(name):
    """Four updates from the same gradients, under warm-up (3 steps) and decay;
    gradient norm about 9, so the clip at 10 sometimes bites.

    RMSprop: torch adds eps to the root of the second moment, optax (the JAX
    package) adds it under the root: 1e-8 against a second moment of 0.01 g^2
    is a relative 5e-7 / g^2 on every step, times lr / sqrt(0.01) = 1 for the
    bias group. So its gradients are kept at |g| >= 1 and its atol is 2e-5."""
    rms = name == "rmsprop"
    opt, _, _ = run_both(name, batch_size=64, n_steps=4, grad_floor=1.0 if rms else 0.0,
                         atol=2e-5 if rms else ATOL)
    assert opt.updates == 4 and opt.accumulate == 1


def test_sgd_clips_at_global_norm_10():
    run_both("sgd", batch_size=64, n_steps=3, grad_scale=25.0)


def test_three_groups_and_decay_scaling():
    rng = np.random.default_rng(0)
    opt, _, acc = port_optim.build_optimizer("sgd", make_port_params(jax_tree(rng)), HYP, epochs=3,
                                             steps_per_epoch=4, batch_size=16)
    assert acc == 4
    groups = {g["label"]: g for g in opt.optimizer.param_groups}
    assert {k: len(g["params"]) for k, g in groups.items()} == {"weight": 2, "bn": 1, "bias": 2}
    assert groups["weight"]["weight_decay"] == pytest.approx(0.05 * 16 * 4 / 64)
    assert groups["bn"]["weight_decay"] == 0.0 and groups["bias"]["weight_decay"] == 0.0
    assert all(g["nesterov"] for g in groups.values())
    with pytest.raises(NotImplementedError):
        port_optim.build_optimizer("lion", make_port_params(jax_tree(rng)), HYP, 3, 4, 16)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_accumulation_over_4_matches_jax(name):
    """batch 16 of nbs 64: one update per 4 loader batches, on the summed
    gradient, with the schedules read at the loader step."""
    opt, _, _ = run_both(name, batch_size=16, n_steps=9)
    assert opt.accumulate == 4 and opt.updates == 2 and opt.micro == 1


def test_freeze_matches_jax():
    """freeze=[0]: layer 0 never moves, layer 1 trains, and the frozen
    gradients still count in the clipped norm (grad norm far above 10)."""
    opt, port_params, tree = run_both("sgd", batch_size=64, n_steps=3, freeze=[0], grad_scale=25.0)
    start = to_port(tree)
    for k, p in port_params.items():
        moved = not np.array_equal(p.detach().numpy(), start[k])
        assert moved == k.startswith("model.1."), k
    assert sum(len(g["params"]) for g in opt.optimizer.param_groups) == 2


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 3, 1, bias=False)
        self.bn = torch.nn.BatchNorm2d(3)


def test_ema_matches_jax_over_several_updates():
    rng = np.random.default_rng(1)
    net = TinyNet()

    def randomize():
        with torch.no_grad():
            for t in (net.conv.weight, net.bn.weight, net.bn.bias, net.bn.running_mean, net.bn.running_var):
                t.copy_(torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(np.float32)))
            net.bn.num_batches_tracked += 1

    def variables():
        return {"params": {"conv": jnp.asarray(net.conv.weight.detach().numpy()),
                           "scale": jnp.asarray(net.bn.weight.detach().numpy()),
                           "bias": jnp.asarray(net.bn.bias.detach().numpy())},
                "batch_stats": {"mean": jnp.asarray(net.bn.running_mean.numpy()),
                                "var": jnp.asarray(net.bn.running_var.numpy())}}

    randomize()
    ema = port_optim.EMA(net)
    state = jax_optim.EMA(variables()).state
    for i in range(6):
        randomize()
        decay = 0.9 if i % 2 else 0.9999
        ema.update(net, decay=decay)
        state = jax_optim.EMA.update(state, variables(), decay=decay)
        assert ema.updates == int(state["updates"]) == i + 1
        pairs = [("conv.weight", state["ema"]["params"]["conv"]), ("bn.weight", state["ema"]["params"]["scale"]),
                 ("bn.bias", state["ema"]["params"]["bias"]), ("bn.running_mean", state["ema"]["batch_stats"]["mean"]),
                 ("bn.running_var", state["ema"]["batch_stats"]["var"])]
        for key, want in pairs:
            np.testing.assert_allclose(ema.ema[key].numpy(), np.asarray(want), rtol=1e-5, atol=1e-7, err_msg=key)
        assert int(ema.ema["bn.num_batches_tracked"]) == int(net.bn.num_batches_tracked)
    # the EMA owns its tensors: the model's are not aliased
    assert ema.ema["conv.weight"].data_ptr() != net.conv.weight.data_ptr()


def test_early_stopping_matches_jax():
    ref, es = jax_optim.EarlyStopping(patience=3), port_optim.EarlyStopping(patience=3)
    for epoch, fitness in enumerate([0.5, 0.4, 0.6, 0.5, 0.5, 0.5, 0.5]):
        assert es(epoch, fitness) == ref(epoch, fitness)
        assert (es.best_epoch, es.best_fitness, es.possible_stop) == \
            (ref.best_epoch, ref.best_fitness, ref.possible_stop)
    assert es.best_epoch == 2 and es(6, 0.1)
    assert port_optim.EarlyStopping(patience=0).patience == float("inf")

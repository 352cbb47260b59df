"""JAX variables -> port state dict: the inverse of
yolov3_tpu/models/convert.py:torch_key_to_path.

  JAX                                   port
  params/l{i}/conv/kernel (kh,kw,I,O)   model.{i}.conv.weight (O,I,kh,kw)
  params/l{i}/conv/bias                 model.{i}.conv.bias (fused models)
  params/l{i}/bn/{scale,bias}           model.{i}.bn.{weight,bias}
  batch_stats/l{i}/bn/{mean,var}        model.{i}.bn.running_{mean,var}
  params/l{i}_{r}/cv1/...  (repeats)    model.{i}.{r}.cv1...
  params/l{last}/m{k}/{kernel,bias}     model.{last}.m.{k}.{weight,bias}

Training state (yolov3_tpu/train/step.py's state pytree, SGD) is carried
across the same way: `from_jax_train_state` flattens it to

  model/<key>       params and batch_stats, as above
  momentum/<key>    opt "mu" (same tree as params) -> SGD momentum_buffer
  ema/<key>         ema/ema/{params,batch_stats}
  ema/updates, optimizer/updates, step, balance

`flatten_train_state` gives the port's TrainState under the same keys, and
`load_jax_train_state` loads the JAX state into a TrainState.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def jax_path_to_key(collection, path):
    """('params', ('l4_1', 'cv1', 'conv', 'kernel')) -> 'model.4.1.cv1.conv.weight'."""
    layer, *mods, leaf = path
    m = re.fullmatch(r"l(\d+)(?:_(\d+))?", layer)
    if m is None or (collection, leaf) not in _LEAF:
        raise KeyError(f"no port key for {collection}/{'/'.join(path)}")
    parts = ["model", m.group(1)] + ([m.group(2)] if m.group(2) is not None else [])
    for mod in mods:
        mk = re.fullmatch(r"m(\d+)", mod)
        parts += ["m", mk.group(1)] if mk else [mod]
    return ".".join(parts + [_LEAF[(collection, leaf)]])


def _collection_to_state_dict(coll, tree):
    sd = {}
    for path, v in _flatten(tree):
        a = np.asarray(v, dtype=np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1)  # (kh,kw,I,O) -> (O,I,kh,kw)
        sd[jax_path_to_key(coll, path)] = torch.tensor(a)
    return sd


def from_jax_variables(variables):
    """JAX {params, batch_stats} tree of arrays -> the port's state dict (f32 CPU tensors)."""
    sd = {}
    for coll in ("params", "batch_stats"):
        sd.update(_collection_to_state_dict(coll, variables.get(coll, {})))
    return sd


def load_jax_variables(model, variables):
    """Load JAX variables into a port DetectionModel built from the same spec.
    Every key must match; only BatchNorm's `num_batches_tracked` counters,
    which JAX does not keep, may be absent."""
    missing, unexpected = model.load_state_dict(from_jax_variables(variables), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"JAX variables do not match the model: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model


def _find_sgd_state(node):
    """The {"mu", "step"} dict of the JAX package's SGD inside an optax state
    (nested tuples of chain / masked / MultiSteps states), or None."""
    if isinstance(node, dict) or hasattr(node, "items"):
        return node if "mu" in node else None
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_sgd_state(child)
            if found is not None:
                return found
    return None


def from_jax_train_state(state):
    """JAX train state (SGD) -> flat {key: f32 CPU tensor or int}; see the module docstring."""
    sgd = _find_sgd_state(state["opt"])
    if sgd is None:
        raise NotImplementedError("only the SGD optimizer state (its 'mu' tree) is carried across")
    mini_step = getattr(state["opt"], "mini_step", None)
    if mini_step is not None and int(mini_step) != 0:
        raise NotImplementedError("a state in the middle of a gradient accumulation is not carried across")
    flat = {f"model/{k}": v for k, v in from_jax_variables(state).items()}
    flat.update({f"momentum/{k}": v for k, v in _collection_to_state_dict("params", sgd["mu"]).items()})
    flat.update({f"ema/{k}": v for k, v in from_jax_variables(state["ema"]["ema"]).items()})
    flat["ema/updates"] = int(state["ema"]["updates"])
    flat["optimizer/updates"] = int(sgd["step"])
    flat["step"] = int(state["step"])
    if "balance" in state:
        flat["balance"] = torch.tensor(np.asarray(state["balance"], dtype=np.float32))
    return flat


def _momentum_buffers(train_state):
    """{parameter name: (parameter, its SGD state dict)} over the optimizer's groups."""
    opt = train_state.optimizer.optimizer
    grouped = {id(p) for g in opt.param_groups for p in g["params"]}
    return {k: (p, opt.state[p]) for k, p in train_state.model.named_parameters() if id(p) in grouped}


def flatten_train_state(train_state):
    """The port's TrainState under `from_jax_train_state`'s keys (detached
    tensors on their device). A momentum buffer that no step has made yet
    counts as zeros, as the JAX state starts; frozen parameters have none."""
    flat = {}
    for k, v in train_state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            flat[f"model/{k}"] = v.detach()
    for k, (p, st) in _momentum_buffers(train_state).items():
        buf = st.get("momentum_buffer")
        flat[f"momentum/{k}"] = torch.zeros_like(p) if buf is None else buf.detach()
    for k, v in train_state.ema.ema.items():
        if v.is_floating_point():
            flat[f"ema/{k}"] = v
    flat["ema/updates"] = train_state.ema.updates
    flat["optimizer/updates"] = train_state.optimizer.updates
    flat["step"] = train_state.step
    if train_state.balance is not None:
        flat["balance"] = train_state.balance
    return flat


@torch.no_grad()
def load_jax_train_state(train_state, state):
    """Load a JAX train state (SGD) into the port's TrainState, in place."""
    flat = from_jax_train_state(state)
    load_jax_variables(train_state.model, state)
    for k, (p, st) in _momentum_buffers(train_state).items():
        st["momentum_buffer"] = flat[f"momentum/{k}"].to(device=p.device, dtype=p.dtype)
    for k, v in train_state.ema.ema.items():
        if v.is_floating_point():
            v.copy_(flat[f"ema/{k}"])
    train_state.ema.updates = flat["ema/updates"]
    train_state.optimizer.updates = flat["optimizer/updates"]
    train_state.optimizer.micro = 0
    train_state.step = flat["step"]
    if "balance" in flat:
        train_state.balance = flat["balance"].to(train_state.model.device)
    return train_state

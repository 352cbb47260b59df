"""JAX variables -> port state dict: the inverse of
yolov3_tpu/models/convert.py:torch_key_to_path.

  JAX                                   port
  params/l{i}/conv/kernel (kh,kw,I,O)   model.{i}.conv.weight (O,I,kh,kw)
  params/l{i}/conv/bias                 model.{i}.conv.bias (fused models)
  params/l{i}/bn/{scale,bias}           model.{i}.bn.{weight,bias}
  batch_stats/l{i}/bn/{mean,var}        model.{i}.bn.running_{mean,var}
  params/l{i}_{r}/cv1/...  (repeats)    model.{i}.{r}.cv1...
  params/l{last}/m{k}/{kernel,bias}     model.{last}.m.{k}.{weight,bias}
  .../m{k}/... (C3, MixConv2d)          ....m.{k}....
  .../dw/conv (DWConv)                  ....conv
  GhostBottleneck gc1 / dw / gc2        conv.0 / conv.1 / conv.2
                  dws / sc (s=2)        shortcut.0 / shortcut.1 (sc at s=1 keeps its name)
  .../tr{i}/... (TransformerBlock)      ....tr.{i}....
  Dense kernel (in, out)                Linear weight (out, in)
  dwt{i}/{kernel,bias} (per group)      one grouped, spatially flipped weight and bias
  w (Sum), p1 / p2 / beta (1,1,1,c)     w, p1 / p2 / beta (1,c,1,1)

Where the JAX package's own `torch_key_to_path` maps the reference's keys
right, this is its exact inverse; for DWConv, GhostBottleneck and
TransformerBlock (whose reference keys it cannot map) the port's forward on
the carried variables equals the JAX forward.

Training state (yolov3_tpu/train/step.py's state pytree) is carried across
the same way: `from_jax_train_state` flattens it to

  model/<key>        params and batch_stats, as above
  <slot>/<key>       the optimizer's per-parameter state (same tree as params):
                       SGD      opt "mu"                  -> momentum/ (momentum_buffer)
                       Adam(W)  ScaleByAdamState mu / nu  -> exp_avg/ / exp_avg_sq/
                       RMSprop  ScaleByRmsState nu        -> square_avg/
                                TraceState trace          -> momentum/ (momentum_buffer)
  optimizer/updates  the optimizer's update count (SGD "step", Adam "count",
                     RMSprop the schedule's count): torch's per-parameter "step"
  ema/<key>          ema/ema/{params,batch_stats}
  ema/updates, step, balance

Reference torch checkpoints (`.pt`) share the port's key names, so
`load_torch_checkpoint` (the EMA weights, else the model's, of a pickled
module, a state dict or a module tree unpickled through stub classes) and
`match_torch_state_dict` load them with `load_state_dict`.

`flatten_train_state` gives the port's TrainState under the same keys, and
`load_jax_train_state` loads the JAX state into a TrainState;
`from_jax_opt_state` / `flatten_optimizer` / `load_jax_opt_state` do the
same for an optimizer alone. RMSprop's eps stays a stated difference: torch
adds it to the root of the second moment, optax under the root.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from yolov3_tpu_torch.utils.general import LOGGER

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "w"): "w",  # Sum
    ("params", "p1"): "p1",  # AconC / MetaAconC
    ("params", "p2"): "p2",
    ("params", "beta"): "beta",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
# a GhostBottleneck's JAX scopes -> the reference's keys (`sc` too when `dws` is beside it: s=2)
_GHOST = {"gc1": ("conv", "0"), "dw": ("conv", "1"), "gc2": ("conv", "2"), "dws": ("shortcut", "0")}


def _child_parts(name, scope):
    """Port key parts of the child `name` of the JAX module scope `scope`."""
    if "gc1" in scope:  # GhostBottleneck
        if name == "sc" and "dws" in scope:
            return ("shortcut", "1")
        if name in _GHOST:
            return _GHOST[name]
    if name == "dw" and ("conv" in scope[name] or "bn" in scope[name]):
        return ()  # DWConv's inner Conv: the port's DWConv is that Conv
    m = re.fullmatch(r"(m|tr)(\d+)", name)  # Detect / C3 / MixConv2d's m{k}, TransformerBlock's tr{i}
    return (m.group(1), m.group(2)) if m else (name,)


def _leaf(coll, name, a):
    """(port leaf name, array in the port's layout) of a JAX leaf."""
    if (coll, name) not in _LEAF:
        raise KeyError(f"no port name for the JAX leaf {coll}/{name}")
    a = np.asarray(a, dtype=np.float32)
    if name == "kernel":  # conv (kh, kw, I, O) -> (O, I, kh, kw); Dense (in, out) -> Linear (out, in)
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    elif name in ("p1", "p2", "beta"):
        a = a.transpose(0, 3, 1, 2)  # (1, 1, 1, c) -> (1, c, 1, 1)
    return _LEAF[(coll, name)], a


def _transposed_conv(scope):
    """A DWConvTranspose2d's per-group flax ConvTranspose scopes (`dwt`, or
    `dwt{i}`, kernels (k, k, in/g, out/g)) -> its one grouped weight
    (in, out/g, k, k), flipped in space (see nn.modules.DWConvTranspose2d),
    and the groups' biases concatenated."""
    groups = [scope[k] for k in sorted(scope, key=lambda k: int(k[3:] or 0))]
    w = [np.asarray(g["kernel"], np.float32).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1] for g in groups]
    return {"weight": np.concatenate(w), "bias": np.concatenate([np.asarray(g["bias"], np.float32) for g in groups])}


def _entries(coll, scope, parts=()):
    """(port key, array) of every leaf of one JAX module scope, the key under `parts`."""
    if scope and all(re.fullmatch(r"dwt\d*", k) for k in scope):
        for leaf, a in _transposed_conv(scope).items():
            yield ".".join(parts + (leaf,)), a
        return
    for name, child in scope.items():
        if hasattr(child, "items"):
            yield from _entries(coll, child, parts + _child_parts(name, scope))
        else:
            leaf, a = _leaf(coll, name, child)
            yield ".".join(parts + (leaf,)), a


def _tensor(a):
    return torch.tensor(np.ascontiguousarray(a))


def _collection_to_state_dict(coll, tree):
    """A JAX model's collection ({l{i} or l{i}_{r}: scope}) -> {model.{i}[.{r}].<key>: tensor}."""
    sd = {}
    for layer, scope in tree.items():
        m = re.fullmatch(r"l(\d+)(?:_(\d+))?", layer)
        if m is None:
            raise KeyError(f"no port key for the JAX scope {coll}/{layer}")
        prefix = ("model", m.group(1)) + ((m.group(2),) if m.group(2) is not None else ())
        sd.update({k: _tensor(a) for k, a in _entries(coll, scope, prefix)})
    return sd


def from_jax_variables(variables):
    """JAX {params, batch_stats} tree of arrays -> the port's state dict (f32 CPU tensors)."""
    sd = {}
    for coll in ("params", "batch_stats"):
        sd.update(_collection_to_state_dict(coll, variables.get(coll, {})))
    return sd


def from_jax_module_variables(variables):
    """One JAX module's {params, batch_stats} (a module of nn/modules.py or
    nn/activations.py applied on its own) -> the state dict of its port
    module, keys relative to it."""
    return {k: _tensor(a) for coll in ("params", "batch_stats") for k, a in _entries(coll, variables.get(coll, {}))}


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


# torch slot of each optax per-parameter state, by optimizer
SLOTS = {"sgd": {"momentum": "momentum_buffer"},
         "adam": {"exp_avg": "exp_avg", "exp_avg_sq": "exp_avg_sq"},
         "rmsprop": {"square_avg": "square_avg", "momentum": "momentum_buffer"}}


def _find(node, match):
    """The first node of an optax state (nested tuples, named tuples and
    dicts) for which match(node) holds, or None."""
    if match(node):
        return node
    children = node.values() if hasattr(node, "items") else node if isinstance(node, (tuple, list)) else ()
    for child in children:
        found = _find(child, match)
        if found is not None:
            return found
    return None


def _named(name):
    return lambda node: type(node).__name__ == name


def from_jax_opt_state(opt):
    """An optax state of the JAX package's `build_optimizer` -> (kind, {<slot>/<key>:
    f32 CPU tensor}, update count); kind is "sgd", "adam" (Adam and AdamW) or
    "rmsprop"."""
    mini_step = getattr(opt, "mini_step", None)
    if mini_step is not None and int(mini_step) != 0:
        raise NotImplementedError("a state in the middle of a gradient accumulation is not carried across")
    sgd = _find(opt, lambda node: hasattr(node, "items") and "mu" in node)
    adam = _find(opt, _named("ScaleByAdamState"))
    rms = _find(opt, _named("ScaleByRmsState"))
    if sgd is not None:
        kind, trees, updates = "sgd", {"momentum": sgd["mu"]}, sgd["step"]
    elif adam is not None:
        kind, trees, updates = "adam", {"exp_avg": adam.mu, "exp_avg_sq": adam.nu}, adam.count
    elif rms is not None:
        trace = _find(opt, _named("TraceState"))
        kind, trees = "rmsprop", {"square_avg": rms.nu, "momentum": trace.trace}
        updates = _find(opt, _named("ScaleByScheduleState")).count
    else:
        raise NotImplementedError("only the SGD, Adam, AdamW and RMSprop optimizer states are carried across")
    flat = {}
    for slot, tree in trees.items():
        flat.update({f"{slot}/{k}": v for k, v in _collection_to_state_dict("params", tree).items()})
    return kind, flat, int(updates)


def optimizer_kind(optimizer):
    """"sgd", "adam" or "rmsprop" for a ScheduledOptimizer's torch optimizer."""
    kind = {"SGD": "sgd", "Adam": "adam", "AdamW": "adam", "RMSprop": "rmsprop"}.get(
        type(optimizer.optimizer).__name__)
    if kind is None:
        raise NotImplementedError(f"no JAX state layout for {type(optimizer.optimizer).__name__}")
    return kind


def _param_states(optimizer, named_params):
    """{parameter name: (parameter, its optimizer state dict)} over the optimizer's groups."""
    opt = optimizer.optimizer
    grouped = {id(p) for g in opt.param_groups for p in g["params"]}
    return {k: (p, opt.state[p]) for k, p in named_params if id(p) in grouped}


def flatten_optimizer(optimizer, named_params):
    """A ScheduledOptimizer's state under `from_jax_opt_state`'s keys, plus
    optimizer/updates. A slot that no step has made yet counts as zeros, as
    the JAX state starts; frozen parameters have none."""
    flat = {}
    for k, (p, st) in _param_states(optimizer, named_params).items():
        for slot, torch_slot in SLOTS[optimizer_kind(optimizer)].items():
            v = st.get(torch_slot)
            flat[f"{slot}/{k}"] = torch.zeros_like(p) if v is None else v.detach()
    flat["optimizer/updates"] = optimizer.updates
    return flat


@torch.no_grad()
def load_jax_opt_state(optimizer, named_params, opt):
    """Load an optax state into a ScheduledOptimizer of the same kind, in place."""
    kind, flat, updates = from_jax_opt_state(opt)
    if kind != optimizer_kind(optimizer):
        raise ValueError(f"a JAX {kind} state cannot be loaded into {type(optimizer.optimizer).__name__}")
    for k, (p, st) in _param_states(optimizer, named_params).items():
        for slot, torch_slot in SLOTS[kind].items():
            st[torch_slot] = flat[f"{slot}/{k}"].to(device=p.device, dtype=p.dtype)
        if kind != "sgd":  # torch's own step count (Adam's bias correction), a CPU scalar
            st["step"] = torch.tensor(float(updates), dtype=torch.float32)
    optimizer.updates = updates
    optimizer.micro = 0
    return optimizer


def from_jax_train_state(state):
    """JAX train state -> flat {key: f32 CPU tensor or int}; see the module docstring."""
    _, opt_flat, updates = from_jax_opt_state(state["opt"])
    flat = {f"model/{k}": v for k, v in from_jax_variables(state).items()}
    flat.update(opt_flat)
    flat.update({f"ema/{k}": v for k, v in from_jax_variables(state["ema"]["ema"]).items()})
    flat["ema/updates"] = int(state["ema"]["updates"])
    flat["optimizer/updates"] = updates
    flat["step"] = int(state["step"])
    if "balance" in state:
        flat["balance"] = torch.tensor(np.asarray(state["balance"], dtype=np.float32))
    return flat


def flatten_train_state(train_state):
    """The port's TrainState under `from_jax_train_state`'s keys (detached
    tensors on their device)."""
    flat = {}
    for k, v in train_state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            flat[f"model/{k}"] = v.detach()
    flat.update(flatten_optimizer(train_state.optimizer, train_state.model.named_parameters()))
    for k, v in train_state.ema.ema.items():
        if v.is_floating_point():
            flat[f"ema/{k}"] = v
    flat["ema/updates"] = train_state.ema.updates
    flat["step"] = train_state.step
    if train_state.balance is not None:
        flat["balance"] = train_state.balance
    return flat


@torch.no_grad()
def load_jax_train_state(train_state, state):
    """Load a JAX train state into the port's TrainState, in place."""
    flat = from_jax_train_state(state)
    load_jax_variables(train_state.model, state)
    load_jax_opt_state(train_state.optimizer, train_state.model.named_parameters(), state["opt"])
    for k, v in train_state.ema.ema.items():
        if v.is_floating_point():
            v.copy_(flat[f"ema/{k}"])
    train_state.ema.updates = flat["ema/updates"]
    train_state.step = flat["step"]
    if "balance" in flat:
        train_state.balance = flat["balance"].to(train_state.model.device)
    return train_state


# reference state-dict entries the port's model does not hold (yolov3_tpu/models/convert.py torch_key_to_path)
_SKIPPED_LEAVES = ("num_batches_tracked", "anchors", "anchor_grid", "stride")


def load_torch_checkpoint(path):
    """A reference .pt -> (flat {name: float32 CPU tensor}, the model's cfg
    dict or None). The tensors: the EMA weights when the checkpoint has them,
    else its model's (reference experimental.py:105), from a pickled module,
    a state dict, or a module tree whose classes are not importable
    (unpickled through stub classes); fp16 tensors are cast to float32. The
    cfg: a pickled reference model keeps the one it was built from as its
    `yaml` attribute (reference yolo.py:193-200); a bare state dict has none."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        LOGGER.warning(f"pickled classes unavailable ({e}); retrying with stub modules")
        ckpt = _load_with_stubs(path)
    obj = ckpt
    if isinstance(ckpt, dict):
        obj = ckpt.get("ema") or ckpt.get("model") or ckpt
    cfg = None
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif not isinstance(obj, dict):  # a stub module with _parameters / _buffers / _modules
        sd = _walk_stub_state_dict(obj)
    else:
        sd = obj
    if not isinstance(obj, dict):
        cfg = getattr(obj, "__dict__", {}).get("yaml")
    sd = {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
          for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return sd, (dict(cfg) if isinstance(cfg, dict) else None)


def _load_with_stubs(path):
    """Unpickle a checkpoint whose module classes are not importable, with
    permissive stub classes installed under the reference's module paths."""
    import pickle
    import sys
    import types

    class _Stub:
        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {})

        def __getattr__(self, k):
            raise AttributeError(k)

    class _StubModule(types.ModuleType):
        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            cls = type(name, (_Stub,), {})
            setattr(self, name, cls)
            return cls

    created = []
    for mod in ("models", "models.yolo", "models.common", "models.experimental", "utils", "utils.loss"):
        if mod not in sys.modules:
            sys.modules[mod] = _StubModule(mod)
            created.append(mod)
    try:
        return torch.load(path, map_location="cpu", weights_only=False, pickle_module=pickle)
    finally:
        for mod in created:
            sys.modules.pop(mod, None)


def _walk_stub_state_dict(obj, prefix=""):
    """The tensors of a stub-unpickled torch module tree, under state-dict names."""
    out = {}
    d = getattr(obj, "__dict__", {})
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if v is not None:
                out[prefix + k] = v
    for k, child in (d.get("_modules") or {}).items():
        out.update(_walk_stub_state_dict(child, prefix + k + "."))
    return out


def match_torch_state_dict(model, sd):
    """Split a reference state dict against `model`: ({key: tensor} that
    load, [reasons for the ones that do not]); the reference's anchors,
    strides and BatchNorm counters are skipped, as in the JAX converter."""
    target = model.state_dict()
    matched, missed = {}, []
    for k, v in sd.items():
        if k.split(".")[-1] in _SKIPPED_LEAVES:
            continue
        if k not in target:
            missed.append(f"{k}: no target in the model")
        elif tuple(v.shape) != tuple(target[k].shape):
            missed.append(f"{k}: shape {tuple(v.shape)} vs ours {tuple(target[k].shape)}")
        else:
            matched[k] = v
    LOGGER.info(f"convert: matched {len(matched)} torch tensors -> {len(target)} target entries; "
                f"{len(missed)} unmatched")
    for msg in missed[:10]:
        LOGGER.warning(f"  unmatched: {msg}")
    return matched, missed

"""JAX variables -> port state dict: the inverse of
yolov3_tpu/models/convert.py:torch_key_to_path.

  JAX                                   port
  params/l{i}/conv/kernel (kh,kw,I,O)   model.{i}.conv.weight (O,I,kh,kw)
  params/l{i}/conv/bias                 model.{i}.conv.bias (fused models)
  params/l{i}/bn/{scale,bias}           model.{i}.bn.{weight,bias}
  batch_stats/l{i}/bn/{mean,var}        model.{i}.bn.running_{mean,var}
  params/l{i}_{r}/cv1/...  (repeats)    model.{i}.{r}.cv1...
  params/l{last}/m{k}/{kernel,bias}     model.{last}.m.{k}.{weight,bias}
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


def from_jax_variables(variables):
    """JAX {params, batch_stats} tree of arrays -> the port's state dict (f32 CPU tensors)."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            a = np.asarray(v, dtype=np.float32)
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1)  # (kh,kw,I,O) -> (O,I,kh,kw)
            sd[jax_path_to_key(coll, path)] = torch.tensor(a)
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

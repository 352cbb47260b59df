"""Stateless activations (yolov3_tpu/nn/activations.py), as tensor functions.

`Conv` resolves `act=True` to the process default at construction time;
`DetectionModel` sets that default to the YAML `activation:` only while it
builds its own layers, so one model's override never reaches another.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x):
    return F.silu(x)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x):
    return x * torch.tanh(F.softplus(x))


def relu(x):
    return F.relu(x)


def leaky_relu(x, negative_slope=0.1):
    return F.leaky_relu(x, negative_slope=negative_slope)


def identity(x):
    return x


ACTIVATIONS = {
    "silu": silu,
    "swish": silu,
    "hardswish": hardswish,
    "mish": mish,
    "relu": relu,
    "leakyrelu": leaky_relu,
    "identity": identity,
    "none": identity,
}

# default for act=True (the reference's Conv.default_act, overridden by a YAML
# `activation:` key); read when a Conv is built, not when it runs
_DEFAULT_ACT = [silu]


def set_default_activation(act):
    """Override the default activation (YAML `activation:` key)."""
    _DEFAULT_ACT[0] = get_activation(act) if act not in (None, True) else silu


def get_activation(act):
    """Resolve an activation spec (True/False/str/callable) to a function."""
    if act is True:
        return _DEFAULT_ACT[0]
    if act in (False, None):
        return identity
    if callable(act):
        return act
    key = str(act).lower().replace("nn.", "").replace("()", "")
    if key not in ACTIVATIONS:
        raise KeyError(f"unknown activation {act!r}; available: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]

"""The activations of yolov3_tpu/nn/activations.py: the stateless ones as
tensor functions, and FReLU, AconC and MetaAconC as modules (which, as in the
JAX package, no YAML `activation:` names).

`Conv` resolves `act=True` to the process default at construction time;
`DetectionModel` sets that default to the YAML `activation:` only while it
builds its own layers, so one model's override never reaches another.
"""

from __future__ import annotations

import torch
import torch.nn as nn
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


class FReLU(nn.Module):
    """Funnel activation, max(x, BN(depthwise kxk conv(x))) (JAX
    activations.py:75-85; reference activations.py:57-71). Its BN is flax's
    plain nn.BatchNorm (eps 1e-3, momentum 0.03 in torch's convention), which
    stores the *biased* batch variance as its running variance, unlike every
    other BN of the port."""

    def __init__(self, c1, k=3):
        super().__init__()
        if k % 2 != 1:
            raise ValueError(f"FReLU: k={k}; flax's SAME padding is symmetric only for an odd k")
        self.conv = nn.Conv2d(c1, c1, k, 1, k // 2, groups=c1, bias=False)
        self.bn = nn.BatchNorm2d(c1, eps=1e-3, momentum=0.03)

    def forward(self, x):
        t, bn = self.conv(x), self.bn
        if self.training:
            var, mean = torch.var_mean(t.float(), dim=(0, 2, 3), correction=0)
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
                bn.num_batches_tracked += 1
        else:
            mean, var = bn.running_mean, bn.running_var
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        shift = bn.bias - mean * scale
        return torch.maximum(x, t * scale[:, None, None].to(t.dtype) + shift[:, None, None].to(t.dtype))


def _acon(x, p1, p2, beta):
    dpx = (p1 - p2) * x
    return dpx * torch.sigmoid(beta * dpx) + p2 * x


class AconC(nn.Module):
    """ACON-C, (p1 - p2) x sigmoid(beta (p1 - p2) x) + p2 x (arxiv 2009.04759;
    JAX activations.py:88). p1, p2 and beta are (1, c, 1, 1) here, (1, 1, 1, c)
    in the JAX package."""

    def __init__(self, c1):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.beta = nn.Parameter(torch.ones(1, c1, 1, 1))

    def forward(self, x):
        return _acon(x, self.p1, self.p2, self.beta)


class MetaAconC(nn.Module):
    """Meta-ACON: ACON-C with beta = sigmoid(fc2(fc1(spatial mean of x))), two
    kxk convs with bias through max(r, c // r) channels (JAX
    activations.py:101-119; reference activations.py:86-119)."""

    def __init__(self, c1, k=1, r=16):
        super().__init__()
        if k % 2 != 1:
            raise ValueError(f"MetaAconC: k={k}; flax's SAME padding is symmetric only for an odd k")
        c2 = max(r, c1 // r)
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.fc1 = nn.Conv2d(c1, c2, k, 1, k // 2, bias=True)
        self.fc2 = nn.Conv2d(c2, c1, k, 1, k // 2, bias=True)

    def forward(self, x):
        beta = torch.sigmoid(self.fc2(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return _acon(x, self.p1, self.p2, beta)

"""The layers yolov3 / yolov3-spp / yolov3-tiny are built from
(yolov3_tpu/nn/modules.py), as `nn.Module`s on NCHW tensors.

The JAX package runs NHWC. Here activations are NCHW tensors in
`torch.channels_last` memory format, which is the same NHWC byte layout: the
Detect head's output permuted to (B, ny, nx, C) is then a free contiguous
view. State-dict keys follow the reference naming (`conv.weight`,
`bn.running_mean`, ...), which yolov3_tpu/models/convert.py maps to the JAX
variable tree.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolov3_tpu_torch.nn.activations import get_activation
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats

BN_EPS = 1e-3  # the JAX package's BatchNorm epsilon
BN_MOMENTUM = 0.03  # torch convention of flax's decay 0.97

_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The context of an activation-checkpoint recompute (models/detection.py):
    train-mode convs normalise with their batch statistics as in the first
    forward but leave the BatchNorm running statistics and counters alone,
    so a recomputed segment updates them once, not twice (as Flax's
    nn.remat does, where the update comes from the forward's output only).
    Thread-local: autograd may run the recompute on its own thread."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def in_recompute():
    return getattr(_RECOMPUTE, "on", False)


def autopad(k, p=None, d=1):
    """Same-shape padding for a given kernel/dilation (reference common.py:48-54)."""
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else [d * (x - 1) + 1 for x in k]
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-3) + activation.

    `fused=True` is the inference form with the BN folded into the conv
    (models/fuse.py): the conv carries a bias and there is no `bn`.

    Routing in train mode: a stride-1, 3x3, groups=1, dilation=1 conv with a
    `bn` goes through `conv3x3_bn_stats` (ops/conv_bn_cuda.py), which returns
    the conv output with its batch mean and biased variance in one pass; this
    module then normalises, and updates `bn`'s running statistics as
    `nn.BatchNorm2d` would (Bessel-corrected variance, momentum 0.03). Every
    other conv (1x1, stride 2, grouped, dilated) keeps `nn.BatchNorm2d`. Eval
    mode and the fused form never take that route. `bn_stats_fn` is the
    function called; a caller comparing the kernel with its plain version
    sets it (DetectionModel.set_bn_stats_fn)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True, fused=False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=fused)
        self.bn = None if fused else nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)
        self.stats_route = (not fused and k == 3 and s == 1 and g == 1 and d == 1
                            and self.conv.padding == (1, 1))
        self.bn_stats_fn = conv3x3_bn_stats

    def forward(self, x):
        if self.stats_route and self.training:
            return self.act(self._conv_bn_train(x))
        x = self.conv(x)
        if self.bn is not None and self.training and in_recompute():
            # batch statistics as in the first forward; momentum 0 leaves the running
            # statistics' values as they are and the counter is not advanced
            bn = self.bn
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, True, 0.0, bn.eps)
        elif self.bn is not None:
            x = self.bn(x)
        return self.act(x)

    def _conv_bn_train(self, x):
        bn = self.bn
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)  # NHWC view
        y, mean, var = self.bn_stats_fn(x, self.conv.weight.permute(2, 3, 1, 0))
        var = var.clamp(min=0.0)  # E[y^2] - mean^2 can round below 0
        scale = bn.weight.float() * torch.rsqrt(var + bn.eps)
        shift = bn.bias.float() - mean * scale
        out = torch.addcmul(shift.to(y.dtype), y, scale.to(y.dtype))
        if in_recompute():
            return out.permute(0, 3, 1, 2)
        with torch.no_grad():
            n = y.numel() // y.shape[-1]
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m * n / max(n - 1, 1))
            bn.num_batches_tracked += 1
        return out.permute(0, 3, 1, 2)  # NCHW view in channels_last


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 conv with optional residual add (reference common.py:150-166)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class SPP(nn.Module):
    """Spatial pyramid pooling (reference common.py:267-290)."""

    def __init__(self, c1, c2, k=(5, 9, 13), fused=False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1, fused=fused)
        self.k = tuple(k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class MaxPool(nn.Module):
    """Square max pooling; the padding counts as -inf, like torch's MaxPool2d."""

    def __init__(self, k=2, s=2, p=0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad(nn.Module):
    """Zero padding of H/W; pad = (left, right, top, bottom), torch ZeroPad2d order."""

    def __init__(self, pad=(0, 1, 0, 1)):
        super().__init__()
        self.pad = tuple(pad)

    def forward(self, x):
        return F.pad(x, self.pad)


class Upsample(nn.Module):
    """Nearest-neighbour integer upsample."""

    def __init__(self, scale=2, mode="nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError(f"unsupported upsample mode {mode}")
        self.scale = int(scale)

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    """Concatenate a list of tensors on channels."""

    def forward(self, xs):
        return torch.cat(xs, 1)


# the ops of the three yolov3 configs, under their spec names and the
# reference YAML spellings
MODULE_REGISTRY = {
    "Conv": Conv,
    "Bottleneck": Bottleneck,
    "SPP": SPP,
    "MaxPool": MaxPool,
    "nn.MaxPool2d": MaxPool,
    "ZeroPad": ZeroPad,
    "nn.ZeroPad2d": ZeroPad,
    "Upsample": Upsample,
    "nn.Upsample": Upsample,
    "Concat": Concat,
}

MULTI_INPUT_OPS = {"Concat"}
# ops built as cls(c1, *args, fused=...): first arg is the input channel count
CHANNEL_OPS = {"Conv", "Bottleneck", "SPP"}

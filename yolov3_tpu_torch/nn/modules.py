"""The module zoo of yolov3_tpu/nn/modules.py, as `nn.Module`s on NCHW tensors:
the layers of yolov3 / yolov3-spp / yolov3-tiny and of the YOLOv5 family
(C3, SPPF, Focus, Ghost, transformer, CSP, ...).

The JAX package runs NHWC. Here activations are NCHW tensors in
`torch.channels_last` memory format, which is the same NHWC byte layout: the
Detect head's output permuted to (B, ny, nx, C) is then a free contiguous
view. State-dict keys follow the reference naming (`conv.weight`,
`bn.running_mean`, ...), which yolov3_tpu/models/convert.py maps to the JAX
variable tree; where the JAX module names differ (DWConv, GhostBottleneck,
TransformerBlock, DWConvTranspose2d), models/convert.py carries the JAX
variables across.

Where the JAX module computes something other than the reference, the port
computes the JAX function: DWConvTranspose2d (flax ConvTranspose: unflipped
kernel, explicit padding) and TransformerLayer (no attention in-projection,
no biases).
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolov3_tpu_torch.nn.activations import get_activation, identity, leaky_relu, silu
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
from yolov3_tpu_torch.ops.conv_pool_cuda import conv_pool, route_of
from yolov3_tpu_torch.ops.epilogue_cuda import conv_epilogue, in_vector_layout
from yolov3_tpu_torch.parallel.mesh import all_reduce_sum, statistics_synchronized, world_size

BN_EPS = 1e-3  # the JAX package's BatchNorm epsilon
BN_MOMENTUM = 0.03  # torch convention of flax's decay 0.97
EPILOGUE_ACTS = {silu: "silu", identity: "identity", leaky_relu: "leaky_relu"}  # what conv_epilogue computes

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


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d at the JAX package's eps and momentum (TorchBatchNorm:
    the running variance is Bessel-corrected). Inside an activation-checkpoint
    recompute (`recomputing`) it normalises with the batch statistics and
    leaves the running statistics and the counter alone.

    In train mode when `statistics_synchronized()` (inside the train step,
    under a process group of more than one rank), the statistics are the
    global batch's, as under the JAX package's mesh (`global_batch_norm`)."""

    def __init__(self, c):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        if self.training and statistics_synchronized():
            return global_batch_norm(x, self)
        if self.training and in_recompute():
            # momentum 0 leaves the running statistics' values as they are
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, True, 0.0, self.eps)
        return super().forward(x)


def global_batch_norm(x, bn):
    """Train-mode BatchNorm over the global batch of a process group, in
    F.batch_norm's arithmetic: each rank's channel mean and biased variance
    (computed in f32 at least) become its sums [n mean, n (var + mean^2), n]
    in float64, which a differentiable all-reduce adds over the ranks
    (parallel.mesh.all_reduce_sum: the sums forward, their cotangents
    backward, as SyncBatchNorm does); then mean = S / N, var = Q / N - mean^2
    and y = x * scale + shift. The running statistics move by momentum with
    the variance Bessel-corrected over the global N (not inside a recompute).
    torch.nn.SyncBatchNorm is not used: it refuses CPU tensors."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var_l, mean_l = torch.var_mean(xf, (0, 2, 3), unbiased=False)
    n = float(x.numel() // x.shape[1])
    local = torch.cat([mean_l * n, (var_l + mean_l * mean_l) * n,
                       torch.full((1,), n, dtype=acc, device=x.device)]).double()
    sums = all_reduce_sum(local)
    c = x.shape[1]
    total = sums[2 * c]
    mean = sums[:c] / total
    var = (sums[c:2 * c] / total - mean * mean).to(acc).clamp(min=0.0)
    mean = mean.to(acc)
    scale = bn.weight.to(acc) * torch.rsqrt(var + bn.eps)
    shift = bn.bias.to(acc) - mean * scale
    out = torch.addcmul(shift[None, :, None, None], xf, scale[None, :, None, None]).to(x.dtype)
    if not in_recompute():
        with torch.no_grad():  # no host sync: the Bessel factor stays on the device
            m = bn.momentum
            bessel = total / (total - 1).clamp(min=1.0)
            bn.running_mean.mul_(1.0 - m).add_(mean.to(bn.running_mean.dtype), alpha=m)
            bn.running_var.mul_(1.0 - m).add_((var * (m * bessel)).to(bn.running_var.dtype))
            bn.num_batches_tracked += 1
    return out


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-3) + activation. `k` and `s` may
    be (h, w) pairs (CrossConv's 1xk / kx1).

    `fused=True` is the inference form with the BN folded into the conv
    (models/fuse.py): the conv carries a bias and there is no `bn`.

    Routing in train mode: a stride-1, 3x3, groups=1, dilation=1 conv with a
    `bn` goes through `conv3x3_bn_stats` (ops/conv_bn_cuda.py), which returns
    the conv output with its batch mean and biased variance in one pass; this
    module then normalises, and updates `bn`'s running statistics as
    `nn.BatchNorm2d` would (Bessel-corrected variance, momentum 0.03). Every
    other conv (1x1, stride 2, grouped, dilated) keeps `nn.BatchNorm2d`. Eval
    mode and the fused form never take that route. Nested Convs (C3's
    bottlenecks, a DWConv whose groups come to 1) route the same way.
    `bn_stats_fn` is the function called; a caller comparing the kernel with
    its plain version sets it (DetectionModel.set_bn_stats_fn).

    The fused form's epilogue on the card: a folded conv in eval mode on a
    CUDA bf16 input, with no autograd graph to record, C_out a multiple of
    8 and an activation of `EPILOGUE_ACTS` (SiLU, identity, leaky ReLU 0.1)
    runs the conv without its bias, then `conv_epilogue`
    (ops/epilogue_cuda.py): bias, activation and `residual` in one pass
    over the conv's output, in place. Every other case (CPU tensors,
    float32 and float16, train mode, a recorded graph, other activations)
    runs the conv with its bias, the activation and the residual add as
    PyTorch ops. `residual` (a Bottleneck's shortcut) is added after the
    activation either way.

    Where a `MaxPool(2, 2, 0)` follows and `pools` (the structure) allows,
    `forward_pooled` computes this conv and that pool in one `conv_pool`
    launch, under the epilogue's conditions and for even H and W."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True, fused=False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=fused)
        self.bn = None if fused else BatchNorm2d(c2)
        self.act = get_activation(act)
        self.stats_route = (not fused and k == 3 and s == 1 and g == 1 and d == 1
                            and self.conv.padding == (1, 1))
        self.bn_stats_fn = conv3x3_bn_stats

    def forward(self, x, residual=None):
        if self.stats_route and self.training:
            out = self.act(self._conv_bn_train(x))
        elif (act := self._epilogue_act(x, residual)) is not None:
            c = self.conv
            y = F.conv2d(x, c.weight, None, c.stride, c.padding, c.dilation, c.groups)
            if residual is not None:
                residual = in_vector_layout(residual)
            return conv_epilogue(in_vector_layout(y), c.bias, act, residual)
        else:
            y = self.conv(x)
            out = self.act(y if self.bn is None else self.bn(y))
        return out if residual is None else residual + out

    def _epilogue_act(self, x, residual):
        """The name of the activation where `conv_epilogue` takes this call's epilogue, else None."""
        act = EPILOGUE_ACTS.get(self.act)
        w, b = self.conv.weight, self.conv.bias
        if (act is None or self.bn is not None or b is None or self.training or not x.is_cuda
                or x.dtype != torch.bfloat16 or w.dtype != x.dtype or b.dtype != x.dtype or w.shape[0] % 8):
            return None
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b, residual)):
            return None
        if residual is not None and not (residual.is_cuda and residual.dtype == x.dtype):
            return None
        return act

    def pools(self):
        """Whether `conv_pool` computes this conv: folded, 3x3, stride 1,
        padding 1, one group, no dilation, an activation of `EPILOGUE_ACTS`
        and widths of one of the kernel's routes (`route_of`)."""
        c = self.conv
        return (self.bn is None and c.bias is not None and c.kernel_size == (3, 3) and c.stride == (1, 1)
                and c.padding == (1, 1) and c.groups == 1 and c.dilation == (1, 1)
                and EPILOGUE_ACTS.get(self.act) is not None and route_of(c.in_channels, c.out_channels) is not None)

    def forward_pooled(self, x, keep):
        """(pooled, unpooled) of this conv and the `MaxPool(2, 2, 0)` after it
        in one `conv_pool` launch (unpooled None unless `keep`), or None where
        this call takes the separate layers: the epilogue's conditions
        (`_epilogue_act`), and even H and W."""
        act = self._epilogue_act(x, None)
        if act is None or x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
            return None
        c = self.conv
        return conv_pool(in_vector_layout(x), c.weight, c.bias, act, keep)

    def _conv_bn_train(self, x):
        bn = self.bn
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)  # NHWC view
        y, mean, var = self.bn_stats_fn(x, self.conv.weight.permute(2, 3, 1, 0))
        var = var.clamp(min=0.0)  # E[y^2] - mean^2 can round below 0
        # in the statistics' dtype: float32 (float64 for a float64 model, whose BatchNorm
        # parameters would otherwise round their gradients to float32)
        scale = bn.weight.to(mean.dtype) * torch.rsqrt(var + bn.eps)
        shift = bn.bias.to(mean.dtype) - mean * scale
        out = torch.addcmul(shift.to(y.dtype), y, scale.to(y.dtype))
        if in_recompute():
            return out.permute(0, 3, 1, 2)
        with torch.no_grad():
            n = y.numel() // y.shape[-1]
            if statistics_synchronized():
                n *= world_size()  # the global batch's (ranks take equal batches)
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m * n / max(n - 1, 1))
            bn.num_batches_tracked += 1
        return out.permute(0, 3, 1, 2)  # NCHW view in channels_last


class DWConv(Conv):
    """Depthwise-ish conv, groups = gcd(c1, c2) (reference common.py:85-93). A
    Conv itself, so its keys are the reference's `conv.*` / `bn.*` and the
    fused form folds it (the JAX package nests it as `dw/conv`)."""

    def __init__(self, c1, c2, k=1, s=1, d=1, act=True, fused=False):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act, fused=fused)


class DWConvTranspose2d(nn.ConvTranspose2d):
    """Depthwise transposed conv, groups = gcd(c1, c2), computing the JAX
    module's function (yolov3_tpu/nn/modules.py:420): flax ConvTranspose, i.e.
    the stride-dilated input padded by p1 on both sides and correlated with the
    unflipped kernel, then p2 zero rows and columns appended bottom and right.
    That is torch's transposed conv at padding k - 1 - p1 with the kernel
    flipped in space, which `weight` holds. A side of the output is
    (n - 1) s + 2 p1 - k + 2 (+ p2), not torch ConvTranspose2d's
    (n - 1) s - 2 p1 + k: a stated difference of the JAX package."""

    def __init__(self, c1, c2, k=1, s=1, p1=0, p2=0):
        if not 0 <= p1 <= k - 1:
            raise ValueError(f"DWConvTranspose2d: p1={p1} outside [0, k - 1] for k={k}")
        super().__init__(c1, c2, k, s, k - 1 - p1, groups=math.gcd(c1, c2), bias=True)
        self.p2 = p2

    def forward(self, x):
        y = super().forward(x)
        return F.pad(y, (0, self.p2, 0, self.p2)) if self.p2 else y


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 conv with optional residual add (reference common.py:150-166)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        return self.cv2(self.cv1(x), residual=x if self.add else None)


class BottleneckCSP(nn.Module):
    """CSP bottleneck (reference common.py:168-196): cv2 / cv3 are raw
    bias-free 1x1 convs, and the BN over their concat is a standalone BN with
    no conv to fold into, kept as it is by the fused form."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, 1, fused=fused)
        self.bn = BatchNorm2d(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0, fused=fused) for _ in range(n)))

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        return self.cv4(F.silu(self.bn(torch.cat((y1, self.cv2(x)), 1))))


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions (reference common.py:199-221); the
    subclasses put another core in `m`."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv3 = Conv(2 * c_, c2, 1, fused=fused)
        self.m = self.core(c_, n, shortcut, g, fused)

    @staticmethod
    def core(c_, n, shortcut, g, fused):
        return nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0, fused=fused) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class CrossConv(nn.Module):
    """Cross-convolution: 1xk then kx1 (reference common.py:224-240)."""

    def __init__(self, c1, c2, k=3, s=1, g=1, e=1.0, shortcut=False, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, (1, k), (1, s), fused=fused)
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        return self.cv2(self.cv1(x), residual=x if self.add else None)


class C3x(C3):
    """C3 with CrossConv bottlenecks (reference common.py:244-250)."""

    @staticmethod
    def core(c_, n, shortcut, g, fused):
        return nn.Sequential(*(CrossConv(c_, c_, 3, 1, g, 1.0, shortcut, fused=fused) for _ in range(n)))


class C3TR(C3):
    """C3 with a TransformerBlock of n layers as its core (reference common.py:253-259)."""

    @staticmethod
    def core(c_, n, shortcut, g, fused):
        return TransformerBlock(c_, c_, 4, n, fused=fused)


class C3SPP(C3):
    """C3 with an SPP core (reference common.py:262-268). The arguments keep
    the JAX module's order, k last."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=(5, 9, 13), fused=False):
        self.k = tuple(k)
        super().__init__(c1, c2, n, shortcut, g, e, fused)

    def core(self, c_, n, shortcut, g, fused):
        return SPP(c_, c_, self.k, fused=fused)


class C3Ghost(C3):
    """C3 with GhostBottlenecks (reference common.py:271-277)."""

    @staticmethod
    def core(c_, n, shortcut, g, fused):
        return nn.Sequential(*(GhostBottleneck(c_, c_, fused=fused) for _ in range(n)))


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


class SPPF(nn.Module):
    """Fast SPP: three chained k-pools, the same as SPP(k, 2k-1, 3k-2) (reference common.py:293-313)."""

    def __init__(self, c1, c2, k=5, fused=False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, fused=fused)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class Focus(nn.Module):
    """Space-to-depth stem, (b, c, h, w) -> (b, 4c, h/2, w/2) -> Conv (reference
    common.py:316-332); the phases in the JAX module's order over (H, W):
    [::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2]."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True, fused=False):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act, fused=fused)

    def forward(self, x):
        return self.conv(torch.cat((x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]), 1))


class GhostConv(nn.Module):
    """Ghost convolution (reference common.py:335-352): half the channels from
    a conv, the other half from a 5x5 depthwise conv of those."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True, fused=False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act, fused=fused)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act, fused=fused)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat((y, self.cv2(y)), 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (reference common.py:355-377), under the reference's
    keys: `conv.0` / `conv.1` (the stride-2 DWConv) / `conv.2`, and at s=2
    `shortcut.0` (DWConv) / `shortcut.1` (Conv). At s=1 with c1 != c2 the JAX
    module adds a 1x1 Conv on the shortcut that the reference lacks; it keeps
    the JAX name `sc`."""

    def __init__(self, c1, c2, k=3, s=1, fused=False):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1, fused=fused),
                                  DWConv(c_, c_, k, s, act=False, fused=fused) if s == 2 else nn.Identity(),
                                  GhostConv(c_, c2, 1, 1, act=False, fused=fused))
        self.shortcut = nn.Sequential(DWConv(c1, c1, k, s, act=False, fused=fused),
                                      Conv(c1, c2, 1, 1, act=False, fused=fused)) if s == 2 else None
        self.sc = Conv(c1, c2, 1, 1, act=False, fused=fused) if s != 2 and c1 != c2 else None

    def forward(self, x):
        y = self.conv(x)
        if self.shortcut is not None:
            return y + self.shortcut(x)
        return y + (x if self.sc is None else self.sc(x))


class TransformerLayer(nn.Module):
    """Self-attention + MLP without LayerNorm, as the JAX module computes it
    (yolov3_tpu/nn/modules.py:726): q, k, v and proj without bias and without
    the reference's attention in-projection, softmax(q k^T / sqrt(hd)) in f32 (or
    wider),
    then fc2(fc1(x)) + x. x: (seq, batch, c)."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q", "k", "v", "proj", "fc1", "fc2"):
            self.add_module(name, nn.Linear(c, c, bias=False))

    def forward(self, x):
        s, b, c = x.shape
        hd = c // self.num_heads

        def heads(t):  # (seq, batch, c) -> (batch * heads, seq, hd)
            return t.reshape(s, b * self.num_heads, hd).transpose(0, 1)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = q @ k.transpose(1, 2)
        att = torch.softmax(scores.to(torch.promote_types(scores.dtype, torch.float32)) / math.sqrt(hd), dim=-1)
        att = att.to(v.dtype)
        x = self.proj((att @ v).transpose(0, 1).reshape(s, b, c)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Vision-transformer block over a feature map (reference common.py:130-147):
    a 1x1 Conv when c1 != c2, a learned position term (`linear`), then
    `num_layers` TransformerLayers (`tr.{i}`)."""

    def __init__(self, c1, c2, num_heads=4, num_layers=1, fused=False):
        super().__init__()
        self.conv = Conv(c1, c2, fused=fused) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(num_layers)))

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).permute(2, 0, 1)  # (h w, b, c), positions in row-major order as the NHWC reshape
        return self.tr(p + self.linear(p)).permute(1, 2, 0).reshape(b, c, h, w)


class MixConv2d(nn.Module):
    """Mixed-kernel-size conv groups (reference models/experimental.py:42-71):
    the channels split as the JAX module's linspace-floor (the remainder in the
    last groups), then a standalone BN over the concat and SiLU. There is no
    Conv+BN pair to fold: the fused form is this module as it is."""

    def __init__(self, c1, c2, k=(1, 3), s=1):
        super().__init__()
        n = len(k)
        lin = np.floor(np.linspace(0, n - 1e-6, c2))
        splits = [int((lin == g).sum()) for g in range(n)]
        self.m = nn.ModuleList(nn.Conv2d(c1, c, kk, s, kk // 2, bias=False) for c, kk in zip(splits, k))
        self.bn = BatchNorm2d(c2)

    def forward(self, x):
        return F.silu(self.bn(torch.cat([m(x) for m in self.m], 1)))


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


class Contract(nn.Module):
    """Space-to-depth, (b, c, h, w) -> (b, c g^2, h/g, w/g) (reference
    common.py:380-395); the channels in the JAX module's (gain_h, gain_w, c) order."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.gain
        x = x.reshape(b, c, h // g, g, w // g, g).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * g * g, h // g, w // g)


class Expand(nn.Module):
    """Depth-to-space, (b, c, h, w) -> (b, c/g^2, h g, w g) (reference
    common.py:398-413); reads the channels in the (gain_h, gain_w, c) order
    Contract writes."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.gain
        x = x.reshape(b, g, g, c // (g * g), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (g * g), h * g, w * g)


class Sum(nn.Module):
    """Sum of n feature maps, the i-th after the first weighted by
    2 sigmoid(w[i - 1]) when `weight` (reference models/experimental.py:15-39);
    `w` starts at -arange(1, n) / 2."""

    def __init__(self, n, weight=False):
        super().__init__()
        self.n = n
        self.w = nn.Parameter(-torch.arange(1.0, n) / 2.0) if weight else None

    def forward(self, xs):
        y = xs[0]
        w = None if self.w is None else torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else xs[i + 1] * w[i])
        return y


# spec op names -> modules, with the reference YAML spellings
MODULE_REGISTRY = {
    "Conv": Conv,
    "DWConv": DWConv,
    "DWConvTranspose2d": DWConvTranspose2d,
    "Bottleneck": Bottleneck,
    "BottleneckCSP": BottleneckCSP,
    "C3": C3,
    "C3x": C3x,
    "C3TR": C3TR,
    "C3SPP": C3SPP,
    "C3Ghost": C3Ghost,
    "CrossConv": CrossConv,
    "TransformerBlock": TransformerBlock,
    "MixConv2d": MixConv2d,
    "SPP": SPP,
    "SPPF": SPPF,
    "Focus": Focus,
    "GhostConv": GhostConv,
    "GhostBottleneck": GhostBottleneck,
    "MaxPool": MaxPool,
    "nn.MaxPool2d": MaxPool,
    "ZeroPad": ZeroPad,
    "nn.ZeroPad2d": ZeroPad,
    "Upsample": Upsample,
    "nn.Upsample": Upsample,
    "Concat": Concat,
    "Contract": Contract,
    "Expand": Expand,
    "Sum": Sum,
}

MULTI_INPUT_OPS = {"Concat", "Sum"}
# ops whose first spec arg is an output-channel count that the width multiple
# scales (yolov3_tpu/models/spec.py _CHANNEL_OPS)
CHANNEL_OPS = {
    "Conv", "DWConv", "Bottleneck", "GhostBottleneck", "SPP", "SPPF", "Focus",
    "GhostConv", "BottleneckCSP", "C3", "C3x", "C3TR", "C3SPP", "C3Ghost",
    "CrossConv", "MixConv2d", "TransformerBlock",
}  # fmt: skip
# ops that take the repeat count as their second constructor arg instead of being stacked
REPEAT_ARG_OPS = {"BottleneckCSP", "C3", "C3x", "C3TR", "C3SPP", "C3Ghost"}
# ops built as cls(c1, *args): the channel ops and DWConvTranspose2d, whose
# first arg is its (unscaled) output channel count
INPUT_CHANNEL_OPS = CHANNEL_OPS | {"DWConvTranspose2d"}

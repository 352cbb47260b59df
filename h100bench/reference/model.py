"""Plain PyTorch YOLOv3 and YOLOv5 forward, read from a configuration file's `model` block.

The layer graph of ultralytics' yolo.py (Conv = conv + BatchNorm + SiLU,
with its padding k // 2 unless the row gives one; Bottleneck, C3, MaxPool,
ZeroPad, Upsample, Concat, SPP, SPPF, Detect over any number of levels),
written as functions of a {name: tensor} dict keyed as the published state
dicts are (`model.{i}.conv.weight`, `model.{i}.{r}.cv1.bn.running_mean`,
`model.{i}.m.{r}.cv2.conv.weight`, `model.{last}.m.{k}.bias`, ...). A block
lists its rows under `layers`, or under `backbone` and `head` as the
published YOLOv5 YAMLs do (`nn.Upsample [None, 2, 'nearest']`, `Concat
[1]`). Nothing here imports the program under test: the benchmark hands
both sides the same seeded tensors, and this module computes the function
they define.

Precision (`precision=`): "f32" runs every convolution in float32, with
TF32 off for the duration (`strict_f32`); "bf16" casts each convolution's
input and weight to bfloat16; "fp8" is FP8 training's recipe: the input and
the weight rounded to float8 e4m3 and, in the backward, the output's
gradient to float8 e5m2, each under a per-tensor scale (its largest
magnitude over the format's largest value), the rounded values convolved in
float32. "bf16" and "fp8" are the lower precisions of the controls.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-3
FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # the formats' largest finite values


def make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


PUBLISHED_NAMES = {"nn.Upsample": "Upsample", "nn.MaxPool2d": "MaxPool", "nn.ZeroPad2d": "ZeroPad"}
WIDTH_OPS = ("Conv", "Bottleneck", "C3", "SPP", "SPPF")  # the ops whose first argument is their width


def rows(model_cfg):
    """(from, repeats, op, arguments) of each row of a `model` block."""
    table = model_cfg["layers"] if "layers" in model_cfg else model_cfg["backbone"] + model_cfg["head"]
    for f, n, op, args in table:
        yield f, n, PUBLISHED_NAMES.get(op, op), list(args)


def canonical(op, a, n):
    """A row's arguments with common.py's defaults filled in: Conv (c2, k, s, p),
    Bottleneck (c2, shortcut), C3 (c2, bottlenecks, shortcut), SPP (c2, ks),
    SPPF (c2, k), MaxPool (k, s, p), Upsample (scale, mode); `n` is the
    row's repeats after the depth gain, which C3 takes as its bottlenecks."""
    if op == "Conv":
        k = a[1] if len(a) > 1 else 1
        return (a[0], k, a[2] if len(a) > 2 else 1, a[3] if len(a) > 3 and a[3] is not None else k // 2)
    if op == "Bottleneck":
        return (a[0], a[1] if len(a) > 1 else True)
    if op == "C3":
        return (a[0], n, a[1] if len(a) > 1 else True)
    if op == "SPP":
        return (a[0], tuple(a[1]) if len(a) > 1 else (5, 9, 13))
    if op == "SPPF":
        return (a[0], a[1] if len(a) > 1 else 5)
    if op == "MaxPool":
        return (a[0], a[1] if len(a) > 1 else a[0], a[2] if len(a) > 2 else 0)
    if op == "Upsample":
        a = a[1:] if a and a[0] is None else a  # nn.Upsample(size=None, scale_factor, mode)
        return (int(a[0]) if a else 2, a[1] if len(a) > 1 else "nearest")
    return tuple(a)


class Net:
    """The resolved layer graph of a `model` block: per layer its inputs,
    repeats (1 for a C3, whose bottlenecks are its own), op, arguments
    (`canonical`), output channels and stride; the Detect inputs, anchors
    (pixels, (nl, na, 2)) and strides."""

    def __init__(self, model_cfg, ch=3):
        nc = model_cfg["nc"]
        gd, gw = model_cfg.get("depth_multiple", 1.0), model_cfg.get("width_multiple", 1.0)
        anchors = [list(map(float, a)) for a in model_cfg["anchors"]]
        self.nc, self.na, self.no = nc, len(anchors[0]) // 2, nc + 5
        chans, strides, self.layers, self.save = [ch], [1], [], set()
        for i, (f, n, op, args) in enumerate(rows(model_cfg)):
            fs = [f] if isinstance(f, int) else list(f)
            fs = tuple(x if x >= 0 else i + x for x in fs)
            n = max(round(n * gd), 1) if n > 1 else n
            c1, s = chans[fs[0] + 1], strides[fs[0] + 1]
            if op == "Detect":
                self.detect_from = fs
                self.save.update(fs)
                self.layers.append(dict(i=i, f=fs, n=1, op=op, args=(), c1=0, c2=0))
                continue
            if op in WIDTH_OPS:
                c2 = args[0] = make_divisible(args[0] * gw, 8)
            elif op == "Concat":
                c2 = sum(chans[x + 1] for x in fs)
            else:
                c2 = c1
            args = canonical(op, args, n)
            if op == "C3":
                n = 1
            if op in ("Conv", "MaxPool"):
                s *= args[2] if op == "Conv" else args[1]
            elif op == "Upsample":
                s //= args[0]
            self.save.update(x for x in fs if x != i - 1)
            self.layers.append(dict(i=i, f=fs, n=n, op=op, args=args, c1=c1, c2=c2))
            chans.append(c2)
            strides.append(s)
        self.chans = chans[1:]
        self.strides = tuple(strides[x + 1] for x in self.detect_from)
        self.anchors = torch.tensor(anchors, dtype=torch.float32).reshape(len(anchors), self.na, 2)
        self.nl = len(anchors)

    def param_shapes(self):
        """[(name, shape, kind)] in a fixed order. kind: conv (a conv weight
        followed by a BatchNorm), bn_w, bn_b, bn_mean, bn_var, bn_count,
        head_w, head_b."""
        out = []

        def conv(prefix, c1, c2, k):
            out.append((f"{prefix}.conv.weight", (c2, c1, k, k), "conv"))
            for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                               ("running_var", "bn_var")):
                out.append((f"{prefix}.bn.{leaf}", (c2,), kind))
            out.append((f"{prefix}.bn.num_batches_tracked", (), "bn_count"))

        def bottleneck(prefix, c1, c2, e=0.5):
            c_ = int(c2 * e)
            conv(f"{prefix}.cv1", c1, c_, 1)
            conv(f"{prefix}.cv2", c_, c2, 3)

        for ly in self.layers:
            i, op, a, c1, c2 = ly["i"], ly["op"], ly["args"], ly["c1"], ly["c2"]
            for r in range(ly["n"]):
                p = f"model.{i}" if ly["n"] == 1 else f"model.{i}.{r}"
                cin = c1 if r == 0 else c2
                if op == "Conv":
                    conv(p, cin, c2, a[1])
                elif op == "Bottleneck":
                    bottleneck(p, cin, c2)
                elif op == "C3":
                    c_ = int(c2 * 0.5)
                    conv(f"{p}.cv1", cin, c_, 1)
                    conv(f"{p}.cv2", cin, c_, 1)
                    conv(f"{p}.cv3", 2 * c_, c2, 1)
                    for b in range(a[1]):
                        bottleneck(f"{p}.m.{b}", c_, c_, e=1.0)
                elif op in ("SPP", "SPPF"):
                    conv(f"{p}.cv1", cin, cin // 2, 1)
                    conv(f"{p}.cv2", cin // 2 * (len(a[1]) + 1 if op == "SPP" else 4), c2, 1)
                elif op == "Detect":
                    for k, j in enumerate(self.detect_from):
                        out.append((f"{p}.m.{k}.weight", (self.na * self.no, self.chans[j], 1, 1), "head_w"))
                        out.append((f"{p}.m.{k}.bias", (self.na * self.no,), "head_b"))
        return out


@contextlib.contextmanager
def strict_f32():
    """float32 convolutions and matrix products without TF32, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8_round(t, fmt=torch.float8_e4m3fn):
    """t rounded to `fmt` under a per-tensor scale, returned in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8[fmt]
    return (t / scale).to(fmt).to(t.dtype) * scale


class FP8Conv(torch.autograd.Function):
    """A convolution of e4m3-rounded input and weight whose backward rounds
    the output's gradient to e5m2."""

    @staticmethod
    def forward(ctx, x, w, stride, pad):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.pad = stride, pad
        return F.conv2d(xq, wq, None, stride, pad)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride, ctx.pad)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride, ctx.pad)
        return gx, gw, None, None


def conv2d(x, w, b=None, stride=1, pad=0, precision="f32"):
    if precision == "bf16":
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None, stride, pad).float()
    elif precision == "fp8":
        y = FP8Conv.apply(x, w, stride, pad)
    else:
        y = F.conv2d(x, w, None, stride, pad)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def conv_bn_act(p, prefix, x, s, pad, train, precision, record=None):
    """Conv (no bias) -> BatchNorm (eps 1e-3; batch statistics, biased
    variance, in train mode; running statistics otherwise) -> SiLU. In train
    mode `record` (a dict) takes each BatchNorm's batch (mean, variance)."""
    y = conv2d(x, p[f"{prefix}.conv.weight"], None, s, pad, precision)
    g, b = p[f"{prefix}.bn.weight"], p[f"{prefix}.bn.bias"]
    if train:
        var, mean = torch.var_mean(y, (0, 2, 3), unbiased=False)
        if record is not None:
            record[prefix] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{prefix}.bn.running_mean"], p[f"{prefix}.bn.running_var"]
    scale = g / torch.sqrt(var + BN_EPS)
    y = y * scale.reshape(1, -1, 1, 1) + (b - mean * scale).reshape(1, -1, 1, 1)
    return F.silu(y)


def run_layer(p, net, ly, x, train, precision, record=None):
    op, a = ly["op"], ly["args"]
    if op == "Concat":
        return torch.cat(x, 1)

    def cba(prefix, x, k=1, s=1, pad=None):
        return conv_bn_act(p, prefix, x, s, k // 2 if pad is None else pad, train, precision, record)

    def bottleneck(prefix, x, shortcut):
        y = cba(f"{prefix}.cv2", cba(f"{prefix}.cv1", x), 3)
        return x + y if shortcut and x.shape[1] == y.shape[1] else y

    for r in range(ly["n"]):
        pre = f"model.{ly['i']}" if ly["n"] == 1 else f"model.{ly['i']}.{r}"
        if op == "Conv":
            x = cba(pre, x, a[1], a[2], a[3])
        elif op == "Bottleneck":
            x = bottleneck(pre, x, a[1])
        elif op == "C3":  # cv3(cat(m(cv1(x)), cv2(x)))
            y = cba(f"{pre}.cv1", x)
            for b in range(a[1]):
                y = bottleneck(f"{pre}.m.{b}", y, a[2])
            x = cba(f"{pre}.cv3", torch.cat([y, cba(f"{pre}.cv2", x)], 1))
        elif op == "SPP":
            x = cba(f"{pre}.cv1", x)
            x = cba(f"{pre}.cv2", torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in a[1]], 1))
        elif op == "SPPF":  # three chained stride-1 k-pools
            ys = [cba(f"{pre}.cv1", x)]
            for _ in range(3):
                ys.append(F.max_pool2d(ys[-1], a[1], 1, a[1] // 2))
            x = cba(f"{pre}.cv2", torch.cat(ys, 1))
        elif op == "MaxPool":
            x = F.max_pool2d(x, a[0], a[1], a[2])
        elif op == "ZeroPad":
            x = F.pad(x, tuple(a[0]))
        elif op == "Upsample":
            x = F.interpolate(x, scale_factor=a[0], mode=a[1])
        else:
            raise ValueError(f"reference: no op {op}")
    return x


def trunk(p, net, x, train=False, precision="f32", segments=False, record=None):
    """The Detect head's inputs, NCHW float32, for NHWC images x in [0, 1].
    segments=True checkpoints each layer (the backward recomputes it), so a
    train-mode batch keeps only the layers' outputs alive. `record`: see
    `conv_bn_act`."""
    out = x.float().permute(0, 3, 1, 2)
    saved = {}
    for ly in net.layers[:-1]:
        inp = [out if j == ly["i"] - 1 else saved[j] for j in ly["f"]] if ly["op"] == "Concat" else \
            (out if ly["f"][0] == ly["i"] - 1 else saved[ly["f"][0]])
        if segments and torch.is_grad_enabled():
            out = checkpoint(run_layer, p, net, ly, inp, train, precision, use_reentrant=False)
        else:
            out = run_layer(p, net, ly, inp, train, precision, record)
        if ly["i"] in net.save:
            saved[ly["i"]] = out
    last = net.layers[-2]["i"]
    return [out if j == last else saved[j] for j in net.detect_from]


def head(p, net, feats, precision="f32", weights=None):
    """Raw head maps (B, na, ny, nx, no) float32 per level from the trunk's
    outputs; `weights` overrides the head's (weight, bias) pairs."""
    det = net.layers[-1]["i"]
    outs = []
    for k, f in enumerate(feats):
        w, b = weights[k] if weights is not None else (p[f"model.{det}.m.{k}.weight"], p[f"model.{det}.m.{k}.bias"])
        y = conv2d(f, w, b, 1, 0, precision)
        bs, _, ny, nx = y.shape
        outs.append(y.reshape(bs, net.na, net.no, ny, nx).permute(0, 1, 3, 4, 2))
    return outs


def forward(p, net, x, train=False, precision="f32", segments=False):
    return head(p, net, trunk(p, net, x, train, precision, segments), precision)


def decode(feats, net, order="ayx"):
    """(B, N, 5 + nc) [cx, cy, w, h, obj, cls...] in pixels, sigmoid applied:
    xy = (2 sigmoid(t) - 0.5 + cell) * stride, wh = (2 sigmoid(t))^2 * anchor;
    level by level, each flattened anchor-major ("ayx": the published Detect's
    order) or cell-major ("yxa": the NHWC serving head's). Candidates of equal
    score are taken in this order, and a letterbox's uniform border makes
    such ties."""
    z = []
    for i, f in enumerate(feats):
        bs, na, ny, nx, no = f.shape
        s = torch.sigmoid(f.float())
        yv, xv = torch.meshgrid(torch.arange(ny, device=f.device), torch.arange(nx, device=f.device), indexing="ij")
        grid = torch.stack([xv, yv], -1).float().reshape(1, 1, ny, nx, 2)
        xy = (s[..., :2] * 2 - 0.5 + grid) * net.strides[i]
        wh = (s[..., 2:4] * 2) ** 2 * net.anchors[i].to(f.device).reshape(1, na, 1, 1, 2)
        d = torch.cat([xy, wh, s[..., 4:]], -1)
        if order == "yxa":
            d = d.permute(0, 2, 3, 1, 4)
        z.append(d.reshape(bs, -1, no))
    return torch.cat(z, 1)

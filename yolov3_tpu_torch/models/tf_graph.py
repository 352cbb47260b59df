"""A TensorFlow graph of a DetectionModel, written from its spec and its
folded weights: the part `jax2tf.convert(serve)` plays in the JAX package's
SavedModel and TFLite export (yolov3_tpu/export.py:123-143).

    module = serving_tf_module(model, imgsz=640, batch=None, include_nms=False)
    tf.saved_model.save(module, "yolov3_savedmodel")

`module.serve` takes uint8 NHWC (B, H, W, 3) images and returns the decoded
(B, N, 5 + nc) float32 predictions of `decode_predictions`, or with
`include_nms` the (out (B, max_det, 6), n (B,) int32) of the port's
`batched_nms` at the serving settings (conf 0.25, iou 0.45, max_det 300,
max_nms 8192). TensorFlow's native layout is NHWC, the JAX package's, so
the graph has no transposes but the head's.

The graph walks the spec's layers as `DetectionModel.forward` does and
writes each layer's module from its folded parameters, which the module
holds as variables: every op of the spec registry (nn/modules.py
MODULE_REGISTRY) with the silu, swish, hardswish, mish, relu, leakyrelu and
identity activations. Where the port computes the JAX function rather than
torch's, the graph does too: DWConvTranspose2d is flax's ConvTranspose and
TransformerLayer has no in-projection and no biases. Any other module (the
FReLU / ACON activation modules, which no spec names) raises
NotImplementedError naming its layer. A bfloat16 model writes a bfloat16
graph (TensorFlow's CPU kernels take bfloat16 convolutions); the head and
the decode run in float32, as the port's Detect does.

The NMS is the greedy loop of the port's plain `greedy_nms` in TF ops (a
while loop of argmax and IoU suppression, ties to the lowest index), after
`batched_nms`'s single-label candidate selection and its stable top-k: the
rows come out in the port's order with its class offset.
`tf.image.non_max_suppression` breaks ties its own way and is not used.

TensorFlow is imported by the functions that need it, never by this
module's import.
"""

from __future__ import annotations

import math

import numpy as np
import torch.nn as nn

from yolov3_tpu_torch.models.detect_head import Detect, make_grid
from yolov3_tpu_torch.nn import activations as acts
from yolov3_tpu_torch.nn.modules import MULTI_INPUT_OPS

MAX_WH = 7680  # the class offset of ops/nms.py


def serving_tf_module(model, imgsz=640, batch=None, include_nms=False, conf_thres=0.25, iou_thres=0.45,
                      max_det=300, max_nms=8192):
    """A `tf.Module` whose tf.function `serve` runs the model's serving
    function on uint8 (batch, imgsz, imgsz, 3) images; batch=None makes the
    batch dimension dynamic. The model is folded first if it is not."""
    import tensorflow as tf

    model = model.fuse().eval()
    writer = _Writer(tf, model)
    forward = writer.forward()
    dtype = writer.dtype

    def serve(imgs_u8):
        x = tf.cast(tf.cast(imgs_u8, tf.float32) / 255.0, dtype)
        pred = forward(x)
        if include_nms:
            return batched_nms(tf, pred, conf_thres, iou_thres, max_det, max_nms)
        return pred

    module = tf.Module()
    module.weights = writer.variables  # tracked: the SavedModel stores them as its variables
    module.serve = tf.function(serve, input_signature=[tf.TensorSpec((batch, imgsz, imgsz, 3), tf.uint8)],
                               autograph=False)
    return module


class _Writer:
    """Turns the folded model's modules into TF callables on NHWC tensors,
    holding each parameter as a tf.Variable in `variables`."""

    def __init__(self, tf, model):
        self.tf = tf
        self.model = model
        self.dtype = {"torch.float32": tf.float32, "torch.bfloat16": tf.bfloat16,
                      "torch.float16": tf.float16}[str(model.dtype)]
        self.variables = []

    def var(self, array):
        v = self.tf.Variable(self.tf.cast(np.asarray(array, np.float32), self.dtype), trainable=False)
        self.variables.append(v)
        return v

    def forward(self):
        spec, model = self.model.spec, self.model
        layers = []
        for ls, m in zip(spec.layers[:-1], model.model[:-1]):
            try:
                layers.append((ls, self.module(m)))
            except NotImplementedError as e:
                raise NotImplementedError(f"TF graph writer: layer {ls.i} ({ls.op}): {e}") from None
        detect = self.detect(model.model[-1], spec)

        def run(x):
            saved, prev, out = {}, -1, x
            for ls, fn in layers:
                if ls.op in MULTI_INPUT_OPS:
                    out = fn([out if j == prev else saved[j] for j in ls.f])
                else:
                    out = fn(out if ls.f[0] == prev else saved[ls.f[0]])
                prev = ls.i
                if ls.i in spec.save:
                    saved[ls.i] = out
            return detect([out if j == prev else saved[j] for j in spec.layers[-1].f])

        return run

    # -- modules ------------------------------------------------------------
    def module(self, m):
        fn = getattr(self, "_" + type(m).__name__, None)
        if fn is None:
            raise NotImplementedError(f"module {type(m).__name__} has no form in the TF graph")
        return fn(m)

    def _Sequential(self, m):
        fns = [self.module(c) for c in m]

        def run(x):
            for f in fns:
                x = f(x)
            return x

        return run

    def _Identity(self, m):
        return lambda x: x

    def _Conv(self, m):
        conv, act = self.conv2d(m.conv), self.activation(m.act)
        bn = self.batch_norm(m.bn) if m.bn is not None else (lambda x: x)
        return lambda x: act(bn(conv(x)))

    _DWConv = _Conv

    def _Bottleneck(self, m):
        cv1, cv2 = self._Conv(m.cv1), self._Conv(m.cv2)
        return (lambda x: x + cv2(cv1(x))) if m.add else (lambda x: cv2(cv1(x)))

    _CrossConv = _Bottleneck

    def _BottleneckCSP(self, m):
        tf = self.tf
        cv1, cv2, cv3, cv4 = self._Conv(m.cv1), self.conv2d(m.cv2), self.conv2d(m.cv3), self._Conv(m.cv4)
        bn, core = self.batch_norm(m.bn), self.module(m.m)
        return lambda x: cv4(tf.nn.silu(bn(tf.concat([cv3(core(cv1(x))), cv2(x)], -1))))

    def _C3(self, m):
        tf = self.tf
        cv1, cv2, cv3, core = self._Conv(m.cv1), self._Conv(m.cv2), self._Conv(m.cv3), self.module(m.m)
        return lambda x: cv3(tf.concat([core(cv1(x)), cv2(x)], -1))

    _C3x = _C3TR = _C3SPP = _C3Ghost = _C3

    def _SPP(self, m):
        tf = self.tf
        cv1, cv2 = self._Conv(m.cv1), self._Conv(m.cv2)
        pools = [self.max_pool(k, 1, k // 2) for k in m.k]

        def run(x):
            x = cv1(x)
            return cv2(tf.concat([x] + [p(x) for p in pools], -1))

        return run

    def _SPPF(self, m):
        tf = self.tf
        cv1, cv2, pool = self._Conv(m.cv1), self._Conv(m.cv2), self.max_pool(m.k, 1, m.k // 2)

        def run(x):
            ys = [cv1(x)]
            for _ in range(3):
                ys.append(pool(ys[-1]))
            return cv2(tf.concat(ys, -1))

        return run

    def _Focus(self, m):
        tf, conv = self.tf, self._Conv(m.conv)
        # the phases over (H, W): [::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2]
        return lambda x: conv(tf.concat([x[:, ::2, ::2], x[:, 1::2, ::2], x[:, ::2, 1::2], x[:, 1::2, 1::2]], -1))

    def _GhostConv(self, m):
        tf, cv1, cv2 = self.tf, self._Conv(m.cv1), self._Conv(m.cv2)

        def run(x):
            y = cv1(x)
            return tf.concat([y, cv2(y)], -1)

        return run

    def _GhostBottleneck(self, m):
        conv = self._Sequential(m.conv)
        if m.shortcut is not None:
            short = self._Sequential(m.shortcut)
        else:
            short = self._Conv(m.sc) if m.sc is not None else (lambda x: x)
        return lambda x: conv(x) + short(x)

    def _MaxPool(self, m):
        return self.max_pool(m.k, m.s, m.p)

    def _ZeroPad(self, m):
        left, right, top, bottom = m.pad
        return lambda x: self.tf.pad(x, [[0, 0], [top, bottom], [left, right], [0, 0]])

    def _Upsample(self, m):
        tf, s = self.tf, m.scale

        def run(x):
            h, w = x.shape[1], x.shape[2]
            # nearest at an integer scale s: source pixel floor((dst + 0.5) / s) = floor(dst / s), torch's
            return tf.image.resize(x, [h * s, w * s], method="nearest")

        return run

    def _Concat(self, m):
        return lambda xs: self.tf.concat(xs, -1)

    def _Contract(self, m):
        tf, g = self.tf, m.gain

        def run(x):  # channels in (gain_h, gain_w, c) order
            _, h, w, c = x.shape
            y = tf.reshape(x, [-1, h // g, g, w // g, g, c])
            return tf.reshape(tf.transpose(y, [0, 1, 3, 2, 4, 5]), [-1, h // g, w // g, c * g * g])

        return run

    def _Expand(self, m):
        tf, g = self.tf, m.gain

        def run(x):  # reads the (gain_h, gain_w, c) order Contract writes
            _, h, w, c = x.shape
            y = tf.reshape(x, [-1, h, w, g, g, c // (g * g)])
            return tf.reshape(tf.transpose(y, [0, 1, 3, 2, 4, 5]), [-1, h * g, w * g, c // (g * g)])

        return run

    def _Sum(self, m):
        tf = self.tf
        w = None if m.w is None else self.var(m.w.detach().float().cpu().numpy())

        def run(xs):
            y = xs[0]
            ws = None if w is None else tf.sigmoid(w) * 2
            for i in range(m.n - 1):
                y = y + (xs[i + 1] if ws is None else xs[i + 1] * ws[i])
            return y

        return run

    def _MixConv2d(self, m):
        tf = self.tf
        convs, bn = [self.conv2d(c) for c in m.m], self.batch_norm(m.bn)
        return lambda x: tf.nn.silu(bn(tf.concat([c(x) for c in convs], -1)))

    def _DWConvTranspose2d(self, m):
        """flax ConvTranspose (the JAX module's function): the input dilated by
        the stride, padded by p1 on both sides, correlated with the kernel,
        then p2 zero rows and columns bottom and right. The port's `weight` is
        torch's transposed-conv kernel, which holds that kernel flipped."""
        tf = self.tf
        k, s = m.kernel_size[0], m.stride[0]
        p1, p2, g = k - 1 - m.padding[0], m.p2, m.groups
        w = m.weight.detach().float().cpu().numpy()  # (c1, c2 / g, k, k)
        c1, cg = w.shape[0], w.shape[1]
        kern = w.reshape(g, c1 // g, cg, k, k)[..., ::-1, ::-1]  # (g, cin_g, cout_g, kh, kw), unflipped
        kern = kern.transpose(3, 4, 1, 0, 2).reshape(k, k, c1 // g, g * cg)  # HWIO, out = group * cout_g + j
        conv = self._conv(kern, m.bias.detach().float().cpu().numpy(), (1, 1), (p1, p1), (1, 1), g)

        def run(x):
            if s > 1:
                _, h, wd, c = x.shape
                z = tf.pad(x[:, :, None, :, None, :], [[0, 0], [0, 0], [0, s - 1], [0, 0], [0, s - 1], [0, 0]])
                x = tf.reshape(z, [-1, h * s, wd * s, c])[:, : (h - 1) * s + 1, : (wd - 1) * s + 1]
            y = conv(x)
            return tf.pad(y, [[0, 0], [0, p2], [0, p2], [0, 0]]) if p2 else y

        return run

    def _TransformerBlock(self, m):
        tf = self.tf
        conv = self._Conv(m.conv) if m.conv is not None else (lambda x: x)
        linear, layers = self.linear(m.linear), [self._TransformerLayer(t) for t in m.tr]

        def run(x):
            x = conv(x)
            _, h, w, c = x.shape
            p = tf.reshape(x, [-1, h * w, c])  # (b, positions, c), positions in row-major order
            p = p + linear(p)
            for layer in layers:
                p = layer(p)
            return tf.reshape(p, [-1, h, w, c])

        return run

    def _TransformerLayer(self, m):
        tf = self.tf
        q, k, v, proj, fc1, fc2 = (self.linear(getattr(m, n)) for n in ("q", "k", "v", "proj", "fc1", "fc2"))
        nh = m.num_heads

        def run(x):  # x: (b, seq, c); attention per image over its positions
            _, s, c = x.shape
            hd = c // nh

            def heads(t):
                return tf.transpose(tf.reshape(t, [-1, s, nh, hd]), [0, 2, 1, 3])

            scores = tf.matmul(heads(q(x)), heads(k(x)), transpose_b=True)
            wide = tf.float64 if scores.dtype == tf.float64 else tf.float32
            att = tf.cast(tf.nn.softmax(tf.cast(scores, wide) / math.sqrt(hd), -1), x.dtype)
            o = tf.reshape(tf.transpose(tf.matmul(att, heads(v(x))), [0, 2, 1, 3]), [-1, s, c])
            x = proj(o) + x
            return fc2(fc1(x)) + x

        return run

    # -- pieces -------------------------------------------------------------
    def conv2d(self, c):
        """An nn.Conv2d (OIHW weight, symmetric zero padding) on NHWC."""
        if c.padding_mode != "zeros" or isinstance(c.padding, str):
            raise NotImplementedError(f"conv padding {c.padding!r} / {c.padding_mode}")
        kern = c.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
        bias = None if c.bias is None else c.bias.detach().float().cpu().numpy()
        return self._conv(kern, bias, c.stride, c.padding, c.dilation, c.groups)

    def _conv(self, kern, bias, stride, padding, dilation, groups):
        tf = self.tf
        kh, kw, cin_g, cout = kern.shape
        cin = cin_g * groups
        depthwise = groups == cin > 1 and stride[0] == stride[1] and dilation[0] == dilation[1]
        if depthwise:  # (kh, kw, cin, multiplier): output channel c * mult + j, torch's group order
            kern = kern.reshape(kh, kw, cin, cout // cin)
        k = self.var(kern)
        b = None if bias is None else self.var(bias)
        ph, pw = padding
        pads = [[0, 0], [ph, ph], [pw, pw], [0, 0]]

        def run(x):
            if ph or pw:
                x = tf.pad(x, pads)
            if depthwise:
                y = tf.nn.depthwise_conv2d(x, k, [1, stride[0], stride[1], 1], "VALID",
                                           dilations=list(dilation))
            else:
                y = tf.nn.conv2d(x, k, [1, *stride, 1], "VALID", dilations=[1, *dilation, 1])
            return y if b is None else y + b

        return run

    def batch_norm(self, bn):
        """Eval-mode BatchNorm as its per-channel affine (running statistics)."""
        var = bn.running_var.detach().double().cpu().numpy()
        scale = bn.weight.detach().double().cpu().numpy() / np.sqrt(var + bn.eps)
        shift = bn.bias.detach().double().cpu().numpy() - bn.running_mean.detach().double().cpu().numpy() * scale
        s, t = self.var(scale), self.var(shift)
        return lambda x: x * s + t

    def linear(self, lin):
        tf = self.tf
        w = self.var(lin.weight.detach().float().cpu().numpy().T)  # (in, out)
        b = None if lin.bias is None else self.var(lin.bias.detach().float().cpu().numpy())

        def run(x):
            shape = tf.shape(x)
            y = tf.reshape(tf.matmul(tf.reshape(x, [-1, x.shape[-1]]), w), tf.concat([shape[:-1], [w.shape[1]]], 0))
            return y if b is None else y + b

        return run

    def max_pool(self, k, s, p):
        """torch's max_pool2d (padding counts as -inf, floor mode)."""
        tf = self.tf
        if p == 0:
            return lambda x: tf.nn.max_pool2d(x, k, s, "VALID")
        if s == 1 and k % 2 == 1 and p == k // 2:  # SAME pads (k - 1) / 2 a side and ignores the pad
            return lambda x: tf.nn.max_pool2d(x, k, 1, "SAME")

        def run(x):
            low = x.dtype.min
            return tf.nn.max_pool2d(tf.pad(x, [[0, 0], [p, p], [p, p], [0, 0]], constant_values=low), k, s, "VALID")

        return run

    def activation(self, act):
        tf = self.tf
        if isinstance(act, nn.Module):
            raise NotImplementedError(f"activation module {type(act).__name__} has no form in the TF graph")
        table = {
            acts.silu: tf.nn.silu,
            acts.relu: tf.nn.relu,
            acts.leaky_relu: lambda x: tf.nn.leaky_relu(x, alpha=0.1),
            acts.identity: lambda x: x,
            acts.hardswish: lambda x: x * tf.clip_by_value(x + 3.0, 0.0, 6.0) / 6.0,
            acts.mish: lambda x: x * tf.tanh(tf.nn.softplus(x)),
        }
        if act not in table:
            raise NotImplementedError(f"activation {getattr(act, '__name__', act)!r} has no form in the TF graph")
        return table[act]

    def detect(self, m: Detect, spec):
        """The head's 1x1 convs and `decode_predictions` in float32."""
        tf = self.tf
        convs = [self.conv2d(c) for c in m.m]
        na, no = m.na, m.no
        anchors = np.asarray(spec.anchors, np.float32).reshape(spec.nl, na, 2)

        def run(feats):
            z = []
            for i, (conv, f) in enumerate(zip(convs, feats)):
                y = tf.cast(conv(f), tf.float32)
                _, ny, nx, _ = y.shape
                y = tf.transpose(tf.reshape(y, [-1, ny, nx, na, no]), [0, 3, 1, 2, 4])  # (b, na, ny, nx, no)
                sig = tf.sigmoid(y)
                grid = tf.constant(make_grid(ny, nx).numpy())
                xy = (sig[..., :2] * 2 + grid) * float(m.strides[i])
                wh = tf.square(sig[..., 2:4] * 2) * tf.constant(anchors[i].reshape(1, na, 1, 1, 2))
                z.append(tf.reshape(tf.concat([xy, wh, sig[..., 4:]], -1), [-1, na * ny * nx, no]))
            return tf.concat(z, 1)

        return run


def batched_nms(tf, pred, conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=8192):
    """ops/nms.batched_nms (single label, class offset) in TF ops: (out
    (B, max_det, 6) [x1, y1, x2, y2, conf, cls] zero past the last row,
    n (B,) int32)."""
    xy, wh = pred[..., :2], pred[..., 2:4]
    box = tf.concat([xy - wh / 2, xy + wh / 2], -1)
    obj = pred[..., 4]
    cls_scores = pred[..., 5:] * obj[..., None]
    scores = tf.reduce_max(cls_scores, -1)
    cls_ids = tf.cast(tf.argmax(cls_scores, -1), tf.float32)
    masked = tf.where((scores > conf_thres) & (obj > conf_thres), scores, -1.0)
    k = min(int(max_nms), pred.shape[1])
    top_s, top_i = tf.math.top_k(masked, k)  # ties: the lower index first, as the port's stable sort
    top_box = tf.gather(box, top_i, batch_dims=1)
    top_cls = tf.gather(cls_ids, top_i, batch_dims=1)
    return greedy_nms(tf, top_box + top_cls[..., None] * MAX_WH, top_box, top_s, top_cls, iou_thres, max_det)


def greedy_nms(tf, boxes_off, boxes, scores, cls_ids, iou_thres=0.45, max_det=300):
    """ops/nms_cuda.greedy_nms_plain in TF ops: up to max_det steps of argmax
    (the lowest index of the max) and suppression of the boxes whose IoU with
    it (class-offset geometry) exceeds iou_thres; stops when no score > 0 is
    left."""
    steps = min(int(max_det), scores.shape[1])
    x1, y1, x2, y2 = tf.unstack(boxes_off, axis=-1)
    area = (x2 - x1) * (y2 - y1)

    def cond(t, s, out):
        return (t < steps) & tf.reduce_any(tf.reduce_max(s, 1) > 0.0)

    def body(t, s, out):
        i = tf.argmax(s, 1, output_type=tf.int32)
        smax = tf.gather(s, i, batch_dims=1)
        valid = smax > 0.0
        sel = tf.gather(boxes_off, i, batch_dims=1)
        row = tf.concat([tf.gather(boxes, i, batch_dims=1), smax[:, None], tf.gather(cls_ids, i, batch_dims=1)[:, None]],
                        1)
        out = tf.where((tf.range(max_det) == t)[None, :, None], tf.where(valid[:, None], row, 0.0)[:, None, :], out)
        lt = tf.maximum(sel[:, None, :2], boxes_off[..., :2])
        rb = tf.minimum(sel[:, None, 2:4], boxes_off[..., 2:4])
        wh = tf.maximum(rb - lt, 0.0)
        inter = wh[..., 0] * wh[..., 1]
        sarea = (sel[:, 2] - sel[:, 0]) * (sel[:, 3] - sel[:, 1])
        iou = inter / (sarea[:, None] + area - inter + 1e-7)
        s = tf.where((iou > iou_thres) & valid[:, None], -1.0, s)
        s = tf.where(tf.range(tf.shape(s)[1])[None, :] == i[:, None], -1.0, s)
        return t + 1, s, out

    out = tf.zeros(tf.stack([tf.shape(scores)[0], max_det, 6]))
    _, _, out = tf.while_loop(cond, body, (tf.constant(0), scores, out), maximum_iterations=steps)
    return out, tf.reduce_sum(tf.cast(out[..., 4] > 0.0, tf.int32), 1)

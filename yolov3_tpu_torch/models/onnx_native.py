"""ONNX export without the `onnx` package: ModelSpec + fused state dict ->
ONNX protobuf bytes (yolov3_tpu/models/onnx_native.py).

The wire format is written directly; the encoders below mirror the public
onnx.proto schema (IR version 7, opset 12), field numbers annotated inline.
The graph is NCHW (ONNX Conv's layout) with the full Detect decode baked in,
the reference's artifact contract (reference export.py:196-264): input
"images" float32 (N, 3, H, W), already /255-normalised, output "output"
(N, sum(na*ny*nx), nc+5), e.g. (1, 25200, 85) for yolov3@640.

For the same variables the bytes list the same nodes, in the same order,
with the same names and attributes, as the JAX writer's; the initializers
are the port's fused float32 weights (a bf16 model's are widened).

Supported ops: Conv, Bottleneck, SPP, SPPF, MaxPool, ZeroPad, Upsample,
Concat, Focus and Detect with silu / leakyrelu / relu / identity
activations. Any other op raises, naming the layer, as the JAX writer does.
models/onnx_runtime.py reads and runs the bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from yolov3_tpu_torch.models.detect_head import make_grid

# TensorProto.DataType values (onnx.proto)
F32, I64 = 1, 7

# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # proto int64: negative encodes as 10-byte two's complement
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int(field: int, n: int) -> bytes:  # varint scalar
    return _tag(field, 0) + _varint(int(n))


def _f32(field: int, f: float) -> bytes:  # fixed32 scalar
    return _tag(field, 5) + struct.pack("<f", float(f))


def _bytes(field: int, payload: bytes) -> bytes:  # length-delimited
    return _tag(field, 2) + _varint(len(payload)) + payload


def _string(field: int, s: str) -> bytes:
    return _bytes(field, s.encode("utf-8"))


def _packed_i64(field: int, vals) -> bytes:
    return _bytes(field, b"".join(_varint(int(v)) for v in vals))


# ---------------------------------------------------------------------------
# ONNX message encoders (field numbers per the public onnx.proto)
# ---------------------------------------------------------------------------


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int64:
        dt = I64
    else:
        arr = arr.astype(np.float32)
        dt = F32
    out = _packed_i64(1, arr.shape) if arr.ndim else b""
    out += _int(2, dt)
    out += _string(8, name)
    out += _bytes(9, arr.tobytes())
    return out


def _attr(name: str, v) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, floats=7, ints=8, type=20."""
    out = _string(1, name)
    if isinstance(v, (bool, int, np.integer)):
        out += _int(3, int(v)) + _int(20, 2)  # INT
    elif isinstance(v, float):
        out += _f32(2, v) + _int(20, 1)  # FLOAT
    elif isinstance(v, str):
        out += _bytes(4, v.encode("utf-8")) + _int(20, 3)  # STRING
    elif isinstance(v, (list, tuple)) and all(isinstance(x, (int, np.integer)) for x in v):
        out += _packed_i64(8, v) + _int(20, 7)  # INTS
    elif isinstance(v, (list, tuple)):
        out += b"".join(_f32(7, float(x)) for x in v) + _int(20, 6)  # FLOATS
    else:
        raise TypeError(f"unsupported attribute {name}={v!r}")
    return out


def node_proto(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_string(1, i) for i in inputs)
    out += b"".join(_string(2, o) for o in outputs)
    out += _string(3, name or outputs[0])
    out += _string(4, op_type)
    out += b"".join(_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return out


def value_info(name: str, shape, elem_type: int = F32) -> bytes:
    """ValueInfoProto{name=1, type=2} / TypeProto{tensor_type=1} /
    Tensor{elem_type=1, shape=2} / TensorShapeProto{dim=1} /
    Dimension{dim_value=1 | dim_param=2}."""
    dims = b""
    for d in shape:
        dims += _bytes(1, _string(2, d) if isinstance(d, str) else _int(1, int(d)))
    tensor = _int(1, elem_type) + _bytes(2, dims)
    return _string(1, name) + _bytes(2, _bytes(1, tensor))


def model_proto(graph: bytes, opset: int = 12, producer: str = "yolov3_tpu_torch") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    graph=7, opset_import=8 (OperatorSetIdProto: domain=1, version=2)."""
    out = _int(1, 7)  # IR version 7 <-> opset 12
    out += _string(2, producer)
    out += _string(3, "1.0")
    out += _bytes(7, graph)
    out += _bytes(8, _string(1, "") + _int(2, opset))
    return out


# ---------------------------------------------------------------------------
# graph builder
# ---------------------------------------------------------------------------


class _Graph:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, hint: str, arr) -> str:
        n = self.name(hint)
        self.inits.append(tensor_proto(n, np.asarray(arr)))
        return n

    def add(self, op: str, inputs, hint: str = None, **attrs) -> str:
        out = self.name(hint or op.lower())
        self.nodes.append(node_proto(op, inputs, [out], **attrs))
        return out

    def add_named(self, op: str, inputs, out_name: str, **attrs):
        self.nodes.append(node_proto(op, inputs, [out_name], **attrs))
        return out_name


def _act_name(spec):
    a = spec.activation
    if not a:
        return "silu"
    return str(a).lower().replace("_", "").replace("nn.", "").replace("()", "")


def _emit_act(g: _Graph, x: str, act: str) -> str:
    if act in ("identity", "none", "false"):
        return x
    if act in ("silu", "swish"):
        s = g.add("Sigmoid", [x])
        return g.add("Mul", [x, s], "silu")
    if act == "leakyrelu":
        return g.add("LeakyRelu", [x], alpha=0.1)
    if act == "relu":
        return g.add("Relu", [x])
    raise NotImplementedError(f"ONNX emitter: activation '{act}' not supported")


def _autopad(k: int, p=None) -> int:
    return k // 2 if p is None else int(p)


def _emit_conv(g: _Graph, x: str, p: dict, k: int, s: int, pad=None, groups: int = 1,
               act: str = "silu") -> str:
    """Fused Conv = conv + bias (+ activation). p = {"conv": {"weight", "bias"}}, weight OIHW."""
    w, b = p["conv"]["weight"], p["conv"]["bias"]
    pp = _autopad(k, pad)
    y = g.add("Conv", [x, g.const("w", w), g.const("b", b)], "conv", strides=[s, s], pads=[pp, pp, pp, pp],
              group=groups, dilations=[1, 1], kernel_shape=[w.shape[2], w.shape[3]])
    return _emit_act(g, y, act)


def _emit_bottleneck(g: _Graph, x: str, p: dict, c1: int, c2: int, shortcut: bool, groups: int, act: str) -> str:
    y = _emit_conv(g, x, p["cv1"], 1, 1, act=act)
    y = _emit_conv(g, y, p["cv2"], 3, 1, groups=groups, act=act)
    if shortcut and c1 == c2:
        return g.add("Add", [x, y], "residual")
    return y


def _emit_maxpool(g: _Graph, x: str, k: int, s: int, p: int) -> str:
    return g.add("MaxPool", [x], kernel_shape=[k, k], strides=[s, s], pads=[p, p, p, p])


def _emit_spp(g: _Graph, x: str, p: dict, ks, act: str) -> str:
    y = _emit_conv(g, x, p["cv1"], 1, 1, act=act)
    pools = [_emit_maxpool(g, y, k, 1, k // 2) for k in ks]
    cat = g.add("Concat", [y, *pools], axis=1)
    return _emit_conv(g, cat, p["cv2"], 1, 1, act=act)


def _emit_sppf(g: _Graph, x: str, p: dict, k: int, act: str) -> str:
    y = _emit_conv(g, x, p["cv1"], 1, 1, act=act)
    y1 = _emit_maxpool(g, y, k, 1, k // 2)
    y2 = _emit_maxpool(g, y1, k, 1, k // 2)
    y3 = _emit_maxpool(g, y2, k, 1, k // 2)
    cat = g.add("Concat", [y, y1, y2, y3], axis=1)
    return _emit_conv(g, cat, p["cv2"], 1, 1, act=act)


def _emit_upsample(g: _Graph, x: str, scale: int) -> str:
    scales = g.const("scales", np.array([1, 1, scale, scale], np.float32))
    roi = g.const("roi", np.zeros((0,), np.float32))
    return g.add("Resize", [x, roi, scales], "upsample", mode="nearest",
                 coordinate_transformation_mode="asymmetric", nearest_mode="floor")


def _emit_zeropad(g: _Graph, x: str, pad) -> str:
    l, r, t, b = pad
    pads = g.const("pads", np.array([0, 0, t, l, 0, 0, b, r], np.int64))
    return g.add("Pad", [x, pads], mode="constant")


def _emit_focus(g: _Graph, x: str, p: dict, k: int, s: int, act: str) -> str:
    # (b, c, h, w) -> the 4 stride-2 phase slices concatenated on channels, then Conv
    parts = []
    for a in (0, 1):
        for b in (0, 1):
            st = g.const("st", np.array([a, b], np.int64))
            en = g.const("en", np.array([2**31 - 1, 2**31 - 1], np.int64))
            ax = g.const("ax", np.array([2, 3], np.int64))
            sp = g.const("sp", np.array([2, 2], np.int64))
            parts.append(g.add("Slice", [x, st, en, ax, sp], "phase"))
    # Focus concatenates [::2,::2], [1::2,::2], [::2,1::2], [1::2,1::2] over (H, W)
    cat = g.add("Concat", [parts[0], parts[2], parts[1], parts[3]], axis=1)
    return _emit_conv(g, cat, p["conv"], k, s, act=act)


def _slice_last(g: _Graph, x: str, lo: int, hi: int) -> str:
    st = g.const("st", np.array([lo], np.int64))
    en = g.const("en", np.array([hi], np.int64))
    ax = g.const("ax", np.array([4], np.int64))
    return g.add("Slice", [x, st, en, ax])


def _emit_detect(g: _Graph, feats, spec, params, imgsz: int) -> str:
    """Full decode (reference yolo.py:104-110): per scale
    xy = (sig*2 + grid)*stride, wh = (sig*2)^2*anchor, rest = sig."""
    no, na = spec.nc + 5, spec.na
    anchors = np.asarray(spec.anchors, np.float32).reshape(spec.nl, na, 2)
    zs = []
    for i, f in enumerate(feats):
        stride = int(spec.strides[i])
        ny = nx = imgsz // stride
        p = params["m"][str(i)]
        y = g.add("Conv", [f, g.const("w", p["weight"]), g.const("b", p["bias"])], "head",
                  strides=[1, 1], pads=[0, 0, 0, 0], group=1, dilations=[1, 1], kernel_shape=[1, 1])
        shp = g.const("shape", np.array([0, na, no, ny, nx], np.int64))
        y = g.add("Reshape", [y, shp])
        y = g.add("Transpose", [y], perm=[0, 1, 3, 4, 2])  # (N, na, ny, nx, no)
        sig = g.add("Sigmoid", [y])
        two = g.const("two", np.array([2.0], np.float32))
        grid = g.const("grid", make_grid(ny, nx).numpy())  # (1, 1, ny, nx, 2), -0.5 baked
        sxy = _slice_last(g, sig, 0, 2)
        xy = g.add("Mul", [sxy, two])
        xy = g.add("Add", [xy, grid])
        xy = g.add("Mul", [xy, g.const("stride", np.array([float(stride)], np.float32))])
        swh = _slice_last(g, sig, 2, 4)
        wh = g.add("Mul", [swh, two])
        wh = g.add("Mul", [wh, wh])
        wh = g.add("Mul", [wh, g.const("anchor", anchors[i].reshape(1, na, 1, 1, 2))])
        rest = _slice_last(g, sig, 4, no)
        cat = g.add("Concat", [xy, wh, rest], axis=4)
        flat = g.const("flat", np.array([0, na * ny * nx, no], np.int64))
        zs.append(g.add("Reshape", [cat, flat]))
    return g.add_named("Concat", zs, "output", axis=1)


def _param_tree(state_dict):
    """`model.{i}[.{r}].<path>` float32 numpy leaves as nested dicts keyed by layer index."""
    tree = {}
    for k, v in state_dict.items():
        node = tree
        *path, leaf = k.split(".")[1:]  # drop the leading "model"
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().float().cpu().numpy()
    return tree


def export_onnx_bytes(model, imgsz: int = 640, batch: int = 1, dynamic: bool = False) -> bytes:
    """The ONNX ModelProto of a DetectionModel (folded first if it is not).
    `dynamic` makes the batch dim symbolic ("batch"), like the reference's
    --dynamic (export.py:205-217); H and W stay static (the decode grids are
    baked per shape)."""
    model = model.fuse()
    spec = model.spec
    params = _param_tree(model.state_dict())
    act = _act_name(spec)
    g = _Graph()

    N = "batch" if dynamic else int(batch)
    names = {}  # layer index -> output tensor name
    ch = {-1: spec.ch_in}

    def emit_layer(ls, x, p):
        a = ls.args
        if ls.op == "Conv":
            return _emit_conv(g, x, p, a[1] if len(a) > 1 else 1, a[2] if len(a) > 2 else 1,
                              a[3] if len(a) > 3 else None, int(a[4]) if len(a) > 4 else 1, act)
        if ls.op == "Bottleneck":
            return _emit_bottleneck(g, x, p, ch[ls.f[0]], ls.c2, bool(a[1]) if len(a) > 1 else True,
                                    int(a[2]) if len(a) > 2 else 1, act)
        if ls.op == "SPP":
            return _emit_spp(g, x, p, tuple(a[1]) if len(a) > 1 else (5, 9, 13), act)
        if ls.op == "SPPF":
            return _emit_sppf(g, x, p, int(a[1]) if len(a) > 1 else 5, act)
        if ls.op == "MaxPool":
            return _emit_maxpool(g, x, int(a[0]), int(a[1]) if len(a) > 1 else int(a[0]),
                                 int(a[2]) if len(a) > 2 else 0)
        if ls.op == "ZeroPad":
            return _emit_zeropad(g, x, tuple(a[0]))
        if ls.op == "Upsample":
            return _emit_upsample(g, x, int(a[0]))
        if ls.op == "Focus":
            return _emit_focus(g, x, p, a[1] if len(a) > 1 else 1, a[2] if len(a) > 2 else 1, act)
        raise NotImplementedError(f"ONNX emitter: op '{ls.op}' (layer {ls.i}) not supported; "
                                  "export a checkpoint or pt2 for this architecture")

    prev, prev_i = "images", -1
    for ls in spec.layers[:-1]:
        if ls.op == "Concat":
            x = g.add("Concat", [prev if j == prev_i else names[j] for j in ls.f], axis=1)
        else:
            x = prev if ls.f[0] == prev_i else names[ls.f[0]]
            p = params.get(str(ls.i), {})
            if ls.n == 1:
                x = emit_layer(ls, x, p)
            else:
                for r in range(ls.n):
                    x = emit_layer(ls, x, p[str(r)])
        prev, prev_i = x, ls.i
        ch[ls.i] = ls.c2
        if ls.i in spec.save:
            names[ls.i] = x

    det = spec.layers[-1]
    feats = [prev if j == prev_i else names[j] for j in det.f]
    out = _emit_detect(g, feats, spec, params[str(det.i)], imgsz)

    total = sum(spec.na * (imgsz // s) ** 2 for s in spec.strides)
    gb = b"".join(_bytes(1, n) for n in g.nodes)
    gb += _string(2, spec.name)
    gb += b"".join(_bytes(5, t) for t in g.inits)
    gb += _bytes(11, value_info("images", [N, spec.ch_in, imgsz, imgsz]))
    gb += _bytes(12, value_info(out, [N, total, spec.no]))
    return model_proto(gb, opset=12)

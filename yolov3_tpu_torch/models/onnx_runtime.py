"""In-tree ONNX runtime: a protobuf wire parser (numpy) and an executor that
runs the graph's nodes as torch functions on one device
(yolov3_tpu/models/onnx_runtime.py).

Neither machine has onnxruntime or the onnx package, so `.onnx` artifacts
(the port's from models/onnx_native.py, the JAX package's, or third-party
files with the same op subset) run here. The parser is the JAX package's,
field numbers per the public onnx.proto. The executor computes each op as
the JAX numpy executor does, but on an explicit device (the card unless the
caller asks for the CPU), so an artifact serves at 640 px on the card.

Scope: graphs with a static H and W and a static or symbolic batch,
f32 / int64 tensors, ops Conv, MaxPool, Pad, Sigmoid, Mul, Add, Concat,
Reshape, Transpose, Slice, Resize (integer nearest), LeakyRelu, Relu.
Any other op raises, naming it.
"""

from __future__ import annotations

import importlib.util
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolov3_tpu_torch.utils.general import select_device

# ---------------------------------------------------------------------------
# protobuf wire parser
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int):
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return v, i


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value) over a message payload."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        f, w = key >> 3, key & 7
        if w == 0:
            v, i = _read_varint(buf, i)
        elif w == 1:
            v = buf[i : i + 8]
            i += 8
        elif w == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif w == 5:
            v = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {w}")
        yield f, w, v


def _repeated_i64(entries):
    """Repeated int64 field: packed (one bytes blob) or one per entry."""
    out = []
    for w, v in entries:
        if w == 0:
            out.append(_signed(v))
        else:  # packed
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(_signed(x))
    return out


@dataclass
class Tensor:
    name: str = ""
    dims: tuple = ()
    data_type: int = 1
    array: np.ndarray = None


@dataclass
class NodeT:
    op: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class GraphT:
    nodes: list = field(default_factory=list)
    inits: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)


_DT = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
       9: np.bool_, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    dim_entries, raw, f32s, i64s = [], None, None, None
    for f, w, v in _fields(buf):
        if f == 1:
            dim_entries.append((w, v))
        elif f == 2:
            t.data_type = v
        elif f == 4:
            # float_data: packed chunks (w=2) accumulate; an unpacked entry
            # (w=5) is already a raw 4-byte little-endian float
            f32s = (f32s or b"") + v
        elif f == 7:
            i64s = (i64s or []) + _repeated_i64([(w, v)])
        elif f == 8:
            t.name = v.decode("utf-8")
        elif f == 9:
            raw = v
    t.dims = tuple(_repeated_i64(dim_entries))
    dt = _DT.get(t.data_type, np.float32)
    if raw is not None:
        t.array = np.frombuffer(raw, dtype=dt).reshape(t.dims)
    elif f32s is not None:
        t.array = np.frombuffer(f32s, dtype=np.float32).reshape(t.dims)
    elif i64s is not None:
        t.array = np.asarray(i64s, np.int64).reshape(t.dims)
    else:
        t.array = np.zeros(t.dims, dt)
    return t


def _parse_attr(buf: bytes):
    name, val = "", None
    ints, floats = [], []
    for f, w, v in _fields(buf):
        if f == 1:
            name = v.decode("utf-8")
        elif f == 2:
            val = struct.unpack("<f", v)[0]
        elif f == 3:
            val = _signed(v)
        elif f == 4:
            val = v.decode("utf-8")
        elif f == 5:
            val = _parse_tensor(v).array
        elif f == 7:
            floats += ([struct.unpack("<f", v)[0]] if w == 5 else
                       [x[0] for x in struct.iter_unpack("<f", v)])
        elif f == 8:
            ints += _repeated_i64([(w, v)])
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _parse_node(buf: bytes) -> NodeT:
    n = NodeT()
    for f, w, v in _fields(buf):
        if f == 1:
            n.inputs.append(v.decode("utf-8"))
        elif f == 2:
            n.outputs.append(v.decode("utf-8"))
        elif f == 4:
            n.op = v.decode("utf-8")
        elif f == 5:
            k, val = _parse_attr(v)
            n.attrs[k] = val
    return n


def _vi_name(buf: bytes) -> str:
    for f, w, v in _fields(buf):
        if f == 1:
            return v.decode("utf-8")
    return ""


def parse_onnx(data: bytes) -> GraphT:
    """Parse ModelProto bytes -> GraphT (nodes in file order, initializers as numpy)."""
    graph_buf = None
    for f, w, v in _fields(data):
        if f == 7:
            graph_buf = v
    if graph_buf is None:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    g = GraphT()
    for f, w, v in _fields(graph_buf):
        if f == 1:
            g.nodes.append(_parse_node(v))
        elif f == 5:
            t = _parse_tensor(v)
            g.inits[t.name] = t.array
        elif f == 11:
            g.inputs.append(_vi_name(v))
        elif f == 12:
            g.outputs.append(_vi_name(v))
    return g


# ---------------------------------------------------------------------------
# torch executor
# ---------------------------------------------------------------------------


def _ints(v):
    """An int64 operand (an initializer, or a tensor a node computed) as a list of ints."""
    return [int(x) for x in (v.tolist() if isinstance(v, (np.ndarray, torch.Tensor)) else v)]


def _pad_nchw(x, pads, value=0.0):
    """ONNX 2-D pads [top, left, bottom, right] on an NCHW tensor."""
    pt, pl, pb, pr = pads
    return F.pad(x, (pl, pr, pt, pb), value=value) if any(pads) else x


def _conv2d(x, w, b, strides, pads, group, dilations):
    return F.conv2d(_pad_nchw(x, pads), w, b, stride=tuple(strides), dilation=tuple(dilations), groups=int(group))


def _maxpool(x, k, s, pads):
    return F.max_pool2d(_pad_nchw(x, pads, -float("inf")), tuple(k), tuple(s))


def _resize_nearest(x, scales):
    scales = [float(v) for v in scales.tolist()]
    if scales[:2] != [1.0, 1.0] or any(v != int(v) for v in scales[2:]):
        raise NotImplementedError(f"ONNX executor: Resize scales {scales} (integer nearest upsample only)")
    return x.repeat_interleave(int(scales[2]), 2).repeat_interleave(int(scales[3]), 3)


def _slice(x, starts, ends, axes=None, steps=None):
    starts, ends = _ints(starts), _ints(ends)
    axes = _ints(axes) if axes is not None else list(range(len(starts)))
    steps = _ints(steps) if steps is not None else [1] * len(starts)
    idx = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        en = min(en, x.shape[ax]) if en >= 0 else en
        idx[ax] = slice(st, en, sp)
    return x[tuple(idx)]


def _reshape(x, shape):
    return x.reshape([x.shape[i] if d == 0 else d for i, d in enumerate(_ints(shape))])


def _pad(x, pads, cval):
    pads = _ints(pads)
    half = len(pads) // 2
    torch_pads = []
    for ax in reversed(range(half)):  # F.pad lists the last axis first
        torch_pads += [pads[ax], pads[half + ax]]
    return F.pad(x, torch_pads, value=cval)


def run_graph(g: GraphT, feeds: dict, consts: dict) -> dict:
    """Execute nodes in file order (the emitter writes them topologically).
    `consts`: the float initializers as tensors on the feeds' device; the
    int64 ones stay numpy (shapes, pads, slice bounds)."""
    env = dict(g.inits)
    env.update(consts)
    env.update(feeds)
    env[""] = None  # optional / empty input slots (e.g. Resize roi)

    for n in g.nodes:
        i = [env[name] for name in n.inputs]
        a = n.attrs
        op = n.op
        if op == "Conv":
            y = _conv2d(i[0], i[1], i[2] if len(i) > 2 else None, a.get("strides", [1, 1]),
                        a.get("pads", [0, 0, 0, 0]), a.get("group", 1), a.get("dilations", [1, 1]))
        elif op == "MaxPool":
            y = _maxpool(i[0], a["kernel_shape"], a.get("strides", [1, 1]), a.get("pads", [0, 0, 0, 0]))
        elif op == "Pad":
            # opset 11+ carries constant_value as the third input; the `value`
            # attribute is the opset < 11 spelling
            cval = i[2] if len(i) > 2 and i[2] is not None else a.get("value", 0.0)
            cval = np.asarray(cval.cpu() if isinstance(cval, torch.Tensor) else cval).reshape(-1)
            y = _pad(i[0], i[1] if len(i) > 1 else a["pads"], float(cval[0]) if cval.size else 0.0)
        elif op == "Sigmoid":
            y = torch.sigmoid(i[0])
        elif op == "Mul":
            y = i[0] * i[1]
        elif op == "Add":
            y = i[0] + i[1]
        elif op == "Concat":
            y = torch.cat(i, dim=a["axis"])
        elif op == "Reshape":
            y = _reshape(i[0], i[1])
        elif op == "Transpose":
            y = i[0].permute(*a["perm"])
        elif op == "Slice":
            y = _slice(i[0], i[1], i[2], i[3] if len(i) > 3 else None, i[4] if len(i) > 4 else None)
        elif op == "Resize":
            y = _resize_nearest(i[0], i[2] if len(i) > 2 else i[1])
        elif op == "LeakyRelu":
            y = F.leaky_relu(i[0], float(a.get("alpha", 0.01)))
        elif op == "Relu":
            y = torch.relu(i[0])
        else:
            raise NotImplementedError(f"ONNX executor: op '{op}' not implemented")
        env[n.outputs[0]] = y
    return {name: env[name] for name in g.outputs}


def onnxruntime_available() -> bool:
    """True when the real onnxruntime package is importable (neither machine
    has it today): a test can then hold this executor against it."""
    return importlib.util.find_spec("onnxruntime") is not None


class OnnxModel:
    """A loaded `.onnx` artifact: `model(images)` with images (N, 3, H, W)
    float32 in [0, 1] returns its first output, e.g. (N, M, no), as a float32
    tensor on `device` (None means "cuda" and raises without one)."""

    def __init__(self, path_or_bytes, device=None):
        data = path_or_bytes
        if not isinstance(data, (bytes, bytearray)):
            data = Path(path_or_bytes).read_bytes()
        self.device = select_device(device)
        self.graph = parse_onnx(bytes(data))
        self.input_name = self.graph.inputs[0] if self.graph.inputs else "images"
        self.output_name = self.graph.outputs[0] if self.graph.outputs else "output"
        self.consts = {k: torch.from_numpy(np.array(v, np.float32)).to(self.device)
                       for k, v in self.graph.inits.items() if v.dtype != np.int64}

    @torch.inference_mode()
    def __call__(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device, torch.float32)
        return run_graph(self.graph, {self.input_name: x}, self.consts)[self.output_name]

"""Declarative model spec + parser: YAML -> static layer graph
(yolov3_tpu/models/spec.py). For any config the JAX parser handles, the spec
is the JAX one (layers, args, channels, strides, save list), with one
exception: GhostConv's stride counts here (a fault of the JAX parser, whose
Detect strides come to 0 for yolov5s-ghost).

Two YAML schemas are accepted:
  - native: a `layers:` list of {from, n, op, args} dicts;
  - reference-compat: `backbone:`/`head:` lists of [from, n, module, args].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from yolov3_tpu_torch.nn.modules import CHANNEL_OPS, MODULE_REGISTRY, REPEAT_ARG_OPS
from yolov3_tpu_torch.utils.general import LOGGER, make_divisible, yaml_load

CONFIG_DIR = Path(__file__).parent / "configs"


def _tuplify(x):
    """Recursively convert lists to tuples so the spec is hashable."""
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclass(frozen=True)
class LayerSpec:
    i: int  # layer index
    f: tuple  # absolute input layer indices (resolved; (i-1,) for sequential)
    n: int  # repeats (after depth gain)
    op: str  # registry op name
    args: tuple  # constructor args, channel-resolved (args[0] = c2 for convs)
    c2: int  # output channels
    stride: int  # cumulative stride vs input image


@dataclass(frozen=True)
class ModelSpec:
    name: str
    nc: int
    ch_in: int
    layers: tuple  # tuple[LayerSpec]
    save: tuple  # layer indices whose outputs feed later layers
    detect_from: tuple  # layer indices feeding the Detect head
    anchors: tuple  # ((na*2,)*nl) pixel anchors per scale
    strides: tuple  # per-scale strides, e.g. (8, 16, 32)
    activation: Any = None  # override of the default SiLU
    meta: tuple = field(default_factory=tuple)
    # per-layer output channels as the tensors have them; `LayerSpec.c2` is the
    # JAX parser's count, which has Contract, Expand and DWConvTranspose2d keep
    # their input's channels (its modules read the channels off the tensor)
    channels: tuple = field(default=(), compare=False)

    @property
    def na(self):
        return len(self.anchors[0]) // 2

    @property
    def nl(self):
        return len(self.anchors)

    @property
    def no(self):
        return self.nc + 5

    def grid_anchors(self):
        """Anchors in grid units, (nl, na, 2): pixel anchors over each scale's stride."""
        return [[[a[2 * k] / s, a[2 * k + 1] / s] for k in range(self.na)]
                for a, s in zip(self.anchors, self.strides)]

    def out_channels(self, j):
        """Channels of layer j's output as the tensor has them (j = -1: the input image)."""
        return self.ch_in if j < 0 else self.channels[j]


# spatial stride effect: op -> callable(args) -> downsampling factor
_STRIDE_FNS = {
    "Conv": lambda a: a[2] if len(a) > 2 else 1,
    "DWConv": lambda a: a[2] if len(a) > 2 else 1,
    "GhostConv": lambda a: a[2] if len(a) > 2 else 1,  # missing from the JAX parser's table
    "Focus": lambda a: 2 * (a[2] if len(a) > 2 else 1),
    "MaxPool": lambda a: a[1] if len(a) > 1 else a[0],
    "Contract": lambda a: a[0] if a else 2,
    "GhostBottleneck": lambda a: a[2] if len(a) > 2 else 1,
}

_REF_NAME_MAP = {  # reference YAML module spellings -> registry names
    "nn.MaxPool2d": "MaxPool",
    "nn.ZeroPad2d": "ZeroPad",
    "nn.Upsample": "Upsample",
}


def _resolve_arg(a, symbols):
    """Resolve a YAML arg: symbol name ('nc', 'anchors'), literal, or nested list."""
    if isinstance(a, str):
        if a in symbols:
            return symbols[a]
        if a in ("None", "none"):
            return None
        if a in ("True", "False"):
            return a == "True"
        return a  # plain string like 'nearest'
    if isinstance(a, list):
        return [_resolve_arg(x, symbols) for x in a]
    return a


def _normalize_rows(d):
    """Yield (from, n, op, args) rows from either schema."""
    if "layers" in d:
        for row in d["layers"]:
            if isinstance(row, dict):
                yield row["from"], row.get("n", 1), row["op"], list(row.get("args", []))
            else:
                f, n, op, args = row
                yield f, n, op, list(args)
    else:  # reference-compat backbone + head
        for f, n, op, args in list(d["backbone"]) + list(d["head"]):
            yield f, n, _REF_NAME_MAP.get(op, op), list(args)


def parse_spec(cfg, ch=3, nc=None, anchors=None, activation=None) -> ModelSpec:
    """Parse a model config (path, name like 'yolov3-tiny', or dict) into a ModelSpec."""
    if isinstance(cfg, (str, Path)):
        p = Path(cfg)
        if not p.is_file():
            p = CONFIG_DIR / (str(cfg).replace(".yaml", "").replace(".yml", "") + ".yaml")
        name = p.stem
        d = yaml_load(p)
    else:
        d = dict(cfg)
        name = d.get("name", "custom")

    nc = nc or d["nc"]
    anchors = anchors or d["anchors"]
    gd = d.get("depth_multiple", 1.0)
    gw = d.get("width_multiple", 1.0)
    act = activation or d.get("activation")
    ch = d.get("ch", ch)

    if isinstance(anchors, int):  # anchor count given; placeholder values
        anchors = [[2.0 * (j + 1) for _ in range(anchors) for j in (0, 0)] for _ in range(3)]
    na = len(anchors[0]) // 2
    no = na * (nc + 5)
    symbols = {"nc": nc, "anchors": anchors}

    channels = [ch]  # the JAX parser's count (LayerSpec.c2)
    real = [ch]  # the tensors' (ModelSpec.channels)
    layers: list[LayerSpec] = []
    save: set[int] = set()
    strides = [1]  # per-layer cumulative stride (index 0 = input)
    detect_from = None

    for i, (f, n, op, raw_args) in enumerate(_normalize_rows(d)):
        args = [_resolve_arg(a, symbols) for a in raw_args]
        if op == "Upsample" and args and args[0] is None:
            # reference spelling nn.Upsample(None, scale, mode) -> Upsample(scale, mode)
            args = [int(args[1]), *args[2:]]
        if op == "Concat":
            args = []  # the channel axis is fixed by the layout
        n = max(round(n * gd), 1) if n > 1 else n  # depth gain (reference yolo.py:325)
        f_list = [f] if isinstance(f, int) else list(f)
        f_abs = tuple(x if x >= 0 else i + x for x in f_list)  # resolve negatives

        if op == "Detect":
            detect_from = f_abs
            for x in f_abs:
                save.add(x)
            if len(args) >= 2 and isinstance(args[1], (list, tuple)):
                anchors = args[1]
            layers.append(LayerSpec(i, f_abs, 1, "Detect", (), 0, 0))
            continue

        if op not in MODULE_REGISTRY:
            raise KeyError(f"unknown op {op!r} at layer {i}; registry has {sorted(MODULE_REGISTRY)}")

        c1, r1 = channels[f_abs[0] + 1], real[f_abs[0] + 1]
        if op in CHANNEL_OPS:
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
            if op in REPEAT_ARG_OPS:  # the repeats become the module's own
                args.insert(1, n)
                n = 1
            r2 = c2
        elif op == "Concat":
            c2 = sum(channels[x + 1] for x in f_abs)
            r2 = sum(real[x + 1] for x in f_abs)
        else:
            c2, r2 = c1, r1
            if op in ("Contract", "Expand"):
                g = args[0] if args else 2
                r2 = r1 * g * g if op == "Contract" else r1 // (g * g)
            elif op == "DWConvTranspose2d":
                r2 = args[0]

        scale = _STRIDE_FNS.get(op, lambda a: 1)(args)
        stride = strides[f_abs[0] + 1]
        if op == "Upsample":
            up = args[0] if args else 2
            stride = stride // int(up)
        else:
            stride = stride * int(scale)

        for x in f_abs:
            if x != i - 1:
                save.add(x)
        layers.append(LayerSpec(i, f_abs, n, op, _tuplify(args), c2, stride))
        channels.append(c2)
        real.append(r2)
        strides.append(stride)

    if detect_from is None:
        raise ValueError("model spec has no Detect layer")

    det_strides = [strides[x + 1] for x in detect_from]
    anchors = [list(a) for a in anchors]
    # anchor order check (reference utils/autoanchor.py:16-23): anchor area must
    # grow with stride; flip if the YAML lists them in the opposite order.
    areas = [sum(a[j] * a[j + 1] for j in range(0, len(a), 2)) / (len(a) // 2) for a in anchors]
    if len(areas) > 1:
        da = areas[-1] - areas[0]
        ds = det_strides[-1] - det_strides[0]
        if da and ds and (da > 0) != (ds > 0):
            LOGGER.info("Reversing anchor order to match stride order")
            anchors = anchors[::-1]

    return ModelSpec(
        name=name,
        nc=nc,
        ch_in=ch,
        layers=tuple(layers),
        save=tuple(sorted(save)),
        detect_from=tuple(detect_from),
        anchors=_tuplify(anchors),
        strides=tuple(int(s) for s in det_strides),
        activation=act,
        channels=tuple(real[1:]),
    )

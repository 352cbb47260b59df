"""DetectionModel: spec-driven layer graph (yolov3_tpu/models/detection.py).

`DetectionModel.model` is an `nn.ModuleList` with one entry per spec layer:
the module itself, or an `nn.Sequential` of its repeats, so state-dict keys
are the reference's `model.{i}.…` / `model.{i}.{r}.…` and the Detect convs
`model.{last}.m.{k}.…`. `forward` walks the layers like the JAX `YOLOGraph`:
the save list keeps the outputs later layers route from. With `remat=True`
the body runs in checkpointed segments (torch.utils.checkpoint), as the JAX
`YOLOGraph(remat=True)` does with `nn.remat`.

`predict` decodes one forward, or with augment=True the test-time
augmentation of `predict_augmented` (three scales, a left-right flip),
the counterpart of the JAX package's `predict_augmented_pure`.

The module's self-test builds a config (or, with --test, each of yolov3,
yolov3-spp and yolov3-tiny), logs its summary and runs one forward, or with
--line-profile prints the per-layer profile (utils/profiling.py):

    python -m yolov3_tpu_torch.models.detection --cfg yolov3 --imgsz 640 --line-profile [--device cpu]
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from yolov3_tpu_torch.models.detect_head import Detect, decode_predictions, detect_bias_init
from yolov3_tpu_torch.models.fuse import fuse_state_dict
from yolov3_tpu_torch.models.spec import ModelSpec, parse_spec
from yolov3_tpu_torch.nn import activations
from yolov3_tpu_torch.nn.activations import AconC, MetaAconC
from yolov3_tpu_torch.nn.modules import (INPUT_CHANNEL_OPS, MODULE_REGISTRY, MULTI_INPUT_OPS, Conv, MaxPool,
                                         recomputing)
from yolov3_tpu_torch.utils.general import LOGGER, select_device


def _build_layer(spec: ModelSpec, ls, fused):
    """The module of one spec layer: cls(*args), or cls(c1, *args) for the ops
    that need their input channels, with `fused` for those that fold a BN;
    n > 1 stacks repeats (reference yolo.py:370), repeat r > 0 reading r-1."""
    cls = MODULE_REGISTRY[ls.op]
    kw = {"fused": fused} if "fused" in inspect.signature(cls).parameters else {}
    if ls.op not in INPUT_CHANNEL_OPS:
        return cls(*ls.args, **kw) if ls.n == 1 else nn.Sequential(*(cls(*ls.args, **kw) for _ in range(ls.n)))
    c1, c2 = spec.out_channels(ls.f[0]), spec.out_channels(ls.i)
    if ls.n == 1:
        return cls(c1, *ls.args, **kw)
    return nn.Sequential(*(cls(c1 if r == 0 else c2, *ls.args, **kw) for r in range(ls.n)))


def s2d_eligible(spec, error=None) -> bool:
    """True when the spec's stem is [Conv k3 s1, Conv k3 s2] (yolov3,
    yolov3-spp), the stem the JAX package's space-to-depth layout re-expresses;
    yolov3-tiny's maxpool stem is not. With `error`, an ineligible spec raises
    ValueError(error.format(name=spec.name, stem="[<op><args>, <op><args>]"))
    instead: each caller words it as its JAX counterpart does."""
    l0, l1 = spec.layers[0], spec.layers[1]
    ok = (l0.op == "Conv" and tuple(l0.args[1:3]) == (3, 1)
          and l1.op == "Conv" and tuple(l1.args[1:3]) == (3, 2))
    if error is not None and not ok:
        raise ValueError(error.format(name=spec.name, stem=f"[{l0.op}{l0.args}, {l1.op}{l1.args}]"))
    return ok


class DetectionModel(nn.Module):
    """Layer graph of a ModelSpec. `fused=True` builds the inference form
    with every Conv+BN folded (see `fuse`).

    `s2d_stem=True` is the JAX package's space-to-depth stem
    (yolov3_tpu/models/detection.py:61-110), a TPU layout that re-expresses
    the stem on the same parameters and computes the same function. The port
    keeps the flag and computes the plain layout; a spec whose stem is not
    eligible (`s2d_eligible`) raises the JAX package's ValueError."""

    def __init__(self, spec: ModelSpec, fused=False, s2d_stem=False):
        super().__init__()
        if s2d_stem:
            s2d_eligible(spec, "s2d_stem needs a [Conv k3 s1, Conv k3 s2] stem; {name} is not eligible")
        self.spec = spec
        self.fused = fused
        self.s2d_stem = bool(s2d_stem)
        # the YAML `activation:` applies to this model's Convs only: set the
        # default while they are built, then restore it
        prev = activations._DEFAULT_ACT[0]
        activations.set_default_activation(spec.activation)
        try:
            layers = [_build_layer(spec, ls, fused) for ls in spec.layers[:-1]]
        finally:
            activations._DEFAULT_ACT[0] = prev
        detect = spec.layers[-1]
        assert detect.op == "Detect", "spec must end with a Detect layer"
        layers.append(Detect(spec.nc, spec.na, [spec.out_channels(j) for j in detect.f], spec.strides))
        self.model = nn.ModuleList(layers)
        self.names = {i: str(i) for i in range(spec.nc)}
        self._anchor_tables = {}  # (device, spec.anchors) -> `anchor_table()`; not a buffer: see there
        self.conv_pool_pairs = {}  # conv layer -> keep its unpooled output; set by `optimize_for_inference`

    @classmethod
    def from_config(cls, cfg="yolov3-tiny", seed=0, device=None, dtype=torch.float32, ch=3, nc=None,
                    anchors=None, s2d_stem=False):
        """Build from a YAML config / name / dict with a seeded random init
        (a CPU `torch.Generator`, so the weights do not depend on the device).
        device=None means "cuda" and raises without one. `s2d_stem`: see the
        class; the weights are the same with and without it."""
        spec = parse_spec(cfg, ch=ch, nc=nc, anchors=anchors)
        if s2d_stem:
            s2d_eligible(spec, "s2d_stem needs a [Conv k3 s1, Conv k3 s2] stem; {name} has {stem}")
        device = select_device(device)
        model = cls(spec, s2d_stem=s2d_stem)
        model.init_weights(torch.Generator().manual_seed(seed))
        return model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()

    @torch.no_grad()
    def init_weights(self, generator):
        """Every draw from `generator`, in module order: conv, transposed-conv
        and linear weights U(±1/sqrt(fan_in)) (torch's Conv2d default, the JAX
        package's conv init) and their biases 0 (flax's); ACON's p1 / p2
        N(0, 1) and beta 1; BN identity; Sum's w its -arange(1, n) / 2; Detect
        kernels N(0, 1/fan_in) and the objectness/class prior bias."""
        detect = self.model[-1]
        head = {id(conv) for conv in detect.m}
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and id(m) not in head:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (AconC, MetaAconC)):
                m.p1.normal_(generator=generator)
                m.p2.normal_(generator=generator)
                if isinstance(m, AconC):
                    m.beta.fill_(1.0)
        for conv, s in zip(detect.m, detect.strides):
            conv.weight.normal_(0.0, 1.0 / math.sqrt(conv.weight[0].numel()), generator=generator)
            conv.bias.copy_(detect_bias_init(detect.nc, detect.na, s))

    @property
    def dtype(self):
        return self.model[-1].m[0].weight.dtype

    @property
    def device(self):
        return self.model[-1].m[0].weight.device

    @property
    def stride(self):
        return max(self.spec.strides)

    @property
    def anchors_px(self):
        return np.array(self.spec.anchors, dtype=np.float32).reshape(self.spec.nl, -1, 2)

    def anchor_table(self):
        """The (nl, na, 2) float32 pixel anchors on the model's device, the
        table every decode of the model reads: built once per device and
        `spec.anchors` (so a swap of the spec's anchors builds a new one), then
        the same tensor, so no decode copies it from the host and waits there
        for the queued forward. Not a buffer: a bf16 cast would round it
        (373 becomes 372), and a model built on `meta` and then `to_empty`
        would hold it uninitialised. Built outside inference mode, so a
        grad-recording decode may read a table first built inside it."""
        key = (self.device, self.spec.anchors)
        if key not in self._anchor_tables:
            with torch.inference_mode(False):
                self._anchor_tables[key] = torch.as_tensor(self.anchors_px, device=self.device)
        return self._anchor_tables[key]

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def info(self, imgsz=640):
        """Log the JAX package's summary line (layers, parameters, strides,
        nc) and return the parameter count; `imgsz` is accepted as there."""
        n_p = self.num_params()
        LOGGER.info(f"{self.spec.name}: {len(self.spec.layers)} spec layers, {n_p:,} parameters, "
                    f"strides {list(self.spec.strides)}, nc={self.spec.nc}")
        return n_p

    def forward(self, x, raw=False, remat=False, remat_segment=6, remat_until=-1, raw_pad=0):
        """x: (B, H, W, C) NHWC images in [0, 1].

        raw=False: tuple of per-scale (B, na, ny, nx, no) maps, float32 in
        eval mode and in the compute dtype in train mode (the loss upcasts
        after its gather).
        raw=True: tuple of per-scale (B, ny, nx, na*no) maps in the model's
        dtype, the serving layout `decode_topk_nhwc` reads; with `raw_pad=P`
        the padded layout (B, ny, nx, na*P) of `Detect` (raw_pad implies raw).

        remat=True (with autograd on): the body layers below `remat_until`
        (-1: all of them) run in checkpointed segments of `remat_segment`
        layers (yolov3_tpu/models/detection.py:147-169). The backward
        recomputes one segment at a time, so only segment boundaries and the
        routed outputs stay alive; the recompute runs under
        `nn.modules.recomputing()`, so BatchNorm running statistics are
        updated once. Layers from `remat_until` on run plain."""
        out = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        body = list(zip(self.spec.layers[:-1], self.model))
        saved, prev = {}, -1
        cut = 0
        if remat and torch.is_grad_enabled():
            n = max(int(remat_segment), 1)
            cut = len(body) if remat_until < 0 else min(int(remat_until), len(body))
            for s in range(0, cut, n):
                seg = body[s:min(s + n, cut)]
                # nothing in the forward draws random numbers: no RNG state to keep for the recompute
                out, saved = checkpoint(_run_layers, seg, out, saved, prev, self.spec.save, use_reentrant=False,
                                        preserve_rng_state=False, context_fn=_recompute_context)
                prev = seg[-1][0].i
        out, saved = _run_layers(body[cut:], out, saved, prev, self.spec.save, self.conv_pool_pairs)
        prev = self.spec.layers[-2].i
        detect = self.spec.layers[-1]
        return self.model[-1]([out if j == prev else saved[j] for j in detect.f], raw=raw, raw_pad=raw_pad)

    def predict(self, x, augment=False):
        """Decoded predictions (B, N, 5 + nc) float32 of NHWC images in [0, 1];
        augment=True: the test-time augmentation of `predict_augmented`."""
        if augment:
            return predict_augmented(self, x)
        return decode_predictions(self(x), self.anchor_table(), self.spec.strides)

    def serving_module(self, pad_lanes=0):
        """This model with the raw NHWC head of the fast serving path
        (yolov3_tpu/models/detection.py serving_module): a module whose
        forward(x) returns what forward(x, raw=True) does, or with
        `pad_lanes=P` the padded head layout (`Detect` raw_pad), which
        `decode_topk_nhwc(padded_lanes=P)` reads. It shares this model's
        parameters."""
        return _ServingGraph(self, pad_lanes)

    def set_bn_stats_fn(self, fn):
        """Route every train-mode conv+BN-statistics call (nn.modules.Conv)
        through `fn`: the kernel wrapper `conv3x3_bn_stats` by default, its
        plain version for a caller that compares the two."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.bn_stats_fn = fn

    def fuse(self):
        """A new model with every Conv+BN folded (reference fuse(), yolo.py:163-172),
        on this model's device and dtype; this model is left as it is."""
        if self.fused:
            return self
        sd, _ = fuse_state_dict(self.state_dict())
        with torch.device("meta"):
            fused = DetectionModel(self.spec, fused=True, s2d_stem=self.s2d_stem)
        fused.load_state_dict(sd, assign=True)
        fused.names = dict(self.names)
        return fused.eval()


def build_model(cfg="yolov3-tiny", **kw) -> DetectionModel:
    """`DetectionModel.from_config(cfg, **kw)` (yolov3_tpu/models/detection.py build_model)."""
    return DetectionModel.from_config(cfg, **kw)


class _ServingGraph(nn.Module):
    """`DetectionModel.serving_module`: the model's forward with the raw (or
    padded) head."""

    def __init__(self, model, pad_lanes=0):
        super().__init__()
        self.model = model
        self.pad_lanes = int(pad_lanes)

    def forward(self, x):
        return self.model(x, raw=True, raw_pad=self.pad_lanes)


def _run_layers(layers, out, saved, prev, save, pairs=None):
    """Run (layer spec, module) pairs from the output of layer `prev`; returns
    the last output and a new dict of the outputs of the layers in `save`
    (the dict given is left as it is: a checkpoint recompute runs again on
    the same arguments). A conv of `pairs` (`conv_pool_pairs`) whose pool
    is in `layers` runs with that pool in one launch where the call allows
    (`Conv.forward_pooled`); its unpooled output is then kept only if
    `pairs` says so."""
    saved = dict(saved)
    pooled = None
    for n, (ls, m) in enumerate(layers):
        if pooled is not None:  # this MaxPool was computed with the conv before it
            out, pooled = pooled, None
        elif ls.op in MULTI_INPUT_OPS:
            out = m([out if j == prev else saved[j] for j in ls.f])
        else:
            x = out if ls.f[0] == prev else saved[ls.f[0]]
            both = m.forward_pooled(x, pairs[ls.i]) if pairs and ls.i in pairs and n + 1 < len(layers) else None
            if both is None:
                out = m(x)
            else:
                pooled, out = both
        prev = ls.i
        if ls.i in save:
            saved[ls.i] = out
    return out, saved


def _recompute_context():
    return contextlib.nullcontext(), recomputing()


def predict_augmented(model, x):
    """Test-time augmentation (yolov3_tpu/models/detection.py
    predict_augmented_pure): the decoded predictions of the image at scales
    1, 0.83 and 0.67, the second flipped left-right, each mapped back to the
    image's pixels; the first pass loses its smallest-stride tail and the
    last its largest-stride head (`_clip_augmented`), and the three are
    concatenated. x: (B, H, W, C) NHWC in [0, 1]."""
    h, w = x.shape[1:3]
    gs = int(model.stride)
    anchors = model.anchor_table()
    outs = []
    for si, fi in zip((1.0, 0.83, 0.67), (None, 3, None)):
        xi = x.flip(2) if fi == 3 else (x.flip(1) if fi == 2 else x)
        xi = _scale_img(xi, si, gs)
        yi = decode_predictions(model(xi), anchors, model.spec.strides)
        outs.append(_descale_pred(yi, fi, si, (h, w)))
    return torch.cat(_clip_augmented(outs, model.spec.nl), 1)


def _scale_img(img, ratio=1.0, gs=32, pad_value=0.447):
    """Resize an NHWC batch by `ratio` to int(h * ratio) x int(w * ratio),
    bilinear without antialiasing (half-pixel centres, the explicit output
    size: source coordinates scale by in/out, as jax.image.resize's do), then
    pad bottom and right with `pad_value` to a multiple of gs."""
    if ratio == 1.0:
        return img
    b, h, w, c = img.shape
    sh, sw = int(h * ratio), int(w * ratio)
    y = F.interpolate(img.permute(0, 3, 1, 2), size=(sh, sw), mode="bilinear", align_corners=False)
    th, tw = math.ceil(h * ratio / gs) * gs, math.ceil(w * ratio / gs) * gs
    return F.pad(y, (0, tw - sw, 0, th - sh), value=pad_value).permute(0, 2, 3, 1)


def _descale_pred(p, flips, scale, img_size):
    """Undo a TTA pass's scale and flip on decoded predictions."""
    xy, wh = p[..., 0:2] / scale, p[..., 2:4] / scale
    if flips == 2:  # up-down
        xy = torch.stack([xy[..., 0], img_size[0] - xy[..., 1]], -1)
    elif flips == 3:  # left-right
        xy = torch.stack([img_size[1] - xy[..., 0], xy[..., 1]], -1)
    return torch.cat([xy, wh, p[..., 4:]], -1)


def _clip_augmented(y, nl):
    """Drop the first pass's smallest-stride tail and the last pass's largest-stride head."""
    g = sum(4**x for x in range(nl))
    i = (y[0].shape[1] // g) * 1
    y[0] = y[0][:, :-i]
    i = (y[-1].shape[1] // g) * 4 ** (nl - 1)
    y[-1] = y[-1][:, i:]
    return y


def optimize_for_inference(model: DetectionModel, bf16=None) -> DetectionModel:
    """The inference form (yolov3_tpu/models/detection.py optimize_for_inference):
    Conv+BN folded, and bf16 weights when `bf16`, which None makes true on
    the card and false on the CPU (the JAX `half=None`); its conv -> max-pool
    pairs marked (`conv_pool_pairs`). A new model; this one is left as it is."""
    fused = model.fuse()
    if fused is model:
        fused = copy.deepcopy(model)
    if bf16 is None:
        bf16 = model.device.type == "cuda"
    fused.conv_pool_pairs = conv_pool_pairs(fused)
    return cast_for_inference(fused) if bf16 else fused


def conv_pool_pairs(model: DetectionModel) -> dict:
    """{conv layer: whether a later layer reads its unpooled output} of the
    pairs `conv_pool` computes in one launch: a `Conv` layer that `pools`
    (folded, 3x3, stride 1, padding 1, an activation and widths the kernel
    takes), followed by a `MaxPool(2, 2, 0)` layer that reads it. The
    unpooled output is kept where the conv's index is in `spec.save`.
    yolov3-tiny has four (layers 0, 2, 4 and 6); its layer 8 (128 -> 256
    channels, wider than `route_of` takes), its ZeroPad + `MaxPool(2, 1)`,
    and the pools inside SPP and SPPF, are no such pair."""
    layers = model.spec.layers
    pairs = {}
    for ls, nxt in zip(layers, layers[1:]):
        conv, pool = model.model[ls.i], model.model[nxt.i]
        if (type(conv) is Conv and conv.pools() and isinstance(pool, MaxPool) and (pool.k, pool.s, pool.p) == (2, 2, 0)
                and list(nxt.f) == [ls.i]):
            pairs[ls.i] = ls.i in model.spec.save
    return pairs


def cast_for_inference(model: DetectionModel, dtype=torch.bfloat16) -> DetectionModel:
    """Cast the weights to the serving dtype, in place; BatchNorm layers (none
    in a fused model) keep float32 statistics."""
    model.to(dtype)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return model


def _main(argv=None):
    """The model self-test (JAX models/detection.py:_main, reference models/yolo.py:395-415)."""
    import argparse

    from yolov3_tpu_torch.utils.profiling import model_info, profile_layers

    p = argparse.ArgumentParser()
    p.add_argument("--cfg", default="yolov3-tiny")
    p.add_argument("--imgsz", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--test", action="store_true", help="build all registered configs")
    p.add_argument("--line-profile", action="store_true", help="per-layer time/FLOPs table")
    p.add_argument("--device", default="", help="cuda (the default) or cpu")
    a = p.parse_args(argv)

    for name in ("yolov3", "yolov3-spp", "yolov3-tiny") if a.test else (a.cfg,):
        model = DetectionModel.from_config(name, device=a.device or None)
        model_info(model, a.imgsz)
        if a.line_profile:
            profile_layers(model, imgsz=a.imgsz, batch=a.batch_size)
        else:
            with torch.no_grad():
                pred = model.predict(torch.zeros((a.batch_size, a.imgsz, a.imgsz, 3), device=model.device))
            LOGGER.info(f"{name}: forward OK, decoded {tuple(pred.shape)}")


if __name__ == "__main__":
    _main()

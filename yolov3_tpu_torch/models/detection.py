"""DetectionModel: spec-driven layer graph (yolov3_tpu/models/detection.py).

`DetectionModel.model` is an `nn.ModuleList` with one entry per spec layer:
the module itself, or an `nn.Sequential` of its repeats, so state-dict keys
are the reference's `model.{i}.…` / `model.{i}.{r}.…` and the Detect convs
`model.{last}.m.{k}.…`. `forward` walks the layers like the JAX `YOLOGraph`:
the save list keeps the outputs later layers route from. With `remat=True`
the body runs in checkpointed segments (torch.utils.checkpoint), as the JAX
`YOLOGraph(remat=True)` does with `nn.remat`.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from yolov3_tpu_torch.models.detect_head import Detect, detect_bias
from yolov3_tpu_torch.models.fuse import fuse_state_dict
from yolov3_tpu_torch.models.spec import ModelSpec, parse_spec
from yolov3_tpu_torch.nn import activations
from yolov3_tpu_torch.nn.modules import CHANNEL_OPS, MODULE_REGISTRY, MULTI_INPUT_OPS, Conv, recomputing
from yolov3_tpu_torch.utils.general import select_device


def _build_layer(spec: ModelSpec, ls, fused):
    cls = MODULE_REGISTRY[ls.op]
    if ls.op not in CHANNEL_OPS:
        return cls(*ls.args) if ls.n == 1 else nn.Sequential(*(cls(*ls.args) for _ in range(ls.n)))
    c1 = spec.out_channels(ls.f[0])
    if ls.n == 1:
        return cls(c1, *ls.args, fused=fused)
    # stacked repeats (reference yolo.py:370): repeat r > 0 reads repeat r-1
    return nn.Sequential(*(cls(c1 if r == 0 else ls.c2, *ls.args, fused=fused) for r in range(ls.n)))


class DetectionModel(nn.Module):
    """Layer graph of a ModelSpec. `fused=True` builds the inference form
    with every Conv+BN folded (see `fuse`)."""

    def __init__(self, spec: ModelSpec, fused=False):
        super().__init__()
        self.spec = spec
        self.fused = fused
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

    @classmethod
    def from_config(cls, cfg="yolov3", seed=0, device=None, dtype=torch.float32, ch=3, nc=None,
                    anchors=None):
        """Build from a YAML config / name / dict with a seeded random init
        (a CPU `torch.Generator`, so the weights do not depend on the device).
        device=None means "cuda" and raises without one."""
        device = select_device(device)
        model = cls(parse_spec(cfg, ch=ch, nc=nc, anchors=anchors))
        model.init_weights(torch.Generator().manual_seed(seed))
        return model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()

    @torch.no_grad()
    def init_weights(self, generator):
        """Conv kernels U(±1/sqrt(fan_in)) (torch's Conv2d default, the JAX
        package's conv init); BN identity; Detect kernels N(0, 1/fan_in) and
        the objectness/class prior bias."""
        for m in self.modules():
            if isinstance(m, Conv):
                w = m.conv.weight
                bound = 1.0 / math.sqrt(w[0].numel())
                w.uniform_(-bound, bound, generator=generator)
        detect = self.model[-1]
        for conv, s in zip(detect.m, detect.strides):
            conv.weight.normal_(0.0, 1.0 / math.sqrt(conv.weight[0].numel()), generator=generator)
            conv.bias.copy_(detect_bias(detect.nc, detect.na, s))

    @property
    def dtype(self):
        return self.model[-1].m[0].weight.dtype

    @property
    def device(self):
        return self.model[-1].m[0].weight.device

    @property
    def anchors_px(self):
        return np.array(self.spec.anchors, dtype=np.float32).reshape(self.spec.nl, -1, 2)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def forward(self, x, raw=False, remat=False, remat_segment=6, remat_until=-1):
        """x: (B, H, W, C) NHWC images in [0, 1].

        raw=False: tuple of per-scale (B, na, ny, nx, no) maps, float32 in
        eval mode and in the compute dtype in train mode (the loss upcasts
        after its gather).
        raw=True: tuple of per-scale (B, ny, nx, na*no) maps in the model's
        dtype, the serving layout `decode_topk_nhwc` reads.

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
        out, saved = _run_layers(body[cut:], out, saved, prev, self.spec.save)
        prev = self.spec.layers[-2].i
        detect = self.spec.layers[-1]
        return self.model[-1]([out if j == prev else saved[j] for j in detect.f], raw=raw)

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
            fused = DetectionModel(self.spec, fused=True)
        fused.load_state_dict(sd, assign=True)
        return fused.eval()


def _run_layers(layers, out, saved, prev, save):
    """Run (layer spec, module) pairs from the output of layer `prev`; returns
    the last output and a new dict of the outputs of the layers in `save`
    (the dict given is left as it is: a checkpoint recompute runs again on
    the same arguments)."""
    saved = dict(saved)
    for ls, m in layers:
        if ls.op in MULTI_INPUT_OPS:
            out = m([out if j == prev else saved[j] for j in ls.f])
        else:
            out = m(out if ls.f[0] == prev else saved[ls.f[0]])
        prev = ls.i
        if ls.i in save:
            saved[ls.i] = out
    return out, saved


def _recompute_context():
    return contextlib.nullcontext(), recomputing()


def cast_for_inference(model: DetectionModel, dtype=torch.bfloat16) -> DetectionModel:
    """Cast the weights to the serving dtype, in place; BatchNorm layers (none
    in a fused model) keep float32 statistics."""
    model.to(dtype)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return model

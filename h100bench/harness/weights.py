"""Seeded weights of a configuration, made on the device in one draw.

Every leaf of the published state dict (`reference.model.Net.param_shapes`)
comes from one uniform draw of a `torch.Generator` on the device, cut into
leaves and scaled: a conv weight U(+-1/sqrt(fan_in)) (torch's default); a
BatchNorm weight 0.3 (1 + 0.1 U(-1, 1)), its running variance 1 + 0.1 U(-1, 1),
its bias and running mean 0.1 U(-1, 1); a head weight with standard deviation 1/sqrt(fan_in);
a head bias at the published objectness and class priors (yolo.py
_initialize_biases) plus 0.1 U(-1, 1). The result is float32, the type the
program takes its weights in; both the program and the reference get a
copy.

The BatchNorm weights of 0.3 keep the random model out of the chaotic regime:
once the running statistics are settled to the frames (harness/plant.py),
BatchNorm weights near 1 let a random model amplify rounding layer by layer
(bf16 moves its objectness logits by 6-17% of their spread at 128 px,
against 1-2% at 0.3), which a trained model does not do.
"""

from __future__ import annotations

import math

import torch

from harness.core import generator

BN_GAIN = 0.3


def prior_bias(nc, na, stride, imgsz=640.0):
    b = torch.zeros(na, nc + 5)
    b[:, 4] += math.log(8.0 / (imgsz / stride) ** 2)
    b[:, 5:] += math.log(0.6 / (nc - 0.99999))
    return b.reshape(-1)


def make_weights(net, seed, device):
    shapes = net.param_shapes()
    sizes = [math.prod(s) for _, s, kind in shapes if kind != "bn_count"]
    u = torch.rand(sum(sizes), generator=generator(seed, "weights", device), device=device) * 2 - 1
    out, at = {}, 0
    det_k = 0
    for name, shape, kind in shapes:
        if kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        v = u[at:at + n].reshape(shape)
        at += n
        if kind == "conv":
            v = v / math.sqrt(math.prod(shape[1:]))
        elif kind == "bn_w":
            v = BN_GAIN * (1.0 + 0.1 * v)
        elif kind == "bn_var":
            v = 1.0 + 0.1 * v
        elif kind in ("bn_b", "bn_mean"):
            v = 0.1 * v
        elif kind == "head_w":
            v = v * math.sqrt(3.0 / shape[1])
        elif kind == "head_b":
            v = prior_bias(net.nc, net.na, net.strides[det_k]).to(device) + 0.1 * v
            det_k += 1
        out[name] = v.contiguous()
    return out

"""Detections planted on a random model's head, from the plain reference.

A seeded random YOLOv3 scores no cell above conf 0.25, so its serving path
would sort and suppress nothing. Planting rewrites the head's objectness and
class rows so that about `targets[i]` cells an image of level i pass conf
(after chip_smoke.calibrate and plant_under_topk): the objectness column is
scaled to a logit spread of about 2, shifted so that the (1 - target / cells)
quantile sits at the conf crossing; the class columns are scaled to a logit
spread of 2 and every class bias is raised by 8, so a cell's best class
leads the next by about a logit and its probability is near 1.
The targets are halved until no frame has more than half of its level's
top-k above conf, so no served batch overflows the fast path's top-k.
First the objectness column is turned, by its projection on the features of
a uniform letterbox-gray frame, so that such a frame scores the frames'
mean objectness: a random model would otherwise light up the uniform
padding of letterboxed frames as a plateau of equal scores, whose boxes
scale back outside the frame.

Before planting, `settle` sets every BatchNorm's running statistics to the
batch statistics of a train-mode forward over a few of the frames, as a
trained model's are: with the seeded statistics (mean near 0, variance near
1) a random model's eval activations shrink layer by layer until the head no
longer depends on the frame.

Everything here runs the plain reference on the frames (float32, TF32 off):
the settled and planted weights are part of the benchmark's inputs and are
handed to the program and to the reference alike.
"""

from __future__ import annotations

import math

import torch

from reference.model import head, strict_f32, trunk

CLS_BUMP = 8.0
SETTLE_FRAMES = 8


def settle(p, net, frames, device):
    """Running statistics := the batch statistics of `frames` (uint8 NHWC), in place."""
    stats = {}
    with torch.no_grad(), strict_f32():
        trunk(p, net, torch.as_tensor(frames).to(device).float() / 255.0, train=True, record=stats)
    for prefix, (mean, var) in stats.items():
        p[f"{prefix}.bn.running_mean"], p[f"{prefix}.bn.running_var"] = mean, var


def head_inputs(p, net, frames, device, chunk=16):
    """The head's float32 inputs for uint8 NHWC frames (host or device)."""
    outs = [[] for _ in net.detect_from]
    with torch.no_grad(), strict_f32():
        for i in range(0, len(frames), chunk):
            x = torch.as_tensor(frames[i:i + chunk]).to(device).float() / 255.0
            for k, f in enumerate(trunk(p, net, x)):
                outs[k].append(f)
    return [torch.cat(o) for o in outs]


def spread_gain(logits, spread=2.0):
    return float(min(max(spread / max(float(logits.std()), 1e-8), 1.0), 1e6))


def gray_features(p, net, size, device, value=114):
    """The head's inputs at the centre cell of a uniform `value` frame, per level: (C,)."""
    frame = torch.full((1, size, size, 3), value, dtype=torch.uint8)
    return [f[0, :, f.shape[2] // 2, f.shape[3] // 2] for f in head_inputs(p, net, frame, device)]


def planted_head(p, net, feats, targets, conf, gray):
    """Head (weight, bias) pairs putting about targets[i] cells an image of
    level i above conf."""
    det, no, na = net.layers[-1]["i"], net.no, net.na
    pairs = []
    with torch.no_grad(), strict_f32():
        for k, f in enumerate(feats):
            w, b = p[f"model.{det}.m.{k}.weight"].clone(), p[f"model.{det}.m.{k}.bias"].clone()
            rows = torch.arange(na, device=w.device) * no + 4
            cls_rows = torch.cat([torch.arange(a * no + 5, (a + 1) * no, device=w.device) for a in range(na)])
            wo = w[rows, :, 0, 0]
            mean = torch.einsum("bchw,ac->a", f, wo) / (f.shape[0] * f.shape[2] * f.shape[3])
            w[rows, :, 0, 0] = wo - ((wo @ gray[k] - mean) / (gray[k] @ gray[k]))[:, None] * gray[k][None]
            obj = torch.einsum("bchw,ac->bhwa", f, w[rows, :, 0, 0])  # without the bias
            g = spread_gain(obj)
            w[cls_rows] *= spread_gain(torch.einsum("bchw,ac->bhwa", f[:4], w[cls_rows, :, 0, 0]))
            planted = (g * obj + b[rows]).reshape(-1)
            cells = planted.numel() // f.shape[0]
            q = float(torch.quantile(planted, 1.0 - targets[k] / cells))
            w[rows] *= g
            b[rows] += math.log(conf / (1 - conf)) + 0.05 - q
            b[cls_rows] += CLS_BUMP
            pairs.append((w, b))
    return pairs


def above_conf(net, feats, pairs, conf, chunk=16):
    """Cells above conf per level and frame: (levels, frames) counts."""
    counts = []
    with torch.no_grad(), strict_f32():
        for k, f in enumerate(feats):
            c = []
            for i in range(0, f.shape[0], chunk):
                y = torch.sigmoid(head(None, net, [f[i:i + chunk]], weights=[pairs[k]])[0])
                c.append(((y[..., 4:5] * y[..., 5:]).amax(-1) > conf).flatten(1).sum(1))
            counts.append(torch.cat(c))
    return counts


def plant(p, net, frames, device, plant_targets, k_per_scale, conf=0.25):
    """Settle and plant detections on the reference weights `p` in place, for `frames`:
    about plant_targets[str(stride)] cells an image of each level above conf,
    under half of the level's k_per_scale.
    Returns the targets used, the cells above conf per level and frame, and
    the head's float32 inputs of the frames."""
    settle(p, net, frames[:SETTLE_FRAMES], device)
    gray = gray_features(p, net, frames.shape[1], device)
    feats = head_inputs(p, net, frames, device)
    det = net.layers[-1]["i"]
    targets = [float(plant_targets[str(s)]) for s in net.strides]
    topk = [k_per_scale[min(i, len(k_per_scale) - 1)] for i in range(net.nl)]
    for _ in range(10):
        pairs = planted_head(p, net, feats, targets, conf, gray)
        counts = above_conf(net, feats, pairs, conf)
        over = [k for k, c in enumerate(counts) if int(c.max()) > topk[k] // 2]
        if not over:
            for k, (w, b) in enumerate(pairs):
                p[f"model.{det}.m.{k}.weight"], p[f"model.{det}.m.{k}.bias"] = w, b
            return targets, counts, feats
        for k in over:
            targets[k] /= 2
    raise RuntimeError(f"planting: no targets keep every frame under half the top-k {topk}: {targets}")

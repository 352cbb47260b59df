"""Plain PyTorch train step of YOLOv3 (ultralytics utils/loss.py ComputeLoss,
train.py's optimizer groups, warm-up schedule and gradient clip).

Loss: each label is assigned, at each level, to the anchors whose width and
height ratios to it are under `anchor_t`, in its own cell and in the two
neighbouring cells its centre is nearest to (offsets of 0.5); the box loss
is 1 - CIoU of the decoded (2 sigmoid - 0.5, (2 sigmoid)^2 anchor) box, the
objectness target the detached CIoU clamped at 0 (where candidates share a
cell, the last in (offset, anchor, label) order), the class target a one-hot
row; BCE with logits; the level objectness weights 4, 1, 0.4 (three levels)
or 4, 1 (two); the gains box, obj and cls of the hyper-parameters; the sum
times the batch size.

Step: loss.backward(); the gradients clipped to a global norm of 10; SGD
with Nesterov momentum over three groups, conv and head weights with weight
decay, BatchNorm weights and every bias without; the learning rate and the
momentum of the warm-up schedule at the optimizer's update count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.model import forward

CLIP_NORM = 10.0


def ciou(b1, b2, eps=1e-7):
    """CIoU of aligned xywh boxes; alpha carries no gradient."""
    (x1, y1, w1, h1), (x2, y2, w2, h2) = b1.unbind(-1), b2.unbind(-1)
    b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
    b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * \
        (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def bce(logits, target):
    return F.binary_cross_entropy_with_logits(logits, target, reduction="none")


def loss_fn(feats, labels, net, hyp):
    """feats: (B, na, ny, nx, no) raw maps per level; labels: (n, 6) rows
    [image, cls, x, y, w, h] (normalised). Returns the total loss."""
    bs = feats[0].shape[0]
    dev = feats[0].device
    balance = [4.0, 1.0, 0.4] if net.nl == 3 else [4.0, 1.0, 0.25, 0.06, 0.02][:net.nl]
    lbox = lobj = lcls = torch.zeros((), device=dev)
    off = torch.tensor([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], device=dev).float() * 0.5
    for i, p in enumerate(feats):
        _, na, ny, nx, no = p.shape
        anchors = net.anchors[i].to(dev) / net.strides[i]
        gain = torch.tensor([nx, ny], device=dev).float()
        gxy, gwh = labels[:, 2:4] * gain, labels[:, 4:6] * gain
        r = gwh[None] / anchors[:, None]
        match = torch.maximum(r, 1 / r).amax(-1) < hyp["anchor_t"]  # (na, n)
        gxi = gain - gxy
        near = torch.stack([torch.ones_like(gxy[:, 0], dtype=torch.bool),
                            (gxy[:, 0] % 1 < 0.5) & (gxy[:, 0] > 1), (gxy[:, 1] % 1 < 0.5) & (gxy[:, 1] > 1),
                            (gxi[:, 0] % 1 < 0.5) & (gxi[:, 0] > 1), (gxi[:, 1] % 1 < 0.5) & (gxi[:, 1] > 1)])
        sel = near[:, None, :] & match[None]  # (5, na, n) in (offset, anchor, label) order
        o_i, a_i, l_i = sel.nonzero(as_tuple=True)
        b = labels[l_i, 0].long()
        cls = labels[l_i, 1].long()
        gij = (gxy[l_i] - off[o_i]).floor()
        gi = gij[:, 0].clamp(0, nx - 1).long()
        gj = gij[:, 1].clamp(0, ny - 1).long()
        tobj = torch.zeros(p.shape[:4], device=dev)
        if len(b):
            ps = p[b, a_i, gj, gi].float()
            pxy = torch.sigmoid(ps[:, :2]) * 2 - 0.5
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2) ** 2 * anchors[a_i]
            txy = gxy[l_i] - torch.stack([gi, gj], 1).float()
            iou = ciou(torch.cat([pxy, pwh], 1), torch.cat([txy, gwh[l_i]], 1))
            lbox = lbox + (1.0 - iou).mean()
            flat = ((b * na + a_i) * ny + gj) * nx + gi
            last = torch.full((tobj.numel(),), -1, dtype=torch.long, device=dev)
            last.scatter_reduce_(0, flat, torch.arange(len(flat), device=dev), "amax")
            win = last[flat] == torch.arange(len(flat), device=dev)
            tobj.view(-1)[flat[win]] = iou.detach().clamp(min=0)[win]
            t = torch.zeros_like(ps[:, 5:])
            t[torch.arange(len(cls), device=dev), cls] = 1.0
            lcls = lcls + bce(ps[:, 5:], t).mean()
        lobj = lobj + bce(p[..., 4].float(), tobj).mean() * balance[i]
    return (lbox * hyp["box"] + lobj * hyp["obj"] + lcls * hyp["cls"]) * bs


def labels_of(targets, mask):
    """(B, M, 5) padded labels and their (B, M) mask -> (n, 6) rows [image, cls, x, y, w, h]."""
    B, M, _ = targets.shape
    img = torch.arange(B, device=targets.device).float()[:, None, None].expand(B, M, 1)
    rows = torch.cat([img, targets], -1).reshape(B * M, 6)
    return rows[mask.reshape(-1).bool()]


def group_of(name):
    if name.endswith(".bias"):
        return "bias"
    return "bn" if name.endswith("bn.weight") else "weight"


def schedule(hyp, update, steps_per_epoch, epochs, min_warmup_steps):
    """(weight and bn lr, bias lr, momentum) of optimizer update `update`."""
    nw = max(round(hyp["warmup_epochs"] * steps_per_epoch), min_warmup_steps, 1)
    epoch = min(max(update // steps_per_epoch, 0), epochs)
    base = hyp["lr0"] * ((1 - epoch / epochs) * (1.0 - hyp["lrf"]) + hyp["lrf"])
    if update >= nw:
        return base, base, hyp["momentum"]
    f = update / nw
    return (base * f, hyp["warmup_bias_lr"] + (base - hyp["warmup_bias_lr"]) * f,
            hyp["warmup_momentum"] + (hyp["momentum"] - hyp["warmup_momentum"]) * f)


class Trainer:
    """The reference's train state: float32 parameters (a dict of leaves), SGD
    momentum buffers and the update count."""

    def __init__(self, params, net, wl):
        self.net, self.wl, self.hyp = net, wl, wl["hyp"]
        self.p = {k: v.detach().clone().requires_grad_(v.is_floating_point() and not k.endswith(
            ("running_mean", "running_var"))) for k, v in params.items()}
        self.leaves = [k for k, v in self.p.items() if v.requires_grad]
        self.buf = {}
        self.updates = 0

    def step(self, imgs_u8, targets, mask, precision="f32", batch_rows=None):
        """One step on a batch; returns (loss, {leaf: gradient as the optimizer gets it}, the
        gradient's global norm before the clip)."""
        x = imgs_u8.float() / 255.0
        labels = labels_of(targets, mask)
        if batch_rows is not None:  # a fault: the loss of some rows only
            keep = torch.isin(labels[:, 0].long(), torch.as_tensor(batch_rows, device=labels.device))
            remap = torch.full((x.shape[0],), -1.0, device=labels.device)
            remap[torch.as_tensor(batch_rows, device=labels.device)] = torch.arange(len(batch_rows),
                                                                                   device=labels.device).float()
            labels = labels[keep]
            labels[:, 0] = remap[labels[:, 0].long()]
            x = x[torch.as_tensor(batch_rows, device=x.device)]
        feats = forward(self.p, self.net, x, train=True, precision=precision, segments=True)
        loss = loss_fn(feats, labels, self.net, self.hyp)
        grads = torch.autograd.grad(loss, [self.p[k] for k in self.leaves])
        total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        coef = (CLIP_NORM / (total + 1e-6)).clamp(max=1.0)
        grads = {k: g * coef for k, g in zip(self.leaves, grads)}
        lr_w, lr_b, mom = schedule(self.hyp, self.updates, self.wl["steps_per_epoch"], self.wl["epochs"],
                                   self.wl["min_warmup_steps"])
        nbs, bs = self.wl["nbs"], self.wl["batch"]
        wd = self.hyp["weight_decay"] * bs * max(round(nbs / bs), 1) / nbs
        with torch.no_grad():
            for k in self.leaves:
                grp = group_of(k)
                d = grads[k] + wd * self.p[k] if grp == "weight" else grads[k]
                self.buf[k] = d.clone() if k not in self.buf else self.buf[k] * mom + d
                d = d + mom * self.buf[k]
                self.p[k] -= (lr_b if grp == "bias" else lr_w) * d
        self.updates += 1
        return float(loss.detach()), grads, float(total)

"""YOLOv3 loss: CIoU box + IoU-aware objectness + class BCE (yolov3_tpu/train/loss.py).

The JAX package's fixed-shape design is kept: every (offset, anchor, target)
candidate slot is scored under a validity mask, 5 neighbour offsets x na
anchors x (B*M) padded targets per scale, and invalid slots contribute 0. On
the card that means no data-dependent shapes and no host sync inside the
loss.

 - anchor match: max(r, 1/r).max() < anchor_t
 - neighbour expansion: +-0.5 cell offsets under (frac < 0.5, coord > 1)
 - objectness targets: the detached, clamped CIoU of the matched predictions;
   where several candidates land in one cell the last in (offset, anchor,
   target) order wins, placed by two scatter-max passes (position, then the
   winner's IoU), which is deterministic on CUDA where an indexed write with
   duplicate indices is not
 - per-scale balance [4.0, 1.0, 0.4] (3 scales) or the P3-P7 table
 - class BCE with label smoothing, optional focal modulation
 - the returned total is scaled by the batch size
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from yolov3_tpu_torch.ops.boxes import bbox_iou


@dataclass(frozen=True)
class LossConfig:
    """Static loss configuration."""

    nc: int
    nl: int
    na: int
    anchors: tuple  # grid-unit anchors, shape (nl, na, 2) as nested tuples
    strides: tuple
    box: float = 0.05
    obj: float = 1.0
    cls: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    label_smoothing: float = 0.0
    fl_gamma: float = 0.0
    anchor_t: float = 4.0
    autobalance: bool = False

    @property
    def balance(self):
        return (4.0, 1.0, 0.4) if self.nl == 3 else ((4.0, 1.0, 0.25, 0.06, 0.02)[: self.nl])

    @classmethod
    def from_model(cls, spec, hyp: dict | None = None):
        """Build from a ModelSpec + hyp dict. Scaling the gains per layer count
        and image size is the caller's job (it needs imgsz)."""
        hyp = hyp or {}
        return cls(
            nc=spec.nc,
            nl=spec.nl,
            na=spec.na,
            anchors=tuple(tuple(tuple(float(v) for v in a) for a in layer) for layer in spec.grid_anchors()),
            strides=tuple(spec.strides),
            box=hyp.get("box", 0.05),
            obj=hyp.get("obj", 1.0),
            cls=hyp.get("cls", 0.5),
            cls_pw=hyp.get("cls_pw", 1.0),
            obj_pw=hyp.get("obj_pw", 1.0),
            label_smoothing=hyp.get("label_smoothing", 0.0),
            fl_gamma=hyp.get("fl_gamma", 0.0),
            anchor_t=hyp.get("anchor_t", 4.0),
        )


def smooth_bce(eps=0.1):
    """Positive/negative BCE targets for label smoothing (arxiv 1902.04103 eqn 3)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight=1.0):
    """Elementwise BCE-with-logits with positive-class weight (torch semantics)."""
    return -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def focal_modulation(logits, targets, loss, gamma=1.5, alpha=0.25):
    """TF-style focal loss factor applied to an elementwise BCE loss."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def qfocal_modulation(logits, targets, loss, gamma=1.5, alpha=0.25):
    """Quality focal loss factor."""
    p = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * torch.abs(targets - p) ** gamma


def bce_blur_with_logits(logits, targets, alpha=0.05):
    """BCE that downweights probable missing labels."""
    loss = bce_with_logits(logits, targets)
    dx = torch.sigmoid(logits) - targets
    alpha_factor = 1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4))
    return (loss * alpha_factor).mean()


# neighbour offsets: centre, left cell, top cell, right cell, bottom cell (x0.5)
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def assign_targets_layer(targets, mask, anchors, ny, nx, anchor_t):
    """Assign padded targets to one detection scale.

    Args:
        targets: (N, 6) rows [img_idx, cls, x, y, w, h], xywh normalized 0-1.
        mask: (N,) bool validity of each row.
        anchors: (na, 2) grid-unit anchors for this scale.
        ny, nx: grid size.
        anchor_t: wh-ratio match threshold.

    Returns a dict of fixed-shape (5, na, N) candidate tensors (views where
    they only broadcast):
        m: candidate validity; b/a/gj/gi: gather indices (int64); txy: xy
        offset target within the cell (gxy - gij); twh: grid-unit wh target;
        tcls: class index; awh: matched anchor wh.
    """
    na = anchors.shape[0]
    n = targets.shape[0]
    dev = targets.device
    gain = torch.tensor([nx, ny], dtype=torch.float32, device=dev)
    gxy = targets[:, 2:4] * gain  # grid xy
    gwh = targets[:, 4:6] * gain  # grid wh

    # anchor ratio test -> (na, N)
    r = gwh[None, :, :] / anchors[:, None, :]
    match = (torch.maximum(r, 1.0 / r).amax(-1) < anchor_t) & mask[None, :]

    # neighbour-cell conditions -> (5, N)
    fx, fy = gxy[:, 0], gxy[:, 1]
    ix, iy = gain[0] - fx, gain[1] - fy
    cond = torch.stack([
        torch.ones_like(fx, dtype=torch.bool),
        (torch.remainder(fx, 1) < 0.5) & (fx > 1),  # left neighbour
        (torch.remainder(fy, 1) < 0.5) & (fy > 1),  # top neighbour
        (torch.remainder(ix, 1) < 0.5) & (ix > 1),  # right neighbour
        (torch.remainder(iy, 1) < 0.5) & (iy > 1),  # bottom neighbour
    ])

    m = match[None, :, :] & cond[:, None, :]  # (5, na, N)

    offsets = torch.tensor(_OFFSETS, dtype=torch.float32, device=dev)
    gij = torch.floor(gxy[None, :, :] - offsets[:, None, :])  # (5, N, 2)
    gi = gij[..., 0].clamp(0, nx - 1).long()
    gj = gij[..., 1].clamp(0, ny - 1).long()
    txy = gxy[None, :, :] - torch.stack([gi, gj], -1).float()  # (5, N, 2)

    shape = (5, na, n)
    return {
        "m": m,
        "b": targets[None, None, :, 0].long().expand(shape),
        "a": torch.arange(na, device=dev)[None, :, None].expand(shape),
        "gj": gj[:, None, :].expand(shape),
        "gi": gi[:, None, :].expand(shape),
        "txy": txy[:, None, :, :].expand(*shape, 2),
        "twh": gwh[None, None, :, :].expand(*shape, 2),
        "tcls": targets[None, None, :, 1].long().expand(shape),
        "awh": anchors[None, :, None, :].expand(*shape, 2),
    }


def compute_loss(feats, targets, mask, cfg: LossConfig, balance=None, return_per_layer_obj=False):
    """Total detection loss.

    Args:
        feats: nl raw head outputs (bs, na, ny, nx, no), in any float dtype;
            each is gathered first and upcast to f32 after, so a bf16 head
            keeps bf16 cotangents and no f32 copy of the maps is made.
        targets: (B, M, 5) padded per-image labels [cls, x, y, w, h] (normalized).
        mask: (B, M) label validity.
        cfg: LossConfig.
        balance: optional (nl,) per-scale obj weights overriding cfg.balance
            (autobalance).
        return_per_layer_obj: also return the raw per-layer obj losses.

    Returns:
        (total_loss_scaled_by_bs, tensor([lbox, lobj, lcls]) detached[, obj_per_layer])
    """
    dev = feats[0].device
    bs = feats[0].shape[0]
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev).bool()
    B, M, _ = targets.shape
    img_idx = torch.arange(B, dtype=torch.float32, device=dev)[:, None, None].expand(B, M, 1)
    flat = torch.cat([img_idx, targets], -1).reshape(B * M, 6)
    flat_mask = mask.reshape(B * M)

    cp, cn = smooth_bce(cfg.label_smoothing)
    anchors = torch.tensor(cfg.anchors, dtype=torch.float32, device=dev)  # (nl, na, 2)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lbox, lobj, lcls = zero, zero, zero
    obj_per_layer = []
    for i, pi in enumerate(feats):
        _, na, ny, nx, no = pi.shape
        t = assign_targets_layer(flat, flat_mask, anchors[i], ny, nx, cfg.anchor_t)
        valid = t["m"].reshape(-1)  # (K,)
        m = valid.float()
        n_match = m.sum().clamp(min=1.0)

        # predictions at the candidate cells; f32 only after the gather
        flat_idx = ((t["b"].reshape(-1) * na + t["a"].reshape(-1)) * ny + t["gj"].reshape(-1)) * nx \
            + t["gi"].reshape(-1)
        p_flat = pi.reshape(-1, no)
        psel = p_flat[flat_idx].float()  # (K, no)

        # box regression
        pxy = torch.sigmoid(psel[:, 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(psel[:, 2:4]) * 2.0) ** 2 * t["awh"].reshape(-1, 2)
        pbox = torch.cat([pxy, pwh], -1)
        # padding slots carry wh = 0, which makes CIoU's atan(w/h) NaN, and a
        # NaN times a 0 mask still poisons the backward: give them a safe box
        twh_safe = torch.where(valid[:, None], t["twh"].reshape(-1, 2), 1.0)
        tbox = torch.cat([t["txy"].reshape(-1, 2), twh_safe], -1)
        iou = bbox_iou(pbox, tbox, xywh=True, CIoU=True)
        lbox = lbox + ((1.0 - iou) * m).sum() / n_match

        # objectness targets: the last candidate of a cell in flat (5, na, N)
        # order wins; scatter-max its position, then its IoU
        with torch.no_grad():
            iou_d = iou.detach().clamp(min=0.0) * m
            pos = torch.arange(m.shape[0], device=dev)
            cells = bs * na * ny * nx
            winner = torch.full((cells,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
                0, flat_idx, torch.where(valid, pos, -1), "amax")
            is_last = (pos == winner[flat_idx]) & valid
            tobj = torch.zeros((cells,), dtype=torch.float32, device=dev).scatter_reduce_(
                0, flat_idx, torch.where(is_last, iou_d, 0.0), "amax")
        obj_logits = pi[..., 4].reshape(-1).float()
        obj_loss = bce_with_logits(obj_logits, tobj, cfg.obj_pw)
        if cfg.fl_gamma > 0:
            obj_loss = focal_modulation(obj_logits, tobj, obj_loss, cfg.fl_gamma)
        obji = obj_loss.mean()
        obj_per_layer.append(obji.detach())
        w_i = balance[i] if balance is not None else cfg.balance[i]
        lobj = lobj + obji * w_i

        # classification
        if cfg.nc > 1:
            # the targets in the head's dtype, at least f32: a float64 model's are float64, as
            # the JAX package's one_hot gives under x64 (its logits stay f32 there too)
            tc = F.one_hot(t["tcls"].reshape(-1), cfg.nc).to(torch.promote_types(pi.dtype, torch.float32)) \
                * (cp - cn) + cn
            cls_loss = bce_with_logits(psel[:, 5:], tc, cfg.cls_pw)
            if cfg.fl_gamma > 0:
                cls_loss = focal_modulation(psel[:, 5:], tc, cls_loss, cfg.fl_gamma)
            lcls = lcls + (cls_loss * m[:, None]).sum() / (n_match * cfg.nc)

    lbox = lbox * cfg.box
    lobj = lobj * cfg.obj
    lcls = lcls * cfg.cls
    total = (lbox + lobj + lcls) * bs  # the reference scales by the batch size
    comps = torch.stack([lbox, lobj, lcls]).detach()
    if return_per_layer_obj:
        return total, comps, torch.stack(obj_per_layer)
    return total, comps


def update_balance(balance, obj_per_layer, ssi=0):
    """Autobalance EMA of the per-scale obj weights: b_i <- 0.9999 b_i + 0.0001 / obj_i,
    then normalized by the stride-16 scale."""
    new = balance * 0.9999 + 0.0001 / obj_per_layer.clamp(min=1e-6)
    return new / new[ssi]

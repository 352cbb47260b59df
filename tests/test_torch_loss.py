"""The port's loss (ops/boxes.bbox_iou, train/loss.py) against the JAX
package's on the same numpy inputs, in f32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from yolov3_tpu.train import loss as jax_loss
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.boxes import bbox_iou
from yolov3_tpu_torch.train import loss as port_loss

MODES = {"iou": {}, "giou": {"GIoU": True}, "diou": {"DIoU": True}, "ciou": {"CIoU": True}}


def random_boxes(rng, n, xywh):
    xy = rng.uniform(2, 8, size=(n, 2))
    wh = rng.uniform(0.5, 4, size=(n, 2))
    boxes = np.concatenate([xy, wh], -1) if xywh else np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    return boxes.astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False], ids=["xywh", "xyxy"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bbox_iou_matches_jax(mode, xywh):
    """Values at atol 1e-6, and the gradient wrt box1 at atol 1e-5 (CIoU's alpha detached)."""
    rng = np.random.default_rng(0)
    b1, b2 = random_boxes(rng, 64, xywh), random_boxes(rng, 64, xywh)
    b2[:8] = b1[:8]  # identical boxes: IoU 1
    want = jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, **MODES[mode])
    t1 = torch.from_numpy(b1).requires_grad_()
    got = bbox_iou(t1, torch.from_numpy(b2), xywh=xywh, **MODES[mode])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    got.sum().backward()
    g_want = jax.grad(lambda a: jax_bbox_iou(a, jnp.asarray(b2), xywh=xywh, **MODES[mode]).sum())(jnp.asarray(b1))
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g_want), atol=1e-5)


def make_config(nc=4, **kw):
    """The port's and the JAX package's LossConfig for narrowed yolov3 at nc classes."""
    cfg = port_loss.LossConfig.from_model(parse_spec("yolov3", nc=nc), {})
    cfg = dataclasses.replace(cfg, **kw)
    ref = jax_loss.LossConfig.from_model(jax_parse_spec("yolov3", nc=nc), {})
    ref = dataclasses.replace(ref, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)  # same anchors, strides and gains
    assert cfg.balance == ref.balance
    return cfg, ref


def make_labels(rng, B=3, M=10, n_valid=6, nc=4):
    targets = np.zeros((B, M, 5), np.float32)
    targets[:, :n_valid, 0] = rng.integers(0, nc, size=(B, n_valid))
    targets[:, :n_valid, 1:3] = rng.uniform(0.05, 0.95, size=(B, n_valid, 2))
    targets[:, :n_valid, 3:5] = rng.uniform(0.05, 0.6, size=(B, n_valid, 2))
    mask = np.zeros((B, M), bool)
    mask[:, :n_valid] = True
    return targets, mask


def make_feats(rng, cfg, B=3, grids=((8, 12), (4, 6), (2, 3))):
    return [rng.normal(0, 1.5, size=(B, cfg.na, ny, nx, cfg.nc + 5)).astype(np.float32) for ny, nx in grids]


def test_assign_targets_layer_field_by_field():
    rng = np.random.default_rng(1)
    cfg, _ = make_config()
    targets, mask = make_labels(rng)
    B, M, _ = targets.shape
    idx = np.broadcast_to(np.arange(B, dtype=np.float32)[:, None, None], (B, M, 1))
    flat = np.concatenate([idx, targets], -1).reshape(B * M, 6)
    for i, (ny, nx) in enumerate(((8, 12), (4, 6), (2, 3))):
        anchors = np.asarray(cfg.anchors[i], np.float32)
        want = jax_loss.assign_targets_layer(jnp.asarray(flat), jnp.asarray(mask.reshape(-1)),
                                             jnp.asarray(anchors), ny, nx, cfg.anchor_t)
        got = port_loss.assign_targets_layer(torch.from_numpy(flat), torch.from_numpy(mask.reshape(-1)),
                                             torch.from_numpy(anchors), ny, nx, cfg.anchor_t)
        assert set(got) == set(want)
        assert int(np.asarray(want["m"]).sum()) > 0
        for key, w in want.items():
            g = got[key].numpy()
            assert g.shape == w.shape, key
            if np.asarray(w).dtype.kind in "bi":
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
            else:
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, err_msg=key)


def loss_both(cfg, ref, feats, targets, mask, balance=None):
    """(port total, comps, obj_per_layer, grads), (JAX total, comps, obj_per_layer, grads)."""
    ts = [torch.from_numpy(f).requires_grad_() for f in feats]
    bal_t = None if balance is None else torch.from_numpy(balance)
    total, comps, obj = port_loss.compute_loss(ts, targets, mask, cfg, balance=bal_t, return_per_layer_obj=True)
    total.backward()
    got = (float(total.detach()), comps.numpy(), obj.numpy(), [t.grad.numpy() for t in ts])

    bal_j = None if balance is None else jnp.asarray(balance)

    def fn(fs):
        t, c, o = jax_loss.compute_loss(fs, jnp.asarray(targets), jnp.asarray(mask), ref, balance=bal_j,
                                        return_per_layer_obj=True)
        return t, (c, o)

    (t, (c, o)), grads = jax.value_and_grad(fn, has_aux=True)([jnp.asarray(f) for f in feats])
    return got, (float(t), np.asarray(c), np.asarray(o), [np.asarray(g) for g in grads])


def assert_loss_matches(got, want):
    """Value rtol 1e-4, gradient wrt the head maps atol 1e-5."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    for g, w in zip(got[3], want[3]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-5)


CASES = {
    "default": dict(),
    "label_smoothing": dict(label_smoothing=0.1),
    "focal": dict(fl_gamma=1.5),
    "pos_weights": dict(cls_pw=0.7, obj_pw=1.3),
    "nc1": dict(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_loss_matches_jax(case):
    nc = 1 if case == "nc1" else 4
    cfg, ref = make_config(nc=nc, **CASES[case])
    rng = np.random.default_rng(2)
    targets, mask = make_labels(rng, nc=nc)
    got, want = loss_both(cfg, ref, make_feats(rng, cfg), targets, mask)
    assert_loss_matches(got, want)
    assert (got[1][2] == 0.0) == (nc == 1)  # no class loss with a single class


def test_compute_loss_autobalance_matches_jax():
    cfg, ref = make_config(autobalance=True)
    rng = np.random.default_rng(3)
    targets, mask = make_labels(rng)
    balance = np.array([3.0, 1.0, 0.5], np.float32)
    got, want = loss_both(cfg, ref, make_feats(rng, cfg), targets, mask, balance=balance)
    assert_loss_matches(got, want)
    new = port_loss.update_balance(torch.from_numpy(balance), torch.from_numpy(got[2]), ssi=1)
    new_j = jax_loss.update_balance(jnp.asarray(balance), jnp.asarray(want[2]), ssi=1)
    np.testing.assert_allclose(new.numpy(), np.asarray(new_j), rtol=1e-6)
    assert abs(float(new[1]) - 1.0) < 1e-6


def test_compute_loss_two_targets_in_one_cell():
    """Two labels of one image in the same cell with the same anchors matched:
    the objectness target of that cell is the LAST candidate's IoU."""
    cfg, ref = make_config()
    rng = np.random.default_rng(4)
    targets, mask = make_labels(rng, B=2, M=6, n_valid=4)
    # image 0: labels 0 and 1 share a centre cell on every scale, sizes differ a little
    targets[0, 0, 1:] = [0.53, 0.47, 0.30, 0.34]
    targets[0, 1, 1:] = [0.54, 0.48, 0.33, 0.29]
    feats = make_feats(rng, cfg, B=2, grids=((8, 8), (4, 4), (2, 2)))

    flat = np.concatenate([np.repeat(np.arange(2, dtype=np.float32), 6)[:, None], targets.reshape(12, 5)], -1)
    t = port_loss.assign_targets_layer(torch.from_numpy(flat), torch.from_numpy(mask.reshape(-1)),
                                       torch.tensor(cfg.anchors[1]), 4, 4, cfg.anchor_t)
    m = t["m"].reshape(-1)
    cell = (((t["b"] * cfg.na + t["a"]) * 4 + t["gj"]) * 4 + t["gi"]).reshape(-1)[m]
    assert cell.numel() > cell.unique().numel()  # duplicates exist

    got, want = loss_both(cfg, ref, feats, targets, mask)
    assert_loss_matches(got, want)


def test_compute_loss_without_labels_is_finite():
    """All slots padding: wh = 0 everywhere must not reach CIoU's atan as NaN."""
    cfg, ref = make_config()
    rng = np.random.default_rng(5)
    targets = np.zeros((2, 4, 5), np.float32)
    mask = np.zeros((2, 4), bool)
    got, want = loss_both(cfg, ref, make_feats(rng, cfg, B=2), targets, mask)
    assert_loss_matches(got, want)
    assert got[1][0] == 0.0 and got[1][2] == 0.0


def test_compute_loss_bf16_heads_keep_bf16_cotangents():
    """The loss gathers before it upcasts: bf16 head maps get bf16 gradients,
    and the value is the f32 loss of the rounded maps (rtol 1e-4)."""
    cfg, _ = make_config()
    rng = np.random.default_rng(6)
    targets, mask = make_labels(rng)
    feats = make_feats(rng, cfg)
    ts = [torch.from_numpy(f).bfloat16().requires_grad_() for f in feats]
    total, _ = port_loss.compute_loss(ts, targets, mask, cfg)
    total.backward()
    assert total.dtype == torch.float32 and all(t.grad.dtype == torch.bfloat16 for t in ts)
    ref_total, _ = port_loss.compute_loss([t.detach().float() for t in ts], targets, mask, cfg)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-4)


def test_helper_losses_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, size=(5, 7)).astype(np.float32)
    tgt = rng.uniform(0, 1, size=(5, 7)).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(tgt)
    lj, tj = jnp.asarray(logits), jnp.asarray(tgt)
    assert port_loss.smooth_bce(0.1) == jax_loss.smooth_bce(0.1)
    bce_t, bce_j = port_loss.bce_with_logits(lt, tt, 1.3), jax_loss.bce_with_logits(lj, tj, 1.3)
    np.testing.assert_allclose(bce_t.numpy(), np.asarray(bce_j), atol=1e-6)
    for name in ("focal_modulation", "qfocal_modulation"):
        got = getattr(port_loss, name)(lt, tt, bce_t)
        want = getattr(jax_loss, name)(lj, tj, bce_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(port_loss.bce_blur_with_logits(lt, tt)),
                               float(jax_loss.bce_blur_with_logits(lj, tj)), rtol=1e-5)

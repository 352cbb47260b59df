"""The plain version of the greedy-NMS kernel (yolov3_tpu_torch.ops.nms_cuda)
and the port's batched_nms against the JAX package, on the same numpy inputs.

The plain version must EQUAL the Pallas kernel (interpret mode) and the XLA
loop: its rows are copies of input values and the IoU is the same f32
arithmetic. batched_nms is held at the NMS bar of test_parity_reference.py:152-153.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.nms import _greedy_nms
from yolov3_tpu.ops.nms import batched_nms as jax_batched_nms
from yolov3_tpu.ops.nms_pallas import pallas_greedy_nms
from yolov3_tpu_torch.ops.nms import MAX_WH, batched_nms, nms_from_candidates
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain


def make_candidates(rng, B=2, K=256, nc=3, ties=False):
    xy = rng.uniform(50, 600, size=(B, K, 2)).astype(np.float32)
    wh = rng.uniform(10, 80, size=(B, K, 2)).astype(np.float32)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    scores = rng.uniform(0.25, 1.0, size=(B, K)).astype(np.float32)
    if ties:  # runs of equal scores: the lowest index must win each
        scores = np.round(scores * 8) / 8
    scores[:, K // 2:] = -1.0  # invalid tail (as after top-k masking)
    order = np.argsort(-scores, axis=1, kind="stable")
    scores = np.take_along_axis(scores, order, axis=1)
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    cls = rng.integers(0, nc, size=(B, K)).astype(np.float32)
    return boxes + cls[..., None] * np.float32(MAX_WH), boxes, scores, cls


def run_port(fn, args, iou, max_det):
    out, n = fn(*(torch.from_numpy(a) for a in args), iou, max_det)
    return out.numpy(), n.numpy()


def run_xla_loop(args, iou, max_det):
    out, n = jax.vmap(lambda bo, bx, s, c: _greedy_nms(bo, bx, s, c, iou, max_det))(*args)
    return np.asarray(out), np.asarray(n)


CASES = [  # (B, K, max_det, iou, ties)
    (2, 256, 50, 0.5, False),
    (3, 448, 300, 0.45, False),  # the serving candidate count, more slots than detections
    (2, 64, 300, 0.45, True),  # max_det > K; tied scores
    (1, 1, 10, 0.45, False),  # a single candidate
]


@pytest.mark.parametrize("B,K,max_det,iou,ties", CASES)
def test_plain_equals_pallas_interpret(B, K, max_det, iou, ties):
    args = make_candidates(np.random.default_rng(K), B, K, ties=ties)
    out, n = run_port(greedy_nms_plain, args, iou, max_det)
    ref_out, ref_n = pallas_greedy_nms(*args, iou_thres=iou, max_det=max_det, interpret=True)
    np.testing.assert_array_equal(n, np.asarray(ref_n))
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    assert n.dtype == np.int32 and out.shape == (B, max_det, 6)


@pytest.mark.parametrize("B,K,max_det,iou,ties", CASES)
def test_plain_equals_xla_loop(B, K, max_det, iou, ties):
    args = make_candidates(np.random.default_rng(K + 1), B, K, ties=ties)
    out, n = run_port(greedy_nms_plain, args, iou, max_det)
    ref_out, ref_n = run_xla_loop(args, iou, max_det)
    np.testing.assert_array_equal(n, ref_n)
    np.testing.assert_array_equal(out, ref_out)


def test_wrapper_runs_plain_on_cpu():
    args = make_candidates(np.random.default_rng(5))
    launches = greedy_nms.launches
    out, n = run_port(greedy_nms, args, 0.5, 50)
    ref_out, ref_n = run_port(greedy_nms_plain, args, 0.5, 50)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(n, ref_n)
    assert greedy_nms.launches == launches  # the CPU path launches no kernel


def test_empty_pool():
    boxes_off, boxes, scores, cls = make_candidates(np.random.default_rng(0))
    scores[:] = -1.0
    out, n = run_port(greedy_nms_plain, (boxes_off, boxes, scores, cls), 0.5, 20)
    assert (n == 0).all() and (out == 0).all()
    ref_out, _ = pallas_greedy_nms(boxes_off, boxes, scores, cls, iou_thres=0.5, max_det=20, interpret=True)
    np.testing.assert_array_equal(out, np.asarray(ref_out))


def test_tie_order_lowest_index_first():
    """Two identical boxes with equal scores: slot 0 is kept, slot 1 suppressed."""
    box = np.array([[10, 10, 50, 50]], np.float32)
    boxes = np.repeat(box, 3, 0)[None]
    boxes[0, 2] += 200  # a third, disjoint box
    scores = np.array([[0.5, 0.5, 0.5]], np.float32)
    cls = np.array([[1.0, 2.0, 1.0]], np.float32)
    out, n = run_port(greedy_nms_plain, (boxes, boxes, scores, cls), 0.45, 5)
    assert n[0] == 2 and out[0, 0, 5] == 1.0 and out[0, 1, 0] == 210.0


def test_class_offset_keeps_overlapping_classes():
    """Overlapping boxes of different classes survive through nms_from_candidates;
    agnostic NMS suppresses them."""
    boxes = np.array([[[10, 10, 50, 50], [12, 12, 52, 52], [11, 11, 51, 51]]], np.float32)
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    cls = np.array([[0.0, 1.0, 0.0]], np.float32)
    t = [torch.from_numpy(a) for a in (boxes, scores, cls)]
    out, n = nms_from_candidates(*t, iou_thres=0.45, max_det=10)
    assert int(n[0]) == 2 and out[0, :2, 5].tolist() == [0.0, 1.0]
    out, n = nms_from_candidates(*t, iou_thres=0.45, max_det=10, agnostic=True)
    assert int(n[0]) == 1
    from yolov3_tpu.ops.nms import nms_from_candidates as jax_nfc

    ref_out, ref_n = jax_nfc(*(jnp.asarray(a) for a in (boxes, scores, cls)), iou_thres=0.45, max_det=10)
    out, n = nms_from_candidates(*t, iou_thres=0.45, max_det=10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))


def make_prediction(rng, bs=2, n=600, nc=4):
    pred = rng.uniform(0, 1, size=(bs, n, 5 + nc)).astype(np.float32)
    pred[..., :2] *= 640
    pred[..., 2:4] = pred[..., 2:4] * 100 + 5
    return pred


@pytest.mark.parametrize("kw", [
    dict(),
    dict(multi_label=True),
    dict(multi_label=True, conf_thres=0.1, iou_thres=0.6, max_nms=300),
    dict(classes=(0, 2)),
    dict(agnostic=True, max_det=20),
], ids=["single", "multi", "multi-val", "classes", "agnostic"])
def test_batched_nms_matches_jax(kw):
    kw = {"conf_thres": 0.3, "iou_thres": 0.5, "max_det": 100, **kw}
    pred = make_prediction(np.random.default_rng(11))
    ref_out, ref_n = jax_batched_nms(jnp.asarray(pred), **kw)
    out, n = batched_nms(torch.from_numpy(pred), **kw)
    ref_out, ref_n = np.asarray(ref_out), np.asarray(ref_n)
    np.testing.assert_array_equal(n.numpy(), ref_n)
    assert ref_n.min() > 0
    for b, k in enumerate(ref_n):
        np.testing.assert_allclose(out[b, :k, :4].numpy(), ref_out[b, :k, :4], atol=0.1)
        np.testing.assert_allclose(out[b, :k, 4].numpy(), ref_out[b, :k, 4], atol=1e-3)
        np.testing.assert_array_equal(out[b, :k, 5].numpy(), ref_out[b, :k, 5])

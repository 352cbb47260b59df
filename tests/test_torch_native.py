"""The port's host ops of yolov3_tpu/native (yolov3_tpu_torch/native and
`non_max_suppression(engine="native" / "auto")`) against the JAX package's
native library and its XLA NMS, on the CPU, on inputs numpy makes from a seed.

Bars: the greedy NMS rows and counts are exactly equal (the same float32
loop); the letterbox is byte-equal to JAX's native one wherever that equals
cv2, and byte-equal to cv2 (JAX's data letterbox) where JAX's native resize
is off cv2 by one level (the rows an upscale clamps to the image's edge,
tests/test_native.py:97-126).
"""

import numpy as np
import pytest
import torch

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu import native as jax_native
from yolov3_tpu.data.augment import letterbox as jax_letterbox
from yolov3_tpu.ops.nms import MAX_WH
from yolov3_tpu.ops.nms import nms_from_candidates as jax_nms_from_candidates
from yolov3_tpu.ops.nms import non_max_suppression as jax_non_max_suppression
from yolov3_tpu_torch import native
from yolov3_tpu_torch.ops.nms import non_max_suppression
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain

pytestmark = pytest.mark.skipif(not jax_native.available(), reason="the JAX native library needs a C++ compiler")


def random_candidates(rng, bs=3, k=64, nc=5):
    """tests/test_native.py's candidates: boxes, scores with an invalid tail, classes."""
    xy = rng.uniform(0, 600, (bs, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(4, 120, (bs, k, 2)).astype(np.float32)], -1)
    scores = rng.uniform(0.05, 1.0, (bs, k)).astype(np.float32)
    scores[:, -5:] = -1.0
    return boxes, scores, rng.integers(0, nc, (bs, k)).astype(np.float32)


def assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("seed,bs,k,max_det", [(0, 3, 64, 32), (1, 2, 448, 300), (2, 1, 2000, 100)])
def test_greedy_nms_batch_matches_jax(seed, bs, k, max_det):
    """Equal to JAX's native loop and XLA NMS, and to the port's plain NMS (the NMS kernel's reference)."""
    boxes, scores, cls = random_candidates(np.random.default_rng(seed), bs, k)
    off = boxes + (cls * MAX_WH)[..., None]
    got = native.greedy_nms_batch(off, boxes, scores, cls, 0.45, max_det)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32 and got[0].shape == (bs, max_det, 6)
    assert_same(got, jax_native.greedy_nms_batch(off, boxes, scores, cls, 0.45, max_det))
    out_x, n_x = jax_nms_from_candidates(boxes, scores, cls, 0.45, max_det)
    assert_same(got, (np.asarray(out_x), np.asarray(n_x)))
    plain = greedy_nms_plain(*(torch.from_numpy(a) for a in (off, boxes, scores, cls)), 0.45, max_det)
    assert_same(got, tuple(t.numpy() for t in plain))


def test_greedy_nms_tie_break_and_early_exit():
    """Equal scores keep the lower index first; the loop stops at the first score <= 0."""
    boxes = np.tile(np.array([[10, 10, 50, 50]], np.float32), (1, 6, 1)).reshape(1, 6, 4)
    boxes[0, 3:] += 200.0
    scores = np.array([[0.9, 0.9, 0.9, 0.5, -1.0, -1.0]], np.float32)
    cls = np.zeros((1, 6), np.float32)
    cls[0, 1] = 1.0  # the second tie is another class: kept beside the first
    off = boxes + (cls * MAX_WH)[..., None]
    got = native.greedy_nms_batch(off, boxes, scores, cls, 0.45, 8)
    assert got[1][0] == 3 and got[0][0, :3, 5].tolist() == [0.0, 1.0, 0.0]
    assert_same(got, jax_native.greedy_nms_batch(off, boxes, scores, cls, 0.45, 8))
    out_x, n_x = jax_nms_from_candidates(boxes, scores, cls, 0.45, 8)
    assert_same(got, (np.asarray(out_x), np.asarray(n_x)))


def nms_predictions(seed=1, bs=2, n=300, nc=6):
    rng = np.random.default_rng(seed)
    pred = np.zeros((bs, n, 5 + nc), np.float32)
    pred[..., 0:2] = rng.uniform(60, 500, (bs, n, 2))
    pred[..., 2:4] = rng.uniform(8, 90, (bs, n, 2))
    pred[..., 4] = rng.uniform(0, 1, (bs, n))
    pred[..., 5:] = rng.uniform(0, 1, (bs, n, nc))
    return pred


@pytest.mark.parametrize("kw", [{}, {"multi_label": True}, {"agnostic": True}, {"classes": (1, 3)},
                                {"conf_thres": 0.001, "multi_label": True}, {"max_det": 7, "max_nms": 50}],
                         ids=["default", "multi-label", "agnostic", "classes", "val-grade", "caps"])
def test_non_max_suppression_engines_match_jax(kw):
    """engine="native" and "auto" on numpy run the host loop: rows equal to JAX's native and XLA engines."""
    pred = nms_predictions()
    want = jax_non_max_suppression(pred, engine="native", **kw)
    xla = jax_non_max_suppression(pred, engine="xla", **kw)
    for got in (non_max_suppression(pred, engine="native", **kw), non_max_suppression(pred, **kw),
                non_max_suppression(torch.from_numpy(pred), engine="native", **kw)):
        assert len(got) == len(want) == 2
        for g, w, x in zip(got, want, xla):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, x)


def test_non_max_suppression_apriori_labels_native():
    pred = np.zeros((1, 20, 10), np.float32)
    labels = [np.array([[2, 100, 100, 40, 40]], np.float32)]
    got = non_max_suppression(pred, labels=labels, engine="native")
    np.testing.assert_array_equal(got[0], jax_non_max_suppression(pred, labels=labels, engine="native")[0])
    np.testing.assert_array_equal(got[0], jax_non_max_suppression(pred, labels=labels, engine="xla")[0])
    assert len(got[0]) == 1 and int(got[0][0, 5]) == 2


def test_auto_keeps_tensors_and_merge_on_batched_nms(monkeypatch):
    """"auto" sends a tensor, and merge on any input, to batched_nms (the NMS
    kernel's route on the card); only numpy without merge takes the host loop."""
    from yolov3_tpu_torch.ops import nms as nms_mod

    calls = []
    real = nms_mod._host_nms
    monkeypatch.setattr(nms_mod, "_host_nms", lambda *a, **k: calls.append(1) or real(*a, **k))
    pred = nms_predictions(seed=3)
    non_max_suppression(torch.from_numpy(pred), device="cpu")
    non_max_suppression(pred, merge=True, device="cpu")
    non_max_suppression(pred, engine="native", merge=True, device="cpu")
    assert calls == []
    non_max_suppression(pred)
    assert calls == [1]


@pytest.mark.parametrize("shape,kw", [
    ((1080, 810, 3), {}), ((480, 640, 3), {"auto": False}), ((730, 1280, 3), {"scaleup": False}),
    ((1080, 810, 4), {}), ((720, 1280, 4), {"auto": False, "color": (1, 2, 3)}), ((700, 900), {}),
    ((640, 640, 3), {"auto": False})],
    ids=["downscale", "square", "no-scaleup", "bgra", "bgra-colour", "gray", "same-size"])
def test_letterbox_matches_jax_native(shape, kw):
    im = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    got, ratio, pad = native.letterbox(im, 640, **kw)
    want, ratio_j, pad_j = jax_native.letterbox(im, 640, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape and (ratio, pad) == (ratio_j, pad_j)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,kw", [((200, 300, 3), {"scale_fill": True, "auto": False}),
                                      ((123, 457, 3), {"auto": False})], ids=["stretch", "pad"])
def test_letterbox_upscale_is_cv2s(shape, kw):
    """On an upscale the port's letterbox is cv2's (JAX's data letterbox) in
    every byte; JAX's native one is off by one level on the clamped edge rows
    only, which the port does not copy."""
    im = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    got = native.letterbox(im, 640, **kw)[0]
    np.testing.assert_array_equal(got, jax_letterbox(im, 640, **kw)[0])
    d = np.abs(got.astype(int) - jax_native.letterbox(im, 640, **kw)[0])
    assert 0 < d.max() <= 1
    assert native.available()


def test_resize_linear_is_the_pipelines():
    from yolov3_tpu_torch.data import image_ops

    im = np.random.default_rng(6).integers(0, 256, (505, 303, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_linear(im, (202, 212)), image_ops.resize_linear(im, (202, 212)))
    np.testing.assert_array_equal(native.resize_linear(im, (202, 212)), jax_native.resize_linear(im, (202, 212)))

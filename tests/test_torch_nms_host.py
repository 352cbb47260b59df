"""Merge-NMS and the host `non_max_suppression` of the port (ops/nms.py)
against the JAX package's on the same decoded predictions, on the CPU.

JAX side: `batched_nms(merge=True)` and `non_max_suppression(engine="xla")`
on their XLA path. Port side: the same functions through the plain greedy
NMS (a CPU tensor). Bars: n equal, boxes atol 0.1, conf atol 1e-3, classes
equal (tests/test_parity_reference.py:152-153).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.nms import batched_nms as jax_batched_nms
from yolov3_tpu.ops.nms import non_max_suppression as jax_non_max_suppression
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.ops.nms import batched_nms, non_max_suppression

NC = 3


def make_predictions(seed=0, n=4000, n_valid=(150, 4000)):
    """(bs, n, 5+NC) decoded [xywh, obj, cls...]: image b has n_valid[b]
    confident rows, in clusters of three near-duplicates and single isolated
    boxes, so merge averages some boxes and the redundant filter drops others."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((len(n_valid), n, 5 + NC), np.float32)
    for b, k in enumerate(n_valid):
        xy = rng.uniform(0, 640, (n, 2))
        wh = rng.uniform(10, 80, (n, 2))
        groups = k // 2 // 3  # the first 3 * groups rows are clusters of three
        for g in range(groups):
            base = 3 * g
            xy[base + 1:base + 3] = xy[base] + rng.normal(0, 2.0, (2, 2))
            wh[base + 1:base + 3] = wh[base] * rng.uniform(0.95, 1.05, (2, 2))
        pred[b, :, :2], pred[b, :, 2:4] = xy, wh
        pred[b, :, 4] = rng.uniform(0.001, 0.2, n)
        pred[b, :k, 4] = rng.uniform(0.3, 1.0, k)
        pred[b, :, 5:] = rng.uniform(0.0, 1.0, (n, NC))
        pred[b, :k, 5 + rng.integers(0, NC, k)[None]] = 0.0  # spread the best class
        pred[b, np.arange(k), 5 + rng.integers(0, NC, k)] = rng.uniform(0.8, 1.0, k)
    return pred


def assert_dets_match(out, n, ref_out, ref_n):
    np.testing.assert_array_equal(np.asarray(n), np.asarray(ref_n))
    for b, k in enumerate(np.asarray(ref_n)):
        np.testing.assert_allclose(out[b, :k, :4], ref_out[b, :k, :4], atol=0.1)
        np.testing.assert_allclose(out[b, :k, 4], ref_out[b, :k, 4], atol=1e-3)
        np.testing.assert_array_equal(out[b, :k, 5], ref_out[b, :k, 5])
        assert (out[b, k:] == 0).all()


@pytest.mark.parametrize("multi_label", [False, True], ids=["best-class", "multi-label"])
def test_merge_nms_matches_jax(multi_label):
    """Image 0 has 150 candidates (inside the 1 < n < 3000 gate: boxes merged,
    isolated boxes dropped), image 1 has 4000 (outside it: plain greedy rows)."""
    pred = make_predictions()
    kw = dict(conf_thres=0.25, iou_thres=0.45, multi_label=multi_label, max_det=300)
    ref_out, ref_n = (np.asarray(a) for a in jax_batched_nms(jnp.asarray(pred), merge=True, **kw))
    out, n = batched_nms(torch.from_numpy(pred), merge=True, **kw)
    assert_dets_match(out.numpy(), n.numpy(), ref_out, ref_n)

    plain, plain_n = batched_nms(torch.from_numpy(pred), **kw)
    plain, plain_n = plain.numpy(), plain_n.numpy()
    # inside the gate the redundant filter dropped isolated boxes and the merge moved clustered ones
    assert 0 < n[0] < plain_n[0]
    kept = {tuple(r) for r in np.round(plain[0, :plain_n[0], 4:], 6)}
    assert {tuple(r) for r in np.round(out[0, :n[0], 4:].numpy(), 6)} <= kept
    # outside it the rows are the plain greedy rows
    assert n[1] == plain_n[1]
    np.testing.assert_array_equal(out[1].numpy(), plain[1])
    # rows stay valid-first and score-sorted
    for b in range(2):
        conf = out[b, :n[b], 4].numpy()
        assert (conf > 0).all() and (np.diff(conf) <= 0).all()


def test_merge_nms_agnostic_matches_jax():
    pred = make_predictions(seed=3, n=600, n_valid=(120, 40))
    kw = dict(conf_thres=0.25, iou_thres=0.5, agnostic=True, max_det=100)
    ref_out, ref_n = (np.asarray(a) for a in jax_batched_nms(jnp.asarray(pred), merge=True, **kw))
    out, n = batched_nms(torch.from_numpy(pred), merge=True, **kw)
    assert_dets_match(out.numpy(), n.numpy(), ref_out, ref_n)


def make_labels(seed=1, bs=2):
    """Per image [cls, x, y, w, h] in pixels; the second image has none."""
    rng = np.random.default_rng(seed)
    lb = np.concatenate([rng.integers(0, NC, (5, 1)), rng.uniform(100, 500, (5, 2)), rng.uniform(20, 90, (5, 2))], 1)
    return [lb.astype(np.float32)] + [np.zeros((0, 5), np.float32)] * (bs - 1)


@pytest.mark.parametrize("merge", [False, True], ids=["greedy", "merge"])
def test_non_max_suppression_with_labels_matches_jax(merge):
    pred = make_predictions(seed=2, n=800, n_valid=(200, 60))
    labels = make_labels()
    kw = dict(conf_thres=0.3, iou_thres=0.5, multi_label=True, labels=labels, max_det=300, merge=merge)
    want = jax_non_max_suppression(pred, engine="xla", **kw)
    got = non_max_suppression(pred, device="cpu", **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.1)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-3)
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
    if not merge:  # the injected labels come out as confidence-1 detections of their class
        ones = got[0][got[0][:, 4] == 1.0]
        assert len(ones) >= 1 and set(ones[:, 5].astype(int)) <= set(labels[0][:, 0].astype(int))


def test_non_max_suppression_inputs():
    """A tensor, an array and the (inference, train_out) tuple give the same
    lists; without labels it equals batched_nms's valid rows."""
    pred = make_predictions(seed=4, n=300, n_valid=(50, 0))
    out, n = batched_nms(torch.from_numpy(pred))
    for arg in (pred, torch.from_numpy(pred), (pred, None)):
        got = non_max_suppression(arg, device="cpu")
        assert [len(g) for g in got] == n.tolist() and n[1] == 0
        np.testing.assert_array_equal(got[0], out[0, :n[0]].numpy())


def test_non_max_suppression_engines():
    """"native" (and "auto" on numpy) is the host C++ loop, "xla" batched_nms:
    the same rows, equal to JAX's native engine; an unknown engine raises."""
    pred = make_predictions(seed=5, n=50, n_valid=(10, 10))
    with pytest.raises(ValueError, match="engine"):
        non_max_suppression(pred, engine="tensorrt", device="cpu")
    xla = non_max_suppression(pred, engine="xla", device="cpu")
    auto = non_max_suppression(pred, device="cpu")
    native = non_max_suppression(pred, engine="native")
    jax_native = jax_non_max_suppression(pred, engine="native")
    for a, b, c, d in zip(xla, auto, native, jax_native):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(c, d)

"""The slice as a whole: the port's serving path against the JAX package.

1. fused f32 narrow yolov3 with detections planted on the head bias:
   `decode_topk_nhwc` + `nms_from_candidates` of both packages on the same
   weights and uint8 frames; n equal, boxes atol 0.1, conf atol 1e-3
   (test_parity_reference.py:152-153);
2. the overflow flag on a dense 80x80 scene (cf. test_fused_decode.py
   test_overflow_flag_dense_scene_80x80);
3. `build_batched_infer` + `MicroBatcher` on the CPU: shapes, valid-first
   rows, and the full-decode fallback on overflow.
"""

import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.models.detect_head import decode_topk_nhwc as jax_decode_topk_nhwc
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.ops.nms import nms_from_candidates as jax_nms_from_candidates
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detect_head import decode_topk_nhwc
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.nms import nms_from_candidates
from yolov3_tpu_torch.serve import MicroBatcher, build_batched_infer

ROOT = Path(__file__).resolve().parents[1]
IMGSZ = 128
CONF = 0.25


def narrow_yolov3():
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3.yaml").read_text())
    d.update(name="yolov3", width_multiple=0.125, depth_multiple=0.33)
    return d


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.array(v, np.float32)
            for k, v in tree.items()}


def plant(variables, head, gains, deltas, no=85, cls_bump=12.0):
    """bench.py:_plant_detections on numpy variables: scale i's objectness
    kernel column times gains[i], its bias plus deltas[i], class biases +cls_bump."""
    v = to_numpy_tree(variables)
    for i, (g, d) in enumerate(zip(gains, deltas)):
        m = v["params"][head][f"m{i}"]
        m["kernel"][..., 4::no] *= g
        m["bias"][4::no] += d
        b = m["bias"].reshape(-1, no)
        b[:, 5:] += cls_bump
    return v


@pytest.fixture(scope="module")
def planted():
    """(JAX variables with planted detections, spec cfg, uint8 frames)."""
    cfg = narrow_yolov3()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64)
    frames = np.random.default_rng(0).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    x = jnp.asarray(frames, jnp.float32) / 255.0
    head = f"l{len(ref.spec.layers) - 1}"
    fused = ref.fuse()
    feats = jax.jit(fused.serving_module().apply, static_argnames="train")(fused.variables, x, train=False)
    gains, deltas = [], []
    for i, f in enumerate(feats):  # calibrate: ~16/8/2 candidates per image and scale
        f = np.asarray(f, np.float32)
        b0 = np.asarray(ref.variables["params"][head][f"m{i}"]["bias"])[4::85]
        spread = f[..., 4::85] - b0
        g = float(np.clip(2.0 / max(spread.std(), 1e-8), 1.0, 1e6))
        q = np.quantile(g * spread + b0, 1.0 - (16, 8, 2)[i] / spread[0].size)
        gains.append(g)
        deltas.append(float(np.log(CONF / (1 - CONF))) + 0.05 - q)
    return plant(ref.variables, head, gains, deltas), cfg, frames, head


def port_model(variables, cfg):
    model = DetectionModel(parse_spec(cfg)).eval()
    return load_jax_variables(model, variables)


def test_slice_matches_jax(planted):
    variables, cfg, frames, _ = planted
    ref = JaxModel(jax_parse_spec(cfg), variables).fuse()
    x = jnp.asarray(frames, jnp.float32) / 255.0
    feats = jax.jit(ref.serving_module().apply, static_argnames="train")(ref.variables, x, train=False)
    jb, js, jc, jov = jax_decode_topk_nhwc(feats, ref.anchors_px, ref.spec.strides, conf_thres=CONF,
                                           with_overflow=True)
    want, want_n = (np.asarray(a) for a in jax_nms_from_candidates(jb, js, jc))

    fused = port_model(variables, cfg).fuse()
    with torch.no_grad():
        pfeats = fused(torch.from_numpy(frames).float() / 255.0, raw=True)
    pb, ps, pc, pov = decode_topk_nhwc(pfeats, fused.anchors_px, fused.spec.strides, conf_thres=CONF,
                                       with_overflow=True)
    got, got_n = (a.numpy() for a in nms_from_candidates(pb, ps, pc))
    np.testing.assert_array_equal(pov.numpy(), np.asarray(jov))
    assert not pov.any()
    np.testing.assert_array_equal(got_n, want_n)
    assert want_n.min() > 0
    for b, k in enumerate(want_n):
        np.testing.assert_allclose(got[b, :k, :4], want[b, :k, :4], atol=0.1)
        np.testing.assert_allclose(got[b, :k, 4], want[b, :k, 4], atol=1e-3)
        np.testing.assert_array_equal(got[b, :k, 5], want[b, :k, 5])
    assert (got[:, :, 4] > 0).sum(1).tolist() == got_n.tolist()


ANCHORS = np.array([[10, 13], [16, 30], [33, 23]], np.float32)[None]


def test_overflow_flag_dense_scene_80x80():
    rng = np.random.default_rng(0)
    nc, na = 80, 3
    raw = rng.normal(-8.0, 0.5, size=(2, 80, 80, na * (nc + 5))).astype(np.float32)
    flat = raw.reshape(2, -1, nc + 5)
    for b, count in [(0, 400), (1, 20)]:  # image 0: 400 confident cells (> k=256); image 1: 20
        idx = rng.choice(flat.shape[1], size=count, replace=False)
        flat[b, idx, 4] = 4.0
        flat[b, idx, 5 + rng.integers(0, nc)] = 5.0
    jb, js, jc, jov = jax_decode_topk_nhwc([jnp.asarray(raw)], ANCHORS, (8,), k_per_scale=(256,),
                                           conf_thres=CONF, with_overflow=True)
    pb, ps, pc, pov = decode_topk_nhwc([torch.from_numpy(raw)], ANCHORS, (8,), k_per_scale=(256,),
                                       conf_thres=CONF, with_overflow=True)
    assert pov.tolist() == [True, False]
    np.testing.assert_array_equal(pov.numpy(), np.asarray(jov))
    valid = np.asarray(js) > 0
    np.testing.assert_array_equal(ps.numpy() > 0, valid)
    np.testing.assert_allclose(ps.numpy()[valid], np.asarray(js)[valid], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pb.numpy()[valid], np.asarray(jb)[valid], atol=1e-3)
    np.testing.assert_array_equal(pc.numpy()[valid], np.asarray(jc)[valid])


def check_rows(dets, n):
    assert dets.shape[-1] == 6 and n.dtype == np.int32
    for d, k in zip(dets, n):
        assert (d[:k, 4] > 0).all() and (np.diff(d[:k, 4]) <= 0).all()
        assert (d[k:] == 0).all()


def test_batched_infer_and_microbatcher(planted):
    variables, cfg, frames, _ = planted
    infer = build_batched_infer(port_model(variables, cfg))
    dets, n = infer(frames)
    dets = dets.numpy()
    assert dets.shape == (2, 300, 6) and n.shape == (2,) and infer.fallbacks == 0
    check_rows(dets, n)
    assert n.min() > 0

    # a long wait, so the three requests always coalesce into one bucket-4 call
    batcher = MicroBatcher(infer, max_batch=4, batch_wait_ms=2000.0)
    out = [None] * 3
    frames3 = np.concatenate([frames, frames[:1]])
    dets4, n4 = infer(np.concatenate([frames3, frames3[-1:]]))  # the padded batch it runs

    def submit(i):
        out[i] = batcher.submit(frames3[i])

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert batcher.requests == 3 and batcher.calls == 1
    for i, (d, k) in enumerate(out):
        assert k == n4[i] and d.shape == (k, 6)
        np.testing.assert_array_equal(d, dets4[i, :k].numpy())


def test_fallback_on_overflow(planted):
    variables, cfg, frames, head = planted
    dense = to_numpy_tree(variables)
    # every scale-0 cell is a candidate: 768 at 128 px, over its top-k of 256
    dense["params"][head]["m0"]["bias"][4::85] += 10.0
    model = port_model(dense, cfg)
    infer = build_batched_infer(model)
    _, _, overflow = infer.fast_fn(frames)
    assert overflow.all()
    dets, n = infer(frames)
    assert infer.fallbacks == 1
    full, full_n = infer.full_fn(frames)
    np.testing.assert_array_equal(dets.numpy(), full.numpy())
    np.testing.assert_array_equal(np.asarray(n), full_n.numpy())
    check_rows(dets.numpy(), np.asarray(n))
    assert np.asarray(n).min() > 0

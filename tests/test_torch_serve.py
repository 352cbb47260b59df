"""The slice as a whole: the port's serving path against the JAX package,
for each published configuration (yolov3, yolov3-spp, yolov3-tiny; narrowed
as tests/test_torch_model.py narrows them).

1. fused f32 models with detections planted on the head bias:
   `decode_topk_nhwc` + `nms_from_candidates` of both packages on the same
   weights and uint8 frames; n equal, boxes atol 0.1, conf atol 1e-3
   (test_parity_reference.py:152-153);
2. the overflow flag on a dense 80x80 scene (cf. test_fused_decode.py
   test_overflow_flag_dense_scene_80x80);
3. `build_batched_infer` + `MicroBatcher` on the CPU: shapes, valid-first
   rows, the fast path with its serving cast off against the JAX decode and
   NMS at the same bars, and the full-decode fallback on overflow, whose
   full path is held to the JAX package's (`build_batched_infer(...).full_jit`).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.models.detect_head import decode_topk_nhwc as jax_decode_topk_nhwc
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.ops.nms import nms_from_candidates as jax_nms_from_candidates
from yolov3_tpu.serve import build_batched_infer as jax_build_batched_infer
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from torch_narrow import narrow_cfg
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detect_head import decode_topk_nhwc
from yolov3_tpu_torch.models.detection import DetectionModel, optimize_for_inference
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.nms import nms_from_candidates
from yolov3_tpu_torch.serve import MicroBatcher, build_batched_infer

IMGSZ = 128
CONF = 0.25
FAMILY = ("yolov3", "yolov3-spp", "yolov3-tiny")


def narrow_yolov3():
    return narrow_cfg("yolov3")


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


def plant_calibrated(cfg):
    """(JAX variables with planted detections, spec cfg, uint8 frames, head
    name): ~16 / 8 / 2 candidates an image at head levels 0 / 1 / 2,
    calibrated on the port's fused f32 head (the same weights)."""
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64)
    frames = np.random.default_rng(0).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    head = f"l{len(ref.spec.layers) - 1}"
    no = ref.spec.nc + 5
    with torch.no_grad():
        feats = port_model(ref.variables, cfg).fuse()(torch.from_numpy(frames).float() / 255.0, raw=True)
    gains, deltas = [], []
    for i, f in enumerate(feats):
        f = f.numpy()
        b0 = np.asarray(ref.variables["params"][head][f"m{i}"]["bias"])[4::no]
        spread = f[..., 4::no] - b0
        g = float(np.clip(2.0 / max(spread.std(), 1e-8), 1.0, 1e6))
        q = np.quantile(g * spread + b0, 1.0 - (16, 8, 2)[i] / spread[0].size)
        gains.append(g)
        deltas.append(float(np.log(CONF / (1 - CONF))) + 0.05 - q)
    return plant(ref.variables, head, gains, deltas, no=no), cfg, frames, head


@pytest.fixture(scope="module")
def planted():
    """yolov3's planted weights (tests/test_torch_layout.py's fixture)."""
    return plant_calibrated(narrow_yolov3())


@pytest.fixture(scope="module", params=FAMILY)
def family(request):
    """Each configuration's planted weights, and the JAX fused f32 decode and
    NMS of its frames: (variables, cfg, frames, head, (dets, n, overflow))."""
    variables, cfg, frames, head = plant_calibrated(narrow_cfg(request.param))
    ref = JaxModel(jax_parse_spec(cfg), variables).fuse()
    x = jnp.asarray(frames, jnp.float32) / 255.0
    feats = jax.jit(ref.serving_module().apply, static_argnames="train")(ref.variables, x, train=False)
    jb, js, jc, jov = jax_decode_topk_nhwc(feats, ref.anchors_px, ref.spec.strides, conf_thres=CONF,
                                           with_overflow=True)
    want, want_n = (np.asarray(a) for a in jax_nms_from_candidates(jb, js, jc))
    return variables, cfg, frames, head, (want, want_n, np.asarray(jov))


def port_model(variables, cfg):
    model = DetectionModel(parse_spec(cfg)).eval()
    return load_jax_variables(model, variables)


def assert_rows_match(got, got_n, want, want_n):
    """n equal; per image the first n rows within boxes 0.1, conf 1e-3, classes equal."""
    np.testing.assert_array_equal(got_n, want_n)
    assert want_n.min() > 0
    for b, k in enumerate(want_n):
        np.testing.assert_allclose(got[b, :k, :4], want[b, :k, :4], atol=0.1)
        np.testing.assert_allclose(got[b, :k, 4], want[b, :k, 4], atol=1e-3)
        np.testing.assert_array_equal(got[b, :k, 5], want[b, :k, 5])


def test_slice_matches_jax(family):
    variables, cfg, frames, _, (want, want_n, jov) = family
    fused = port_model(variables, cfg).fuse()
    with torch.no_grad():
        pfeats = fused(torch.from_numpy(frames).float() / 255.0, raw=True)
    assert len(pfeats) == fused.spec.nl == (2 if cfg["name"] == "yolov3-tiny" else 3)
    pb, ps, pc, pov = decode_topk_nhwc(pfeats, fused.anchors_px, fused.spec.strides, conf_thres=CONF,
                                       with_overflow=True)
    got, got_n = (a.numpy() for a in nms_from_candidates(pb, ps, pc))
    np.testing.assert_array_equal(pov.numpy(), jov)
    assert not pov.any()
    assert_rows_match(got, got_n, want, want_n)
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


def test_batched_infer_and_microbatcher(family, monkeypatch):
    variables, cfg, frames, _, (want, want_n, _) = family
    infer = build_batched_infer(port_model(variables, cfg))
    dets, n = infer(frames)
    dets = dets.numpy()
    assert dets.shape == (2, 300, 6) and n.shape == (2,) and infer.fallbacks == 0
    check_rows(dets, n)
    assert n.min() > 0

    # the fast path in float32 (its serving cast off) against the JAX decode and NMS: the bf16 forwards
    # round apart across the packages (tests/test_torch_serve_pipeline.py::test_pipeline_matches_jax)
    import yolov3_tpu_torch.serve as port_serve

    with monkeypatch.context() as m:
        m.setattr(port_serve, "optimize_for_inference",
                  lambda model, bf16=None: optimize_for_inference(model, bf16=False))
        f32_infer = build_batched_infer(port_model(variables, cfg))
    f32_dets, f32_n = f32_infer(frames)
    assert f32_infer.serving_model.dtype == torch.float32 and f32_infer.fallbacks == 0
    assert_rows_match(f32_dets.numpy(), np.asarray(f32_n), want, want_n)

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


def test_fallback_on_overflow(family):
    variables, cfg, frames, head, _ = family
    no = cfg.get("nc", 80) + 5
    dense = to_numpy_tree(variables)
    # every level-0 cell is a candidate: 768 (yolov3, -spp) or 192 (tiny, stride 16) at 128 px, over a
    # level-0 top-k of 128
    dense["params"][head]["m0"]["bias"][4::no] += 10.0
    k_per_scale = (128, 64, 32)
    model = port_model(dense, cfg)
    infer = build_batched_infer(model, k_per_scale=k_per_scale)
    _, _, overflow = infer.fast_fn(frames)  # (B, nl): a flag per image and level
    assert overflow[:, 0].all()
    dets, n = infer(frames)
    assert infer.fallbacks == 1 and infer.level_overflows[0] == 1
    full, full_n = infer.full_fn(frames)
    np.testing.assert_array_equal(dets.numpy(), full.numpy())
    np.testing.assert_array_equal(np.asarray(n), full_n.numpy())
    check_rows(dets.numpy(), np.asarray(n))
    assert np.asarray(n).min() > 0

    # the fallback's full path (float32 forward, full decode, batched NMS) against the JAX package's on
    # the planted weights, whose detections are not ties of a saturated score
    jax_full = jax_build_batched_infer(JaxModel(jax_parse_spec(cfg), jax.tree.map(jnp.asarray, variables)),
                                       k_per_scale=k_per_scale).full_jit
    want, want_n = (np.asarray(a) for a in jax_full(frames))
    got, got_n = (a.numpy() for a in build_batched_infer(port_model(variables, cfg)).full_fn(frames))
    assert_rows_match(got, got_n, want, want_n)

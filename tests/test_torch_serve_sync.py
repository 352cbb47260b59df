"""The model's anchor table: float32, on the model's device, built once.

`DetectionModel.anchor_table()` is the one owner of the (nl, na, 2) pixel
anchors every decode of the port reads: the served step (one table a
distinct replica model, read when the path is built), the validator's
forward, `predict`, `predict_augmented` and `bf16_deltas`. A copy from the
host in every batch's decode would make the host wait there for the queued
forward (it ends in a stream synchronisation).

On the CPU: each decode gives the same bits with the table as a tensor as
with the numpy `anchors_px` (the plain and padded NHWC layouts, the 5-D
head, `decode_predictions`), `_anchor_table` only reshapes such a tensor;
the table across every way a model is built (from a config, fused, the
inference form, the benchmark's meta build, a mesh replica, new anchors),
never part of the state dict and usable by a grad-recording decode when
first built under `inference_mode`; `infer` and the other entry points hand
the decode the same tensor on every call, the full path of a fallback batch
included; and `build_batched_infer` keeps a fused float32 model float32. On
a card (skipped without one): the fast path of yolov3 and yolov3-tiny, and
the validator's forward and decode, run under
`torch.cuda.set_sync_debug_mode("error")`, and the fast path's decode gives
the same bits with either table.

The file imports no JAX. On a card, from the repository's root
(`--noconftest` keeps tests/conftest.py, which imports JAX, out):

    python -m pytest tests/test_torch_serve_sync.py -q --noconftest
"""


import numpy as np
import pytest
import torch

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from torch_narrow import narrow_cfg
from yolov3_tpu_torch.models import detect_head
from yolov3_tpu_torch.models.detect_head import (PAD_BIAS, decode_predictions, decode_topk_candidates,
                                                 decode_topk_nhwc)
from yolov3_tpu_torch.eval.validator import make_forward
from yolov3_tpu_torch.models.detection import DetectionModel, optimize_for_inference, predict_augmented
from yolov3_tpu_torch.parallel.mesh import Mesh
from yolov3_tpu_torch.serve import build_batched_infer
from yolov3_tpu_torch.train.loop import _with_new_anchors
from yolov3_tpu_torch.utils.checks import bf16_deltas

CONF = 0.25
NC, NA = 3, 3
NO = NC + 5
STRIDES = (8, 16, 32)
ANCHORS_PX = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]],
                      np.float32).reshape(3, NA, 2)  # yolov3's: 373 is not exact in bf16


def raw_maps(layout, size=16, bs=2, seed=0):
    """Seeded head outputs of three levels (size, size / 2, size / 4 cells a side) in `layout`: "nhwc"
    (B, ny, nx, na*no), "padded" (B, ny, nx, na*16, pad lanes at the head's -20) or "5d" (B, na, ny, nx,
    no). Logits around -1, so a share of the cells passes CONF at every level."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(len(STRIDES)):
        n = size >> i
        t = torch.randn((bs, n, n, NA, NO), generator=g) * 2.0 - 1.0
        if layout == "padded":
            t = torch.cat([t, torch.full((bs, n, n, NA, 16 - NO), PAD_BIAS)], -1)
        out.append(t.permute(0, 3, 1, 2, 4).contiguous() if layout == "5d" else t.reshape(bs, n, n, -1))
    return out


def decode(layout, feats, anchors):
    kw = dict(k_per_scale=(64, 32, 16), conf_thres=CONF, with_overflow=True)
    if layout == "nhwc":
        return decode_topk_nhwc(feats, anchors, STRIDES, **kw)
    if layout == "padded":
        return decode_topk_nhwc(feats, anchors, STRIDES, padded_lanes=16, **kw)
    if layout == "5d":
        return decode_topk_candidates(feats, anchors, STRIDES, **kw)
    return (decode_predictions(feats, anchors, STRIDES),)


@pytest.mark.parametrize("layout", ["nhwc", "padded", "5d", "full"])
def test_tensor_table_equals_numpy_table(layout):
    feats = raw_maps("5d" if layout == "full" else layout)
    want = decode(layout, feats, ANCHORS_PX)
    got = decode(layout, feats, torch.as_tensor(ANCHORS_PX))
    assert len(got) == len(want) == (1 if layout == "full" else 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if layout != "full":
        assert (got[1] > 0).sum() > 0  # candidates at the decoded rows


def test_anchor_table_reshapes_a_device_table_and_converts_the_rest():
    table = torch.tensor(ANCHORS_PX.reshape(3, -1))
    t = detect_head._anchor_table(table, 3, table.device)
    assert t.shape == (3, NA, 2) and t.data_ptr() == table.data_ptr()
    for other in (ANCHORS_PX, ANCHORS_PX.tolist(), table.double()):  # numpy, a list, another dtype: converted
        c = detect_head._anchor_table(other, 3, torch.device("cpu"))
        assert c.dtype == torch.float32 and c.shape == (3, NA, 2) and c.data_ptr() != table.data_ptr()
        assert torch.equal(c, t)


def spy_tables(monkeypatch):
    """The anchors each decode of the port is handed, in order."""
    seen = []
    real = detect_head._anchor_table

    def spy(anchors, nl, device):
        seen.append(anchors)
        return real(anchors, nl, device)

    monkeypatch.setattr(detect_head, "_anchor_table", spy)
    return seen


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "mesh2"])
@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_infer_hands_the_decode_a_device_table(name, sharded, monkeypatch):
    seen = spy_tables(monkeypatch)
    model = DetectionModel.from_config(narrow_cfg(name), seed=0, device="cpu")
    mesh = Mesh((torch.device("cpu"),) * 2) if sharded else None
    infer = build_batched_infer(model, CONF, k_per_scale=(32, 16, 8), mesh=mesh)
    assert seen == []
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    for _ in range(3):
        infer(frames)
    assert infer.fallbacks == 0
    replicas = 2 if sharded else 1
    assert len(seen) == 3 * replicas

    # one fallback batch: every level-0 cell of the fast path's serving model a candidate, over a top-k of 32
    with torch.no_grad():
        b = infer.serving_model.model[-1].m[0].bias.view(NA, -1)
        b[:, 4:] += 20.0
    infer(frames)
    assert infer.fallbacks == 1
    assert len(seen) == 5 * replicas  # the fast path's decodes, then the full path's, a shard each

    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32 and a.device == model.device
               for a in seen)
    models = {id(m) for m in (mesh.replicas(model) if sharded else [model])}
    tables = {a.data_ptr() for a in seen}
    assert len(tables) == len(models) == 1  # one table a distinct replica model: two CPU shards share the model
    assert seen[0] is model.anchor_table()
    np.testing.assert_array_equal(seen[0].numpy(), model.anchors_px)


def meta_build(model):
    """h100bench/harness/program.py's build of the program's model: on `meta`, then `to_empty` and a strict
    `load_state_dict` of the weights."""
    with torch.device("meta"):
        m = DetectionModel(model.spec)
    m.to_empty(device=model.device)
    m.load_state_dict(model.state_dict(), strict=True)
    return m.to(memory_format=torch.channels_last).eval()


ROUTES = {
    "from_config": lambda m: m,
    "fuse": lambda m: m.fuse(),
    "optimize_for_inference": lambda m: optimize_for_inference(m, bf16=True),
    "meta_to_empty": meta_build,
    "mesh_replica": lambda m: Mesh((torch.device("cpu"), torch.device("cpu", 0))).replicas(m)[1],
    "new_anchors": lambda m: _with_new_anchors(m, m.anchors_px * 1.5),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_anchor_table_across_build_routes(route):
    """Whichever way a model is built (its source's table built first, so a copy carries it), its table is
    the float32 `anchors_px` on its device, one tensor, and no part of its state dict."""
    src = DetectionModel.from_config(narrow_cfg("yolov3"), seed=0, device="cpu")
    src.anchor_table()
    model = ROUTES[route](src)
    if route == "mesh_replica":
        assert model is not src
    table = model.anchor_table()
    assert table.dtype == torch.float32 and table.device == model.device and table.shape == (3, NA, 2)
    np.testing.assert_array_equal(table.numpy(), model.anchors_px)  # 373 kept: not rounded with a bf16 model
    assert model.anchor_table() is table
    assert all(v.data_ptr() != table.data_ptr() for v in model.state_dict().values())
    assert all(b is not table for b in model.buffers())
    if route == "new_anchors":
        np.testing.assert_array_equal(table.numpy(), ANCHORS_PX * 1.5)


def test_anchor_table_first_built_under_inference_mode_serves_a_grad_decode():
    model = DetectionModel.from_config(narrow_cfg("yolov3-tiny"), seed=0, device="cpu")
    with torch.inference_mode():
        first = model.anchor_table()
    assert not first.is_inference()
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    decode_predictions(model(x), model.anchor_table(), model.spec.strides).sum().backward()
    assert model.anchor_table() is first and model.model[-1].m[0].weight.grad is not None


@pytest.mark.parametrize("entry", ["validator", "validator_half", "predict", "predict_augmented", "bf16_deltas"])
def test_entry_points_hand_the_decode_the_models_table(entry, monkeypatch):
    """Each entry point hands every decode of two calls one float32 tensor on the device: nothing is built
    or copied per call. The validator's half path reads its bf16 model's own table."""
    seen = spy_tables(monkeypatch)
    model = DetectionModel.from_config(narrow_cfg("yolov3"), seed=0, device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    x = imgs.float() / 255.0
    if entry.startswith("validator"):
        forward = make_forward(model, half=entry == "validator_half", decode_only=True)
        call = lambda: forward(imgs)
    else:
        call = {"predict": lambda: model.predict(x), "predict_augmented": lambda: predict_augmented(model, x),
                "bf16_deltas": lambda: bf16_deltas(model, imgsz=64)}[entry]
    with torch.no_grad():
        call()
        call()
    per_call = {"validator": 1, "validator_half": 1, "predict": 1, "predict_augmented": 3, "bf16_deltas": 2}[entry]
    assert len(seen) == 2 * per_call
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32 and a.device == model.device
               for a in seen)
    assert len({id(a) for a in seen}) == 1
    np.testing.assert_array_equal(seen[0].numpy(), model.anchors_px)
    if entry != "validator_half":
        assert seen[0] is model.anchor_table()


def test_batched_infer_keeps_a_fused_float32_model():
    """A fused float32 model (a fused checkpoint loads as one) stays float32: the served step's bf16 model is
    a copy, and the full path is the float32 forward, as an unfused copy's."""
    unfused = DetectionModel.from_config(narrow_cfg("yolov3-tiny"), seed=0, device="cpu")
    with torch.no_grad():  # candidates at every level
        for conv in unfused.model[-1].m:
            conv.bias.view(NA, -1)[:, 4:] += 8.0
    fused = unfused.fuse()
    infer = build_batched_infer(fused, CONF, k_per_scale=(32, 16, 8))
    assert fused.dtype == torch.float32 and infer.serving_model is not fused
    assert infer.serving_model.dtype == torch.bfloat16
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    dets, n = infer.full_fn(frames)
    want, want_n = build_batched_infer(unfused, CONF, fast=False)(frames)
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    assert n.min() > 0
    np.testing.assert_allclose(dets.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)  # the fold's rounding


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_fast_path_makes_the_host_wait_nowhere(card, name):
    """The served step at its published widths, batch 4 at 320 px, uint8 on the card: `infer.fast_fn`
    raises under sync debug mode "error" if any of its ops synchronises with the host."""
    model = DetectionModel.from_config(name, seed=0, device=card)
    infer = build_batched_infer(model)
    with torch.no_grad():  # candidates at every level, so K2, the sort, the gathers and K1 see real rows
        for conv in infer.serving_model.model[-1].m:
            conv.bias.view(model.spec.na, -1)[:, 4:] += 8.0
    imgs = torch.randint(0, 256, (4, 320, 320, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    imgs = imgs.to(card)
    want = infer.fast_fn(imgs)  # builds the kernels, and cuDNN's plans, outside the checked call
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = infer.fast_fn(imgs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 0

    # the decode with the numpy table (a copy from the host each call) gives the same bits
    with torch.inference_mode():
        feats = infer.serving_model(imgs.to(torch.bfloat16) / 255.0, raw=True)
        on_card = decode_topk_nhwc(feats, torch.as_tensor(model.anchors_px, device=card), model.spec.strides,
                                   with_overflow=True)
        from_host = decode_topk_nhwc(feats, model.anchors_px, model.spec.strides, with_overflow=True)
    for g, w in zip(on_card, from_host):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_val_forward_makes_the_host_wait_nowhere(card, name):
    """The validator's float32 forward and decode (`make_forward(decode_only=True)`) on a batch of uint8
    images already on the card raise under sync debug mode "error" if an op synchronises with the host (a
    copy of the numpy anchors in the decode did)."""
    model = DetectionModel.from_config(name, seed=0, device=card)
    forward = make_forward(model, decode_only=True)
    imgs = torch.randint(0, 256, (4, 320, 320, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    imgs = imgs.to(card)
    want = forward(imgs)  # cuDNN's plans and the table, outside the checked call
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = forward(imgs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)

"""The served step's anchor table, built once per replica on its device.

`serve.build_batched_infer` copies each replica's anchor table to that
replica's device when the path is built, so nothing in the fast path between
the copy-in and the fetch makes the host wait on the device (a copy from the
host in every batch's decode did: it ends in a stream synchronisation).

On the CPU: each decode gives the same bits with the table as a tensor as
with the numpy `anchors_px` (the plain and padded NHWC layouts, the 5-D
head, `decode_predictions`), `_anchor_table` only reshapes such a tensor,
and `infer` hands the decode a tensor on every call, the full path of a
fallback batch included, one table a replica. On a card (skipped without
one): the fast path of yolov3 and yolov3-tiny runs under
`torch.cuda.set_sync_debug_mode("error")`, and its decode gives the same
bits with either table.

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
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.parallel.mesh import Mesh
from yolov3_tpu_torch.serve import build_batched_infer

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


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "mesh2"])
@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_infer_hands_the_decode_a_device_table(name, sharded, monkeypatch):
    seen = []
    real = detect_head._anchor_table

    def spy(anchors, nl, device):
        seen.append(anchors)
        return real(anchors, nl, device)

    monkeypatch.setattr(detect_head, "_anchor_table", spy)
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
    tables = {a.data_ptr() for a in seen}
    assert len(tables) == replicas  # built once a replica, at build time
    np.testing.assert_array_equal(seen[0].numpy(), model.anchors_px)


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

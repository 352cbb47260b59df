"""The served path of a model of any number of head levels: the top-k sized
to the input, the per-level overflow counter, the NMS kernel's launches by
route, and the P6 model by name.

- `build_pipeline` (and through it `make_server` and `serve`) gives level i
  a top-k of max(64, (256 >> i) * max(1, imgsz // 640)): (256, 128, 64) at
  640 px and below, as before, and (512, 256, 128, 64) for YOLOv5x6 at
  1280 px.
- `infer.level_overflows[i]` counts the batches that overflowed at level i,
  carried in the fast path's one fetch; `/health` reports it beside
  `greedy_nms.route_launches`.
- `greedy_nms.route_launches` counts K1's launches by route: on the CPU the
  route of K = 960 (yolov5x6-serve-b16's candidates a batch) is resolved
  from csrc/nms.cu's limits; on a card (skipped without one) a launch at
  K = 960 is counted under the shared-memory route.

The file imports no JAX. On a card, from the repository's root
(`--noconftest` keeps tests/conftest.py, which imports JAX, out):

    python -m pytest tests/test_torch_serve_levels.py -q --noconftest
"""

import json
import re
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from torch_narrow import narrow_cfg
from yolov3_tpu_torch import serve
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.ops.nms_cuda import ROUTES, greedy_nms

NMS_CU = Path(__file__).resolve().parents[1] / "yolov3_tpu_torch/csrc/nms.cu"
IMGSZ = 128


def narrow_model(name, bump_level=None):
    """The narrow `name` on the CPU; `bump_level`: that level's objectness and class biases raised by 10, so
    every one of its anchors is a candidate."""
    model = DetectionModel.from_config(narrow_cfg(name), seed=0, device="cpu")
    if bump_level is not None:
        with torch.no_grad():
            model.model[-1].m[bump_level].bias.view(model.spec.na, -1)[:, 4:] += 10.0
    return model


def frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, IMGSZ, IMGSZ, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,imgsz,want", [
    ("yolov5x6", 1280, (512, 256, 128, 64)),
    ("yolov5x6", 640, (256, 128, 64, 64)),
    ("yolov3", 640, (256, 128, 64)),
    ("yolov3", 320, (256, 128, 64)),
    ("yolov3-tiny", 640, (256, 128)),
])
def test_pipeline_topk_sized_to_the_input(monkeypatch, name, imgsz, want):
    seen = {}
    real = serve.build_batched_infer

    def spy(model, *args, **kwargs):
        seen["k"] = tuple(kwargs["k_per_scale"])
        return real(model, *args, **kwargs)

    monkeypatch.setattr(serve, "build_batched_infer", spy)
    serve.build_pipeline(narrow_model(name), imgsz=imgsz, fast=True)
    assert seen["k"] == want


def test_load_weights_builds_yolov5x6():
    from yolov3_tpu_torch.models.loading import load_weights

    model = load_weights("yolov5x6", device="cpu")
    assert model.spec.name == "yolov5x6" and model.num_params() == 140_794_780
    assert model.spec.strides == (8, 16, 32, 64)


def test_level_overflows_count_p6_alone():
    model = narrow_model("yolov5x6", bump_level=3)  # P6: 2 x 2 cells x 3 anchors = 12 candidates at 128 px
    # every other level's top-k holds all its anchors, so only P6's k of 4 can overflow
    infer = serve.build_batched_infer(model, k_per_scale=(768, 192, 48, 4))
    x = frames(2)
    _, _, overflow = infer.fast_fn(x)
    assert overflow.shape == (2, 4) and overflow[:, 3].all() and not overflow[:, :3].any()
    for _ in range(2):
        dets, n = infer(x)
    assert infer.fallbacks == 2 and infer.level_overflows == [0, 0, 0, 2]
    full, full_n = infer.full_fn(x)
    np.testing.assert_array_equal(dets.numpy(), full.numpy())
    np.testing.assert_array_equal(np.asarray(n), full_n.numpy())


def route_of(K):
    """greedy_nms_route(K) of csrc/nms.cu, from the limits the source sets."""
    src = NMS_CU.read_text()
    reg, on_chip = (int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                    for name in ("REG_MAX_K", "ON_CHIP_MAX_K"))
    return 1 if K <= reg else (2 if K <= on_chip else 3)


def test_route_names_resolve():
    assert set(greedy_nms.route_launches) == set(ROUTES.values())
    assert route_of(sum(serve.topk_per_level(4, 1280))) == 2  # K = 960: candidates in shared memory
    assert (route_of(448), route_of(30000)) == (1, 3)  # yolov3-serve-b32's K and validation's
    assert "shared memory" in ROUTES[route_of(960)]


def test_health_reports_the_counters(tmp_path):
    model = narrow_model("yolov5x6", bump_level=0)  # P3 overflows its top-k of 256 on every frame
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = save_checkpoint(tmp_path / "best", {"model": model.state_dict()}, spec=model.spec)
    server = serve.make_server(ckpt, host="127.0.0.1", port=0, imgsz=IMGSZ, max_batch=1, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        serve.RemoteModel(url)(frames(1)[0])
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    infer = server.predict.batcher.infer
    counters = health["counters"]
    assert counters["infer.fallbacks"] == infer.fallbacks >= 2  # the warm-up and the request
    assert counters["infer.level_overflows"] == infer.level_overflows == [infer.fallbacks, 0, 0, 0]
    assert counters["greedy_nms.launches"] == greedy_nms.launches
    assert counters["greedy_nms.route_launches"] == greedy_nms.route_launches


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda", 0)


def test_route_launches_count_shared_memory_at_k960(card):
    B, K = 16, 960
    g = torch.Generator(device=card).manual_seed(0)
    xy = torch.rand((B, K, 2), generator=g, device=card) * 1200
    boxes = torch.cat([xy, xy + 8 + torch.rand((B, K, 2), generator=g, device=card) * 64], -1)
    scores = torch.rand((B, K), generator=g, device=card)
    cls_ids = torch.randint(0, 80, (B, K), generator=g, device=card).float()
    off = boxes + cls_ids[..., None] * 4096
    before = dict(greedy_nms.route_launches)
    out, n = greedy_nms(off, boxes, scores, cls_ids)
    torch.cuda.synchronize(card)
    assert greedy_nms.last_route == ROUTES[2]
    assert {k: v - before[k] for k, v in greedy_nms.route_launches.items()} == \
        {ROUTES[1]: 0, ROUTES[2]: 1, ROUTES[3]: 0}
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain

    want, want_n = greedy_nms_plain(off, boxes, scores, cls_ids)
    assert torch.equal(n, want_n) and torch.equal(out, want)

"""The port's serving surface (serve.py) against the JAX package's, on the CPU.

1. `build_pipeline(fast=True)` (weights kept in float32, see the test)
   and `(fast=False)` of both packages on the same narrowed yolov3
   (weights carried across with models.convert, detections planted on the
   head bias) and the same BGR frames of three sizes: letterbox,
   micro-batched infer, scale-back. Per frame n equal, boxes atol 0.1 px,
   conf atol 1e-3, classes equal.
2. The HTTP server: `make_server(port=0, device="cpu")` over a port
   checkpoint directory, `RemoteModel` and raw requests with npy and PNG
   bodies, `/health`'s counts, 400 for a body that does not decode, 404 for
   an unknown path; every answer equal to the in-process predict within
   JSON's rounding to 4 places.
3. What is not ported raises: `mesh`, `shard`, a reference `.pt`.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_torch_serve import narrow_yolov3, port_model, to_numpy_tree

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.serve import build_pipeline as jax_build_pipeline
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox
from yolov3_tpu_torch.serve import RemoteModel, build_batched_infer, build_pipeline, make_server
from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

IMGSZ = 128
CONF = 0.25
SIZES = ((100, 150), (128, 128), (150, 90))  # (h, w): landscape, square, portrait


def plant_gap(variables, head, gains, deltas, no=85):
    """Scale i's objectness kernel column times gains[i] and its bias plus
    deltas[i]; class 0's bias +12 and every other class's -12, so each
    detection's class is 0 beyond doubt and conf = obj * ~1."""
    v = to_numpy_tree(variables)
    for i, (g, d) in enumerate(zip(gains, deltas)):
        m = v["params"][head][f"m{i}"]
        m["kernel"][..., 4::no] *= g
        m["bias"][4::no] += d
        b = m["bias"].reshape(-1, no)
        b[:, 5] += 12.0
        b[:, 6:] -= 12.0
    return v


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX model, port model, BGR frames, port checkpoint dir). The conf
    threshold sits in the middle of the widest gap between the top planted
    objectness logits of each scale over the letterboxed frames, so the bf16
    fast paths of the two packages, which round differently, agree on which
    cells are candidates."""
    cfg = narrow_yolov3()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(1), imgsz=64)
    head = f"l{len(ref.spec.layers) - 1}"
    probe = port_model(ref.variables, cfg).fuse()
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]
    boxed = np.stack([letterbox(f, IMGSZ, auto=False)[0][:, :, ::-1] for f in frames])
    with torch.no_grad():
        feats = probe(torch.from_numpy(np.ascontiguousarray(boxed)).float() / 255.0, raw=True)
    gains, deltas = [], []
    for i, f in enumerate(feats):  # up to 12 / 6 / 2 candidates per frame and scale
        b0 = np.asarray(ref.variables["params"][head][f"m{i}"]["bias"])[4::85]
        spread = f.numpy()[..., 4::85] - b0
        g = float(np.clip(2.0 / max(spread.std(), 1e-8), 1.0, 1e6))
        logits = (g * spread + b0).reshape(len(frames), -1)
        top = np.sort(logits.reshape(-1))[::-1][: 2 * len(frames) * (12, 6, 2)[i]]
        # on scale 0, every frame's best cell is a candidate: the gap lies below the lowest of them
        first = int(np.searchsorted(-top, -logits.max(1).min())) if i == 0 else 0
        j = first + int(np.argmax(top[first:-1] - top[first + 1:]))
        gains.append(g)
        deltas.append(float(np.log(CONF / (1 - CONF))) - (top[j] + top[j + 1]) / 2)
    variables = plant_gap(ref.variables, head, gains, deltas)
    jax_model = JaxModel(ref.spec, jax.tree.map(np.asarray, variables))
    model = port_model(variables, cfg)
    ckpt = save_checkpoint(tmp_path_factory.mktemp("serve") / "best", {"model": model.state_dict()},
                           spec=model.spec, meta={"names": {i: f"c{i}" for i in range(80)}})
    return jax_model, model, frames, ckpt


def assert_dets_match(got, want, msg=""):
    """n equal, and each row of `got` has its own row of `want` within boxes
    0.1 px, conf 1e-3 and the same class. Rows are matched, not compared in
    order: two detections whose scores are within float rounding of each
    other may come out in either order."""
    assert got.dtype == np.float32 and got.shape == want.shape, (msg, got.shape, want.shape)
    free = list(range(len(want)))
    for row in got:
        close = [j for j in free if np.abs(row[:4] - want[j, :4]).max() <= 0.1
                 and abs(row[4] - want[j, 4]) <= 1e-3 and row[5] == want[j, 5]]
        assert close, f"{msg}: no detection of the JAX pipeline within tolerance of {row}"
        free.remove(close[0])


def run_pipelines(served, fast):
    jax_model, model, frames, _ = served
    want = jax_build_pipeline(jax_model, IMGSZ, CONF, max_batch=1, fast=fast)
    got = build_pipeline(model, IMGSZ, CONF, max_batch=1, fast=fast)
    counts = []
    for frame in frames:
        g = got(frame.copy())
        assert_dets_match(g, want(frame.copy()), f"{frame.shape} fast={fast}")
        counts.append(len(g))
        assert (g[:, [0, 2]] <= frame.shape[1]).all() and (g[:, [1, 3]] <= frame.shape[0]).all()
    assert min(counts) > 0, counts
    assert got.batcher.calls == len(frames) and got.batcher.requests == len(frames)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_pipeline_matches_jax(served, fast, monkeypatch):
    """The fast pipeline with its weights kept in float32 on both sides (the
    serving cast turned off), so the comparison holds everything but the
    bf16 forward's rounding at the stated bars; fast=False is float32
    anyway. The bf16 forwards are not compared across the packages: XLA
    keeps excess precision between bf16 ops where torch rounds each one,
    and the head's logits are rounded to bf16, so near conf 0.3 they part by
    about 2e-3 (one bf16 step of a logit is 1.6e-3 there). The bf16 fast
    path is held to the plain functions on its own head outputs in
    tests/test_torch_serve.py and, on the card, by chip_smoke.py."""
    import yolov3_tpu.models.detection as jax_detection
    import yolov3_tpu_torch.serve as port_serve

    monkeypatch.setattr(jax_detection, "cast_variables_for_inference", lambda v: v)
    monkeypatch.setattr(port_serve, "cast_for_inference", lambda m: m)
    run_pipelines(served, fast)


def test_full_path_alone_and_options(served):
    _, model, frames, _ = served
    full = build_batched_infer(model, fast=False)
    assert not hasattr(full, "full_fn")
    fast = build_batched_infer(model)
    imgs = np.stack([np.zeros((IMGSZ, IMGSZ, 3), np.uint8), frames[1]])
    dets, n = full(imgs)
    fdets, fn_ = fast.full_fn(imgs)
    np.testing.assert_array_equal(dets.numpy(), fdets.numpy())
    np.testing.assert_array_equal(n.numpy(), fn_.numpy())
    # s2d is an exact transform of the TPU layout: accepted, the plain layout computed
    s2d, s2d_n = build_batched_infer(model, s2d=True)(imgs)
    plain, plain_n = fast(imgs)
    np.testing.assert_array_equal(s2d.numpy(), plain.numpy())
    # a smaller per-scale top-k overflows where the default does not
    small = build_batched_infer(model, k_per_scale=(1, 1, 1))
    assert small.fast_fn(imgs)[2].any() and not fast.fast_fn(imgs)[2].any()
    with pytest.raises(NotImplementedError, match="item 8"):
        build_batched_infer(model, mesh=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        build_pipeline(model, IMGSZ, shard=True)
    # a reference .pt loads through models/loading.py; a missing one is never downloaded
    with pytest.raises(FileNotFoundError, match="never downloaded"):
        make_server("yolov3.pt", device="cpu")


def post(url, body, content_type):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(served):
    _, model, frames, ckpt = served
    server = make_server(ckpt, host="127.0.0.1", port=0, imgsz=IMGSZ, max_batch=4, batch_wait_ms=20.0,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        remote = RemoteModel(url)
        assert remote.imgsz == IMGSZ and remote.names[3] == "c3"
        want = [server.predict(f.copy()) for f in frames]  # in process, through the same batcher
        calls0 = server.predict.batcher.calls

        answers = [None] * (2 * len(frames))

        def npy(i):
            answers[i] = remote(frames[i])

        def png(i):
            status, out = post(f"{url}/predict", image_ops.encode_png(frames[i]), "image/png")
            assert status == 200 and set(out) == {"detections", "names", "speed_ms"}
            answers[len(frames) + i] = np.array(out["detections"], np.float32).reshape(-1, 6)

        threads = [threading.Thread(target=fn, args=(i,)) for fn in (npy, png) for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, got in enumerate(answers):
            w = want[i % len(frames)]
            assert got.shape == w.shape and len(w) > 0
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-4)  # JSON rounds to 4 places

        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            health = json.loads(r.read())
        assert health["model"] == "yolov3" and health["imgsz"] == IMGSZ and health["names"]["0"] == "c0"
        assert health["batching"]["requests"] == 2 * len(frames) + len(frames)
        assert 1 <= health["batching"]["device_calls"] - calls0 <= 2 * len(frames)

        status, out = post(f"{url}/predict", b"certainly not an image", "image/png")
        assert status == 400 and "bad image payload" in out["error"]
        # a JPEG header claiming 65535 x 65535 is refused before anything is allocated
        sof = bytes.fromhex("ffd8ffc0000b08ffffffff01011100ffd9")
        status, out = post(f"{url}/predict", sof, "image/jpeg")
        assert status == 400 and "2^30 pixels" in out["error"]
        buf = __import__("io").BytesIO()
        np.save(buf, np.zeros((8, 8), np.uint8))
        assert post(f"{url}/predict", buf.getvalue(), "application/x-npy")[0] == 400
        assert post(f"{url}/nowhere", b"", "image/png")[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/nowhere", timeout=10)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

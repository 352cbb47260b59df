"""Sharded serving, NMS and validation of the port (a parallel.mesh.Mesh of
CPU devices) against the JAX package on a mesh of the conftest's virtual CPU
devices, at the JAX package's own bar for its sharded paths (rtol 1e-5,
tests/test_multichip.py:98,160), and against the port's unsharded calls.

 - build_batched_infer(mesh=2 devices), fast (the serving cast turned off on
   both sides, as tests/test_torch_serve_pipeline.py does) and fast=False,
   on a batch of 4 letterboxed frames; each shard's rows equal to the
   unsharded call on those rows, in their bits; the NMS kernel's wrapper
   called once a shard;
 - batched_nms and nms_from_candidates with spmd_mesh against the JAX
   functions with the kernel shard_mapped in interpret mode;
 - a batch the mesh does not divide (3 rows over 2 devices) runs whole on
   the first device in serving, the validator's forward and both NMS entry
   points (`Mesh.apply`), as the unsharded call;
 - validator.run(sharded=) over a 4-device mesh on a 10-image set in
   batches of 4, 4 and 2 (the tail batch unsharded), with the loss.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_serve_pipeline import CONF, IMGSZ, served  # noqa: F401 — `served` is a fixture
from test_torch_val import (HYP, NC, Recorder, narrow_cfg, plant, port_model, write_dataset)

from yolov3_tpu.data.augment import letterbox as jax_letterbox
from yolov3_tpu.data.datasets import DataLoader as JaxDataLoader
from yolov3_tpu.data.datasets import DetectionDataset as JaxDetectionDataset
from yolov3_tpu.eval import validator as jax_validator
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.ops.nms import batched_nms as jax_batched_nms
from yolov3_tpu.ops.nms import nms_from_candidates as jax_nms_from_candidates
from yolov3_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yolov3_tpu.serve import build_batched_infer as jax_build_batched_infer
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.detection import optimize_for_inference
from yolov3_tpu_torch.ops import nms as port_nms
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
from yolov3_tpu_torch.parallel.mesh import create_mesh
from yolov3_tpu_torch.serve import build_batched_infer
from yolov3_tpu_torch.train.loss import LossConfig

RTOL = ATOL = 1e-5


def match_rows(got, want, msg=""):
    """n equal and every row of `got` within rtol/atol 1e-5 of its own row of
    `want` (rows of near-equal score may swap)."""
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    free = list(range(len(want)))
    for row in got:
        close = [j for j in free if np.allclose(row, want[j], rtol=RTOL, atol=ATOL)]
        assert close, f"{msg}: no row of the JAX result within 1e-5 of {row}"
        free.remove(close[0])


def frames_batch(frames):
    boxed = [jax_letterbox(f, IMGSZ, auto=False)[0][:, :, ::-1] for f in frames]
    return np.ascontiguousarray(np.stack(boxed + boxed[:1]))  # 4 frames: 2 a shard


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_sharded_infer_matches_jax(served, fast, monkeypatch):  # noqa: F811
    import yolov3_tpu.models.detection as jax_detection
    import yolov3_tpu_torch.serve as port_serve

    monkeypatch.setattr(jax_detection, "cast_variables_for_inference", lambda v: v)
    monkeypatch.setattr(port_serve, "optimize_for_inference",
                        lambda m, bf16=None: optimize_for_inference(m, bf16=False))
    jax_model, model, frames, _ = served
    imgs = frames_batch(frames)
    calls = []

    def counting(*args):
        calls.append(args[2].shape[0])
        return greedy_nms(*args)

    monkeypatch.setattr(port_nms, "greedy_nms", counting)  # batched_nms's (fast=False)
    monkeypatch.setattr(port_serve, "nms_from_candidates", functools.partial(port_nms.nms_from_candidates,
                                                                             nms_fn=counting))
    mesh = create_mesh(["cpu", "cpu"])
    infer = build_batched_infer(model, CONF, fast=fast, mesh=mesh)
    dets, n = infer(imgs)
    assert calls == [2, 2]  # the kernel's wrapper once a shard, on that shard's rows
    dets, n = dets.numpy(), np.asarray(n)
    want_dets, want_n = map(np.asarray, jax_build_batched_infer(
        jax_model, CONF, fast=fast, mesh=jax_create_mesh(jax.devices()[:2]))(imgs))
    np.testing.assert_array_equal(n, want_n)
    assert n.min() > 0
    for i in range(len(imgs)):
        match_rows(dets[i, : n[i]], want_dets[i, : n[i]], f"frame {i} fast={fast}")
    plain = build_batched_infer(model, CONF, fast=fast)
    for a, b in ((0, 2), (2, 4)):  # each shard's rows: the unsharded call on those rows, in their bits
        p_dets, p_n = plain(imgs[a:b])
        np.testing.assert_array_equal(dets[a:b], p_dets.numpy())
        np.testing.assert_array_equal(n[a:b], np.asarray(p_n))
    if fast:
        assert infer.fallbacks == 0


def random_predictions(rng, bs, n=300, nc=3):
    xy = rng.uniform(20, 200, (bs, n, 2))
    wh = rng.uniform(5, 60, (bs, n, 2))
    obj = rng.uniform(0, 1, (bs, n, 1))
    cls = rng.uniform(0, 1, (bs, n, nc))
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("multi_label,merge", [(False, False), (True, False), (True, True)],
                         ids=["best-class", "multi-label", "merge"])
def test_batched_nms_spmd_mesh_matches_jax(multi_label, merge):
    pred = random_predictions(np.random.default_rng(3), 4)
    kw = dict(conf_thres=0.3, iou_thres=0.5, multi_label=multi_label, max_det=50, max_nms=400, merge=merge)
    calls = []

    def counting(*args):
        calls.append(args[2].shape[0])
        return greedy_nms(*args)

    got, got_n = port_nms.batched_nms(torch.from_numpy(pred), nms_fn=counting,
                                      spmd_mesh=create_mesh(["cpu", "cpu"]), **kw)
    assert calls == [2, 2]
    want, want_n = map(np.asarray, jax_batched_nms(jax.numpy.asarray(pred), use_pallas="interpret",
                                                   spmd_mesh=jax_create_mesh(jax.devices()[:2]), **kw))
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plain, plain_n = port_nms.batched_nms(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # a batch of 3 does not divide over 2 devices: one unsharded call
    calls.clear()
    odd, odd_n = port_nms.batched_nms(torch.from_numpy(pred[:3]), nms_fn=counting,
                                      spmd_mesh=create_mesh(["cpu", "cpu"]), **kw)
    assert calls == [3]
    np.testing.assert_array_equal(odd.numpy(), plain[:3].numpy())


def random_candidates(rng, bs, k=96):
    boxes = np.sort(rng.uniform(0, 200, (bs, k, 2, 2)), axis=2).transpose(0, 1, 3, 2).reshape(bs, k, 4)
    boxes = boxes[..., [0, 2, 1, 3]].astype(np.float32)  # x1 y1 x2 y2 with x1 < x2, y1 < y2
    scores = np.where(rng.uniform(size=(bs, k)) < 0.8, rng.uniform(0.3, 1.0, (bs, k)), -1.0).astype(np.float32)
    cls = rng.integers(0, 3, (bs, k)).astype(np.float32)
    return boxes, scores, cls


def test_nms_from_candidates_spmd_mesh_matches_jax():
    boxes, scores, cls = random_candidates(np.random.default_rng(4), 4)
    got, got_n = port_nms.nms_from_candidates(torch.from_numpy(boxes), torch.from_numpy(scores),
                                              torch.from_numpy(cls), 0.45, 40,
                                              spmd_mesh=create_mesh(["cpu", "cpu"]))
    want, want_n = map(np.asarray, jax_nms_from_candidates(
        jax.numpy.asarray(boxes), jax.numpy.asarray(scores), jax.numpy.asarray(cls), 0.45, 40,
        use_pallas="interpret", spmd_mesh=jax_create_mesh(jax.devices()[:2])))
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("entry", ["serve", "val", "batched_nms", "nms_from_candidates"])
def test_undivided_batch_runs_whole_on_the_first_device(served, entry, monkeypatch):  # noqa: F811
    """A batch of 3 on a mesh of 2 CPU devices: one call of the NMS kernel's wrapper on all 3 rows, and the
    unsharded call's results, in their bits, on the mesh's first device."""
    import yolov3_tpu_torch.serve as port_serve

    _, model, frames, _ = served
    calls = []

    def counting(*args):
        calls.append(args[2].shape[0])
        return greedy_nms(*args)

    imgs = frames_batch(frames)[:3]
    if entry == "serve":
        monkeypatch.setattr(port_serve, "nms_from_candidates", functools.partial(port_nms.nms_from_candidates,
                                                                                 nms_fn=counting))

        def run(mesh):
            return build_batched_infer(model, CONF, mesh=mesh)(imgs)
    elif entry == "val":
        def run(mesh):
            return validator.make_forward(model, nms_fn=counting, mesh=mesh)(imgs)
    elif entry == "batched_nms":
        pred = torch.from_numpy(random_predictions(np.random.default_rng(3), 3))

        def run(mesh):
            return port_nms.batched_nms(pred, conf_thres=0.3, iou_thres=0.5, max_det=50, max_nms=400,
                                        nms_fn=counting, spmd_mesh=mesh)
    else:
        cands = [torch.from_numpy(a) for a in random_candidates(np.random.default_rng(4), 3)]

        def run(mesh):
            return port_nms.nms_from_candidates(*cands, 0.45, 40, nms_fn=counting, spmd_mesh=mesh)
    mesh = create_mesh(["cpu", "cpu"])
    got = run(mesh)
    assert calls == [3]
    want = run(None)
    assert calls == [3, 3]
    assert got[0].device == mesh.devices[0]  # the detections (serving fetches its counts to the host)
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))
    assert int(torch.as_tensor(got[1]).sum()) > 0


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """A planted narrowed yolov3 (as tests/test_torch_val.py's) and 10
    images labelled with its own detections above conf 0.25; batches of 4."""
    cfg = narrow_cfg()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64)
    head = f"l{len(ref.spec.layers) - 1}"
    probe = port_model(ref.variables, cfg)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    with torch.no_grad():
        feats = probe(torch.from_numpy(frames).float() / 255.0)
    gains, deltas = [], []
    for i, f in enumerate(feats):
        b0 = np.asarray(ref.variables["params"][head][f"m{i}"]["bias"])[4::NC + 5]
        spread = f[..., 4].numpy() - b0[None, :, None, None]
        g = float(np.clip(4.0 / max(spread.std(), 1e-8), 1.0, 1e6))
        q = np.quantile(g * spread + b0[None, :, None, None], 1.0 - (4, 2, 1)[i] / spread[0].size)
        gains.append(g)
        deltas.append(float(np.log(0.25 / 0.75)) + 0.05 - q)
    variables = plant(ref.variables, head, gains, deltas)
    jax_model, model = JaxModel(ref.spec, variables), port_model(variables, cfg)
    root = tmp_path_factory.mktemp("sharded_val")
    sizes = [(96, 96)] * 10
    images = write_dataset(root / "unlabelled", sizes, seed=11)
    loader = JaxDataLoader(JaxDetectionDataset(str(images), imgsz=96, num_cls=NC), batch_size=4)
    forward, labels = validator.make_forward(model), {}
    for imgs, _, _, _ in loader:
        dets, n = forward(torch.from_numpy(imgs))
        for si in range(imgs.shape[0]):
            d = dets[si, : int(n[si])].numpy()
            d = d[d[:, 4] > 0.25]
            d[:, :4] = d[:, :4].clip(0.0, 96.0)
            xywh = np.concatenate([(d[:, :2] + d[:, 2:4]) / 2, d[:, 2:4] - d[:, :2]], 1) / 96.0
            labels[f"{len(labels):03d}"] = [[c, *b] for c, b in zip(d[:, 5], xywh) if (b[2:] > 0.01).all()]
    assert sum(map(len, labels.values())) >= 10, labels
    ds = JaxDetectionDataset(str(write_dataset(root / "labelled", sizes, seed=11, labels=labels)), imgsz=96,
                             num_cls=NC)
    batches = list(JaxDataLoader(ds, batch_size=4))
    assert [len(b[0]) for b in batches] == [4, 4, 2]

    class Batches:
        dataset = ds

        def __iter__(self):
            return iter(batches)

    data = {"path": str(root), "val": str(root / "labelled" / "images"), "names": {i: str(i) for i in range(NC)}}
    return jax_model, model, data, Batches()


def test_sharded_val_matches_jax(val_set):
    jax_model, model, data, batches = val_set
    out = {}
    for label, run, m, mesh, cfg in (
            ("jax", jax_validator.run, jax_model, jax_create_mesh(jax.devices()[:4]),
             JaxLossConfig.from_model(jax_model.spec, HYP)),
            ("port", validator.run, model, create_mesh(["cpu"] * 4), LossConfig.from_model(model.spec, HYP)),
            ("port unsharded", validator.run, model, False, LossConfig.from_model(model.spec, HYP))):
        rec = Recorder()
        results, maps, _ = run(data, model=m, batch_size=4, imgsz=96, dataloader=batches, loss_cfg=cfg,
                               compute_loss_flag=True, callbacks=rec, sharded=mesh)
        out[label] = (np.array(results, np.float64), np.asarray(maps), rec.preds)
    got, want = out["port"], out["jax"]
    assert want[0][2] > 0.9, want[0]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert sorted(got[2]) == sorted(want[2]) and len(want[2]) == 10
    for stem, w in want[2].items():
        match_rows(np.asarray(got[2][stem], np.float32), np.asarray(w, np.float32), stem)
    np.testing.assert_allclose(got[0], out["port unsharded"][0], rtol=RTOL, atol=ATOL)

"""The port's validation (yolov3_tpu_torch.eval) against the JAX package.

1. The numpy copies: eval.metrics, eval.cocoeval, the box helpers of
   ops.boxes and the utils, equal to yolov3_tpu's on seeded inputs, exactly;
   the box helpers on torch tensors within float32 rounding of their numpy
   results.
2. `validator.run` of both packages on the same narrowed yolov3 (nc=3,
   weights carried across with models.convert), with detections planted on
   the head bias and distinct class biases, so that near-ties do not decide
   NMS. The batches come from the JAX DataLoader over a small synthetic rect
   dataset at 96 px (three batch shapes, the last one partial), labelled
   with the port's own detections above conf 0.25. Metrics within 0.005
   (ROADMAP.md's mAP bar), per-image detections n equal, boxes atol 0.1,
   conf atol 1e-3, losses rtol 2e-3.
   `save_hybrid=True` (labels injected before the host NMS) is held the
   same way.
3. Every argument of the JAX `run` that the port does not take yet raises
   NotImplementedError.
"""

import json
import time
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.data.datasets import DataLoader, DetectionDataset
from yolov3_tpu.eval import cocoeval as jax_cocoeval
from yolov3_tpu.eval import metrics as jax_metrics
from yolov3_tpu.eval import validator as jax_validator
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.ops import boxes as jax_boxes
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.utils import general as jax_general
from yolov3_tpu_torch.eval import cocoeval, metrics, validator
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops import boxes
from yolov3_tpu_torch.ops import nms as port_nms
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.utils import general

ROOT = Path(__file__).resolve().parents[1]
NC = 3
IMGSZ = 96
CLS_BUMPS = (4.0, 0.0, -4.0)  # distinct class biases: a box's classes never tie
HYP = {"box": 0.05, "obj": 1.0, "cls": 0.5, "anchor_t": 4.0}


# --- 1. the numpy copies ------------------------------------------------------


def random_xyxy(rng, n, size=640.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_box_helpers_equal_jax(dtype):
    rng = np.random.default_rng(0)
    a, b = random_xyxy(rng, 40).astype(dtype), random_xyxy(rng, 30).astype(dtype)
    extra = np.concatenate([a, rng.uniform(0, 1, (40, 2)).astype(dtype)], 1)  # columns past 4 pass through
    for name, args in (("xyxy2xywh", (extra,)), ("xywh2xyxy", (extra,)), ("clip_boxes", (extra, (480, 600))),
                       ("scale_boxes", ((640, 640), extra, (480, 600))),
                       ("scale_boxes", ((512, 640), extra, (390, 500), ((1.28, 1.28), (0.0, 6.4)))),
                       ("box_iou", (a, b))):
        got, want = getattr(boxes, name)(*args), np.asarray(getattr(jax_boxes, name)(*args))
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_box_helpers_take_tensors():
    rng = np.random.default_rng(1)
    a, b = random_xyxy(rng, 20).astype(np.float32), random_xyxy(rng, 10).astype(np.float32)
    for name, args in (("xyxy2xywh", (a,)), ("xywh2xyxy", (a,)), ("clip_boxes", (a, (480, 600))),
                       ("scale_boxes", ((640, 640), a, (480, 600))), ("box_iou", (a, b))):
        got = getattr(boxes, name)(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in args))
        assert isinstance(got, torch.Tensor), name
        np.testing.assert_allclose(got.numpy(), getattr(boxes, name)(*args), rtol=1e-6, atol=1e-4, err_msg=name)


def random_stats(rng, n_det=400, n_gt=150, nc=5):
    tp = rng.uniform(size=(n_det, 10)) < np.linspace(0.8, 0.2, 10)
    conf = rng.uniform(0.001, 1.0, n_det)
    conf[:20] = conf[20:40]  # ties
    return tp, conf, rng.integers(0, nc, n_det).astype(float), rng.integers(0, nc, n_gt).astype(float)


def test_ap_per_class_equals_jax():
    stats = random_stats(np.random.default_rng(2))
    got, want = metrics.ap_per_class(*stats), jax_metrics.ap_per_class(*stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got, want = metrics.ap_per_class(*stats, curves=True)[-1], jax_metrics.ap_per_class(*stats, curves=True)[-1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_small_metrics_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(7, 7))
    np.testing.assert_array_equal(metrics.fitness(x), jax_metrics.fitness(x))
    y = rng.uniform(size=300)
    np.testing.assert_array_equal(metrics.smooth(y, 0.1), jax_metrics.smooth(y, 0.1))
    r = np.sort(rng.uniform(size=50))
    p = rng.uniform(size=50)
    for g, w in zip(metrics.compute_ap(r, p), jax_metrics.compute_ap(r, p)):
        np.testing.assert_array_equal(g, w)


def detections_and_labels(rng, n_det=60, n_gt=25, nc=4):
    labels = np.concatenate([rng.integers(0, nc, (n_gt, 1)), random_xyxy(rng, n_gt)], 1).astype(np.float32)
    jitter = rng.normal(0, 8, (n_det, 4))
    src = rng.integers(0, n_gt, n_det)
    boxes_ = labels[src, 1:] + jitter
    cls = np.where(rng.uniform(size=n_det) < 0.8, labels[src, 0], rng.integers(0, nc, n_det))
    dets = np.concatenate([boxes_, rng.uniform(0.05, 1, (n_det, 1)), cls[:, None]], 1).astype(np.float32)
    return dets, labels


def test_process_batch_and_confusion_matrix_equal_jax():
    rng = np.random.default_rng(4)
    iouv = np.linspace(0.5, 0.95, 10)
    cm, jcm = metrics.ConfusionMatrix(nc=4), jax_metrics.ConfusionMatrix(nc=4)
    for _ in range(5):
        dets, labels = detections_and_labels(rng)
        np.testing.assert_array_equal(metrics.process_batch(dets, labels, iouv),
                                      jax_metrics.process_batch(dets, labels, iouv))
        cm.process_batch(dets, labels)
        jcm.process_batch(dets, labels)
    cm.process_batch(dets[:0], labels)  # no detections
    jcm.process_batch(dets[:0], labels)
    np.testing.assert_array_equal(cm.matrix, jcm.matrix)
    for g, w in zip(cm.tp_fp(), jcm.tp_fp()):
        np.testing.assert_array_equal(g, w)


def coco_json(rng, n_img=6, nc=3):
    images = [{"id": i} for i in range(n_img)]
    anns, dets = [], []
    for i in range(n_img):
        for k in range(int(rng.integers(2, 9))):
            xy, wh = rng.uniform(0, 300, 2), rng.uniform(5, 150, 2)
            c = int(rng.integers(1, nc + 1))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": c, "bbox": [*xy, *wh],
                         "iscrowd": int(k == 0 and i == 0)})
            for _ in range(int(rng.integers(0, 3))):
                dets.append({"image_id": i, "category_id": c, "bbox": [*(xy + rng.normal(0, 6, 2)), *wh],
                             "score": float(rng.uniform())})
        dets.append({"image_id": i, "category_id": 1, "bbox": [1.0, 1.0, 20.0, 20.0], "score": 0.5})
    gt = {"images": images, "annotations": anns, "categories": [{"id": c} for c in range(1, nc + 1)]}
    return gt, dets


def test_cocoeval_equals_jax(tmp_path):
    gt, dets = coco_json(np.random.default_rng(5))
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "dt.json").write_text(json.dumps(dets))
    got = cocoeval.COCOBboxEval(json.loads(json.dumps(gt)), dets).accumulate()
    want = jax_cocoeval.COCOBboxEval(json.loads(json.dumps(gt)), dets).accumulate()
    np.testing.assert_array_equal(got.precision, want.precision)
    np.testing.assert_array_equal(got.recall, want.recall)
    assert got.summarize(verbose=False) == want.summarize(verbose=False)
    assert (cocoeval.evaluate_coco_json(str(tmp_path / "gt.json"), str(tmp_path / "dt.json"), verbose=False)
            == jax_cocoeval.evaluate_coco_json(str(tmp_path / "gt.json"), str(tmp_path / "dt.json"), verbose=False))


def test_general_helpers():
    assert general.coco80_to_coco91_class() == jax_general.coco80_to_coco91_class()
    p = general.Profile(device="cpu")
    with p:
        time.sleep(0.01)
    with p:
        pass
    assert p.t >= p.dt > 0 and p.t >= 0.01 and not p.cuda


def test_batched_nms_takes_nms_fn():
    rng = np.random.default_rng(6)
    pred = torch.from_numpy(rng.uniform(0, 1, (2, 50, 5 + NC)).astype(np.float32))
    pred[..., :2] *= 96
    pred[..., 2:4] *= 30
    calls = []

    def recording(*args):
        calls.append(args[2].shape)
        return greedy_nms_plain(*args)

    got = port_nms.batched_nms(pred, 0.001, 0.6, multi_label=True, nms_fn=recording)
    want = port_nms.batched_nms(pred, 0.001, 0.6, multi_label=True)
    assert calls == [(2, 50 * NC)]
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and int(want[1].min()) > 0


# --- 2. validator.run against the JAX validator ------------------------------


def narrow_cfg():
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3.yaml").read_text())
    d.update(name="yolov3", width_multiple=0.125, depth_multiple=0.33, nc=NC)
    return d


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.array(v, np.float32) for k, v in tree.items()}


def plant(variables, head, gains, deltas):
    """Scale i's objectness kernel column times gains[i], its bias plus
    deltas[i]; class k's bias plus CLS_BUMPS[k]."""
    no = NC + 5
    v = to_numpy_tree(variables)
    for i, (g, d) in enumerate(zip(gains, deltas)):
        m = v["params"][head][f"m{i}"]
        m["kernel"][..., 4::no] *= g
        m["bias"][4::no] += d
        m["bias"].reshape(-1, no)[:, 5:] += np.asarray(CLS_BUMPS, np.float32)
    return v


def port_model(variables, cfg):
    return load_jax_variables(DetectionModel(parse_spec(cfg)).eval(), variables)


def write_dataset(root, sizes, seed, labels=None):
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(root / "images" / f"{i:03d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        rows = (labels or {}).get(f"{i:03d}", [])
        (root / "labels" / f"{i:03d}.txt").write_text("".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows))
    return root / "images"


def rect_loader(images):
    ds = DetectionDataset(str(images), imgsz=IMGSZ, rect=True, stride=32, pad=0.5, batch_size=2, num_cls=NC)
    return DataLoader(ds, batch_size=2, shuffle=False)


class Recorder:
    """A callbacks object that keeps each image's native-space predictions."""

    def __init__(self):
        self.preds = {}

    def run(self, event, predn, path, **_):
        assert event == "on_val_image_end"
        self.preds[Path(path).stem] = np.array(predn)


@pytest.fixture(scope="module")
def val_runs(tmp_path_factory):
    """Both validators on the same model and batches; returns their results."""
    cfg = narrow_cfg()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64)
    head = f"l{len(ref.spec.layers) - 1}"
    probe = port_model(ref.variables, cfg)
    frames = np.random.default_rng(0).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    with torch.no_grad():
        feats = probe(torch.from_numpy(frames).float() / 255.0)
    gains, deltas = [], []
    for i, f in enumerate(feats):  # ~4 / 2 / 1 cells an image above conf 0.25, logits spread 4
        b0 = np.asarray(ref.variables["params"][head][f"m{i}"]["bias"])[4::NC + 5]
        spread = f[..., 4].numpy() - b0[None, :, None, None]
        g = float(np.clip(4.0 / max(spread.std(), 1e-8), 1.0, 1e6))
        q = np.quantile(g * spread + b0[None, :, None, None], 1.0 - (4, 2, 1)[i] / spread[0].size)
        gains.append(g)
        deltas.append(float(np.log(0.25 / 0.75)) + 0.05 - q)
    variables = plant(ref.variables, head, gains, deltas)
    jax_model = JaxModel(ref.spec, variables)
    model = port_model(variables, cfg)

    # landscape, square and portrait frames: batch shapes (96, 128), (128, 128), (128, 96), the last partial
    sizes = [(72, 96), (66, 96), (96, 96), (96, 72), (96, 70)]
    root = tmp_path_factory.mktemp("valds")
    images = write_dataset(root / "unlabelled", sizes, seed=7)
    # labels: the port's own detections above conf 0.25, in native normalised xywh
    labels = {}
    forward = validator.make_forward(model)
    loader = rect_loader(images)
    for imgs, _, _, shapes in loader:
        dets, n = forward(torch.from_numpy(imgs))
        for si in range(imgs.shape[0]):
            stem = Path(loader.dataset.im_files[len(labels)]).stem
            d = dets[si, : int(n[si])].numpy()
            d = d[d[:, 4] > 0.25]
            (h0, w0), ratio_pad = shapes[si]
            xyxy = boxes.scale_boxes(imgs.shape[1:3], d[:, :4], (h0, w0), ratio_pad)
            xywh = boxes.xyxy2xywh(xyxy) / np.array([w0, h0, w0, h0], np.float32)
            labels[stem] = [[c, *b] for c, b in zip(d[:, 5], xywh) if (b[2:] > 0.01).all()]
    assert sum(map(len, labels.values())) >= 8, labels
    data = {"path": str(root), "val": str(root / "labelled" / "images"), "names": {i: str(i) for i in range(NC)}}
    loader = rect_loader(write_dataset(root / "labelled", sizes, seed=7, labels=labels))
    batches = list(loader)  # the same numpy batches for both
    assert [b[0].shape[:3] for b in batches] == [(2, 96, 128), (2, 128, 128), (1, 128, 96)]

    class Batches:  # an iterable with the dataset's file names, as the callbacks read them
        dataset = loader.dataset

        def __iter__(self):
            return iter(batches)

    out = {}
    for label, run, m, loss_cfg in (
            ("jax", jax_validator.run, jax_model, JaxLossConfig.from_model(jax_model.spec, HYP)),
            ("port", validator.run, model, LossConfig.from_model(model.spec, HYP))):
        rec = Recorder()
        results, maps, _ = run(data, model=m, batch_size=2, imgsz=IMGSZ, dataloader=Batches(), loss_cfg=loss_cfg,
                               compute_loss_flag=True, callbacks=rec)
        out[label] = dict(results=np.array(results, np.float64), maps=maps, preds=rec.preds)
    out["model"], out["jax_model"], out["data"], out["batches"] = model, jax_model, data, Batches()
    return out


def test_val_metrics_match_jax(val_runs):
    got, want = val_runs["port"]["results"][:4], val_runs["jax"]["results"][:4]
    assert want[2] > 0.9, f"the self-labelled set should give mAP50 near 1, got {want}"
    np.testing.assert_allclose(got, want, rtol=0, atol=0.005)
    np.testing.assert_allclose(val_runs["port"]["maps"], val_runs["jax"]["maps"], rtol=0, atol=0.005)


def test_val_detections_match_jax(val_runs):
    got, want = val_runs["port"]["preds"], val_runs["jax"]["preds"]
    assert sorted(got) == sorted(want) and len(want) == 5
    for stem in want:
        g, w = got[stem], want[stem]
        assert len(g) == len(w), stem
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.1, err_msg=stem)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-3, err_msg=stem)
        np.testing.assert_array_equal(g[:, 5], w[:, 5], err_msg=stem)
    assert sum(map(len, want.values())) > 20


def test_val_losses_match_jax(val_runs):
    got, want = val_runs["port"]["results"][4:], val_runs["jax"]["results"][4:]
    assert len(got) == 3 and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_val_txt_and_coco_json_match_jax(val_runs, tmp_path):
    """save_txt/save_conf and save_json write the same files as the JAX run (the
    COCO eval finds no annotations here and is skipped by both with a warning)."""
    for label, run, m in (("jax", jax_validator.run, val_runs["jax_model"]), ("port", validator.run, val_runs["model"])):
        run(val_runs["data"], model=m, batch_size=2, imgsz=IMGSZ, dataloader=val_runs["batches"], save_txt=True,
            save_conf=True, save_json=True, save_dir=tmp_path / label)
    names = sorted(p.name for p in (tmp_path / "jax" / "labels").glob("*.txt"))
    assert names == sorted(p.name for p in (tmp_path / "port" / "labels").glob("*.txt")) and len(names) == 5
    for name in names:
        got, want = (np.loadtxt(tmp_path / k / "labels" / name, ndmin=2) for k in ("port", "jax"))
        assert got.shape == want.shape and got.shape[1] == 6, name
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1e-3, err_msg=name)  # 0.1 px at 96 px, conf 1e-3
    got, want = (json.loads((tmp_path / k / "predictions.json").read_text()) for k in ("port", "jax"))
    assert len(got) == len(want) > 20
    assert [(d["image_id"], d["category_id"]) for d in got] == [(d["image_id"], d["category_id"]) for d in want]
    np.testing.assert_allclose([d["bbox"] for d in got], [d["bbox"] for d in want], atol=0.1)
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], atol=1e-3)


def test_val_plain_nms_gives_the_same_metrics(val_runs):
    results, maps, speeds = validator.run(val_runs["data"], model=val_runs["model"],
                                          dataloader=val_runs["batches"], nms_fn=greedy_nms_plain)
    np.testing.assert_array_equal(np.array(results[:4]), val_runs["port"]["results"][:4])
    assert len(speeds) == 3 and all(s >= 0 for s in speeds)


def test_val_half_runs_and_leaves_the_model(val_runs):
    model = val_runs["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    (mp, mr, map50, map_, *_), _, _ = validator.run(model=model, dataloader=val_runs["batches"], half=True)
    assert 0.0 <= map_ <= map50 <= 1.0 and map50 > 0.5
    assert model.dtype == torch.float32 and not model.fused
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def test_val_speed_task_uses_benchmark_settings(val_runs):
    calls = []

    def recording(boxes_off, boxes_, scores, cls_ids, iou_thres, max_det):
        calls.append((float(scores[scores > 0].min()) if bool((scores > 0).any()) else None, iou_thres))
        return greedy_nms_plain(boxes_off, boxes_, scores, cls_ids, iou_thres, max_det)

    validator.run(model=val_runs["model"], dataloader=val_runs["batches"], task="speed", nms_fn=recording)
    assert len(calls) == 3 and all(iou == 0.45 and (s is None or s > 0.25) for s, iou in calls)


def test_val_save_hybrid_matches_jax(val_runs):
    """save_hybrid=True: the labels join each batch's predictions as
    confidence-1 candidates before the host NMS, in both packages. Metrics
    within 0.005, per-image detections n equal / boxes 0.1 / conf 1e-3, no
    losses; with every label a detection of confidence 1, mAP50 is 1."""
    out = {}
    runs = (("jax", jax_validator.run, val_runs["jax_model"]), ("port", validator.run, val_runs["model"]))
    for label, run, m in runs:
        rec = Recorder()
        results, maps, _ = run(val_runs["data"], model=m, batch_size=2, imgsz=IMGSZ, dataloader=val_runs["batches"],
                               save_hybrid=True, callbacks=rec)
        out[label] = (np.array(results, np.float64), maps, rec.preds)
    (got, got_maps, got_preds), (want, want_maps, want_preds) = out["port"], out["jax"]
    np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=0.005)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=0.005)
    assert (got[4:] == 0).all() and got[2] > 0.99
    assert sorted(got_preds) == sorted(want_preds) and len(want_preds) == 5
    for stem, w in want_preds.items():
        g = got_preds[stem]
        assert len(g) == len(w), stem
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.1, err_msg=stem)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-3, err_msg=stem)
        np.testing.assert_array_equal(g[:, 5], w[:, 5], err_msg=stem)
    # the injected labels are among the detections: more rows at confidence 1 than without them
    plain = val_runs["port"]["preds"]
    assert sum((g[:, 4] == 1.0).sum() for g in got_preds.values()) > sum((g[:, 4] == 1.0).sum() for g in plain.values())


# --- 3. what is not ported yet raises -----------------------------------------


@pytest.mark.parametrize("kwargs,error,match", [
    # augment (TTA) is ported (tests/test_torch_tta.py): accepted, the call goes on to need `data`
    (dict(augment=True, dataloader=None), ValueError, "needs `data`"),
    (dict(plots=True), NotImplementedError, "item 5"),
    (dict(sharded=True), NotImplementedError, "item 8"),
    # item 9 is ported: without a dataloader `run` reads `data` (a dataset YAML or dict) and raises
    # what reading it raises; tests/test_torch_trainer.py holds the loader it builds to the JAX one's
    (dict(dataloader=None), ValueError, "needs `data`"),
    (dict(data="coco128.yaml"), FileNotFoundError, "coco128.yaml"),
], ids=["augment", "plots", "sharded", "no-dataloader", "yaml-data"])
def test_unported_arguments_raise(kwargs, error, match):
    model = DetectionModel(parse_spec(narrow_cfg())).eval()
    call = dict(model=model, dataloader=[])
    call.update(kwargs)
    with pytest.raises(error, match=match):
        validator.run(**call)


def test_non_native_model_raises():
    with pytest.raises(NotImplementedError, match="item 6"):
        validator.run(model=object(), dataloader=[])

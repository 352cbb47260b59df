"""End to end through the port alone: synthetic dataset -> train -> validate -> detect.

The port of tests/test_e2e.py. The dataset is written on the fly with cv2
(solid rectangles whose boxes are the labels), which the tests may import
and the port never does; the port reads the JPEGs with its own decoder.

- `test_train_val_detect_smoke`: 2 epochs of `train()` with its default
  plots, then `cli.detect.run` on the `last` checkpoint; the run's artifacts
  in the port's checkpoint layout, PNG where the JAX package writes JPEG.
- `test_training_learns_to_detect`: the JAX test's recipe (300 steps of 8
  images at 96 px, lr0 0.05, no augmentation) and its two bars on the train
  split: trained mAP50 > 0.5, and trained > untrained + 0.4. The JAX copy is
  marked slow; the port's takes about 15 s alone on a CPU, so it runs in
  Tier-1.
- `test_resume_roundtrip`: an epoch, then a resumed second one, logged as
  epoch 1 in results.csv.
"""

import csv
from pathlib import Path

import cv2
import numpy as np
import pytest

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.cli import detect as detect_cli
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.train.loop import train
from yolov3_tpu_torch.utils.checkpoint import load_model_from_checkpoint

MICRO_SPEC = {
    "nc": 2,
    "anchors": [[12, 12, 20, 20, 32, 32], [48, 48, 64, 64, 96, 96]],
    "layers": [
        {"from": -1, "n": 1, "op": "Conv", "args": [8, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": [3, 4], "n": 1, "op": "Detect", "args": ["nc", "anchors"]},
    ],
}
NO_AUGMENT = {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0,
              "shear": 0.0, "perspective": 0.0, "flipud": 0.0, "mosaic": 0.0, "mixup": 0.0, "copy_paste": 0.0}


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    """8 images of coloured rectangles on grey with YOLO labels (tests/test_e2e.py's fixture)."""
    root = tmp_path_factory.mktemp("synthds")
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(8):
        im = np.full((96, 96, 3), 114, np.uint8)
        lines = []
        for _ in range(rng.integers(1, 3)):
            cls = int(rng.integers(0, 2))
            w, h = rng.integers(24, 48, 2)
            x1 = int(rng.integers(0, 96 - w))
            y1 = int(rng.integers(0, 96 - h))
            color = (0, 0, 220) if cls == 0 else (220, 0, 0)
            cv2.rectangle(im, (x1, y1), (x1 + int(w), y1 + int(h)), color, -1)
            lines.append(f"{cls} {(x1 + w / 2) / 96:.6f} {(y1 + h / 2) / 96:.6f} {w / 96:.6f} {h / 96:.6f}")
        cv2.imwrite(str(root / "images" / "train" / f"{i:03d}.jpg"), im)
        (root / "labels" / "train" / f"{i:03d}.txt").write_text("\n".join(lines))
    return {"path": str(root), "train": "images/train", "val": "images/train", "names": {0: "red", 1: "blue"}}


def test_train_val_detect_smoke(synth_dataset, tmp_path):
    hyp = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.9, "weight_decay": 0.0, "warmup_epochs": 0.0,
           "box": 0.05, "cls": 0.5, "obj": 1.0, "anchor_t": 4.0, "fl_gamma": 0.0, **NO_AUGMENT, "fliplr": 0.5}
    best_fitness, results, save_dir = train(
        data=synth_dataset, cfg=MICRO_SPEC, hyp=hyp, epochs=2, batch_size=8, imgsz=96, noautoanchor=True,
        patience=100, save_dir=tmp_path / "exp", max_labels=8, rect_val=False, workers=1, device="cpu")
    exp = tmp_path / "exp"
    assert save_dir == exp
    for f in ("results.csv", "hyp.yaml", "weights/last/checkpoint.yaml", "weights/best/checkpoint.yaml",
              "weights/last/state.pt", "weights/best/state.pt"):
        assert (exp / f).exists(), f
    # the default plots (utils/loggers, eval/validator.py), named as the JAX package names them
    for f in ("labels.png", "labels_correlogram.jpg", "train_batch0.jpg", "results.png", "confusion_matrix.png",
              "val_batch0_labels.jpg", "val_batch0_pred.jpg"):
        assert (exp / f).exists(), f"{f} missing; got {sorted(p.name for p in exp.iterdir())}"
    assert np.isfinite(best_fitness) and all(np.isfinite(results))

    src = Path(synth_dataset["path"]) / "images" / "train" / "000.jpg"
    out_dir = detect_cli.run(weights=exp / "weights" / "last", source=str(src), imgsz=(96, 96), conf_thres=0.001,
                             project=str(tmp_path / "detect"), save_txt=True, device="cpu")
    assert (Path(out_dir) / "000.jpg").exists()
    assert (Path(out_dir) / "labels" / "000.txt").exists()


def test_training_learns_to_detect(synth_dataset, tmp_path):
    """Training moves mAP, not just the loss: a micro model trained for 300 steps
    separates from its random init by a wide mAP50 margin on the train split."""
    hyp = {"lr0": 0.05, "lrf": 0.2, "momentum": 0.9, "weight_decay": 0.0, "warmup_epochs": 0.0,
           "box": 0.05, "cls": 0.5, "obj": 1.0, "anchor_t": 4.0, **NO_AUGMENT, "fliplr": 0.0}
    train(data=synth_dataset, cfg=MICRO_SPEC, hyp=hyp, epochs=300, batch_size=8, imgsz=96, noautoanchor=True,
          noval=True, noplots=True, max_labels=8, save_dir=tmp_path / "exp", workers=0, device="cpu")

    def map50_of(model):
        results, _, _ = validator.run(synth_dataset, model=model, batch_size=8, imgsz=96, rect=False,
                                      conf_thres=0.001, iou_thres=0.6, save_dir=tmp_path, workers=0)
        return float(results[2])

    trained = map50_of(load_model_from_checkpoint(tmp_path / "exp" / "weights" / "last", device="cpu"))
    untrained = map50_of(DetectionModel.from_config(dict(MICRO_SPEC), device="cpu"))
    assert trained > 0.5, f"trained mAP50 {trained:.3f}: training did not learn the dataset"
    assert trained > untrained + 0.4, f"trained {trained:.3f} against untrained {untrained:.3f}"


def test_resume_roundtrip(synth_dataset, tmp_path):
    """Checkpoint save -> resume continues from the next epoch."""
    hyp = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.9, "weight_decay": 0.0, "warmup_epochs": 0.0,
           "mosaic": 0.0, "fliplr": 0.0}
    kw = dict(data=synth_dataset, cfg=MICRO_SPEC, hyp=hyp, batch_size=8, imgsz=96, noautoanchor=True, noval=True,
              max_labels=8, save_dir=tmp_path / "exp", workers=1, device="cpu")
    train(epochs=1, **kw)
    _, _, save_dir = train(epochs=2, resume=True, **kw)
    with open(save_dir / "results.csv") as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == ["0", "1"]  # epoch 1: the resumed second epoch

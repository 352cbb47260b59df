"""The plots a run writes by default: `train()`, `validator.run(plots=True)`,
detect's --visualize and `evolve` (tests/test_wired_features.py:128, 175,
198 and tests/test_aux_utils.py:79 for the port, PNG where the JAX package
writes JPEG).

The JAX detect's --visualize fails (a TypeError on the root module's entry
of flax's captured intermediates, yolov3_tpu/cli/detect.py:175);
`test_jax_detect_visualize_still_fails` asserts it still does, and the port
writes the reference's stage{i}_{op}_features.png for each layer.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.cli import detect
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.train.evolve import evolve
from yolov3_tpu_torch.train.loop import train

MICRO_CFG = {
    "nc": 2,
    "anchors": [[12, 12, 20, 20, 32, 32], [48, 48, 64, 64, 96, 96]],
    "layers": [{"from": -1, "n": 1, "op": "Conv", "args": [8, 3, 2]},
               {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
               {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
               {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
               {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
               {"from": [3, 4], "n": 1, "op": "Detect", "args": ["nc", "anchors"]}],
}
HYP = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.9, "weight_decay": 0.0, "warmup_epochs": 0.0, "box": 0.05,
       "obj": 1.0, "cls": 0.5, "mosaic": 0.0, "fliplr": 0.0, "hsv_h": 0, "hsv_s": 0, "hsv_v": 0,
       "translate": 0.0, "scale": 0.0, "anchor_t": 4.0}
TRAIN_PLOTS = ("labels.png", "labels_correlogram.jpg", "train_batch0.jpg", "train_batch1.jpg", "results.png",
               "confusion_matrix.png")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 noise images of 64 x 80 with two labels each (tests/test_wired_features.py's ds_root)."""
    root = tmp_path_factory.mktemp("wiredds")
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        cv2.imwrite(str(root / "images" / "train" / f"{i}.jpg"), rng.integers(0, 255, (64, 80, 3), np.uint8))
        (root / "labels" / "train" / f"{i}.txt").write_text("0 0.5 0.5 0.4 0.4\n1 0.3 0.3 0.2 0.2")
    return {"path": str(root), "train": "images/train", "val": "images/train", "names": {0: "a", 1: "b"}}


def test_training_emits_logger_artifacts(data, tmp_path):
    """Label plots, the correlogram, the first batches' mosaics, the confusion
    matrix and results.png (reference loggers/__init__.py:112-240); the PR / F1
    curves need a right detection, which this noise run has none of."""
    sd = tmp_path / "exp"
    train(data=data, cfg=MICRO_CFG, epochs=2, batch_size=4, imgsz=64, save_dir=sd, hyp=HYP, noautoanchor=True,
          workers=1, device="cpu")
    produced = {p.name for p in sd.iterdir()}
    for expected in (*TRAIN_PLOTS, "results.csv", "val_batch0_labels.jpg", "val_batch0_pred.jpg"):
        assert expected in produced, f"{expected} missing; got {sorted(produced)}"


def test_train_rect_noplots_label_smoothing(data, tmp_path):
    """--rect / --noplots / --label-smoothing / --sync-bn reach the engine: the rect run
    completes, no plot is written, hyp.yaml records the smoothing."""
    sd = tmp_path / "exp"
    train(data=data, cfg=MICRO_CFG, epochs=1, batch_size=4, imgsz=64, save_dir=sd, hyp={**HYP, "mosaic": 1.0},
          noautoanchor=True, rect=True, noplots=True, label_smoothing=0.05, sync_bn=True, workers=1, device="cpu")
    produced = {p.name for p in sd.iterdir()}
    assert "results.csv" in produced
    assert not produced & {*TRAIN_PLOTS, "val_batch0_labels.jpg"}, f"--noplots wrote {sorted(produced)}"
    assert yaml.safe_load((sd / "hyp.yaml").read_text())["label_smoothing"] == 0.05


def test_val_batch_mosaics(data, tmp_path):
    """plots=True writes val_batch{i}_labels / _pred.jpg (reference val.py:417-419)."""
    model = DetectionModel.from_config(MICRO_CFG, device="cpu")
    validator.run(data, model=model, batch_size=4, imgsz=64, rect=False, plots=True, save_dir=tmp_path)
    got = {p.name for p in tmp_path.glob("val_batch*")}
    assert {"val_batch0_labels.jpg", "val_batch0_pred.jpg", "val_batch1_labels.jpg", "val_batch1_pred.jpg"} <= got


@pytest.fixture(scope="module")
def micro_yaml(tmp_path_factory):
    f = tmp_path_factory.mktemp("cfg") / "micro.yaml"
    f.write_text(yaml.safe_dump(MICRO_CFG))
    return f


def test_detect_visualize_writes_feature_maps(micro_yaml, data, tmp_path):
    src = Path(data["path"]) / "images" / "train" / "0.jpg"
    out = detect.run(weights=str(micro_yaml), source=str(src), imgsz=(64, 64), visualize=True, nosave=True,
                     project=str(tmp_path), device="cpu")
    got = sorted(p.name for p in (Path(out) / "0").iterdir())
    assert got == [f"stage{i}_Conv_features.png" for i in range(5)]  # Detect's output is a tuple of maps
    with pytest.raises(NotImplementedError, match="visualize"):
        detect.run(weights=[str(micro_yaml)] * 2, source=str(src), imgsz=(64, 64), visualize=True,
                   project=str(tmp_path), device="cpu")


def test_jax_detect_visualize_still_fails(micro_yaml, data, tmp_path):
    from yolov3_tpu.cli import detect as jax_detect

    src = Path(data["path"]) / "images" / "train" / "0.jpg"
    with pytest.raises(TypeError, match="tuple indices"):
        jax_detect.run(weights=str(micro_yaml), source=str(src), imgsz=(64, 64), visualize=True, nosave=True,
                       project=str(tmp_path))


def test_evolve_plots_scatter(tmp_path):
    """evolve() writes the evolution's scatter plot (reference train.py:778)."""
    base = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.9, "weight_decay": 0.0005, "box": 0.05, "cls": 0.5,
            "obj": 1.0, "anchor_t": 4.0}
    calls = []

    def fake_train(hyp):
        calls.append(hyp)
        return (0.5, 0.5, 0.4 + 0.01 * len(calls), 0.2, 0, 0, 0)

    best_hyp, best_fit = evolve(fake_train, base, generations=3, save_dir=tmp_path, seed=0)
    assert len(calls) == 3 and best_fit > 0
    assert (tmp_path / "evolve.csv").exists() and (tmp_path / "evolve.png").exists()

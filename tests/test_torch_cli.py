"""The port's CLIs (yolov3_tpu_torch/cli/{detect,val,train}.py) against the
JAX package's.

- `parse_opt` of each takes the JAX CLI's flags with the JAX defaults; the
  stated differences: detect's default source (the port's own sample
  images) and val's resolved --data path (each package's coco128.yaml).
- `cli.val.run` on a `.pt` over a synthetic PNG dataset (12 frames at 96
  px, nc 80 labels) and `cli.train.main` for one epoch (yolov3 narrowed to
  width 0.125, depth 0.33, nc 5, 64 px, 8 train + 4 val frames, one worker,
  from the same starting weights): metrics within 0.005 of the JAX CLI's,
  the train losses within rtol 1e-3.
- `--device` unset means the card: without one, main raises.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import yolov3_tpu.cli.detect as jax_detect_cli
import yolov3_tpu.cli.train as jax_train_cli
import yolov3_tpu.cli.val as jax_val_cli
import yolov3_tpu.utils.general as jax_general
from test_torch_detect import planted_state_dict, write_pt
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov3_tpu_torch.cli import detect, train, val
from yolov3_tpu_torch.data import synthetic
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.utils.checkpoint import save_checkpoint
from yolov3_tpu_torch.utils.loggers import read_results

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95")
LOSSES = ("train/box_loss", "train/obj_loss", "train/cls_loss", "val/box_loss", "val/obj_loss", "val/cls_loss")


def jax_opt(monkeypatch, parse, argv=()):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    return vars(parse())


@pytest.mark.parametrize("name,differ", [("detect", {"source"}), ("val", {"data"}), ("train", set())])
def test_parse_opt_has_jax_flags_and_defaults(monkeypatch, name, differ):
    port_mod, jax_mod = {"detect": (detect, jax_detect_cli), "val": (val, jax_val_cli),
                         "train": (train, jax_train_cli)}[name]
    got, want = vars(port_mod.parse_opt(argv=[])), jax_opt(monkeypatch, jax_mod.parse_opt)
    assert set(got) == set(want)
    for k in set(want) - differ:
        assert got[k] == want[k], k
    if name == "val":
        assert Path(got["data"]).name == Path(want["data"]).name == "coco128.yaml"
        assert "yolov3_tpu_torch" in got["data"]
    if name == "detect":
        assert got["source"] == detect.DEFAULT_SOURCE
    flags = ["--weights", "a", "b", "--imgsz", "320", "--half", "--device", "cpu"]
    if name != "train":
        assert vars(port_mod.parse_opt(argv=flags)) == {**jax_opt(monkeypatch, jax_mod.parse_opt, flags),
                                                        **{k: vars(port_mod.parse_opt(argv=flags))[k] for k in differ}}


def test_main_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect.main(detect.parse_opt(argv=["--weights", "yolov3-tiny"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(train.parse_opt(argv=["--data", str(ROOT / "yolov3_tpu_torch/data/coco128.yaml")]))


@pytest.mark.parametrize("argv,match", [(["--sync-bn"], "item 8"), (["--num-processes", "2"], "item 8"),
                                        (["--resume", "comet://x"], "item 7")])
def test_train_unported_options_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(train.parse_opt(argv=["--device", "cpu", *argv]))


def test_val_run_matches_jax(tmp_path):
    data = synthetic.generate(tmp_path / "shapes", n_images=12, imgsz=96, seed=3)
    data_yaml = str(tmp_path / "shapes" / "dataset.yaml")
    pt = write_pt(tmp_path / "w" / "yolov3-tiny.pt", planted_state_dict())
    kw = dict(batch_size=4, imgsz=96, workers=1, exist_ok=True)
    got, _, _ = val.run(data_yaml, weights=str(pt), device="cpu", project=str(tmp_path / "port"), **kw)
    want, _, _ = jax_val_cli.run(data_yaml, weights=str(pt), project=str(tmp_path / "jax"), **kw)
    np.testing.assert_allclose(np.array(got[:4]), np.array(want[:4]), rtol=0, atol=0.005)
    assert len(data["names"]) == 5


def narrow_cfg():
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3.yaml").read_text())
    d.update(name="yolov3", width_multiple=0.125, depth_multiple=0.33, nc=5)
    return d


def test_train_main_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_general, "enable_compilation_cache", lambda *a, **k: None)
    synthetic.generate(tmp_path / "shapes", n_images=8, imgsz=64, seed=0, n_val=4)
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(narrow_cfg()))
    ref = JaxModel.from_config(narrow_cfg(), imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)
    jax_save_checkpoint(tmp_path / "w_jax", dict(variables), spec=ref.spec)
    model = load_jax_variables(DetectionModel(parse_spec(narrow_cfg())), variables)
    save_checkpoint(tmp_path / "w_port", {"model": model.state_dict()}, spec=model.spec)
    common = ["--data", str(tmp_path / "shapes" / "dataset.yaml"), "--cfg", str(cfg), "--epochs", "1",
              "--batch-size", "8", "--imgsz", "64", "--noautoanchor", "--workers", "1", "--seed", "0",
              "--noplots", "--exist-ok", "--name", "exp", "--device", "cpu",
              "--hyp", str(ROOT / "yolov3_tpu_torch/data/hyps/no-augmentation.yaml")]
    train.main(train.parse_opt(argv=[*common, "--weights", str(tmp_path / "w_port"), "--project",
                                     str(tmp_path / "port")]))
    monkeypatch.setattr(sys, "argv", ["prog", *common, "--weights", str(tmp_path / "w_jax"), "--project",
                                      str(tmp_path / "jax")])
    jax_train_cli.main(jax_train_cli.parse_opt())
    got = read_results(tmp_path / "port" / "exp" / "results.csv")
    want = read_results(tmp_path / "jax" / "exp" / "results.csv")
    assert len(got) == len(want) == 1
    for k in METRICS:
        assert abs(got[0][k] - want[0][k]) <= 0.005, k
    for k in LOSSES:
        assert got[0][k] == pytest.approx(want[0][k], rel=1e-3), k

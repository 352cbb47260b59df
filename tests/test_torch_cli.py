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
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
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


@pytest.mark.parametrize("argv,match", [(["--s2d-stem", "--cfg", "yolov3-tiny"], "tiny's maxpool stem is not")])
def test_train_s2d_stem_on_tiny_raises_jax_value_error(argv, match, tmp_path):
    """--s2d-stem runs (tests/test_torch_layout.py); on a stem that is not
    [Conv k3 s1, Conv k3 s2] it raises the JAX train()'s ValueError."""
    synthetic.generate(tmp_path / "shapes", n_images=4, imgsz=64, seed=0, n_val=2)
    argv = [*argv, "--data", str(tmp_path / "shapes" / "dataset.yaml"), "--project", str(tmp_path / "runs")]
    with pytest.raises(ValueError, match=match):
        train.main(train.parse_opt(argv=["--device", "cpu", *argv]))


def test_train_comet_resume_matches_jax(monkeypatch, tmp_path):
    """--resume comet://<path>: both CLIs restore the experiment's checkpoint
    directory and its opt.yaml through the (fake) Comet API, and train from
    that checkpoint with the saved options."""
    from test_loggers_sdk import _FakeCometAPIExperiment, _install_fake_comet

    assets = {"a1": ("last/checkpoint.yaml", b"epoch: 3\n", True), "a2": ("last/state.pt", b"STATE", True),
              "a3": ("opt.yaml", b"epochs: 7\nimgsz: 96\n", False)}
    _install_fake_comet(monkeypatch, api_experiment=_FakeCometAPIExperiment(assets))
    monkeypatch.chdir(tmp_path)
    calls = {}
    monkeypatch.setattr("yolov3_tpu_torch.train.loop.train", lambda **kw: calls.setdefault("port", kw))
    monkeypatch.setattr(jax_train_cli, "train", lambda **kw: calls.setdefault("jax", kw))
    train.main(train.parse_opt(argv=["--device", "cpu", "--resume", "comet://ws/proj/exp1"]))
    monkeypatch.setattr("yolov3_tpu.utils.general.enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["train.py", "--resume", "comet://ws/proj/exp1"])
    jax_train_cli.main(jax_train_cli.parse_opt())
    got, want = calls["port"], calls["jax"]
    assert got["weights"] == want["weights"] == str(Path("runs/comet_resume/ws_proj_exp1/last"))
    assert (got["epochs"], got["imgsz"], got["resume"]) == (want["epochs"], want["imgsz"], want["resume"]) == (7, 96, False)
    assert (tmp_path / got["weights"] / "state.pt").read_bytes() == b"STATE"


@pytest.mark.parametrize("argv,world", [(["--sync-bn"], None), (["--num-processes", "1"], 1)],
                         ids=["sync-bn", "num-processes"])
def test_train_multi_process_options(monkeypatch, argv, world):
    """--sync-bn reaches train() as the no-op it is; --num-processes with a
    --coordinator joins a gloo group on the CPU for the run (world 1 here;
    two processes in tests/test_torch_ddp.py) and leaves it after."""
    import socket

    from yolov3_tpu_torch.parallel import mesh
    from yolov3_tpu_torch.train import loop

    seen = {}

    def fake_train(**kw):
        seen.update(kw, grouped=mesh.grouped(), world=mesh.world_size(), backend=mesh.backend())
        return 0.0, (), None

    monkeypatch.setattr(loop, "train", fake_train)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    extra = ["--coordinator", f"127.0.0.1:{port}", "--process-id", "0"] if world else []
    train.main(train.parse_opt(argv=["--device", "cpu", "--data", str(ROOT / "yolov3_tpu_torch/data/coco128.yaml"),
                                     *argv, *extra]))
    assert seen["device"] == "cpu" and seen["sync_bn"] == ("--sync-bn" in argv)
    assert seen["grouped"] == bool(world) and seen["world"] == (world or 1)
    assert seen["backend"] == ("gloo" if world else None)
    assert not mesh.grouped()


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

"""The port's `train()` (train/loop.py) against the JAX package's `train()`
on the same synthetic PNG dataset and the same starting weights, in f32 on
the CPU.

Setup: yolov3 narrowed to width 0.125 and depth 0.33 (its stride-1 3x3
convs take the conv+BatchNorm-statistics route), nc 5, 64 px, 32 train
images at batch 16 (accumulate 4: the 4th step updates the parameters),
8 val images, 2 epochs, hyp no-augmentation, no autoanchor, one worker.
The JAX run starts from a JAX checkpoint of its seeded init, the port's
from its own checkpoint of the same variables.

Tolerances: per-epoch train and val losses rtol 1e-3, precision, recall and
mAPs within 0.005, lr equal to 1e-9; final EMA parameters and BatchNorm
statistics atol 1e-4 (the bar of tests/test_torch_train_step.py).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.train.loop import train as jax_train
from yolov3_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov3_tpu_torch.data import synthetic
from yolov3_tpu_torch.models.convert import from_jax_variables, load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.train.loop import train
from yolov3_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from yolov3_tpu_torch.utils.loggers import read_results

ROOT = Path(__file__).resolve().parents[1]
HYP = ROOT / "yolov3_tpu_torch/data/hyps/no-augmentation.yaml"
NC = 5
RUN = dict(epochs=2, batch_size=16, imgsz=64, hyp=str(HYP), noautoanchor=True, workers=1, seed=0)
LOSSES = ("train/box_loss", "train/obj_loss", "train/cls_loss", "val/box_loss", "val/obj_loss", "val/cls_loss")
METRICS = ("metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95")


def narrow_cfg():
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3.yaml").read_text())
    d.update(name="yolov3", width_multiple=0.125, depth_multiple=0.33, nc=NC)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    data = tmp / "shapes"
    synthetic.generate(data, n_images=32, imgsz=64, seed=0, n_val=8)
    ref = JaxModel.from_config(narrow_cfg(), imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)
    jax_save_checkpoint(tmp / "w_jax", dict(variables), spec=ref.spec)
    model = load_jax_variables(DetectionModel(parse_spec(narrow_cfg())), variables)
    save_checkpoint(tmp / "w_port", {"model": model.state_dict()}, spec=model.spec)

    yaml_file = str(data / "dataset.yaml")
    jax_train(yaml_file, weights=str(tmp / "w_jax"), save_dir=tmp / "jax", noplots=True, **RUN)
    train(yaml_file, weights=str(tmp / "w_port"), save_dir=tmp / "port", device="cpu", **RUN)
    return tmp, yaml_file


def test_results_match_jax(runs):
    tmp, _ = runs
    want, got = read_results(tmp / "jax/results.csv"), read_results(tmp / "port/results.csv")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for w, g in zip(want, got):
        for k in LOSSES:
            assert g[k] == pytest.approx(w[k], rel=1e-3), k
        for k in METRICS:
            assert abs(g[k] - w[k]) <= 0.005, k
        assert g["x/lr0"] == pytest.approx(w["x/lr0"], abs=1e-9)


def test_final_ema_matches_jax(runs):
    tmp, _ = runs
    state, meta = jax_load_checkpoint(tmp / "jax/weights/last")
    want = from_jax_variables(state)  # stripped: the EMA promoted to params / batch_stats
    sd, port_meta = load_checkpoint(tmp / "port/weights/last")
    got = sd["model"]
    assert port_meta["stripped"] and meta["stripped"] and set(sd) == {"model"}
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)
    assert port_meta["epoch"] == meta["epoch"] == 1


def test_resume_one_more_epoch(runs):
    tmp, yaml_file = runs
    before, _ = load_checkpoint(tmp / "port/weights/last")
    train(yaml_file, save_dir=tmp / "port", device="cpu", resume=True, **{**RUN, "epochs": 3})
    rows = read_results(tmp / "port/results.csv")
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    sd, meta = load_checkpoint(tmp / "port/weights/last")
    assert meta["epoch"] == 2 and meta["stripped"]
    # the resumed run started from the stripped weights and trained on
    moved = [k for k, v in sd["model"].items() if v.is_floating_point() and not torch.equal(v, before["model"][k])]
    assert moved and all(torch.isfinite(v).all() for v in sd["model"].values() if v.is_floating_point())


def test_validator_builds_its_loader_like_jax(runs):
    """validator.run(data=<yaml>) without a dataloader: the val split in rect
    batches with pad 0.5, as the JAX validator builds it."""
    from yolov3_tpu.eval import validator as jax_validator
    from yolov3_tpu.utils.checkpoint import load_model_from_checkpoint as jax_load_model
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    tmp, yaml_file = runs
    want, want_maps, _ = jax_validator.run(yaml_file, model=jax_load_model(tmp / "w_jax"), batch_size=4, imgsz=64,
                                           conf_thres=0.0001)
    got, got_maps, _ = validator.run(yaml_file, model=load_model_from_checkpoint(tmp / "w_port", device="cpu"),
                                     batch_size=4, imgsz=64, conf_thres=0.0001)
    np.testing.assert_allclose(got[:4], want[:4], atol=0.005)
    np.testing.assert_allclose(got_maps, want_maps, atol=0.005)


@pytest.mark.parametrize("option,item", [("s2d_stem", "item 9"), ("sync_bn", "item 8"),
                                         ("upload_dataset", "item 7"), ("entity", "item 7"),
                                         ("noplots", "item 5")])
def test_unported_options_raise(option, item):
    value = False if option == "noplots" else ("team" if option == "entity" else True)
    with pytest.raises(NotImplementedError, match=item):
        train("unused.yaml", device="cpu", **{option: value})


def test_autobatch_needs_the_card():
    from yolov3_tpu_torch.utils.autobatch import check_train_batch_size

    with pytest.raises(ValueError, match="CUDA"):
        check_train_batch_size(DetectionModel.from_config(narrow_cfg(), device="cpu"), imgsz=64)


@pytest.mark.parametrize("options", [
    dict(multi_scale=True, quad=True, image_weights=True, freeze=[2], cos_lr=True, label_smoothing=0.1,
         save_period=1),
    dict(rect=True, single_cls=True, optimizer="adamw", cache_images="ram"),
], ids=["multi_scale-quad-image_weights-freeze", "rect-single_cls-adamw"])
def test_train_options_run(runs, tmp_path, options):
    """Options of train() through two epochs on the CPU, the port alone (multi-scale and quad would
    make the JAX run compile a program per shape); rect, single_cls, AdamW, image_weights and freeze
    are held to the JAX train() in tests/test_torch_trainer_options.py."""
    tmp, yaml_file = runs
    start, _ = load_checkpoint(tmp / "w_port")
    train(yaml_file, cfg=narrow_cfg(), weights=str(tmp / "w_port"), save_dir=tmp_path / "run", device="cpu",
          **{**RUN, **options})
    rows = read_results(tmp_path / "run/results.csv")
    assert [r["epoch"] for r in rows] == [0, 1] and all(np.isfinite(list(r.values())).all() for r in rows)
    last, meta = load_checkpoint(tmp_path / "run/weights/last")
    if options.get("single_cls"):  # nc 5 -> 1: the Detect head re-initialised, the backbone transferred
        assert meta["model_yaml"]["nc"] == 1
        head = [k for k in last["model"] if ".m.0." in k and k.endswith("weight")]
        assert head and last["model"][head[0]].shape[0] == 3 * (1 + 5) != start["model"][head[0]].shape[0]
        assert last["model"]["model.0.conv.weight"].shape == start["model"]["model.0.conv.weight"].shape
    if options.get("freeze"):  # layers 0 and 1 never move; the others do (early in the warm-up the
        # weights' learning rate is 0, so the one update moves the biases)
        sd, meta = load_checkpoint(tmp_path / "run/weights/epoch1")
        assert meta["epoch"] == 1 and sd["optimizer"]["updates"] == 1
        params = [k for k in sd["model"] if k.endswith(("weight", "bias"))]
        for k in params:
            if k.startswith(("model.0.", "model.1.")):
                assert torch.equal(sd["model"][k], start["model"][k]), k
        assert any(not torch.equal(sd["model"][k], start["model"][k]) for k in params
                   if not k.startswith(("model.0.", "model.1.")) and k.endswith("bias"))

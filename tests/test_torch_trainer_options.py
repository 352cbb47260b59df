"""The port's `train()` against the JAX package's `train()` with the loop's
options on: rect batches, single_cls (the nc 5 checkpoint transferred to
nc 1 through `_transfer_to_nc`), AdamW, image_weights resampling, freeze
and the cosine schedule, on the same synthetic PNG dataset and starting
weights, in f32 on the CPU.

Setup as in tests/test_torch_trainer.py: yolov3 narrowed to width 0.125 and
depth 0.33, 64 px, 32 train images at batch 16, 8 val images, 2 epochs,
hyp no-augmentation, no autoanchor, one worker. A transfer to a new class
count re-initialises the Detect head, and the two packages draw their
random inits differently: the port's run therefore draws its fresh model
from JAX's seeded init (DetectionModel.from_config in train/loop.py is
replaced for this run), so both heads start alike. Which tensors the
transfer keeps is still the port's code.

The port runs first, on files without a label cache: it checks the labels
against the dataset's 5 classes before single_cls collapses them. The JAX
package checks them against nc 1 and would drop every image with a class
other than 0; it reads the label cache the port's run wrote (the two
packages share its format), as it would a cache of its own earlier run.

Tolerances: those of tests/test_torch_trainer.py (losses rtol 1e-3,
metrics within 0.005, lr to 1e-9, final EMA atol 1e-4); the frozen layers
exactly equal to the start in the full checkpoint of the last epoch.
"""

import shutil
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
from yolov3_tpu_torch.train import loop
from yolov3_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from yolov3_tpu_torch.utils.loggers import read_results

ROOT = Path(__file__).resolve().parents[1]
HYP = ROOT / "yolov3_tpu_torch/data/hyps/no-augmentation.yaml"
NC = 5
OPTIONS = dict(rect=True, single_cls=True, optimizer="adamw", image_weights=True, freeze=[2], cos_lr=True,
               save_period=1)
# AdamW's first update moves each parameter by about lr * sign(grad), so where a gradient is near 0
# float rounding decides the step: YOLOv5's Adam lr0 (1e-3) and a bias warm-up lr of 0.01 keep such
# a step below the EMA bar (with the SGD hyps' 0.1 one BatchNorm bias in 128 differs by 2.4e-4)
ADAMW_HYP = {**yaml.safe_load(HYP.read_text()), "lr0": 0.001, "warmup_bias_lr": 0.01}
RUN = dict(epochs=2, batch_size=16, imgsz=64, hyp=ADAMW_HYP, noautoanchor=True, workers=1, seed=0, **OPTIONS)
FROZEN = ("model.0.", "model.1.")
LOSSES = ("train/box_loss", "train/obj_loss", "train/cls_loss", "val/box_loss", "val/obj_loss", "val/cls_loss")
METRICS = ("metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95")


def narrow_cfg():
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3.yaml").read_text())
    d.update(name="yolov3", width_multiple=0.125, depth_multiple=0.33, nc=NC)
    return d


class JaxInitModel(DetectionModel):
    """The port's model, built with the JAX package's seeded init (the one
    the JAX `_transfer_to_nc` draws its new head from)."""

    @classmethod
    def from_config(cls, cfg="yolov3", seed=0, device=None, dtype=torch.float32, ch=3, nc=None, anchors=None):
        ref = JaxModel.from_config(cfg, ch=ch, nc=nc, anchors=anchors, imgsz=256)
        model = load_jax_variables(DetectionModel(parse_spec(cfg, ch=ch, nc=nc, anchors=anchors)),
                                   jax.tree.map(np.asarray, ref.variables))
        return model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_options")
    data = tmp / "shapes"
    synthetic.generate(data, n_images=32, imgsz=64, seed=0, n_val=8)
    ref = JaxModel.from_config(narrow_cfg(), imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)
    jax_save_checkpoint(tmp / "w_jax", dict(variables), spec=ref.spec)
    model = load_jax_variables(DetectionModel(parse_spec(narrow_cfg())), variables)
    save_checkpoint(tmp / "w_port", {"model": model.state_dict()}, spec=model.spec)

    yaml_file = str(data / "dataset.yaml")
    with pytest.MonkeyPatch.context() as mp:  # first, on files without a label cache
        mp.setattr(loop, "DetectionModel", JaxInitModel)
        loop.train(yaml_file, cfg=narrow_cfg(), weights=str(tmp / "w_port"), save_dir=tmp / "port", device="cpu",
                   **RUN)
    jax_train(yaml_file, cfg=narrow_cfg(), weights=str(tmp / "w_jax"), save_dir=tmp / "jax", noplots=True, **RUN)
    return tmp


def test_options_results_match_jax(runs):
    want, got = read_results(runs / "jax/results.csv"), read_results(runs / "port/results.csv")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for w, g in zip(want, got):
        for k in LOSSES:
            assert g[k] == pytest.approx(w[k], rel=1e-3), k
        for k in METRICS:
            assert abs(g[k] - w[k]) <= 0.005, k
        assert g["x/lr0"] == pytest.approx(w["x/lr0"], abs=1e-9)


def test_options_final_ema_matches_jax(runs):
    state, meta = jax_load_checkpoint(runs / "jax/weights/last")
    want = from_jax_variables(state)
    sd, port_meta = load_checkpoint(runs / "port/weights/last")
    got = sd["model"]
    assert port_meta["model_yaml"]["nc"] == meta["model_yaml"]["nc"] == 1  # single_cls: nc 5 -> 1
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)


def test_options_transfer_and_freeze(runs):
    """The backbone came from the nc 5 checkpoint, the head is new, and the
    frozen layers 0 and 1 never moved while the others did."""
    start, _ = load_checkpoint(runs / "w_port")
    sd, meta = load_checkpoint(runs / "port/weights/epoch1")
    model = sd["model"]
    assert meta["epoch"] == 1 and sd["step"] == 4 and sd["optimizer"]["updates"] >= 1  # 32 images, batch 16
    head = [k for k in model if ".m.0." in k and k.endswith("weight")]
    assert head and model[head[0]].shape[0] == 3 * (1 + 5) != start["model"][head[0]].shape[0]
    params = [k for k in model if k.endswith(("weight", "bias")) and k in start["model"]
              and model[k].shape == start["model"][k].shape]
    for k in params:
        if k.startswith(FROZEN):
            assert torch.equal(model[k], start["model"][k]), k
    assert any(not torch.equal(model[k], start["model"][k]) for k in params if not k.startswith(FROZEN))


def test_single_cls_validator_keeps_every_label(runs, tmp_path):
    """validator.run(single_cls=True) on a copy of the dataset without a label
    cache gives the JAX validator's metrics on the cached original: the labels
    are checked against the dataset's 5 classes, not the model's 1."""
    from yolov3_tpu.eval import validator as jax_validator
    from yolov3_tpu.utils.checkpoint import load_model_from_checkpoint as jax_load_model
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    copy = tmp_path / "shapes"
    shutil.copytree(runs / "shapes", copy)
    for f in copy.rglob("*.cache.npz"):
        f.unlink()
    data = yaml.safe_load((copy / "dataset.yaml").read_text())
    (copy / "dataset.yaml").write_text(yaml.safe_dump({**data, "path": str(copy)}))  # the path is absolute
    kw = dict(batch_size=4, imgsz=64, conf_thres=0.0001, single_cls=True)
    want, want_maps, _ = jax_validator.run(str(runs / "shapes/dataset.yaml"),
                                           model=jax_load_model(runs / "jax/weights/last"), **kw)
    got, got_maps, _ = validator.run(str(copy / "dataset.yaml"),
                                     model=load_model_from_checkpoint(runs / "port/weights/last", device="cpu"), **kw)
    assert want[1] > 0 and (copy / "labels/val.cache.npz").is_file()  # the port read the copy, caching it
    np.testing.assert_allclose(got[:4], want[:4], atol=0.005)
    np.testing.assert_allclose(got_maps, want_maps, atol=0.005)

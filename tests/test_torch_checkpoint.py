"""The port's checkpoints (utils/checkpoint.py): save -> load gives the
same state exactly, strip promotes the EMA and drops the optimizer, the
model is rebuilt from `model_yaml`, and checkpoint.yaml has the JAX
package's keys."""

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov3_tpu.utils.checkpoint import spec_to_dict as jax_spec_to_dict
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.optim import build_optimizer
from yolov3_tpu_torch.train.step import make_train_step
from yolov3_tpu_torch.utils import checkpoint

SPEC = {
    "nc": 2,
    "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
    "layers": [
        {"from": -1, "n": 1, "op": "Conv", "args": [8, 3, 1]},
        {"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 2]},
        {"from": -1, "n": 2, "op": "Bottleneck", "args": [16]},
        {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 2]},
        {"from": [2, 3], "n": 1, "op": "Detect", "args": ["nc", "anchors"]},
    ],
}
META = {"epoch": 3, "best_fitness": 0.25, "names": {0: "a", 1: "b"}, "hyp": {"lr0": 0.01}, "results": [0.0] * 7}


def trained_state(steps=3, seed=0, autobalance=True):
    model = DetectionModel.from_config(SPEC, seed=seed, device="cpu")
    hyp = {"warmup_epochs": 0.0}
    opt, _, _ = build_optimizer("sgd", model, hyp, epochs=5, steps_per_epoch=4, batch_size=64, min_warmup_steps=0)
    cfg = LossConfig.from_model(model.spec, hyp)
    cfg = type(cfg)(**{**cfg.__dict__, "autobalance": autobalance})
    step = make_train_step(model, cfg, opt, compute_dtype=torch.float32)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        imgs = rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
        targets = np.tile(np.array([[0, 0.5, 0.5, 0.4, 0.4], [1, 0.3, 0.3, 0.2, 0.2]], np.float32), (2, 1, 1))
        step(imgs, targets, np.ones((2, 2), bool))
    return step.state


def flat(state):
    sd = checkpoint.train_state_dict(state)
    out = {f"model/{k}": v for k, v in sd["model"].items()}
    out.update({f"ema/{k}": v for k, v in sd["ema"]["ema"].items()})
    for p, st in sd["optimizer"]["optimizer"]["state"].items():
        out[f"momentum/{p}"] = st["momentum_buffer"]
    out["balance"] = sd["balance"]
    return out, (sd["step"], sd["ema"]["updates"], sd["optimizer"]["updates"], sd["optimizer"]["micro"])


def test_save_load_restores_every_tensor_and_counter(tmp_path):
    src = trained_state()
    checkpoint.save_checkpoint(tmp_path / "ck", src, spec=src.model.spec, meta=META)
    dst = trained_state(steps=1, seed=1)
    sd, meta = checkpoint.load_checkpoint(tmp_path / "ck")
    checkpoint.restore_train_state(dst, sd)
    (a, ca), (b, cb) = flat(src), flat(dst)
    assert ca == cb == (3, 3, 3, 0) and a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert meta["epoch"] == 3 and meta["names"] == {0: "a", 1: "b"}
    assert dst.optimizer.optimizer.param_groups[0]["lr"] == src.optimizer.optimizer.param_groups[0]["lr"]
    assert not list(tmp_path.glob("ck/.*tmp"))  # the temporary files were renamed


def test_strip_promotes_ema_and_drops_optimizer(tmp_path):
    src = trained_state()
    checkpoint.save_checkpoint(tmp_path / "ck", src, spec=src.model.spec, meta=META)
    checkpoint.strip_checkpoint(tmp_path / "ck", out=tmp_path / "stripped")
    sd, meta = checkpoint.load_checkpoint(tmp_path / "stripped")
    assert set(sd) == {"model"} and meta["stripped"] is True and meta["epoch"] == 3
    for k, v in src.ema.ema.items():
        assert torch.equal(sd["model"][k], v), k
    assert any(not torch.equal(sd["model"][k], v) for k, v in src.model.state_dict().items())
    # resuming from a stripped checkpoint: the weights and a fresh EMA, no optimizer state
    dst = trained_state(steps=0, seed=1)
    checkpoint.restore_train_state(dst, sd)
    assert dst.step == 0 and not dst.optimizer.optimizer.state
    for k, v in sd["model"].items():
        assert torch.equal(dst.model.state_dict()[k], v) and torch.equal(dst.ema.ema[k], v)


def test_load_model_rebuilds_spec_from_model_yaml(tmp_path):
    src = trained_state()
    checkpoint.save_checkpoint(tmp_path / "ck", src, spec=src.model.spec, meta=META)
    model = checkpoint.load_model_from_checkpoint(tmp_path / "ck", device="cpu")
    assert model.spec == src.model.spec and model.names == {0: "a", 1: "b"} and not model.training
    for k, v in src.ema.ema.items():
        assert torch.equal(model.state_dict()[k], v), k  # the EMA weights, as the JAX package loads them
    x = torch.rand(1, 32, 32, 3)
    full = DetectionModel.from_config(SPEC, device="cpu")
    full.load_state_dict(src.ema.ema)
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(model(x), full.eval()(x)))
    for name in ("yolov3", "yolov3-tiny", "yolov3-spp"):  # every shipped config survives the round trip
        spec = parse_spec(name)
        assert parse_spec(checkpoint.spec_to_dict(spec)) == spec


def test_spec_to_dict_equals_jax():
    from yolov3_tpu.models.spec import parse_spec as jax_parse_spec

    for name in ("yolov3", "yolov3-tiny"):
        assert checkpoint.spec_to_dict(parse_spec(name)) == jax_spec_to_dict(jax_parse_spec(name))


def test_checkpoint_yaml_has_the_jax_keys(tmp_path):
    ref = JaxModel.from_config(SPEC, imgsz=32)
    jax_save_checkpoint(tmp_path / "jax", dict(jax.tree.map(np.asarray, ref.variables)), spec=ref.spec, meta=META)
    src = trained_state(steps=1)
    checkpoint.save_checkpoint(tmp_path / "port", src, spec=src.model.spec, meta=META)
    want = yaml.safe_load((tmp_path / "jax/checkpoint.yaml").read_text())
    got = yaml.safe_load((tmp_path / "port/checkpoint.yaml").read_text())
    assert set(got) == set(want) == {"epoch", "best_fitness", "names", "hyp", "results", "date", "git",
                                     "model_yaml"}
    assert got["model_yaml"] == want["model_yaml"] and set(got["git"]) == set(want["git"])


@pytest.mark.parametrize("nc", [2, 4])
def test_transfer_to_nc_keeps_the_backbone(nc):
    from yolov3_tpu_torch.train.loop import _transfer_to_nc

    model = DetectionModel.from_config(SPEC, seed=3, device="cpu")
    new = _transfer_to_nc(model, SPEC, nc)
    assert new.spec.nc == nc
    old, sd = model.state_dict(), new.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, old[k]) == (not k.startswith("model.4.") or nc == 2), k

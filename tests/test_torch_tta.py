"""Test-time augmentation (models/detection.py predict_augmented) against the
JAX package's `predict_augmented_pure`, and `validator.run(augment=True)`
against the JAX validator's.

The model is yolov3 narrowed to width 0.125, depth 0.33 and nc 3, the same
variables in both packages (models.convert), with detections planted on the
head bias as in tests/test_torch_val.py. Augmented decoded predictions at
two input shapes (square, and one whose scaled sides are not stride
multiples, so the 0.447 padding shows) within atol 2e-3, rtol 1e-3; the
resize alone (`_scale_img`) within 1e-5. The
augmented validation over four 96 px frames (one batch shape, labelled with
the port's plain detections): metrics within 0.005."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_val import NC, narrow_cfg, plant, port_model, rect_loader, write_dataset
from yolov3_tpu.eval import validator as jax_validator
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.detection import _scale_img as jax_scale_img
from yolov3_tpu.models.detection import predict_augmented_pure
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.detection import _scale_img, predict_augmented
from yolov3_tpu_torch.ops import boxes


@pytest.fixture(scope="module")
def models():
    """~4 / 2 / 1 cells an image above conf 0.25 at the three scales (tests/test_torch_val.py's planting)."""
    cfg = narrow_cfg()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(1), imgsz=64)
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
    return JaxModel(ref.spec, variables), port_model(variables, cfg)


@pytest.mark.parametrize("shape", [(2, 96, 96), (1, 100, 132)])
def test_scale_img_equals_jax(shape):
    x = np.random.default_rng(0).uniform(0, 1, (*shape, 3)).astype(np.float32)
    for ratio in (0.83, 0.67):
        got = _scale_img(torch.from_numpy(x), ratio, 32).numpy()
        want = np.asarray(jax_scale_img(jnp.asarray(x), ratio, 32))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 96, 96), (1, 96, 160)])
def test_predict_augmented_equals_jax(models, shape):
    jax_model, model = models
    x = np.random.default_rng(1).uniform(0, 1, (*shape, 3)).astype(np.float32)
    with torch.no_grad():
        got = predict_augmented(model, torch.from_numpy(x)).numpy()
        assert np.array_equal(model.predict(torch.from_numpy(x), augment=True).numpy(), got)
    want = np.asarray(predict_augmented_pure(jax_model.module, jax_model.variables, jnp.asarray(x),
                                             jax_model.anchors_px, jax_model.spec.strides, jax_model.spec.nl,
                                             int(jax_model.stride)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_validator_augment_matches_jax(models, tmp_path):
    jax_model, model = models
    sizes = [(96, 96)] * 4
    images = write_dataset(tmp_path / "unlabelled", sizes, seed=11)
    forward = validator.make_forward(model)
    labels, loader = {}, rect_loader(images)
    for imgs, _, _, shapes in loader:
        dets, n = forward(torch.from_numpy(imgs))
        for si in range(imgs.shape[0]):
            d = dets[si, : int(n[si])].numpy()
            d = d[d[:, 4] > 0.25]
            (h0, w0), ratio_pad = shapes[si]
            xywh = boxes.xyxy2xywh(boxes.scale_boxes(imgs.shape[1:3], d[:, :4], (h0, w0), ratio_pad))
            xywh /= np.array([w0, h0, w0, h0], np.float32)
            labels[f"{len(labels):03d}"] = [[c, *b] for c, b in zip(d[:, 5], xywh) if (b[2:] > 0.01).all()]
    assert sum(map(len, labels.values())) >= 4, labels
    batches = list(rect_loader(write_dataset(tmp_path / "labelled", sizes, seed=11, labels=labels)))
    data = {"path": str(tmp_path), "val": str(tmp_path / "labelled" / "images"), "names": {i: str(i) for i in range(NC)}}
    out = {}
    for label, run, m in (("jax", jax_validator.run, jax_model), ("port", validator.run, model)):
        results, maps, _ = run(data, model=m, batch_size=2, imgsz=96, dataloader=batches, augment=True)
        out[label] = (np.array(results[:4], np.float64), maps)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0, atol=0.005)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=0, atol=0.005)
    assert out["jax"][0][2] > 0.3, out["jax"]

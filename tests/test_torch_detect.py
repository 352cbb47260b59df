"""The detect CLI (yolov3_tpu_torch/cli/detect.py) against the JAX
package's, on the same weights and images, in float32 on the CPU.

One yolov3-tiny `.pt` (the reference's layout), written here from seeded
weights with the Detect objectness raised and spread and a few classes
favoured, so that every image has detections and no two candidates nearly
tie. The port reads the `.pt`; the JAX CLI, which reads a single `.pt` as a
cfg YAML and fails (ROADMAP.md queue 3), reads a JAX checkpoint of the same
variables (the JAX `load_weights` of the `.pt`). Sources: both sample
images and the JPEG corpus, at 160 px. Per image: n equal, boxes within 0.1
px before the round, conf within 1e-3, the `--save-txt --save-conf` rows
within 1e-4, the summary strings equal (their times aside); `--augment`,
`--classes` and `--agnostic-nms` are run the same way. The annotated images
and crops are PNG files of the source's shape."""

import logging
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import yolov3_tpu.cli.detect as jax_detect
from yolov3_tpu.models.loading import load_weights as jax_load_weights
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov3_tpu.utils.general import LOGGER as JAX_LOGGER
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.cli import detect
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.utils.general import LOGGER

ROOT = Path(__file__).resolve().parents[1]
IMGSZ = 160
FAVOURED = {0: 7.5, 2: 7.0, 16: 6.5}  # class -> bias bump: class probabilities ~0.93 / 0.9 / 0.84
PER_IMAGE = (8, 4)  # cells an image above conf 0.25, at strides 16 and 32


def source_files():
    return sorted((ROOT / "tests/data/jpeg").glob("*.jpg")) + sorted((ROOT / "yolov3_tpu_torch/data/images").glob("*.jpg"))


def planted_state_dict(seed=0):
    """Seeded yolov3-tiny weights whose objectness logits spread by 4 over the test images (the
    kernel's objectness columns scaled), with the bias set so about PER_IMAGE cells an image pass
    conf 0.25 at each stride, and a few classes favoured (tests/test_torch_val.py's planting)."""
    from yolov3_tpu_torch.data.augment import letterbox

    model = DetectionModel.from_config("yolov3-tiny", seed=seed, device="cpu")
    sd = model.state_dict()
    ims = np.stack([letterbox(image_ops.imread(p), IMGSZ, auto=False)[0][:, :, ::-1] for p in source_files()])
    with torch.no_grad():
        feats = model(torch.from_numpy(ims.copy()).float() / 255.0)
    no = 85
    for i, f in enumerate(feats):
        w, b = sd[f"model.20.m.{i}.weight"], sd[f"model.20.m.{i}.bias"]
        b0 = b[4::no].clone()
        spread = f[..., 4] - b0[None, :, None, None]
        g = float(4.0 / max(float(spread.std()), 1e-8))
        q = float(torch.quantile((g * spread).flatten(), 1.0 - PER_IMAGE[i] / spread[0].numel()))
        w[4::no] *= g
        b[4::no] = float(np.log(0.3 / 0.7)) - q
        cls_b = b.view(3, no)[:, 5:]
        for c, bump in FAVOURED.items():
            cls_b[:, c] += bump
    return sd


def write_pt(path, sd):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": -1, "model": sd}, path)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("detect")
    pt = write_pt(tmp / "w" / "yolov3-tiny.pt", planted_state_dict())
    jm = jax_load_weights(str(pt))
    ckpt = jax_save_checkpoint(tmp / "w" / "jax_ckpt", {"params": jm.variables["params"],
                                                      "batch_stats": jm.variables["batch_stats"]}, spec=jm.spec)
    src = tmp / "images"
    src.mkdir()
    for p in source_files():
        shutil.copy(p, src / p.name)
    return dict(tmp=tmp, pt=pt, ckpt=ckpt, src=src)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_both(setup, monkeypatch, name, **kw):
    """Both CLIs' run with the same options; per package: boxes before the round (one array per image
    with detections), the per-image summary strings without their times, and the save_dir."""
    out = {}
    for label, mod, logger, weights, extra in (
            ("jax", jax_detect, JAX_LOGGER, str(setup["ckpt"]), {}),
            ("port", detect, LOGGER, str(setup["pt"]), {"device": "cpu"})):
        boxes = []
        real = mod.scale_boxes

        def recording(*args, _real=real, _boxes=boxes):
            b = np.asarray(_real(*args))
            _boxes.append(b.copy())
            return b

        monkeypatch.setattr(mod, "scale_boxes", recording)
        h = Lines()
        logger.addHandler(h)
        try:
            save_dir = mod.run(weights=weights, source=str(setup["src"]), imgsz=(IMGSZ, IMGSZ),
                               project=str(setup["tmp"] / label), name=name, **kw, **extra)
        finally:
            logger.removeHandler(h)
        lines = [re.sub(r"[\d.]+ms$", "", ln) for ln in h.lines if ln.startswith("image ")]
        out[label] = dict(boxes=boxes, lines=lines, save_dir=Path(save_dir))
    return out["port"], out["jax"]


def read_txt(save_dir):
    return {p.stem: np.loadtxt(p, ndmin=2) for p in sorted((save_dir / "labels").glob("*.txt"))}


def assert_same(got, want, save_txt=True):
    assert got["lines"] == want["lines"] and len(want["lines"]) == 14
    assert len(got["boxes"]) == len(want["boxes"]) >= 10
    for g, w in zip(got["boxes"], want["boxes"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=0.1)
    if save_txt:
        gt, wt = read_txt(got["save_dir"]), read_txt(want["save_dir"])
        assert sorted(gt) == sorted(wt) and len(wt) >= 10
        for stem in wt:
            g, w = gt[stem], wt[stem]
            assert g.shape == w.shape and g.shape[1] == 6, stem  # cls xywh conf
            np.testing.assert_array_equal(g[:, 0], w[:, 0])
            np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], atol=1e-4, err_msg=stem)
            np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1e-3, err_msg=stem)


def test_detect_matches_jax(setup, monkeypatch):
    """Rows, labels and the files: the same names as the JAX CLI's (JPEG),
    each the bytes cv2.imwrite gives for the array the port drew."""
    import cv2

    written, real = {}, image_ops.imwrite
    monkeypatch.setattr(image_ops, "imwrite", lambda path, im: written.__setitem__(Path(path), im.copy()) or real(path, im))
    got, want = run_both(setup, monkeypatch, "plain", save_txt=True, save_conf=True, save_crop=True)
    assert_same(got, want)
    sd = got["save_dir"]

    def images(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*.jpg"))

    assert images(sd) == images(want["save_dir"]) and len(written) == len(images(sd))
    for f, im in written.items():
        assert f.suffix == ".jpg" and f.read_bytes() == cv2.imencode(".jpg", im)[1].tobytes(), f
    for p in sorted(setup["src"].glob("*.jpg")):
        annotated = image_ops.imread(sd / p.name)
        assert annotated.shape == image_ops.imread(p).shape
    crops = sorted((sd / "crops").rglob("*.jpg"))
    assert crops and {c.parent.name for c in crops} <= {"person", "car", "dog"} | set(map(str, range(80)))
    assert set(detect.run.speed_ms) == {"pre", "inference", "nms", "post"}


def test_detect_augment_matches_jax(setup, monkeypatch):
    got, want = run_both(setup, monkeypatch, "tta", augment=True, save_txt=True, save_conf=True, nosave=True)
    assert_same(got, want)


def test_detect_classes_agnostic_matches_jax(setup, monkeypatch):
    got, want = run_both(setup, monkeypatch, "cls", classes=[0, 16], agnostic_nms=True, save_txt=True,
                         save_conf=True, nosave=True)
    assert_same(got, want)
    for rows in read_txt(got["save_dir"]).values():
        assert set(rows[:, 0].astype(int)) <= {0, 16}


def test_detect_refusals(setup, tmp_path):
    # --visualize is ported (tests/test_torch_plot_hooks.py)
    # exported .pt2 / .onnx / .tflite / _savedmodel run through MultiBackend (tests/test_torch_backend.py,
    # tests/test_torch_tf_export.py), an artifact without its sidecar raises; what the port does not read raises
    for artifact, error, match in (("m.stablehlo", ValueError, "pt2"), ("m.tflite", FileNotFoundError, "sidecar"),
                                   ("m.onnx", FileNotFoundError, "sidecar")):
        with pytest.raises(error, match=match):
            detect.run(weights=artifact, device="cpu", project=str(tmp_path))
    assert detect.DEFAULT_SOURCE.endswith("yolov3_tpu_torch/data/images")
    assert len(list(Path(detect.DEFAULT_SOURCE).glob("*.jpg"))) == 2

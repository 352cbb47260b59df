"""AutoShape / Detections (models/autoshape.py), hub (hub.py) and Ensemble
(models/ensemble.py) against the JAX package's, on the CPU.

- AutoShape over a path, an RGB ndarray, an object with `.convert` (PIL's
  duck type) and a list of them, on the planted yolov3-tiny `.pt` of
  tests/test_torch_detect.py: the Detections' xyxy, xywh, xyxyn and xywhn
  per image equal to the JAX AutoShape's (n equal, boxes 0.1 px, conf 1e-3,
  classes equal), and the same summary from print().
- hub.load builds yolov3, yolov3-spp and yolov3-tiny with the JAX package's
  parameter counts (its module traced with jax.eval_shape).
- An Ensemble of two `.pt` files: detect and the validator give the JAX
  package's results (detections as in tests/test_torch_detect.py; metrics
  within 0.005 and per-image predictions n / 0.1 px / 1e-3).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import yolov3_tpu.hub as jax_hub
from test_torch_detect import IMGSZ, Lines, planted_state_dict, write_pt
from test_torch_val import Recorder
from yolov3_tpu.eval import validator as jax_validator
from yolov3_tpu.models.detection import YOLOGraph
from yolov3_tpu.models.ensemble import attempt_load as jax_attempt_load
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.utils.general import LOGGER as JAX_LOGGER
from yolov3_tpu_torch import hub
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.autoshape import AutoShape, Detections
from yolov3_tpu_torch.models.ensemble import Ensemble, attempt_load
from yolov3_tpu_torch.utils.general import LOGGER

ROOT = Path(__file__).resolve().parents[1]
SAMPLES = sorted((ROOT / "yolov3_tpu_torch" / "data" / "images").glob("*.jpg"))


@pytest.fixture(scope="module")
def pts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hub")
    return [write_pt(tmp / name / "yolov3-tiny.pt", planted_state_dict(seed)) for name, seed in (("a", 0), ("b", 1))]


class Duck:
    """An image with PIL's `.convert`, without PIL."""

    def __init__(self, rgb):
        self.rgb, self.filename = rgb, "duck.jpg"

    def convert(self, mode):
        assert mode == "RGB"
        return self.rgb


def assert_detections_equal(got, want):
    assert got.n == want.n and [Path(f).stem for f in got.files] == [Path(f).stem for f in want.files]
    assert all(f.endswith(".png") for f in got.files)  # saved as PNG, where the JAX package writes .jpg
    for attr in ("xyxy", "xywh", "xyxyn", "xywhn"):
        for g, w in zip(getattr(got, attr), getattr(want, attr)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, attr
            scale = 1.0 if attr in ("xyxy", "xywh") else 1e-3  # 0.1 px, normalised by a side of >= 100 px
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.1 * scale, err_msg=attr)
            np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-3, err_msg=attr)
            np.testing.assert_array_equal(g[:, 5], w[:, 5], err_msg=attr)


def summary(det, logger):
    h = Lines()
    logger.addHandler(h)
    try:
        det.print()
    finally:
        logger.removeHandler(h)
    return h.lines[-1].split("\nSpeed")[0]


def test_autoshape_matches_jax(pts):
    port = hub.custom(str(pts[0]), device="cpu")
    ref = jax_hub.custom(str(pts[0]))
    assert isinstance(port, AutoShape) and port.names == ref.names
    rgb = image_ops.imread(SAMPLES[1])[:, :, ::-1].copy()
    inputs = [str(SAMPLES[0]), rgb, [str(SAMPLES[0]), rgb]]
    for x in inputs:
        got, want = port(x, size=IMGSZ), ref(x, size=IMGSZ)
        assert isinstance(got, Detections)
        assert_detections_equal(got, want)
        assert summary(got, LOGGER) == summary(want, JAX_LOGGER)
        assert sum(len(p) for p in got.pred) > 0
    duck, plain = port(Duck(rgb), size=IMGSZ), port(rgb, size=IMGSZ)
    assert duck.files == ["duck.png"]
    np.testing.assert_array_equal(duck.pred[0], plain.pred[0])
    parts = got.tolist()
    assert len(parts) == 2 and all(p.n == 1 for p in parts)


def test_detections_save_crop_render(pts, tmp_path):
    det = hub.custom(str(pts[0]), device="cpu")([str(SAMPLES[0])], size=IMGSZ)
    before = det.ims[0].copy()
    det.save(save_dir=tmp_path / "save")
    # drawing leaves the images as they are (the JAX package draws into an image read from a path: ROADMAP.md queue 3)
    np.testing.assert_array_equal(det.ims[0], before)
    saved = image_ops.imread(tmp_path / "save" / "sample1.png")
    assert saved.shape == (480, 640, 3)
    crops = det.crop(save_dir=tmp_path / "crop")
    assert len(crops) == len(det.pred[0]) and (tmp_path / "crop" / "crops").is_dir()
    rendered = det.render()
    np.testing.assert_array_equal(rendered[0], saved[:, :, ::-1])


@pytest.mark.parametrize("cfg", ["yolov3", "yolov3-spp", "yolov3-tiny"])
def test_hub_load_builds_jax_parameter_counts(cfg):
    model = hub.load(cfg, autoshape=False, device="cpu")
    module = YOLOGraph(spec=jax_parse_spec(cfg))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert model.num_params() == want
    assert {"yolov3": 61_949_149, "yolov3-spp": 62_998_749, "yolov3-tiny": 8_852_366}[cfg] == want


def test_ensemble_detect_matches_jax(pts, tmp_path, monkeypatch):
    ens = attempt_load([str(p) for p in pts], device="cpu")
    assert isinstance(ens, Ensemble) and ens.stride == 32
    src = tmp_path / "images"
    src.mkdir()
    for p in SAMPLES:
        (src / p.name).write_bytes(p.read_bytes())
    weights = [str(p) for p in pts]

    import yolov3_tpu.cli.detect as jax_detect
    from yolov3_tpu_torch.cli import detect

    outs = {}
    for label, mod, logger, extra in (("jax", jax_detect, JAX_LOGGER, {}), ("port", detect, LOGGER, {"device": "cpu"})):
        h = Lines()
        logger.addHandler(h)
        try:
            sd = mod.run(weights=weights, source=str(src), imgsz=(IMGSZ, IMGSZ), project=str(tmp_path / label),
                         save_txt=True, save_conf=True, nosave=True, **extra)
        finally:
            logger.removeHandler(h)
        outs[label] = (sd, [ln.rsplit(",", 1)[0] for ln in h.lines if ln.startswith("image ")])
    (gd, gl), (wd, wl) = outs["port"], outs["jax"]
    assert gl == wl and len(wl) == 2
    for p in SAMPLES:
        g, w = (np.loadtxt(d / "labels" / f"{p.stem}.txt", ndmin=2) for d in (gd, wd))
        assert g.shape == w.shape and len(w) > 0
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], atol=1e-3)  # boxes rounded to pixels, then normalised
        np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1e-3)


def test_ensemble_validator_matches_jax(pts, tmp_path):
    from yolov3_tpu_torch.data import synthetic

    synthetic.generate(tmp_path / "shapes", n_images=6, imgsz=96, seed=5)
    data = str(tmp_path / "shapes" / "dataset.yaml")
    out = {}
    for label, run, model in (("jax", jax_validator.run, jax_attempt_load([str(p) for p in pts])),
                              ("port", validator.run, attempt_load([str(p) for p in pts], device="cpu"))):
        rec = Recorder()
        results, maps, _ = run(data, model=model, batch_size=3, imgsz=IMGSZ, callbacks=rec, workers=1)
        out[label] = (np.array(results[:4]), rec.preds)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0, atol=0.005)
    got, want = out["port"][1], out["jax"][1]
    assert sorted(got) == sorted(want) and len(want) == 6
    for stem, w in want.items():
        g = got[stem]
        assert len(g) == len(w) and len(w) > 0, stem
        # rows of (nearly) equal confidence may come in either order: match each JAX row to its nearest port row
        free = np.ones(len(g), bool)
        for row in w:
            d = np.where(free, np.abs(g[:, :4] - row[:4]).max(1) + 100 * np.abs(g[:, 4] - row[4])
                         + 1e3 * (g[:, 5] != row[5]), np.inf)
            j = int(np.argmin(d))
            free[j] = False
            np.testing.assert_allclose(g[j, :4], row[:4], atol=0.1, err_msg=stem)
            np.testing.assert_allclose(g[j, 4], row[4], atol=1e-3, err_msg=stem)
            assert g[j, 5] == row[5], stem

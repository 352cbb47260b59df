"""Exported artifacts through the port's validator, detect CLI and
benchmarks (yolov3_tpu_torch/models/backend.py, eval/validator.py,
cli/detect.py, cli/benchmarks.py) against the JAX package's, in float32 on
the CPU.

The weights are tests/test_torch_detect.py's planted yolov3-tiny; the port
exports `.pt2` and `.onnx` from a port checkpoint of the JAX variables, the
JAX package `.stablehlo` and `.onnx` from a JAX checkpoint of them, each with
a dynamic batch. Detect over four detect images through each artifact writes
the same label rows (n equal, coordinates within 1e-4 of the normalised
image). Those JAX rows label the four images as a dataset, so the validator
scores a real mAP: the port's through MultiBackend(pt2) and (onnx) and the
JAX one's through MultiBackend(stablehlo) and (onnx) agree within 0.005
(tests/test_parity_reference.py:247's mAP bar)."""

import shutil

import numpy as np
import pytest

import yolov3_tpu.cli.detect as jax_detect
from test_torch_detect import IMGSZ, planted_state_dict, source_files, write_pt
from yolov3_tpu import export as jax_export
from yolov3_tpu.eval import validator as jax_validator
from yolov3_tpu.models.backend import MultiBackend as JaxMultiBackend
from yolov3_tpu.models.loading import load_weights as jax_load_weights
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch import export
from yolov3_tpu_torch.cli import benchmarks, detect
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.backend import MultiBackend
from yolov3_tpu_torch.models.convert import from_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms

N_IMAGES = 4


def read_labels(save_dir):
    return {p.stem: np.loadtxt(p, ndmin=2) for p in sorted((save_dir / "labels").glob("*.txt"))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("backend")
    jm = jax_load_weights(str(write_pt(tmp / "w" / "yolov3-tiny.pt", planted_state_dict())))
    jax_ckpt = jax_save_checkpoint(tmp / "w" / "jax_ckpt", {"params": jm.variables["params"],
                                                          "batch_stats": jm.variables["batch_stats"]}, spec=jm.spec)
    model = DetectionModel(parse_spec("yolov3-tiny")).eval()
    model.load_state_dict(from_jax_variables(jm.variables))
    ckpt = export.export_checkpoint(model, tmp / "w" / "port_ckpt")
    kw = dict(imgsz=IMGSZ, batch=1, dynamic=True)
    port = export.run(str(ckpt), include=("pt2", "onnx"), out_dir=tmp / "port", device="cpu", **kw)
    jax = jax_export.run(str(jax_ckpt), include=("stablehlo", "onnx"), out_dir=tmp / "jax", **kw)
    images = tmp / "data" / "images"
    images.mkdir(parents=True)
    for p in source_files()[:N_IMAGES]:
        shutil.copy(p, images / p.name)
    det = dict(source=str(images), imgsz=(IMGSZ, IMGSZ), save_txt=True, nosave=True, project=str(tmp / "detect"))
    launches = greedy_nms.launches
    detects = {"jax": read_labels(jax_detect.run(weights=str(jax["stablehlo"]), name="jax", **det))}
    for fmt in ("pt2", "onnx"):
        detects[fmt] = read_labels(detect.run(weights=str(port[fmt]), name=fmt, device="cpu", **det))
    assert greedy_nms.launches == launches  # on the CPU the plain version runs
    labels = tmp / "data" / "labels"
    shutil.copytree(tmp / "detect" / "jax" / "labels", labels)
    data = {"path": str(tmp / "data"), "train": "images", "val": "images", "nc": 80,
            "names": {i: str(i) for i in range(80)}}
    return dict(tmp=tmp, ckpt=str(ckpt), jax_ckpt=str(jax_ckpt), port=port, jax=jax, detects=detects, data=data)


@pytest.mark.parametrize("fmt", ["pt2", "onnx"])
def test_detect_through_artifact_matches_jax_stablehlo(setup, fmt):
    got, want = setup["detects"][fmt], setup["detects"]["jax"]
    assert got.keys() == want.keys() and len(want) == N_IMAGES
    for stem in want:
        assert got[stem].shape == want[stem].shape, stem
        np.testing.assert_array_equal(got[stem][:, 0], want[stem][:, 0])
        np.testing.assert_allclose(got[stem][:, 1:], want[stem][:, 1:], atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_val(setup):
    out = {}
    for fmt in ("stablehlo", "onnx"):
        r, _, _ = jax_validator.run(setup["data"], model=JaxMultiBackend(setup["jax"][fmt], imgsz=IMGSZ),
                                    batch_size=N_IMAGES, imgsz=IMGSZ)
        out[fmt] = np.array(r[:4])
    return out


@pytest.mark.parametrize("fmt,jax_fmt", [("pt2", "stablehlo"), ("onnx", "onnx")])
def test_val_through_multibackend_matches_jax(setup, jax_val, fmt, jax_fmt):
    backend = MultiBackend(setup["port"][fmt], imgsz=IMGSZ, device="cpu")
    got, _, _ = validator.run(setup["data"], model=backend, batch_size=N_IMAGES, imgsz=IMGSZ)
    want = jax_val[jax_fmt]
    assert want[2] > 0.5  # self-labelled: a real score, not two zeros
    np.testing.assert_allclose(np.array(got[:4]), want, rtol=0, atol=0.005)


def test_benchmarks_rows_match_jax(setup, jax_val, monkeypatch):
    """Each row's mAP50-95 within 0.005 of the JAX package's for the same
    format: the checkpoint row against the JAX benchmarks' checkpoint row
    (rect batches in both), the artifacts' rows against the JAX validator
    through its MultiBackend of the stablehlo and the onnx (square batches,
    the non-native path), which is what the JAX benchmarks run for them."""
    from yolov3_tpu.cli import benchmarks as jax_benchmarks

    monkeypatch.chdir(setup["tmp"])
    kw = dict(data=setup["data"], imgsz=IMGSZ, batch_size=N_IMAGES, hard_fail=0.3)
    rows = benchmarks.run(setup["ckpt"], device="cpu", formats=("checkpoint", "pt2", "onnx"), **kw)
    (want,) = jax_benchmarks.run(setup["jax_ckpt"], pt_only=True, **kw)
    assert [r[0] for r in rows] == ["checkpoint", "pt2", "onnx"]
    assert all(v is not None for r in rows for v in r) and all(v is not None for v in want)
    assert rows[1][1] > 30 and rows[2][1] > 30  # MB: yolov3-tiny's 8.9 M float32 weights
    assert abs(rows[0][2] - want[2]) < 0.005, (rows[0], want)
    for r, jax_fmt in zip(rows[1:], ("stablehlo", "onnx")):
        assert abs(r[2] - jax_val[jax_fmt][3]) < 0.005, (r, jax_fmt, jax_val[jax_fmt])
    with pytest.raises(RuntimeError, match="HARD FAIL"):
        benchmarks.run(setup["ckpt"], device="cpu", pt_only=True, **{**kw, "hard_fail": 0.999})


def test_artifact_refusals(setup, tmp_path):
    with pytest.raises(ValueError, match="TTA"):
        detect.run(weights=str(setup["port"]["pt2"]), augment=True, device="cpu", project=str(tmp_path))
    nms = export.run(setup["ckpt"], include=("pt2",), imgsz=IMGSZ, nms=True, out_dir=tmp_path, device="cpu")["pt2"]
    with pytest.raises(ValueError, match="nms=True"):
        detect.run(weights=str(nms), device="cpu", project=str(tmp_path))
    with pytest.raises(ValueError, match="nms=True"):
        validator.run(setup["data"], model=MultiBackend(nms, device="cpu"))


def test_jax_detect_onnx_still_fails(setup, tmp_path):
    """The JAX detect routes only stablehlo / savedmodel / tflite through its
    MultiBackend (yolov3_tpu/cli/detect.py:104-107): an .onnx falls through to
    DetectionModel.from_config, which reads the protobuf as YAML. The port
    routes it (test_detect_through_artifact_matches_jax_stablehlo)."""
    with pytest.raises(Exception, match="unacceptable character"):
        jax_detect.run(weights=str(setup["jax"]["onnx"]), source=str(source_files()[0]), imgsz=(IMGSZ, IMGSZ),
                       nosave=True, project=str(tmp_path))

"""The port's TensorFlow formats (export.export_savedmodel, export_tflite
with int8 calibration, export_onnx_tf; the graph of models/tf_graph.py;
MultiBackend's savedmodel and tflite) against the JAX package's (jax2tf), on
the same weights, in float32 on the CPU.

The weights are tests/test_torch_detect.py's planted yolov3-tiny, which
detects at 160 px on the detect images: the JAX package exports from a JAX
checkpoint of them, the port from a port checkpoint of the same variables
(`from_jax_variables`). Bars: the decode at the forward bar (atol 2e-3, rtol
1e-3, tests/test_parity_reference.py:133), NMS rows at the NMS bars (n equal,
boxes 0.1 px, conf 1e-3, :152-153), mAP within 0.005 (:247), a bf16 artifact
against the float32 one at the JAX package's own bar
(tests/test_backend_routes.py:94: rtol 0.05, atol 1.5). The validation set
is the first four detect images, labelled with the port's own detections.
Artifacts are module fixtures: TensorFlow's import and each conversion are
paid once.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import tensorflow as tf
import torch

from test_torch_detect import IMGSZ, planted_state_dict, source_files, write_pt
from test_torch_zoo_faults import ZOO
from yolov3_tpu import export as jax_export
from yolov3_tpu.cli import benchmarks as jax_benchmarks
from yolov3_tpu.eval import validator as jax_validator
from yolov3_tpu.models.backend import MultiBackend as JaxMultiBackend
from yolov3_tpu.models.loading import load_weights as jax_load_weights
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch import export
from yolov3_tpu_torch.cli import benchmarks, detect
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox
from yolov3_tpu_torch.eval import validator
from yolov3_tpu_torch.models.backend import MultiBackend
from yolov3_tpu_torch.models.convert import from_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.loading import load_weights
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.models.tf_graph import serving_tf_module
from yolov3_tpu_torch.nn.activations import ACTIVATIONS, FReLU
from yolov3_tpu_torch.nn.modules import MODULE_REGISTRY

ROOT = Path(__file__).resolve().parents[1]
N_IMAGES = 4
INT8_MAP50_GAP = 0.05  # the port's int8 mAP50 against JAX's on the same data (measured 0.0: see the test)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tf_export")
    jm = jax_load_weights(str(write_pt(tmp / "w" / "yolov3-tiny.pt", planted_state_dict())))
    jax_ckpt = jax_save_checkpoint(tmp / "w" / "jax_ckpt", {"params": jm.variables["params"],
                                                          "batch_stats": jm.variables["batch_stats"]}, spec=jm.spec)
    model = DetectionModel(parse_spec("yolov3-tiny")).eval()
    model.load_state_dict(from_jax_variables(jm.variables))
    ckpt = export.export_checkpoint(model, tmp / "w" / "port_ckpt")
    ims = np.stack([letterbox(image_ops.imread(p), IMGSZ, auto=False)[0][:, :, ::-1] for p in source_files()[:5]])
    images = tmp / "data" / "images"
    images.mkdir(parents=True)
    for p in source_files()[:N_IMAGES]:
        shutil.copy(p, images / p.name)
    labelled = detect.run(weights=str(ckpt), source=str(images), imgsz=(IMGSZ, IMGSZ), save_txt=True, nosave=True,
                          project=str(tmp / "detect"), name="labels", device="cpu")
    shutil.copytree(labelled / "labels", tmp / "data" / "labels")
    data = {"path": str(tmp / "data"), "train": "images", "val": "images", "nc": 80,
            "names": {i: str(i) for i in range(80)}}
    return dict(tmp=tmp, jax_ckpt=str(jax_ckpt), ckpt=str(ckpt), ims=np.ascontiguousarray(ims), data=data)


def export_pair(setup, name, fmt, **kw):
    """(port artifact, JAX artifact) of the same weights."""
    port = export.run(setup["ckpt"], include=(fmt,), imgsz=IMGSZ, out_dir=setup["tmp"] / name / "port",
                      device="cpu", **kw)[fmt]
    want = jax_export.run(setup["jax_ckpt"], include=(fmt,), imgsz=IMGSZ, out_dir=setup["tmp"] / name / "jax",
                          **kw)[fmt]
    assert port is not None and want is not None
    return port, want


@pytest.fixture(scope="module")
def static2(setup):
    return export_pair(setup, "static2", "savedmodel", batch=2)


@pytest.fixture(scope="module")
def dynamic(setup):
    return export_pair(setup, "dynamic", "savedmodel", batch=1, dynamic=True)


@pytest.fixture(scope="module")
def tflite4(setup):
    return export_pair(setup, "tflite4", "tflite", batch=N_IMAGES)


@pytest.fixture(scope="module")
def int8(setup):
    return export_pair(setup, "int8", "tflite", batch=N_IMAGES, int8=True, data=setup["data"])


def assert_decode_matches(got, want):
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)


def test_savedmodel_matches_jax(setup, static2):
    port, want = static2
    assert Path(port).name == "yolov3-tiny_savedmodel" and Path(port).is_dir()
    backend = MultiBackend(port, device="cpu")
    assert backend.format == "savedmodel" and not backend.has_nms and backend.imgsz == IMGSZ
    ims = setup["ims"][:2]
    assert_decode_matches(backend(ims), JaxMultiBackend(want, imgsz=IMGSZ)(ims))
    serve = export.ServingModule(load_weights(setup["ckpt"], device="cpu"))
    with torch.no_grad():
        torch.testing.assert_close(backend(ims), serve(torch.from_numpy(ims)), atol=2e-3, rtol=1e-3)
    with pytest.raises(Exception, match="[Ss]hape|[Ii]ncompatible|signature|[Bb]inding"):
        backend(setup["ims"][:3])  # a static batch of 2, as exported


def test_savedmodel_dynamic_batch(setup, dynamic):
    port, want = dynamic
    backend, ref = MultiBackend(port, device="cpu"), JaxMultiBackend(want, imgsz=IMGSZ)
    for bs in (1, 3, 5):
        ims = setup["ims"][:bs]
        got = backend(ims)
        assert got.shape == (bs, 3 * (5 * 5 + 10 * 10), 85)
        assert_decode_matches(got, ref(ims))


def test_savedmodel_stays_dynamic_beside_a_tflite(setup, dynamic, tmp_path):
    """savedmodel and tflite in one dynamic run: the tflite converts a
    SavedModel of its own, so the `_savedmodel` the run returns keeps its
    dynamic batch (the JAX package overwrites it with a static one, its
    export.py:195), and the export directory holds the two artifacts and
    their sidecars only."""
    got = export.run(setup["ckpt"], include=("savedmodel", "tflite"), imgsz=IMGSZ, batch=1, dynamic=True,
                     out_dir=tmp_path, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "yolov3-tiny.meta.json", "yolov3-tiny.tflite", "yolov3-tiny_savedmodel", "yolov3-tiny_savedmodel.meta.json"]
    backend, ref = MultiBackend(got["savedmodel"], device="cpu"), JaxMultiBackend(dynamic[1], imgsz=IMGSZ)
    for bs in (1, 3):
        ims = setup["ims"][:bs]
        assert_decode_matches(backend(ims), ref(ims))
    assert_decode_matches(MultiBackend(got["tflite"], device="cpu")(setup["ims"][:1]), ref(setup["ims"][:1]))
    jax_sm = jax_export.run(setup["jax_ckpt"], include=("savedmodel", "tflite"), imgsz=IMGSZ, batch=1, dynamic=True,
                            out_dir=tmp_path / "jax")["savedmodel"]
    with pytest.raises(Exception, match="[Ss]hape|[Ii]ncompatible|signature|[Bb]inding"):
        tf.saved_model.load(jax_sm).serve(tf.constant(setup["ims"][:3]))  # the JAX fault: batch 1 only


def test_savedmodel_nms_matches_jax(setup):
    port, want = export_pair(setup, "nms", "savedmodel", batch=2, nms=True)
    ims = setup["ims"][:2]
    backend = MultiBackend(port, device="cpu")
    assert backend.has_nms
    out, n = backend(ims)
    w_out, w_n = (np.asarray(a) for a in tf.saved_model.load(want).serve(tf.constant(ims)))
    with torch.no_grad():
        s_out, s_n = export.ServingModule(load_weights(setup["ckpt"], device="cpu"), include_nms=True)(
            torch.from_numpy(ims))
    assert out.shape == (2, 300, 6) and n.dtype == torch.int32 and n.min() > 0
    for ref, ref_n in ((w_out, w_n), (s_out.numpy(), s_n.numpy())):
        np.testing.assert_array_equal(n.numpy(), ref_n)
        for i in range(2):
            np.testing.assert_allclose(out[i, : n[i], :4].numpy(), ref[i, : n[i], :4], atol=0.1, rtol=0)
            np.testing.assert_allclose(out[i, : n[i], 4].numpy(), ref[i, : n[i], 4], atol=1e-3, rtol=0)
            np.testing.assert_array_equal(out[i, : n[i], 5].numpy(), ref[i, : n[i], 5])
        assert (out[:, :, 4] > 0).sum(1).tolist() == n.tolist()


def test_tflite_matches_jax(setup, tflite4):
    port, want = tflite4
    assert Path(port).name == "yolov3-tiny.tflite"
    ims = setup["ims"][:N_IMAGES]
    backend = MultiBackend(port, device="cpu")
    assert backend.format == "tflite" and not backend.has_nms
    assert_decode_matches(backend(ims), JaxMultiBackend(want, imgsz=IMGSZ)(ims))


@pytest.mark.parametrize("fixture", ["static2", "tflite4", "int8"])
def test_sidecar_equals_jax(request, fixture):
    port, want = request.getfixturevalue(fixture)
    meta = [json.loads(Path(str(a)).with_suffix(".meta.json").read_text()) if Path(str(a)).suffix else
            json.loads(Path(str(a) + ".meta.json").read_text()) for a in (port, want)]
    assert meta[0] == meta[1] and meta[0]["imgsz"] == IMGSZ


def test_half_savedmodel_is_bf16(setup, static2):
    """--half writes the fused bf16 weights into a bf16 graph (TensorFlow's
    CPU kernels take bf16 convolutions, so nothing is widened)."""
    half = export.run(setup["ckpt"], include=("savedmodel",), imgsz=IMGSZ, batch=2, half=True,
                      out_dir=setup["tmp"] / "half", device="cpu")["savedmodel"]
    loaded = tf.saved_model.load(half)
    assert loaded.weights and all(v.dtype == tf.bfloat16 for v in loaded.weights)
    ims = setup["ims"][:2]
    p16 = MultiBackend(half, device="cpu")(ims)
    p32 = MultiBackend(static2[0], device="cpu")(ims)
    assert p16.dtype == torch.float32 and not torch.equal(p16, p32)  # the bf16 path was taken
    np.testing.assert_allclose(p16[..., :4].numpy(), p32[..., :4].numpy(), rtol=0.05, atol=1.5)


def write_calibration_set(root):
    """Three detect images, a PNG and a noise JPEG of other sizes, and a .jpg
    that decodes in neither package (first in sorted order), as a dataset
    YAML dict."""
    images = root / "images"
    images.mkdir(parents=True)
    for p in source_files()[:3]:
        shutil.copy(p, images / p.name)
    rng = np.random.default_rng(3)
    image_ops.imwrite(str(images / "z_png.png"), rng.integers(0, 256, (50, 90, 3), dtype=np.uint8))
    image_ops.imwrite(str(images / "z_noise.jpg"), rng.integers(0, 256, (70, 40, 3), dtype=np.uint8))
    (images / "a_broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    return {"path": str(root), "train": "images", "val": "images", "nc": 1, "names": {0: "x"}}


@pytest.mark.parametrize("source,n,batch,batches", [
    ("dataset", 3, 2, 2),  # 5 readable of the first 6 files: two whole batches, the fifth image left out
    ("dataset", 1, 8, 1),  # 5 readable of 6: one batch of 8, its last image repeated
    ("random", 2, 2, 2),
    ("unreadable", 2, 2, 2),  # no image decodes: the random fallback
])
def test_calibration_batches_equal_jax(tmp_path, source, n, batch, batches):
    if source == "dataset":
        data = write_calibration_set(tmp_path)
        assert cv2.imread(str(tmp_path / "images" / "a_broken.jpg")) is None
    elif source == "unreadable":
        (tmp_path / "images").mkdir()
        (tmp_path / "images" / "x.jpg").write_bytes(b"\xff\xd8 not a jpeg")
        data = {"path": str(tmp_path), "train": "images", "val": "images", "nc": 1, "names": {0: "x"}}
    else:
        data = None
    got = list(export._calibration_batches(96, batch, data, n=n, stride=32))
    want = list(jax_export._calibration_batches(96, batch, data, n=n, stride=32))
    assert len(got) == len(want) == batches
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.flags.c_contiguous and g.shape == (batch, 96, 96, 3)
        assert g.tobytes() == w.tobytes()


def test_int8_tflite_converts_and_validates(setup, int8):
    """int8 PTQ calibrated on the dataset: the artifact converts, is below
    15 MB (the float file is ~35 MB), validates through MultiBackend to a
    finite mAP, and its mAP50 stands within INT8_MAP50_GAP of the JAX int8
    artifact's on the same data.

    Measured here: both artifacts score mAP50 0.0. The int8 graph carries the
    decode, whose (B, N, 85) output is quantized per tensor: its xy run to
    160 px, so the confidence column takes only the levels 0 and 1.349 in
    both packages (the JAX package's design, which the port keeps). So the
    decodes are also held to JAX's int8 decode: the same quantization levels,
    the wh and class columns equal."""
    port, want = int8
    assert str(port).endswith("yolov3-tiny-int8.tflite") and Path(port).stat().st_size < 15e6
    kw = dict(batch_size=N_IMAGES, imgsz=IMGSZ, rect=False)
    got, _, _ = validator.run(setup["data"], model=MultiBackend(port, device="cpu"), **kw)
    ref, _, _ = jax_validator.run(setup["data"], model=JaxMultiBackend(want, imgsz=IMGSZ), **kw)
    assert len(got) == 7 and np.isfinite(got[3])
    assert abs(got[2] - ref[2]) <= INT8_MAP50_GAP, (got[:4], ref[:4])
    ims = setup["ims"][:N_IMAGES]
    p8, j8 = MultiBackend(port, device="cpu")(ims).numpy(), JaxMultiBackend(want, imgsz=IMGSZ)(ims)
    np.testing.assert_array_equal(np.unique(p8[..., 4]), np.unique(j8[..., 4]))
    np.testing.assert_allclose(p8[..., 2:4], j8[..., 2:4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(p8[..., 5:], j8[..., 5:], atol=1e-3, rtol=0)


@pytest.mark.parametrize("fmt", ["savedmodel", "tflite"])
def test_val_through_multibackend_matches_jax(setup, dynamic, tflite4, fmt):
    port, want = {"savedmodel": dynamic, "tflite": tflite4}[fmt]
    kw = dict(batch_size=N_IMAGES, imgsz=IMGSZ)
    got, _, _ = validator.run(setup["data"], model=MultiBackend(port, device="cpu"), **kw)
    ref, _, _ = jax_validator.run(setup["data"], model=JaxMultiBackend(want, imgsz=IMGSZ), **kw)
    assert ref[2] > 0.5  # self-labelled: a real score
    np.testing.assert_allclose(np.array(got[:4]), np.array(ref[:4]), rtol=0, atol=0.005)


def test_detect_through_savedmodel_and_tflite(setup, dynamic, tmp_path):
    """cli.detect over the four images through the dynamic savedmodel and a
    batch-1 tflite writes the label rows detect wrote through the checkpoint
    (the labels of `setup`): classes equal, coordinates within 1e-4 of the
    normalised image."""
    tflite1 = export.run(setup["ckpt"], include=("tflite",), imgsz=IMGSZ, batch=1, out_dir=tmp_path / "tfl",
                         device="cpu")["tflite"]
    images = Path(setup["data"]["path"]) / "images"
    want = {p.stem: np.loadtxt(p, ndmin=2) for p in (Path(setup["data"]["path"]) / "labels").glob("*.txt")}
    assert len(want) == N_IMAGES
    for weights in (dynamic[0], tflite1):
        save_dir = detect.run(weights=str(weights), source=str(images), imgsz=(IMGSZ, IMGSZ), save_txt=True,
                              nosave=True, project=str(tmp_path), name=Path(str(weights)).name, device="cpu")
        got = {p.stem: np.loadtxt(p, ndmin=2) for p in (save_dir / "labels").glob("*.txt")}
        assert got.keys() == want.keys()
        for stem, rows in want.items():
            assert got[stem].shape == rows.shape, (weights, stem)
            np.testing.assert_array_equal(got[stem][:, 0], rows[:, 0])
            np.testing.assert_allclose(got[stem][:, 1:], rows[:, 1:], atol=1e-4, rtol=0)


def test_benchmarks_rows_match_jax(setup, monkeypatch):
    """All five formats of each package's benchmarks: every row validates,
    and its mAP50-95 is within 0.005 of the JAX row of the same format (the
    port's pt2 beside the JAX stablehlo)."""
    monkeypatch.chdir(setup["tmp"])
    kw = dict(data=setup["data"], imgsz=IMGSZ, batch_size=N_IMAGES)
    rows = benchmarks.run(setup["ckpt"], device="cpu", **kw)
    want = jax_benchmarks.run(setup["jax_ckpt"], formats=jax_export.EXPORT_FORMATS, **kw)
    assert [r[0] for r in rows] == ["checkpoint", "pt2", "savedmodel", "tflite", "onnx"]
    assert [r[0] for r in want] == ["checkpoint", "stablehlo", "savedmodel", "tflite", "onnx"]
    assert all(v is not None for r in rows + want for v in r), (rows, want)
    for r, w in zip(rows, want):
        assert abs(r[2] - w[2]) < 0.005, (r, w)


def test_a_failed_tf_export_is_a_none_row(setup, monkeypatch):
    """As in the JAX package, a format whose export fails is its row of None
    and the sweep goes on (try_export returns None)."""
    monkeypatch.chdir(setup["tmp"])
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # `import tensorflow` raises ImportError
    rows = benchmarks.run(setup["ckpt"], data=setup["data"], imgsz=IMGSZ, batch_size=N_IMAGES, device="cpu",
                          formats=("savedmodel", "tflite"), test=True)
    assert rows == [("savedmodel", None, None, None), ("tflite", None, None, None)]


def test_onnx_tf_leg_with_stubbed_tf2onnx(monkeypatch, tmp_path):
    """export_onnx_tf: a real SavedModel, then the tf2onnx convert CLI as a
    stub package on disk (tests/test_gated_stubs.py:84's), run by the real
    subprocess call; the sidecar lands beside the .onnx."""
    pkg = tmp_path / "fakepkgs" / "tf2onnx"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("__version__ = '0.0-stub'\n")
    (pkg / "convert.py").write_text(
        "import argparse, pathlib\n"
        "if __name__ == '__main__':\n"
        "    p = argparse.ArgumentParser()\n"
        "    p.add_argument('--saved-model'); p.add_argument('--output')\n"
        "    a = p.parse_args()\n"
        "    assert pathlib.Path(a.saved_model).exists(), a.saved_model\n"
        "    pathlib.Path(a.output).write_bytes(b'ONNXSTUB' + pathlib.Path(a.saved_model).name.encode())\n")
    monkeypatch.syspath_prepend(str(tmp_path / "fakepkgs"))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path / "fakepkgs") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    model = DetectionModel.from_config("yolov3-tiny", device="cpu")
    onnx = export.export_onnx_tf(model, tmp_path / "export" / model.spec.name, imgsz=96, batch=1)
    assert onnx is not None and Path(onnx).read_bytes() == b"ONNXSTUB" + b"yolov3-tiny_savedmodel"
    assert Path(onnx).with_suffix(".meta.json").exists()


# one model an op of the registry: a stride-2 stem Conv, the op, a Detect on its output (nc 3, 64 px)
OP_ARGS = {
    "Conv": [16, 3, 1], "DWConv": [16, 3, 1], "DWConvTranspose2d": [16, 4, 2, 1, 2], "Bottleneck": [16],
    "BottleneckCSP": [16, 1], "C3": [16, 1], "C3x": [16, 1], "C3TR": [16, 1], "C3SPP": [16, 1],
    "C3Ghost": [16, 1], "CrossConv": [16, 3, 1], "TransformerBlock": [16, 4, 1], "MixConv2d": [16, [1, 3]],
    "SPP": [16, [3, 5]], "SPPF": [16, 3], "Focus": [16, 3], "GhostConv": [16, 1, 1], "GhostBottleneck": [16, 3, 1],
    "MaxPool": [2, 1, 0], "nn.MaxPool2d": [3, 2, 1], "ZeroPad": [[0, 1, 0, 1]], "nn.ZeroPad2d": [[1, 2, 2, 1]],
    "Upsample": [2, "nearest"], "nn.Upsample": [2], "Concat": [1], "Contract": [2],
    "Expand": [2], "Sum": [2, True],
}


def one_op_spec(op):
    f = [-1, 0] if op in ("Concat", "Sum") else -1
    return {"name": f"op-{op}", "nc": 3, "anchors": [[10, 13, 16, 30, 33, 23]],
            "layers": [[-1, 1, "Conv", [16, 3, 2]], [f, 1, op, OP_ARGS[op]], [-1, 1, "Detect", ["nc", "anchors"]]]}


def test_op_table_is_the_registry():
    assert set(OP_ARGS) == set(MODULE_REGISTRY)
    assert {ls.op for ls in parse_spec(ZOO).layers} - {"Detect"} <= {parse_spec(one_op_spec(op)).layers[1].op
                                                                    for op in OP_ARGS}


@pytest.mark.parametrize("op", sorted(OP_ARGS))
def test_every_registry_op_through_tf(op):
    """The TF graph of a one-op model against the port's own eval decode
    (the port is held to the JAX modules op by op in tests/test_torch_zoo*.py),
    with BatchNorm statistics and Sum weights off their init so the fold and
    the weights show."""
    model = DetectionModel.from_config(one_op_spec(op), seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.2)
            if getattr(m, "w", None) is not None and isinstance(m.w, torch.nn.Parameter):
                m.w.copy_(torch.randn(m.w.shape, generator=g))
    ims = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    with torch.no_grad():
        want = export.ServingModule(model.fuse())(torch.from_numpy(ims)).numpy()
    got = serving_tf_module(model, 64, None).serve(tf.constant(ims)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
def test_every_activation_through_tf(act):
    """A YAML `activation:` of each name the port knows, through the TF graph of
    a Conv model, against the port's own eval decode."""
    model = DetectionModel.from_config({**one_op_spec("Conv"), "activation": act}, seed=1, device="cpu")
    ims = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    with torch.no_grad():
        want = export.ServingModule(model.fuse())(torch.from_numpy(ims)).numpy()
    np.testing.assert_allclose(serving_tf_module(model, 64).serve(tf.constant(ims)).numpy(), want, atol=2e-3,
                               rtol=1e-3)


def test_a_module_without_a_tf_form_raises_naming_its_layer():
    model = DetectionModel.from_config(one_op_spec("Conv"), device="cpu").fuse()
    model.model[1].act = FReLU(16)  # an activation module no spec can name
    with pytest.raises(NotImplementedError, match=r"layer 1 \(Conv\).*FReLU"):
        serving_tf_module(model, 64)


def test_importing_export_and_backend_loads_no_tensorflow():
    code = ("import sys, yolov3_tpu_torch.export, yolov3_tpu_torch.models.backend, "
            "yolov3_tpu_torch.models.tf_graph, yolov3_tpu_torch.cli.benchmarks; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('tensorflow', 'jax', 'yolov3_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)

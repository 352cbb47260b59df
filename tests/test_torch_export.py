"""The port's export (yolov3_tpu_torch/export.py) and the registered NMS op
against the JAX package's export, on the same weights, in float32 on the CPU.

The weights are tests/test_torch_detect.py's planted yolov3-tiny (detections
on every detect image at 160 px): the JAX package loads the `.pt` and
exports from a JAX checkpoint of those variables; the port exports from a
port checkpoint of the same variables (`from_jax_variables`). A port `.pt2`
through the port's MultiBackend is held to the JAX `.stablehlo` through the
JAX MultiBackend at the forward bar (atol 2e-3, rtol 1e-3,
tests/test_parity_reference.py:133); with `nms=True` the detections at the
NMS bars (n equal, boxes 0.1 px, conf 1e-3, :152-153)."""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import export as jexport

from test_torch_detect import IMGSZ, planted_state_dict, source_files, write_pt
from yolov3_tpu import export as jax_export
from yolov3_tpu.models.backend import MultiBackend as JaxMultiBackend
from yolov3_tpu.models.loading import load_weights as jax_load_weights
from yolov3_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch import export
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox
from yolov3_tpu_torch.models.backend import MultiBackend
from yolov3_tpu_torch.models.convert import from_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.loading import load_weights
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    jm = jax_load_weights(str(write_pt(tmp / "w" / "yolov3-tiny.pt", planted_state_dict())))
    jax_ckpt = jax_save_checkpoint(tmp / "w" / "jax_ckpt", {"params": jm.variables["params"],
                                                          "batch_stats": jm.variables["batch_stats"]}, spec=jm.spec)
    model = DetectionModel(parse_spec("yolov3-tiny")).eval()
    model.load_state_dict(from_jax_variables(jm.variables))
    ckpt = export.export_checkpoint(model, tmp / "w" / "port_ckpt")
    ims = np.stack([letterbox(image_ops.imread(p), IMGSZ, auto=False)[0][:, :, ::-1] for p in source_files()[:3]])
    return dict(tmp=tmp, jax_ckpt=str(jax_ckpt), ckpt=str(ckpt), ims=np.ascontiguousarray(ims))


def export_both(setup, name, **kw):
    """(port artifact, JAX artifact) of the same weights; port pt2 against JAX stablehlo."""
    include = kw.pop("include", "pt2")
    port = export.run(setup["ckpt"], include=(include,), imgsz=IMGSZ, out_dir=setup["tmp"] / name / "port",
                      device="cpu", **kw)[include]
    jfmt = {"pt2": "stablehlo"}.get(include, include)
    want = jax_export.run(setup["jax_ckpt"], include=(jfmt,), imgsz=IMGSZ, out_dir=setup["tmp"] / name / "jax",
                          **kw)[jfmt]
    assert port is not None and want is not None
    return port, want


@pytest.fixture(scope="module")
def static2(setup):
    return export_both(setup, "static2", batch=2)


def test_pt2_matches_jax_stablehlo(setup, static2):
    port, want = static2
    ims = setup["ims"][:2]
    got = MultiBackend(port, imgsz=IMGSZ, device="cpu")(ims)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), JaxMultiBackend(want, imgsz=IMGSZ)(ims), atol=2e-3, rtol=1e-3)


def test_pt2_dynamic_batch(setup):
    port = export.run(setup["ckpt"], include=("pt2",), imgsz=IMGSZ, batch=2, dynamic=True,
                      out_dir=setup["tmp"] / "dyn", device="cpu")["pt2"]
    backend = MultiBackend(port, imgsz=IMGSZ, device="cpu")
    serve = export.ServingModule(load_weights(setup["ckpt"], device="cpu"))
    for bs in (1, 3):
        ims = torch.from_numpy(setup["ims"][:bs])
        got = backend(ims)
        assert got.shape == (bs, 3 * (10 * 10 + 5 * 5), 85)
        torch.testing.assert_close(got, serve(ims), atol=1e-5, rtol=1e-5)


def test_pt2_nms_matches_jax_stablehlo_nms(setup):
    port, want = export_both(setup, "nms", batch=2, nms=True)
    ims = setup["ims"][:2]
    backend = MultiBackend(port, imgsz=IMGSZ, device="cpu")
    assert backend.has_nms
    out, n = backend(ims)
    w_out, w_n = (np.asarray(a) for a in jax.jit(jexport.deserialize(Path(want).read_bytes()).call)(ims))
    assert out.shape == (2, 300, 6) and n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), w_n)
    assert n.min() > 0
    for i in range(2):
        np.testing.assert_allclose(out[i, : n[i], :4].numpy(), w_out[i, : w_n[i], :4], atol=0.1, rtol=0)
        np.testing.assert_allclose(out[i, : n[i], 4].numpy(), w_out[i, : w_n[i], 4], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(out[i, : n[i], 5].numpy(), w_out[i, : w_n[i], 5])
    program = torch.export.load(port)
    nodes = [nd for nd in program.graph.nodes if nd.op == "call_function" and "greedy_nms" in str(nd.target)]
    assert [str(nd.target) for nd in nodes] == ["yolov3_tpu_torch.greedy_nms.default"]


def test_half_export_is_bf16_and_round_trips(setup):
    res = export.run(setup["ckpt"], include=("pt2", "checkpoint"), imgsz=IMGSZ, batch=2, half=True,
                     out_dir=setup["tmp"] / "half", device="cpu")
    program = torch.export.load(res["pt2"])
    weights = [v for k, v in program.state_dict.items() if k.endswith("weight")]
    assert weights and all(v.dtype == torch.bfloat16 for v in weights)
    loaded = load_weights(res["checkpoint"], device="cpu")  # a folded checkpoint builds the folded graph
    assert loaded.fused and all("bn" not in k for k in loaded.state_dict())
    ims = torch.from_numpy(setup["ims"][:2])
    f32 = export.ServingModule(load_weights(setup["ckpt"], device="cpu"))(ims)
    half = MultiBackend(res["pt2"], imgsz=IMGSZ, device="cpu")(ims)
    assert half.dtype == torch.float32
    # the checkpoint holds the bf16 weights (read back as float32): in bf16 they give the program's answer
    torch.testing.assert_close(half, export.ServingModule(loaded.to(torch.bfloat16))(ims), atol=0, rtol=0)
    assert (half - f32).abs().max() < 2.0  # bf16 weights: a few tenths of a pixel, not another model


def test_sidecar_equals_jax(static2):
    port, want = static2
    got = json.loads(Path(port).with_suffix(".meta.json").read_text())
    assert got == json.loads(Path(want).with_suffix(".meta.json").read_text())
    assert got["stride"] == 32 and got["imgsz"] == IMGSZ and len(got["names"]) == 80


def test_missing_sidecar_raises(static2, tmp_path):
    onnx = export.export_onnx(DetectionModel.from_config("yolov3-tiny", device="cpu"), tmp_path / "m", imgsz=64)
    for artifact in (static2[0], onnx):
        orphan = tmp_path / f"orphan{Path(artifact).suffix}"
        shutil.copyfile(artifact, orphan)
        with pytest.raises(FileNotFoundError, match="sidecar"):
            MultiBackend(orphan, device="cpu")


# savedmodel, tflite, --int8 and --data export now (tests/test_torch_tf_export.py)
@pytest.mark.parametrize("kw,error,match", [
    (dict(include=("stablehlo",)), ValueError, "'pt2'"),
    (dict(include=("onnx",), nms=True), NotImplementedError, "decode only"),
    (dict(include=("torchscript",)), ValueError, "unknown export format"),
], ids=["stablehlo", "onnx-nms", "unknown"])
def test_unported_formats_raise_before_exporting(kw, error, match, tmp_path):
    with pytest.raises(error, match=match):
        export.run("yolov3-tiny", out_dir=tmp_path / "out", device="cpu", **kw)
    assert not (tmp_path / "out").exists()


# m.tflite and m_savedmodel are read now (tests/test_torch_tf_export.py)
@pytest.mark.parametrize("name,error,match", [("m.stablehlo", ValueError, "pt2")])
def test_backend_refuses_formats_it_does_not_read(name, error, match):
    with pytest.raises(error, match=match):
        MultiBackend(name, device="cpu")


def test_op_is_registered_with_plain_cpu_and_fake_kernels():
    g = torch.Generator().manual_seed(0)
    B, K = 2, 64
    boxes = torch.rand(B, K, 4, generator=g) * 100
    boxes[..., 2:] += boxes[..., :2]
    scores = torch.where(torch.rand(B, K, generator=g) > 0.3, torch.rand(B, K, generator=g), -1.0)
    cls = torch.randint(0, 3, (B, K), generator=g).float()
    off = boxes + cls[..., None] * 7680
    out, n = torch.ops.yolov3_tpu_torch.greedy_nms(off, boxes, scores, cls, 0.45, 30)
    want_out, want_n = greedy_nms_plain(off, boxes, scores, cls, 0.45, 30)
    assert torch.equal(out, want_out) and torch.equal(n, want_n) and n.min() > 0
    launches = greedy_nms.launches
    assert all(torch.equal(a, b) for a, b in zip(greedy_nms(off, boxes, scores, cls, 0.45, 30), (out, n)))
    assert greedy_nms.launches == launches  # the plain version on the CPU launches nothing
    torch.library.opcheck(torch.ops.yolov3_tpu_torch.greedy_nms.default, (off, boxes, scores, cls, 0.45, 30))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fo, fn = torch.ops.yolov3_tpu_torch.greedy_nms(*(mode.from_tensor(t) for t in (off, boxes, scores, cls)),
                                                       0.45, 30)
    assert (fo.shape, fo.dtype, fn.shape, fn.dtype) == ((B, 30, 6), torch.float32, (B,), torch.int32)
    with pytest.raises(ValueError, match="unsupported device meta"):
        greedy_nms(off.to("meta"), boxes.to("meta"), scores.to("meta"), cls.to("meta"))

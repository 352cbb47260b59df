"""The port's ONNX writer and executor (yolov3_tpu_torch/models/onnx_native.py,
onnx_runtime.py) against the JAX package's, on the same variables.

The JAX model is built from its seeded init and carried into the port by
`from_jax_variables`; each package folds its own BatchNorms. The bytes:
the same nodes in the same order (op type, inputs, outputs, attributes),
the same graph inputs and outputs (their value infos byte for byte), the
same initializer names and shapes with values within 1e-6 relative. The
port's executor (torch, on the CPU here) runs its bytes against the JAX
fused forward and full decode at the JAX writer's own bar, 2e-4
(tests/test_onnx_native.py), for yolov3-tiny, yolov3-spp and a Focus stem,
and runs the JAX bytes against the JAX numpy executor."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from yolov3_tpu.models.detect_head import decode_predictions as jax_decode
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.onnx_native import export_onnx_bytes as jax_export_onnx_bytes
from yolov3_tpu.models.onnx_runtime import OnnxModel as JaxOnnxModel
from yolov3_tpu.models.onnx_runtime import parse_onnx as jax_parse_onnx
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.convert import from_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.onnx_native import export_onnx_bytes
from yolov3_tpu_torch.models.onnx_runtime import OnnxModel, _fields, parse_onnx
from yolov3_tpu_torch.models.spec import parse_spec

IMGSZ = 64
FOCUS_CFG = {  # no shipped architecture has a Focus stem: this pins its phase order
    "nc": 4, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
    "backbone": [[-1, 1, "Focus", [16, 3]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[1, 2], 1, "Detect", ["nc", "anchors"]]],
}
CFGS = {"yolov3-tiny": "yolov3-tiny", "yolov3-spp": "yolov3-spp", "focus": FOCUS_CFG}


@pytest.fixture(scope="module", params=list(CFGS))
def pair(request):
    """(cfg id, JAX fused model, port model of the same variables, JAX bytes, port bytes), batch 2."""
    cfg = CFGS[request.param]
    jm = JaxModel.from_config(dict(cfg) if isinstance(cfg, dict) else cfg, imgsz=IMGSZ)
    pm = DetectionModel(parse_spec(dict(cfg) if isinstance(cfg, dict) else cfg)).eval()
    pm.load_state_dict(from_jax_variables(jm.variables))
    jf = jm.fuse()
    return request.param, jf, pm, jax_export_onnx_bytes(jf, imgsz=IMGSZ, batch=2), export_onnx_bytes(pm, IMGSZ, 2)


def graph_io(data):
    """The graph's raw input and output value infos (fields 11 and 12)."""
    graph = next(v for f, w, v in _fields(data) if f == 7)
    return [(f, bytes(v)) for f, w, v in _fields(graph) if f in (11, 12)]


def jax_decode_of(jf, imgs):
    """The JAX fused forward and full decode, jitted (op by op it takes seconds more, with the same bits)."""
    fwd = jax.jit(lambda v, x: jax_decode(list(jf.module.apply(v, x, train=False)), jf.anchors_px, jf.spec.strides))
    return np.asarray(fwd(jf.variables, jnp.asarray(imgs)))


def test_bytes_match_jax(pair):
    _, _, _, want_bytes, got_bytes = pair
    got, want = parse_onnx(got_bytes), jax_parse_onnx(want_bytes)
    assert len(got.nodes) == len(want.nodes)
    for g, w in zip(got.nodes, want.nodes):
        assert (g.op, g.inputs, g.outputs) == (w.op, w.inputs, w.outputs)
        assert g.attrs.keys() == w.attrs.keys()
        for k in g.attrs:
            assert np.array_equal(np.asarray(g.attrs[k]), np.asarray(w.attrs[k])), (g.outputs, k)
    assert (got.inputs, got.outputs) == (want.inputs, want.outputs) == (["images"], ["output"])
    assert graph_io(got_bytes) == graph_io(want_bytes)
    assert list(got.inits) == list(want.inits)
    for k, g in got.inits.items():
        w = want.inits[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)


def test_executor_matches_jax_decode(pair):
    name, jf, _, _, got_bytes = pair
    imgs = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    out = OnnxModel(got_bytes, device="cpu")(torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()))
    ref = jax_decode_of(jf, imgs)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("pair", ["yolov3-tiny", "focus"], indirect=True)  # the numpy executor is slow on spp
def test_executor_on_jax_bytes_matches_jax_executor(pair):
    _, _, _, want_bytes, _ = pair
    imgs = np.random.default_rng(1).random((2, 3, IMGSZ, IMGSZ)).astype(np.float32)
    got = OnnxModel(want_bytes, device="cpu")(imgs).numpy()
    want = JaxOnnxModel(want_bytes, engine="numpy")(imgs)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pair", ["yolov3-tiny"], indirect=True)
def test_dynamic_batch(pair):
    _, jf, pm, _, _ = pair
    data = export_onnx_bytes(pm, IMGSZ, batch=1, dynamic=True)
    assert graph_io(data) == graph_io(jax_export_onnx_bytes(jf, imgsz=IMGSZ, batch=1, dynamic=True))
    rt = OnnxModel(data, device="cpu")
    for bs in (1, 3):
        imgs = np.random.default_rng(bs).random((bs, IMGSZ, IMGSZ, 3)).astype(np.float32)
        out = rt(torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()))
        assert out.shape == (bs, 3 * (2 * 2 + 4 * 4), pm.spec.no)
        with torch.no_grad():
            want = pm.predict(torch.from_numpy(imgs))  # the port's forward, held to JAX's in test_torch_model.py
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_unsupported_op_raises_naming_the_layer():
    cfg = {**FOCUS_CFG, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "C3", [16]], [-1, 1, "Conv", [32, 3, 2]],
                                     [-1, 1, "Conv", [64, 3, 2]]],
           "head": [[[2, 3], 1, "Detect", ["nc", "anchors"]]]}
    jm = JaxModel.from_config(dict(cfg), imgsz=IMGSZ)
    pm = DetectionModel(parse_spec(dict(cfg))).eval()
    pm.load_state_dict(from_jax_variables(jm.variables))
    with pytest.raises(NotImplementedError, match=r"op 'C3' \(layer 1\)"):
        jax_export_onnx_bytes(jm.fuse(), imgsz=IMGSZ)
    with pytest.raises(NotImplementedError, match=r"op 'C3' \(layer 1\)"):
        export_onnx_bytes(pm, IMGSZ)


def test_executor_refuses_an_unknown_op():
    from yolov3_tpu_torch.models.onnx_native import _bytes, _string, model_proto, node_proto, value_info

    graph = _bytes(1, node_proto("Softmax", ["images"], ["output"])) + _string(2, "g")
    graph += _bytes(11, value_info("images", [1, 3])) + _bytes(12, value_info("output", [1, 3]))
    with pytest.raises(NotImplementedError, match="'Softmax'"):
        OnnxModel(model_proto(graph), device="cpu")(torch.zeros(1, 3))

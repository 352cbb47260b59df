"""Models of the module zoo in the port against the JAX package, in f32 on
the CPU: the YOLOv5s family (chip_smoke.YOLOV5_MODELS, written out from
ultralytics/yolov5's published YAMLs) narrowed to width 0.125, depth 0.33,
at 128 px.

For yolov5s and yolov5s-transformer: the spec equals the JAX parser's; the
raw and decoded forward and the fused raw head equal the JAX model's on the
same variables (atol 2e-3 / rtol 1e-3, test_parity_reference.py:133); the
folds count the JAX BNs; the full-width parameter counts are the published
7,235,389 / 7,038,013 in both packages. Their train steps are in
test_torch_zoo_train.py, the JAX faults and a model of every op in
test_torch_zoo_faults.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_zoo import randomized
from yolov3_tpu.models.detect_head import decode_predictions as jax_decode_predictions
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.detection import YOLOGraph
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.fuse import fuse_state_dict
from yolov3_tpu_torch.models.spec import parse_spec

ATOL, RTOL = 2e-3, 1e-3
IMGSZ = 128
MODELS = ("yolov5s", "yolov5s-transformer")


def narrow(name):
    return {**chip_smoke.YOLOV5_MODELS[name], "width_multiple": 0.125, "depth_multiple": 0.33}


def spec_dict(spec):
    d = dataclasses.asdict(spec)
    d.pop("channels", None)  # the port's own record of the tensors' channels
    d["layers"] = [dataclasses.astuple(ls) for ls in spec.layers]
    return d


def jax_variables(spec, imgsz=64, seed=0):
    init = jax.jit(YOLOGraph(spec=spec).init, static_argnames="train")
    return init(jax.random.PRNGKey(seed), jnp.zeros((1, imgsz, imgsz, spec.ch_in)), train=False)


def build_pair(cfg, imgsz, jax_spec=None):
    """(JAX model, port model) on the same variables (BN affines and statistics randomised)."""
    spec = jax_spec or jax_parse_spec(cfg)
    ref = JaxModel(spec, randomized(jax_variables(spec), np.random.default_rng(1)))
    port = load_jax_variables(DetectionModel(parse_spec(cfg)), ref.variables).eval()
    x = np.random.default_rng(2).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    return ref, port, x


def assert_forward_matches(ref, port, x):
    want = jax.jit(ref.module.apply, static_argnames="train")(ref.variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        decoded = port.predict(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    want_decoded = jax_decode_predictions(want, ref.anchors_px, ref.spec.strides)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(want_decoded), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return (request.param, *build_pair(narrow(request.param), IMGSZ))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("width", ["published", "narrow"])
def test_spec_matches_jax(name, width):
    cfg = chip_smoke.YOLOV5_MODELS[name] if width == "published" else narrow(name)
    assert spec_dict(parse_spec(cfg)) == spec_dict(jax_parse_spec(cfg))


@pytest.mark.parametrize("name", MODELS)
def test_full_width_param_count(name):
    cfg = chip_smoke.YOLOV5_MODELS[name]
    with torch.device("meta"):
        port = DetectionModel(parse_spec(cfg))
    shapes = jax.eval_shape(lambda: jax_variables(jax_parse_spec(cfg)))
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes["params"]))
    assert port.num_params() == n_jax == chip_smoke.YOLOV5_PARAMS[name]


def test_forward_matches_jax(pair):
    _, ref, port, x = pair
    assert_forward_matches(ref, port, x)


def test_fused_raw_head_matches_jax(pair):
    _, ref, port, x = pair
    fused_ref = ref.fuse()
    want = jax.jit(fused_ref.serving_module().apply, static_argnames="train")(
        fused_ref.variables, jnp.asarray(x), train=False)
    fused = port.fuse()
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    with torch.no_grad():
        got = fused(torch.from_numpy(x), raw=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_fold_count_matches_jax(pair):
    _, ref, port, _ = pair
    n_bn = sum(1 for path, _ in jax.tree_util.tree_leaves_with_path(ref.variables["batch_stats"])
               if str(getattr(path[-1], "key", "")) == "mean")
    assert fuse_state_dict(port.state_dict())[1] == n_bn > 0

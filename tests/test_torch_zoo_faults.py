"""Faults of the JAX package that the port does not copy, each beside an
assertion that the JAX package still has it, and a model of every op of the
JAX registry, in f32 on the CPU: a top-level DWConv breaks the JAX fused
model; the JAX parser counts no GhostConv stride, so yolov5s-ghost's Detect
strides are 0 (the port is held to the JAX modules on the corrected spec);
the JAX converter cannot map the reference keys of a C3TR; the JAX
checkpoint spec writes a C3's repeats twice. A reference-layout `.pt` of a
zoo model loads with the cfg its pickled model carries.
"""

import dataclasses

import flax.errors
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_zoo_models import IMGSZ, assert_forward_matches, build_pair, jax_variables, narrow, spec_dict
from yolov3_tpu.models.convert import convert_torch_checkpoint
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.nn.modules import MODULE_REGISTRY as JAX_REGISTRY
from yolov3_tpu.utils.checkpoint import spec_to_dict as jax_spec_to_dict
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.fuse import fuse_state_dict
from yolov3_tpu_torch.models.loading import load_weights
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.nn.modules import MODULE_REGISTRY
from yolov3_tpu_torch.utils.checkpoint import spec_to_dict

# every op of the JAX registry in one model (nc 3, 64 px; Detect at strides 4 and 8): a top-level
# DWConv, the standalone BNs of BottleneckCSP and MixConv2d, a repeated GhostBottleneck, Contract /
# Expand (whose channels the JAX parser leaves at their input's), a weighted Sum of three maps and
# a DWConvTranspose2d of the JAX output size
ZOO = {
    "name": "zoo", "nc": 3, "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
    "layers": [
        [-1, 1, "Focus", [16, 3]],  # 0: 32x32
        [-1, 1, "Conv", [32, 3, 2]],  # 1: 16x16
        [-1, 1, "DWConv", [32, 3, 1]],
        [-1, 1, "C3", [32, 1]],
        [-1, 1, "BottleneckCSP", [32, 1]],
        [-1, 1, "C3x", [32, 1]],
        [-1, 1, "CrossConv", [32, 3, 1]],
        [-1, 1, "MixConv2d", [32, [1, 3]]],
        [-1, 1, "GhostConv", [32, 1, 1]],
        [-1, 1, "C3Ghost", [32, 1]],
        [-1, 2, "GhostBottleneck", [32, 3, 1]],  # 10
        [-1, 1, "Contract", [2]],  # 11: 8x8, 128 channels
        [-1, 1, "Conv", [64, 1, 1]],
        [-1, 1, "C3SPP", [64, 1]],
        [-1, 1, "C3TR", [64, 1]],
        [-1, 1, "TransformerBlock", [64, 4, 1]],  # 15
        [[12, 13, 15], 1, "Sum", [3, True]],
        [-1, 1, "SPP", [64, [3, 5]]],
        [-1, 1, "SPPF", [64, 3]],
        [-1, 1, "Bottleneck", [64]],
        [-1, 1, "ZeroPad", [[0, 1, 0, 1]]],  # 20
        [-1, 1, "MaxPool", [2, 1, 0]],
        [-1, 1, "Expand", [2]],  # 22: 16x16, 16 channels
        [11, 1, "DWConvTranspose2d", [32, 4, 2, 1, 2]],  # 16x16, groups 32
        [-1, 1, "Upsample", [1]],
        [[10, 22, 24], 1, "Concat", [1]],  # 25
        [-1, 1, "Conv", [32, 3, 1]],
        [[26, 19], 1, "Detect", ["nc", "anchors"]],
    ],
}



def test_registry_matches_jax():
    assert set(MODULE_REGISTRY) == set(JAX_REGISTRY)
    assert {ls.op for ls in parse_spec(ZOO).layers} >= {_canonical(op) for op in JAX_REGISTRY} | {"Detect"}


def _canonical(op):
    return {"nn.MaxPool2d": "MaxPool", "nn.ZeroPad2d": "ZeroPad", "nn.Upsample": "Upsample"}.get(op, op)


def test_every_op_matches_jax_and_fuses():
    """The model of every op: spec and forward equal to the JAX model's; the
    fused form keeps the standalone BNs of BottleneckCSP and MixConv2d, folds
    the top-level DWConv, and equals the unfused forward (1e-4). The JAX fused
    model cannot run it: its top-level DWConv keeps asking for the BN that
    fuse_variables folded."""
    assert spec_dict(parse_spec(ZOO)) == spec_dict(jax_parse_spec(ZOO))
    ref, port, x = build_pair(ZOO, 64)
    assert_forward_matches(ref, port, x)

    fused_sd, n = fuse_state_dict(port.state_dict())
    standalone = [k for k in fused_sd if k.endswith("bn.running_mean")]
    assert standalone == ["model.4.bn.running_mean", "model.7.bn.running_mean"]
    assert "model.2.conv.bias" in fused_sd and "model.2.bn.weight" not in fused_sd
    fused = port.fuse()
    with torch.no_grad():
        for g, w in zip(fused(torch.from_numpy(x), raw=True), port(torch.from_numpy(x), raw=True)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises((flax.errors.ScopeCollectionNotFound, flax.errors.ScopeVariableNotFoundError), match="dw/bn"):
        ref.fuse().predict(jnp.asarray(x))


def test_yolov5s_ghost_counts_ghostconv_strides():
    cfg = narrow("yolov5s-ghost")
    with pytest.raises(ZeroDivisionError):
        JaxModel.from_config(cfg, imgsz=64)
    spec = parse_spec(cfg)
    assert spec.strides == (8, 16, 32) and jax_parse_spec(cfg).strides == (0, 0, 0)
    # the JAX modules, on the JAX parser's spec with the strides counted
    jax_spec = dataclasses.replace(jax_parse_spec(cfg), strides=spec.strides)
    ref, port, x = build_pair(cfg, IMGSZ, jax_spec=jax_spec)
    assert_forward_matches(ref, port, x)


def test_jax_converter_cannot_map_a_c3tr():
    """The JAX package's torch_key_to_path sends a TransformerBlock's 2-D
    Linear weights through the 4-D conv transpose, so a reference-layout C3TR
    does not load there; it maps `tr.0` under another scope than its own
    `tr0` too, and a DWConv's `conv` where it nests `dw/conv`."""
    from yolov3_tpu.models.convert import torch_key_to_path

    cfg = narrow("yolov5s-transformer")
    port = DetectionModel.from_config(cfg, device="cpu")
    with pytest.raises(ValueError, match="axes"):
        convert_torch_checkpoint(port.state_dict(), JaxModel(jax_parse_spec(cfg), jax_variables(jax_parse_spec(cfg))))
    assert torch_key_to_path("model.8.m.tr.0.q.weight")[1] == ("l8", "m", "tr", "q", "kernel")
    assert torch_key_to_path("model.2.conv.weight")[1] == ("l2", "conv", "kernel")  # JAX: l2/dw/conv/kernel


def test_reference_pt_of_a_zoo_model_loads(tmp_path):
    """A reference-layout yolov5s `.pt` (a pickled module tree of the
    reference's classes, its cfg as the model's `yaml`) loads through the
    stub-unpickling path, the architecture taken from that cfg."""
    from test_torch_loading import write_pt

    cfg = narrow("yolov5s")
    model = DetectionModel.from_config(cfg, seed=4, device="cpu")
    sd = model.state_dict()
    g = torch.Generator().manual_seed(0)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.randn(v.shape, generator=g) * 0.1)
    pt = write_pt(tmp_path / "best.pt", "module_tree", sd, cfg={k: v for k, v in cfg.items() if k != "name"})
    loaded = load_weights(pt, device="cpu")
    assert loaded.spec.layers == model.spec.layers
    for k, v in sd.items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(chip_smoke.YOLOV5_MODELS))
def test_checkpoint_spec_round_trip(name):
    spec = parse_spec(chip_smoke.YOLOV5_MODELS[name])
    assert parse_spec(spec_to_dict(spec)) == spec
    if name == "yolov5s":  # the JAX package writes a C3's repeats twice, so it comes back with n = 1
        jax_spec = jax_parse_spec(chip_smoke.YOLOV5_MODELS[name])
        assert jax_parse_spec(jax_spec_to_dict(jax_spec)).layers[4].args != jax_spec.layers[4].args

"""The port's model spec (yolov3_tpu_torch.models.spec) against the JAX parser."""

import dataclasses
from pathlib import Path

import pytest
import torch

from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"yolov3": 61949149, "yolov3-spp": 62998749, "yolov3-tiny": 8852366}


def spec_dict(spec):
    d = dataclasses.asdict(spec)
    d.pop("channels", None)  # the port's own record of the tensors' channels
    d["layers"] = [dataclasses.astuple(ls) for ls in spec.layers]
    return d


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spec_matches_jax(name):
    port, ref = parse_spec(name), jax_parse_spec(name)
    assert spec_dict(port) == spec_dict(ref)
    assert (port.na, port.nl, port.no) == (ref.na, ref.nl, ref.no)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_narrowed_spec_matches_jax(name):
    import yaml

    d = yaml.safe_load((ROOT / "yolov3_tpu_torch/models/configs" / f"{name}.yaml").read_text())
    d.update(width_multiple=0.125, depth_multiple=0.33, nc=3)
    assert spec_dict(parse_spec(d)) == spec_dict(jax_parse_spec(d))


@pytest.mark.parametrize("name,n_params", sorted(CONFIGS.items()))
def test_param_count(name, n_params):
    with torch.device("meta"):
        model = DetectionModel(parse_spec(name))
    assert model.num_params() == n_params


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_byte_identical(name):
    port = ROOT / "yolov3_tpu_torch/models/configs" / f"{name}.yaml"
    ref = ROOT / "yolov3_tpu/models/configs" / f"{name}.yaml"
    assert port.read_bytes() == ref.read_bytes()


def test_unknown_op_rejected():
    d = {"nc": 2, "anchors": [[10, 13, 16, 30, 33, 23]],
         "layers": [{"from": -1, "n": 1, "op": "NoSuchOp", "args": [16]},
                    {"from": [0], "n": 1, "op": "Detect", "args": ["nc", "anchors"]}]}
    with pytest.raises(KeyError, match="unknown op"):
        parse_spec(d)

"""The benchmark's files: every cell, configuration and per-layer metric of
BENCHMARK.json is found by name, and the configurations are the port's."""

import json
import re

import pytest
import torch

from harness import core
from reference.model import Net

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100bench/run.py"] and BENCH["paths"] == ["h100bench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files(cell):
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    wl = core.load_json("workloads", cell)
    assert wl["name"] == cell and wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    config = core.load_json("configs", wl["config"])
    assert config["name"] == wl["config"]
    driver = core.load_module("traffic", wl["traffic"])
    assert callable(driver.drive) and callable(driver.control)
    reported = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    assert wl["check"], "a cell compares at least one number"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = core.load_module("metrics", metric)
    assert (mod.UNIT, mod.BETTER, mod.MOVES) == (entry["unit"], entry["better"], entry["moves"])
    assert callable(mod.read)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_ports(name):
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.models.spec import CONFIG_DIR
    from yolov3_tpu_torch.utils.general import yaml_load

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    config = json.loads((core.REPO / entry["file"]).read_text())
    assert config["reduced"] == entry["reduced"] == []
    port = yaml_load(CONFIG_DIR / f"{config['cfg']}.yaml")
    m = config["model"]
    assert m["anchors"] == port["anchors"] and m["nc"] == port["nc"] == config["nc"]
    assert [[r["from"], r["n"], r["op"], r["args"]] for r in port["layers"]] == m["layers"]
    from yolov3_tpu_torch.models.spec import parse_spec

    with torch.device("meta"):
        model = DetectionModel(parse_spec(config["cfg"]))
    assert model.num_params() == config["params"]
    ours = {n: tuple(s) for n, s, _ in Net(m).param_shapes()}
    assert ours == {k: tuple(v.shape) for k, v in model.state_dict().items()}

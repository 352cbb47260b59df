"""Every stride-1 3x3 conv-with-BN shape of the models, derived from the
port's own spec (yolov3_tpu_torch.models.spec), is a row that chip_smoke.py
holds against the plain version on the card: yolov3 / -spp / -tiny by their
config names, the YOLOv5s family by chip_smoke's cfg dicts (the package ships
no YOLOv5 YAML)."""

from collections import Counter

import pytest
import torch

import chip_smoke
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec

IMGSZ = 640
MODELS = {"yolov3": "yolov3", "yolov3-spp": "yolov3-spp", "yolov3-tiny": "yolov3-tiny",
          "yolov5s": chip_smoke.YOLOV5S, "yolov5s-transformer": chip_smoke.YOLOV5S_TRANSFORMER}
TIMED = ("yolov3", "yolov5s", "yolov5s-transformer")  # batch 8, as the train phases run them


def stats_route_shapes(name):
    """(H, W, Cin, Cout) of every conv that takes the conv+statistics route in
    train mode, in forward order: a forward of shapes only, on the meta device."""
    with torch.device("meta"):
        model = DetectionModel(parse_spec(MODELS[name]))
    model.eval()  # the route itself needs real tensors; the shapes are the same
    shapes = []

    def record(module, inputs):
        (x,) = inputs
        shapes.append((x.shape[2], x.shape[3], module.conv.in_channels, module.conv.out_channels))

    for m in model.modules():
        if getattr(m, "stats_route", False):
            m.register_forward_pre_hook(record)
    model(torch.empty((1, IMGSZ, IMGSZ, 3), device="meta"), raw=True)
    return shapes


def smoke_rows(batch=None):
    return {(H, W, Cin, Cout) for _, dtype, B, H, W, Cin, Cout in chip_smoke.K3_SHAPES
            if dtype == torch.bfloat16 and (batch is None or B == batch)}


@pytest.mark.parametrize("name", MODELS)
def test_every_conv_shape_is_a_chip_smoke_row(name):
    shapes = stats_route_shapes(name)
    assert shapes, "no conv takes the conv+statistics route"
    # the trained models' rows are the timed ones, at the train phases' batch of 8
    missing = set(shapes) - smoke_rows(batch=8 if name in TIMED else None)
    assert not missing, f"{name}: shapes without a row in chip_smoke.K3_SHAPES: {sorted(missing)}"


def test_yolov3_launch_split():
    shapes = stats_route_shapes("yolov3")
    assert len(shapes) == chip_smoke.YOLOV3_K3_CONVS == 33  # the trainer phase's K3 launches per step
    by_map = Counter(H for H, _, _, _ in shapes)
    assert [by_map[h] for h in (640, 320, 160, 80, 40, 20)] == [1, 1, 2, 11, 11, 7]
    assert all(H == W for H, W, _, _ in shapes)
    # one (Cin, Cout) per map size, so six rows stand for all 33 launches
    assert len(set(shapes)) == 6


@pytest.mark.parametrize("name", MODELS)
def test_kernel_routes_cover_the_models(name):
    """What csrc/conv_bn.cu's launch function routes on: every shape is the
    stem (Cin = 3, Cout 32 or 16) or has Cin % 16 == 0 (the wgmma kernel)."""
    for H, W, Cin, Cout in stats_route_shapes(name):
        assert (Cin == 3 and Cout in (16, 32)) or Cin % 16 == 0, (H, W, Cin, Cout)


@pytest.mark.parametrize("name", ["yolov5s", "yolov5s-transformer"])
def test_yolov5s_launch_split(name):
    """The C3 bottlenecks' 3x3 convs: 1 / 3 / 5 / 2 on the 160 / 80 / 40 / 20
    px maps (yolov5s-transformer's C3TR takes the 20 px backbone one), one
    (Cin = Cout) per map."""
    shapes = stats_route_shapes(name)
    assert len(shapes) == chip_smoke.YOLOV5_K3_CONVS[name]
    by_map = Counter(H for H, _, _, _ in shapes)
    want = [1, 3, 5, 2] if name == "yolov5s" else [1, 3, 5, 1]
    assert [by_map[h] for h in (160, 80, 40, 20)] == want and sum(by_map.values()) == sum(want)
    assert {(H, Cin, Cout) for H, _, Cin, Cout in shapes} == {(160, 32, 32), (80, 64, 64), (40, 128, 128), (20, 256, 256)}


def test_timed_rows_and_main_shape():
    labels = [row[0] for row in chip_smoke.K3_SHAPES]
    assert len(labels) == len(set(labels))
    assert chip_smoke.K3_MAIN_SHAPE in labels
    assert "320x320 32->64" in labels

"""The frozen counts: forward FLOPs and the kernels' bounds against hand counts."""

import json
import math

import pytest

from counts import kernels, peaks
from counts.flops import conv_shapes, forward_flops
from h100bench_support import MODELS
from harness.core import ROOT
from reference.model import Net


def model(layers, anchors=([10, 13, 16, 30, 33, 23],)):
    return {"nc": 2, "anchors": list(anchors), "layers": layers}


def test_flops_by_hand():
    m = model([[-1, 1, "Conv", [16, 3, 1]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Bottleneck", [32]],
               [-1, 1, "MaxPool", [2, 2, 0]], [[-1], 1, "Detect", ["nc", "anchors"]]])
    # 8x8 input: conv 3->16 at 8x8, conv 16->32 stride 2 at 4x4, bottleneck 32->16 (1x1) and 16->32 (3x3) at
    # 4x4, a 2x2 max pool, the head 32->3*7 at 2x2
    want = 2 * (3 * 16 * 9 * 64 + 16 * 32 * 9 * 16 + 32 * 16 * 16 + 16 * 32 * 9 * 16 + 32 * 21 * 4)
    assert forward_flops(m, 8) == want
    assert [s for s in conv_shapes(m, 8) if s[2] == 3 and s[3] == 1] == [(3, 16, 3, 1, 8, 8), (16, 32, 3, 1, 4, 4)]


def test_c3_sppf_and_padded_conv_by_hand():
    m = model([[-1, 1, "Conv", [16, 6, 2, 2]], [-1, 2, "C3", [32]], [-1, 1, "SPPF", [32, 5]],
               [-1, 1, "nn.Upsample", [None, 2, "nearest"]], [[-1], 1, "Detect", ["nc", "anchors"]]])
    # 16x16 input: the 6x6 stem 3->16 with padding 2 at (16 + 4 - 6) // 2 + 1 = 8; the C3 at 8x8: cv1 and cv2
    # 16->16, two bottlenecks 16->16 (1x1) and 16->16 (3x3), cv3 32->32; SPPF at 8x8: 32->16 and 64->32; the
    # upsample to 16x16 and the head 32->3*7 there
    c3 = 2 * 16 * 16 + 2 * (16 * 16 + 16 * 16 * 9) + 32 * 32
    want = 2 * (3 * 16 * 36 * 64 + c3 * 64 + (32 * 16 + 64 * 32) * 64 + 32 * 21 * 256)
    assert forward_flops(m, 16) == want
    assert [s for s in conv_shapes(m, 16) if s[2] == 3 and s[3] == 1] == [(16, 16, 3, 1, 8, 8)] * 2
    net = Net(m)
    assert net.strides == (1,) and [ly["n"] for ly in net.layers] == [1, 1, 1, 1, 1]
    assert sum(1 for n, _, kind in net.param_shapes() if kind == "conv") == 1 + 3 + 2 * 2 + 2


@pytest.mark.parametrize("name,params,k3", [("yolov5s", 7235389, 11), ("yolov5x6", 140.7e6, 56)])
def test_yolov5_counts_are_the_ports(name, params, k3):
    import torch

    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.models.spec import parse_spec
    from yolov3_tpu_torch.utils.profiling import model_flops

    m = MODELS[name]
    with torch.device("meta"):
        port = DetectionModel(parse_spec(dict(m, name=name)))
    ours = sum(math.prod(s) for _, s, kind in Net(m).param_shapes() if kind not in ("bn_mean", "bn_var", "bn_count"))
    assert ours == port.num_params() == pytest.approx(params, abs=0.1e6)
    assert forward_flops(m, 640) == model_flops(port, 640)
    assert sum(1 for s in conv_shapes(m, 640) if s[2] == 3 and s[3] == 1) == k3


@pytest.mark.parametrize("name,gflop,k3", [("yolov3", 155.8913024, 33), ("yolov3-tiny", 13.1715072, 9)])
def test_published_flops(name, gflop, k3):
    m = json.loads((ROOT / "configs" / f"{name}.json").read_text())["model"]
    assert forward_flops(m, 640) == pytest.approx(gflop * 1e9, rel=1e-12)
    assert sum(1 for s in conv_shapes(m, 640) if s[2] == 3 and s[3] == 1) == k3


def test_kernel_bounds_by_hand():
    # K1: 2 images of 10 candidates, 3 kept: bytes 2*10*40 + 2*300*24 + 8 = 15208; ops 17*10*3 = 510
    assert kernels.k1_bound_s(2, 10, 3) == pytest.approx(max(15208 / peaks.HBM_BYTES_S, 510 / peaks.F32_FLOP_S))
    assert kernels.k1_bound_s(2, 30000, 600) == pytest.approx(17 * 30000 * 600 / peaks.F32_FLOP_S)
    # K2: yolov3's three levels at batch 32: 143.5 MB read and written
    total = sum(kernels.k2_bound_s(32, c, 3, 85) for c in (6400, 1600, 400))
    assert total * peaks.HBM_BYTES_S == pytest.approx(32 * 8400 * 3 * (85 * 2 + 8))
    # K3: 8 x 320x320 32->64 is bound by bytes (0.0470 ms), 8 x 80x80 128->256 by operations (0.0305 ms)
    assert kernels.k3_bound_s(8, 320, 320, 32, 64) * 1e3 == pytest.approx(0.0470, abs=5e-5)
    assert kernels.k3_bound_s(8, 80, 80, 128, 256) * 1e3 == pytest.approx(0.0305, abs=5e-5)

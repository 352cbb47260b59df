"""Operations of one forward of a configuration, from its layer graph.

Two operations a multiply-add of every convolution (the conv layers, the
Bottlenecks' two, C3's three and its bottlenecks' two each, SPP's and
SPPF's two, the head's 1x1 convs), from the weight shapes and the output
sizes; BatchNorm, activations, pools and adds are left out,
as utils/profiling.model_flops of the program leaves them out. yolov3 at 640
px: 155.89 GFLOP an image; yolov3-tiny: 13.17.
"""

from __future__ import annotations

from reference.model import Net


def conv_shapes(model_cfg, imgsz):
    """[(cin, cout, k, stride, hout, wout)] of every convolution of one
    forward at imgsz x imgsz, and the stride-1 3x3 ones (which the train
    step's conv + BatchNorm-statistics kernel takes) marked by stride 1."""
    net = Net(model_cfg)
    size, out = {-1: imgsz}, []
    for ly in net.layers:
        i, op, a = ly["i"], ly["op"], ly["args"]
        h = size[ly["f"][0]]
        if op == "Detect":
            for k, j in enumerate(net.detect_from):
                out.append((net.chans[j], net.na * net.no, 1, 1, size[j], size[j]))
            continue
        for r in range(ly["n"]):
            cin = ly["c1"] if r == 0 else ly["c2"]
            c2 = ly["c2"]
            if op == "Conv":
                _, k, s, pad = a
                h = (h + 2 * pad - k) // s + 1
                out.append((cin, c2, k, s, h, h))
            elif op == "Bottleneck":
                c_ = int(c2 * 0.5)
                out += [(cin, c_, 1, 1, h, h), (c_, c2, 3, 1, h, h)]
            elif op == "C3":
                c_ = int(c2 * 0.5)
                out += [(cin, c_, 1, 1, h, h), (cin, c_, 1, 1, h, h)]
                out += [(c_, c_, 1, 1, h, h), (c_, c_, 3, 1, h, h)] * a[1]
                out.append((2 * c_, c2, 1, 1, h, h))
            elif op in ("SPP", "SPPF"):
                pools = len(a[1]) if op == "SPP" else 3
                out += [(cin, cin // 2, 1, 1, h, h), (cin // 2 * (pools + 1), c2, 1, 1, h, h)]
            elif op == "MaxPool":
                k, s, pad = a
                h = (h + 2 * pad - k) // s + 1
            elif op == "ZeroPad":
                h = h + a[0][2] + a[0][3]
            elif op == "Upsample":
                h = h * a[0]
        size[i] = h
    return out


def forward_flops(model_cfg, imgsz):
    """FLOPs of one image's forward."""
    return sum(2 * cin * cout * k * k * h * w for cin, cout, k, _, h, w in conv_shapes(model_cfg, imgsz))

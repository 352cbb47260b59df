"""k3_roofline.train: K3 (csrc/conv_bn.cu, the stride-1 3x3 convs with their
BatchNorm statistics) in the train step: the per-shape bounds (the larger of
bf16 operations and bytes, counts/kernels.py) of every stride-1 3x3 conv of
the traced steps over K3's device time."""

from counts.flops import conv_shapes
from counts.kernels import k3_bound_s
from harness.reads import kernel_seconds

UNIT, BETTER, MOVES = "%", "higher", "train_img_s"
KERNEL = ("conv3x3_stats", "bn_stats_finalize")


def read(run):
    t = kernel_seconds(run, KERNEL)
    steps = run.counters.get("traced", {}).get("steps", 0)
    if t <= 0 or not steps:
        return None
    wl = run.workload
    shapes = [s for s in conv_shapes(wl.get("model") or run.config["model"], wl["imgsz"]) if s[2] == 3 and s[3] == 1]
    bound = sum(k3_bound_s(wl["batch"], h, w, cin, cout) for cin, cout, _, _, h, w in shapes)
    return 100.0 * bound * steps / t

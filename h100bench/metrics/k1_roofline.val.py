"""k1_roofline.val: K1 (csrc/nms.cu, greedy NMS) in the validation batches:
the larger of its byte and operation bounds (counts/kernels.py, 17 x K x the
boxes kept) over K1's device time in the traced window."""

from counts.kernels import k1_bound_s
from harness.reads import kernel_seconds
from reference.model import Net

UNIT, BETTER, MOVES = "%", "higher", "val_img_s"
KERNEL = ("greedy_nms",)


def read(run):
    t = kernel_seconds(run, KERNEL)
    kept = run.counters.get("traced", {}).get("kept_per_batch")
    if t <= 0 or not kept:
        return None
    wl = run.workload
    net = Net(wl.get("model") or run.config["model"])
    anchors = net.na * sum((wl["imgsz"] // s) ** 2 for s in net.strides)
    K = min(wl["max_nms"], anchors * net.nc)
    return 100.0 * sum(k1_bound_s(wl["batch"], K, n, wl["max_det"]) for n in kept) / t

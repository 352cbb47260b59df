"""nms_ms.x6_serve: K1 (csrc/nms.cu, greedy NMS) on the served batches of the
P6 model: its device ms a launch in the traced window. At K = 960 candidates a
batch (k_per_scale 512 + 256 + 128 + 64) K1 takes its shared-memory route,
which no other cell runs on served batches. None where K1 did not run."""

from harness.reads import kernel_seconds

UNIT, BETTER, MOVES = "ms", "lower", "serve_img_s"
KERNEL = ("greedy_nms",)


def read(run):
    t = kernel_seconds(run, KERNEL)
    launches = run.counters.get("traced", {}).get("launches", {}).get("greedy_nms", 0)
    if t <= 0 or not launches:
        return None
    return 1e3 * t / launches

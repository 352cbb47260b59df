"""What the per-layer metrics read from a finished run (metrics/<name>.py)."""

from __future__ import annotations

from counts.flops import forward_flops
from counts.kernels import k2_bound_s
from reference.model import Net


def kernel_seconds(run, substrings):
    """Device seconds of the traced window's operations whose name holds one of `substrings`."""
    if run.trace is None:
        return 0.0
    return sum(t for name, t in run.trace["kernels"] if any(s in name for s in substrings))


def kernel_count(run):
    """Kernels in the traced window (copies and fills left out)."""
    if run.trace is None:
        return 0
    return sum(1 for name, _ in run.trace["kernels"] if not name.startswith(("Memcpy", "Memset")))


def idle_percent(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def image_flops(run):
    """FLOPs of one image's forward at the cell's size."""
    model = run.workload.get("model") or run.config["model"]
    return forward_flops(model, run.workload["imgsz"])


def share_of_peak(run, e2e, flops_per_image, peak):
    rate = run.e2e.get(e2e)
    return None if rate is None else 100.0 * flops_per_image * rate / peak


def k2_roofline(run):
    """K2's byte bound over its device time for the batches served in the traced window (K2
    runs once a head level a batch); None where K2 did not run."""
    t = kernel_seconds(run, ("score_kernel",))
    launches = run.counters.get("traced", {}).get("launches", {}).get("masked_scores", 0)
    if t <= 0 or not launches:
        return None
    wl = run.workload
    net = Net(wl.get("model") or run.config["model"])
    bound = sum(k2_bound_s(wl["batch"], (wl["imgsz"] // s) ** 2, net.na, net.no) for s in net.strides)
    return 100.0 * bound * launches / net.nl / t

"""kernels_per_step.train: device kernels a train step launches (profiler,
copies and fills left out), over the traced steps."""

from harness.reads import kernel_count

UNIT, BETTER, MOVES = "count", "lower", "train_img_s"


def read(run):
    steps = run.counters.get("traced", {}).get("steps", 0)
    return kernel_count(run) / steps if steps and run.trace is not None else None

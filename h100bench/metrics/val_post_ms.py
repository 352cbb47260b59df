"""val_post_ms: the validator's host matching and bookkeeping, ms an image:
the third of the times `eval.validator.run` returns (its own Profile spans)
over the window."""

UNIT, BETTER, MOVES = "ms", "lower", "val_img_s"


def read(run):
    speeds = run.counters.get("speeds_ms")
    return float(speeds[2]) if speeds else None

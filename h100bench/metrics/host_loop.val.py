"""host_loop.val: the share of the traced `validator.run` in which the host
matches and scores while no device work is queued: 100 x (the port's
`val/match` spans, one a batch, plus its `val/map` span) over the traced
window (harness/spans.py)."""

from harness.spans import span_seconds

UNIT, BETTER, MOVES = "%", "lower", "val_img_s"


def read(run):
    s = span_seconds(run, ("val/match", "val/map"))
    return None if s is None or run.trace["window_s"] <= 0 else 100.0 * s / run.trace["window_s"]

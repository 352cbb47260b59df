"""k2_roofline.tiny_serve: K2 (csrc/score.cu, masked candidate scores) at the served batch's
shapes: its byte bound (counts/kernels.py) over K2's device time in the traced
window, for the batches served there."""

from harness.reads import k2_roofline

UNIT, BETTER, MOVES = "%", "higher", "tiny_serve_img_s"


def read(run):
    return k2_roofline(run)

"""enqueue_ms.serve: host ms to queue one served batch of yolov3 (copy in,
forward, decode, NMS spans of the port's fast path, harness/spans.py); set
against the device's busy_s over the traced batches, it says whether the
served step is launch-bound."""

from harness.spans import enqueue_ms

UNIT, BETTER, MOVES = "ms", "lower", "serve_img_s"


def read(run):
    return enqueue_ms(run)

"""enqueue_ms.tiny_serve: enqueue_ms.serve of the yolov3-tiny cell."""

from harness.spans import enqueue_ms

UNIT, BETTER, MOVES = "ms", "lower", "tiny_serve_img_s"


def read(run):
    return enqueue_ms(run)

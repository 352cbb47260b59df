"""device_idle.tiny_serve: the share of the traced window in which no operation ran
on the device (profiler, the union of the device's intervals)."""

from harness.reads import idle_percent

UNIT, BETTER, MOVES = "%", "lower", "tiny_serve_img_s"


def read(run):
    return idle_percent(run)

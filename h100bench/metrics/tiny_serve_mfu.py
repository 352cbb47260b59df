"""tiny_serve_mfu: the served step's share of the H100's bf16 peak: one forward's
FLOPs (counts/flops.py) times the window's img/s over 989 TFLOP/s."""

from counts.peaks import BF16_FLOP_S
from harness.reads import image_flops, share_of_peak

UNIT, BETTER, MOVES = "%", "higher", "tiny_serve_img_s"


def read(run):
    return share_of_peak(run, MOVES, image_flops(run), BF16_FLOP_S)

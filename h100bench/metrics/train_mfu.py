"""train_mfu: the train step's share of the H100's bf16 peak: three forwards'
FLOPs an image (forward, and the backward's two) times the window's img/s
over 989 TFLOP/s."""

from counts.peaks import BF16_FLOP_S
from harness.reads import image_flops, share_of_peak

UNIT, BETTER, MOVES = "%", "higher", "train_img_s"


def read(run):
    return share_of_peak(run, MOVES, 3 * image_flops(run), BF16_FLOP_S)

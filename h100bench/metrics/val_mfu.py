"""val_mfu: the validation forward's share of the H100's TF32 peak (the
port's float32 convolutions run in TF32 under cuDNN's default): one
forward's FLOPs times the window's img/s over 495 TFLOP/s."""

from counts.peaks import TF32_FLOP_S
from harness.reads import image_flops, share_of_peak

UNIT, BETTER, MOVES = "%", "higher", "val_img_s"


def read(run):
    return share_of_peak(run, MOVES, image_flops(run), TF32_FLOP_S)

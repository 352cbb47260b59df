"""Least device time of the work of the port's three kernels, from shapes
(frozen copies of the arithmetic of chip_smoke.py phase_nms, phase_score and
phase_conv_bn). Each count is of the work the cell's shapes need, whatever
kernel does it: every input byte read once, every output byte written once.

K1 greedy NMS over B images of K prefiltered candidates: reads boxes (4 f32
offset + 4 f32 written) and scores and classes (B K 40 bytes), writes
max_det rows of 6 f32 (B 300 24) and B counts; 17 f32 operations an IoU test
and compare, K tests for each kept box.

K2 candidate scores over (B, cells, na*no) head rows: reads the rows, writes
one f32 score and one int32 class an anchor row.

K3 3x3 stride-1 conv with the BatchNorm statistics of its output: 2 Cin Cout 9
operations an output pixel; reads the input and the weights, writes the
output (statistics: 2 Cout f32).
"""

from __future__ import annotations

from counts.peaks import BF16_FLOP_S, F32_FLOP_S, HBM_BYTES_S

NMS_OPS_PER_IOU = 17


def k1_bound_s(B, K, kept, max_det=300):
    """Least seconds of one K1 launch; `kept` is the number of boxes kept over the batch."""
    nbytes = B * K * 40 + B * max_det * 24 + B * 4
    return max(nbytes / HBM_BYTES_S, NMS_OPS_PER_IOU * K * kept / F32_FLOP_S)


def k2_bound_s(B, cells, na, no, elem_bytes=2):
    return (B * cells * na * no * elem_bytes + B * cells * na * 8) / HBM_BYTES_S


def k3_bound_s(B, H, W, cin, cout, elem_bytes=2):
    ops = 2 * B * H * W * cin * cout * 9
    nbytes = (B * H * W * (cin + cout) + 9 * cin * cout) * elem_bytes + 2 * cout * 4
    return max(ops / BF16_FLOP_S, nbytes / HBM_BYTES_S)

"""Candidate-score pass of the top-k decode, as a Triton kernel.

Replaces the TPU kernel `_score_kernel` / `masked_scores_pallas` of
yolov3_tpu/ops/score_pallas.py. One read of the raw head output
(B, ny*nx, na*no): per anchor, score = sigmoid(obj) * sigmoid(max cls logit),
stored where score > conf and sigmoid(obj) > conf, else -1; and the class
argmax (lowest index of the max). Output order is (y, x, a), the order the
JAX default decode uses (detect_head.py:264-271), so the candidates and
their order match JAX's `fast_fn`.

Bound: memory. It reads every head byte once (137 MB at yolov3@640 bs32) and
writes 8 B per anchor; there is no tensor-core work. One program (one warp)
takes BLOCK_M cells and loads each anchor's 80 class logits as one masked
row of a (BLOCK_M, 128) tile, so neighbouring lanes read neighbouring bytes.
Small programs keep many in flight on every SM; the first version (64 cells,
4 warps a program) was many times slower (PERF.md).
The sigmoid is 1 / (1 + exp(-x)) with libdevice's expf and a correctly
rounded division, the arithmetic of PyTorch's CUDA sigmoid, so the scores
agree with the plain version within 1e-6 (chip_smoke.py checks it).
Wider loads (the 510-byte rows are not 16-byte aligned) are later work.
"""

from __future__ import annotations

import functools
import os

import torch

from yolov3_tpu_torch.ops.cuda_build import BUILD_DIR

BLOCK_M = 4  # cells per program
NUM_WARPS = 1


def masked_scores_plain(flat, na, no, conf_thres):
    """Plain PyTorch version: (B, M, na*no) -> (B, M*na) f32 scores, (B, M*na) int32 args."""
    bs, m, ch = flat.shape
    v = flat.reshape(bs, m * na, no)
    obj = torch.sigmoid(v[..., 4].float())
    cls = v[..., 5:]
    cls_max = cls.amax(-1).float()  # max commutes with the exact upcast
    cls_arg = cls.argmax(-1).to(torch.int32)  # lowest index of the max
    score = obj * torch.sigmoid(cls_max)
    valid = (score > conf_thres) & (obj > conf_thres)
    return torch.where(valid, score, -1.0), cls_arg


@functools.cache
def _kernel():
    # Triton's compile cache goes beside the CUDA builds, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _sigmoid(x):
        return tl.math.div_rn(tl.full(x.shape, 1.0, tl.float32), 1.0 + libdevice.exp(-x))

    @triton.jit
    def score_kernel(x_ptr, score_ptr, arg_ptr, M, conf_thres,
                     NA: tl.constexpr, NO: tl.constexpr, NC: tl.constexpr,
                     BLOCK: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(1)
        rows = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        cols = tl.arange(0, BLOCK_C)
        rmask = rows < M
        cell = b.to(tl.int64) * M + rows
        row_ptr = x_ptr + cell * (NA * NO)
        for a in tl.static_range(NA):
            obj_logit = tl.load(row_ptr + (a * NO + 4), mask=rmask, other=0.0).to(tl.float32)
            cls = tl.load(row_ptr[:, None] + (a * NO + 5) + cols[None, :],
                          mask=rmask[:, None] & (cols < NC)[None, :],
                          other=float("-inf")).to(tl.float32)
            cls_max = tl.max(cls, axis=1)
            cls_arg = tl.min(tl.where(cls == cls_max[:, None], cols[None, :], NC), axis=1)
            obj = _sigmoid(obj_logit)
            score = obj * _sigmoid(cls_max)
            valid = (score > conf_thres) & (obj > conf_thres)
            tl.store(score_ptr + cell * NA + a, tl.where(valid, score, -1.0), mask=rmask)
            tl.store(arg_ptr + cell * NA + a, cls_arg, mask=rmask)

    return triton, score_kernel


def masked_scores(flat, na, no, conf_thres):
    """Masked candidate scores + class argmax of one scale's raw head output.

    flat: (B, ny*nx, na*no) head output in its compute dtype.
    Returns scores (B, ny*nx*na) f32 (obj*cls_max where valid, else -1) and
    class args (B, ny*nx*na) int32, both in (y, x, a) order.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if flat.device.type == "cpu":
        return masked_scores_plain(flat, na, no, conf_thres)
    if flat.device.type != "cuda":
        raise ValueError(f"masked_scores: unsupported device {flat.device}")
    bs, m, ch = flat.shape
    if ch != na * no or no < 6:
        raise ValueError(f"masked_scores: {tuple(flat.shape)} is not (B, M, na*no) for na={na}, no={no}")
    if flat.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"masked_scores: unsupported dtype {flat.dtype}")
    flat = flat.contiguous()
    scores = torch.empty((bs, m * na), dtype=torch.float32, device=flat.device)
    args = torch.empty((bs, m * na), dtype=torch.int32, device=flat.device)
    if bs == 0 or m == 0:
        return scores, args
    triton, kernel = _kernel()
    nc = no - 5
    with torch.cuda.device(flat.device):
        kernel[(triton.cdiv(m, BLOCK_M), bs)](
            flat, scores, args, m, float(conf_thres),
            NA=na, NO=no, NC=nc, BLOCK=BLOCK_M, BLOCK_C=triton.next_power_of_2(nc),
            num_warps=NUM_WARPS,
        )
    masked_scores.launches += 1
    return scores, args


masked_scores.launches = 0

"""Candidate-score pass of the top-k decode: the CUDA kernel of csrc/score.cu
and its plain version.

Replaces the TPU kernel `_score_kernel` / `masked_scores_pallas` of
yolov3_tpu/ops/score_pallas.py. One read of the raw head output
(B, ny*nx, na*no): per anchor, score = sigmoid(obj) * sigmoid(max cls logit),
stored where score > conf and sigmoid(obj) > conf, else -1; and the class
argmax (lowest index of the max). Output order is (y, x, a), the order the
JAX default decode uses (detect_head.py:264-271), so the candidates and
their order match JAX's `fast_fn`. The kernel's design and bound are
described in csrc/score.cu; `tile_cells` and `tile_plan` below are its
tiling, in Python, for the wrapper and for tests/test_torch_score_tiles.py.
"""

from __future__ import annotations

import ctypes
import math

import torch

from yolov3_tpu_torch.ops import cuda_build

DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
TILE_BYTES = 32768  # bytes of head output a tile aims at
STAGES = 2  # csrc/score.cu's ring
SMEM_LIMIT = 227 * 1024


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


def tile_cells(row_bytes):
    """Cells per tile: a multiple of 16 / gcd(row_bytes, 16), so that a tile
    of a 16-byte-aligned tensor starts and ends on a 16-byte boundary, and
    about TILE_BYTES of rows (8 * 8 = 64 cells of 510-byte bf16 rows)."""
    group = 16 // math.gcd(row_bytes, 16)
    return group * max(1, TILE_BYTES // (group * row_bytes))


def smem_bytes(row_bytes, cells):
    """Dynamic shared memory of a launch (csrc/score.cu `launch`): the stages and their barriers."""
    stage = (row_bytes * cells + 32 + 127) // 128 * 128
    return STAGES * (stage + 8)


def tile_plan(n_cells, row_bytes, cells, ptr=0):
    """How the kernel moves each tile (csrc/score.cu `split_tile`), for a
    tensor whose data starts at address `ptr`: a list of
    (first cell, end cell, (bulk start, bulk end), [(start, end) of the
    pieces copied by 2-byte loads]), byte addresses absolute."""
    plan = []
    for c0 in range(0, n_cells, cells):
        c1 = min(c0 + cells, n_cells)
        start, end = ptr + c0 * row_bytes, ptr + c1 * row_bytes
        up, down = (start + 15) // 16 * 16, end // 16 * 16
        if down >= up:
            bulk, pieces = (up, down), [(start, up), (down, end)]
        else:
            bulk, pieces = (up, up), [(start, end)]
        plan.append((c0, c1, bulk, [p for p in pieces if p[1] > p[0]]))
    return plan


def masked_scores(flat, na, no, conf_thres):
    """Masked candidate scores + class argmax of one scale's raw head output.

    flat: (B, ny*nx, na*no) head output in its compute dtype (bf16, f16, f32).
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
    if flat.dtype not in DTYPES:
        raise ValueError(f"masked_scores: unsupported dtype {flat.dtype}")
    flat = flat.contiguous()
    row_bytes = ch * flat.element_size()
    cells = tile_cells(row_bytes)
    if smem_bytes(row_bytes, cells) > SMEM_LIMIT:
        raise ValueError(f"masked_scores: rows of {row_bytes} bytes do not fit the kernel's shared memory")
    scores = torch.empty((bs, m * na), dtype=torch.float32, device=flat.device)
    args = torch.empty((bs, m * na), dtype=torch.int32, device=flat.device)
    if bs == 0 or m == 0:
        return scores, args
    lib = _library()
    with torch.cuda.device(flat.device):
        err = lib.masked_scores_launch(flat.data_ptr(), scores.data_ptr(), args.data_ptr(), bs * m, na, no,
                                       DTYPES[flat.dtype], cells, float(conf_thres),
                                       torch.cuda.current_stream(flat.device).cuda_stream)
    if err:
        raise RuntimeError(f"masked_scores kernel launch failed: cudaError {err}")
    masked_scores.launches += 1
    masked_scores.last_route = f"bulk-copy tiles of {cells} cells ({cells * row_bytes} bytes)"
    return scores, args


masked_scores.launches = 0
masked_scores.last_route = None


def _library():
    lib = cuda_build.load("score")
    fn = lib.masked_scores_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                                          ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib

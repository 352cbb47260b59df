"""The tiling of the candidate-score kernel (csrc/score.cu), modelled in numpy.

The kernel treats the B*M cells of a scale as one run of rows, cuts it into
tiles of `tile_cells` cells and moves each tile into shared memory with one
bulk copy of its 16-byte-aligned bytes, plus 2-byte loads for what lies
outside them. `ops.score_cuda.tile_plan` is that arithmetic in Python; these
tests hold it to the kernel's contract: every cell is covered once, every
bulk copy starts and ends on a 16-byte boundary, and for a tensor that starts
on one only the end of the last tile (under 16 bytes) takes element loads.
The landing positions are replayed into a model of a stage in shared memory.
The kernel itself is held to its plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.ops.score_cuda import SMEM_LIMIT, smem_bytes, tile_cells, tile_plan

NA, NO = 3, 85
ELEMENT = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}


def check_plan(n_cells, row_bytes, ptr):
    cells = tile_cells(row_bytes)
    plan = tile_plan(n_cells, row_bytes, cells, ptr)
    # cells: the tiles partition [0, n_cells) in order
    assert plan[0][0] == 0 and plan[-1][1] == n_cells
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert all(0 < c1 - c0 <= cells for c0, c1, _, _ in plan)
    stage = (row_bytes * cells + 32 + 127) // 128 * 128
    for c0, c1, (b0, b1), pieces in plan:
        start, end = ptr + c0 * row_bytes, ptr + c1 * row_bytes
        assert b0 % 16 == 0 and b1 % 16 == 0 and b1 >= b0
        # bytes: the bulk copy and the pieces cover [start, end) once
        spans = sorted([(b0, b1)] + pieces)
        covered = [s for s in spans if s[1] > s[0]]
        assert covered[0][0] == start and covered[-1][1] == end
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
        # a piece is one warp's 2-byte loads: under 16 bytes, or under 32 when no whole line is in the tile
        for p0, p1 in pieces:
            assert (p1 - p0) % 2 == 0 and p1 - p0 < (32 if b1 == b0 else 16)
        # the tile fits its stage, from the 16-byte line below its first byte
        assert end - (start // 16 * 16) <= stage
    return plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
@pytest.mark.parametrize("M", [1, 7, 400, 401, 6400])
@pytest.mark.parametrize("B", [1, 3, 32])
def test_aligned_tensor_only_the_last_tail_takes_element_loads(B, M, dtype):
    row_bytes = NA * NO * ELEMENT[dtype]
    cells = tile_cells(row_bytes)
    assert cells % (16 // np.gcd(row_bytes, 16)) == 0 and (cells * row_bytes) % 16 == 0
    assert smem_bytes(row_bytes, cells) <= SMEM_LIMIT
    plan = check_plan(B * M, row_bytes, ptr=256)
    for c0, c1, (b0, b1), pieces in plan[:-1]:
        assert not pieces and b1 - b0 == (c1 - c0) * row_bytes  # whole tiles: one bulk copy each
    *_, pieces = plan[-1]
    end = 256 + B * M * row_bytes
    assert pieces == ([] if end % 16 == 0 else [(end // 16 * 16, end)])


def test_yolov3_bf16_tiles():
    """510-byte rows: 8 cells are 255 lines of 16 bytes; a tile is 64 cells, 32640 bytes."""
    assert tile_cells(510) == 64 and tile_cells(1020) == 32


@pytest.mark.parametrize("n_cells,row_bytes,ptr", [
    (401 * 3, 510, 2),  # a view that starts 2 bytes past a line
    (401 * 3, 510, 14),
    (64, 1020, 4),  # f32 rows, 4 bytes past
    (50, 48, 6),  # nc=3 bf16 rows: 48 bytes, a whole number of lines, but the tensor starts off one
    (1, 12, 2),  # one 12-byte row (na=1, no=6, bf16) inside one line
    (1, 12, 10),  # one 12-byte row across a boundary, no whole line
    (3, 12, 0),
])
def test_unaligned_and_tiny_tensors_replay_exactly(n_cells, row_bytes, ptr):
    plan = check_plan(n_cells, row_bytes, ptr)
    rng = np.random.default_rng(n_cells + ptr)
    memory = rng.integers(0, 256, size=ptr + n_cells * row_bytes + 64, dtype=np.uint8)
    cells = tile_cells(row_bytes)
    stage_len = (row_bytes * cells + 32 + 127) // 128 * 128
    for c0, c1, (b0, b1), pieces in plan:
        start = ptr + c0 * row_bytes
        base = start // 16 * 16
        stage = np.full(stage_len, 0xEE, np.uint8)
        stage[b0 - base:b1 - base] = memory[b0:b1]  # the bulk copy
        for p0, p1 in pieces:  # the 2-byte loads
            for g in range(p0, p1, 2):
                stage[g - base:g - base + 2] = memory[g:g + 2]
        # row r of the tile is read at (start % 16) + r * row_bytes
        first = start % 16
        got = stage[first:first + (c1 - c0) * row_bytes]
        np.testing.assert_array_equal(got, memory[start:start + (c1 - c0) * row_bytes])


def row_argmax_model(stage, offset, nc):
    """csrc/score.cu `row_argmax` for 2-byte logits: 4-byte word reads from the
    word boundary at or below `offset`, accumulators that each see ascending
    indices taken with a strict >, merged by value, then lowest index (the
    kernel spreads the words over four; any such split gives this result)."""
    s = (offset >> 1) & 1
    nw = (s + nc + 1) // 2
    # the last word may reach 2 bytes past the row: a stage has slack behind its tile
    padded = np.concatenate([stage, np.zeros(4, np.uint8)])
    words = np.frombuffer(padded[offset - 2 * s:offset - 2 * s + 4 * nw].tobytes(), "<u4")
    acc = {0: (-np.inf, 2**31 - 1), 1: (-np.inf, 2**31 - 1)}
    for j in range(nw):
        w = int(words[j])
        for half, bits in ((0, (w & 0xFFFF) << 16), (1, w & 0xFFFF0000)):
            k = 2 * j + half - s
            v = float(np.array([bits], np.uint32).view(np.float32)[0])  # bf16 -> f32: the bits shifted up
            if 0 <= k < nc and v > acc[half][0]:
                acc[half] = (v, k)
    (va, ka), (vb, kb) = acc[0], acc[1]
    best = (vb, kb) if vb > va or (vb == va and kb < ka) else (va, ka)
    return best if best[1] != 2**31 - 1 else (best[0], 0)


@pytest.mark.parametrize("nc", [1, 2, 3, 80])
@pytest.mark.parametrize("offset", [0, 2, 4, 6, 10])
def test_row_argmax_word_reads_find_the_first_max(nc, offset):
    rng = np.random.default_rng(nc * 16 + offset)
    vals = torch.from_numpy(rng.integers(-6, 6, size=offset // 2 + nc + 2).astype(np.float32) / 2)
    stage = vals.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8).copy()  # coarse values: ties
    logits = vals[offset // 2:offset // 2 + nc].numpy()
    v, k = row_argmax_model(stage, offset, nc)
    assert (v, k) == (logits.max(), int(np.argmax(logits)))
    stage[offset:offset + 2 * nc] = torch.full((nc,), -np.inf).to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint8)
    assert row_argmax_model(stage, offset, nc) == (-np.inf, 0)  # every logit -inf: torch.argmax gives 0

"""Recover what cv2 draws for `utils.plots.Annotator` -- the glyphs of
FONT_HERSHEY_SIMPLEX (font 0) and axis-aligned rectangles -- and write it to
yolov3_tpu_torch/utils/fonts/annotator_atlas.npz.

OpenCV 5 draws font 0 with a built-in TrueType face (not the Hershey strokes
of OpenCV 4). Each glyph is a coverage mask placed at an integer pen
position, the pen moving by an integer advance, and the mask is blended as
round((dst * (255 - a) + color * a) / 255). So the font at one (fontScale,
thickness) is fully described by, for each of the 95 printable ASCII
characters, its advance, its descent (getTextSize's baseline) and its mask
with the mask's offset from the pen, plus the text height and the width
getTextSize adds to the sum of advances. This script reads all of that from
cv2 for every Annotator line width lw in 1..LW_MAX (fontScale lw / 3,
thickness max(lw - 1, 1)).

Rectangles: cv2.rectangle at integer corners draws the same pattern around
each corner whatever the box's size, and a constant cross-section along each
side (OpenCV's LineAA / FillConvexPoly at integer coordinates are
translation invariant). So one box of each thickness (1..LW_MAX, and -1 for
filled), drawn white on black, holds every box of that thickness: its
coverage image is stored with the box's corners at (M, M) and (M + L, M + L),
and a box of any size maps each of its pixels to the stamp's corner
neighbourhood or to the middle of a side (csrc/host_ops.cpp
draw_rect_stamp). Stamps are kept for LINE_AA and LINE_8. After writing the
atlas, the script draws random strings and boxes with the port
(utils/plots.py) and with cv2 and prints the pixels that differ (for boxes,
by more than 2 levels: the stamp blends once where cv2 blends each
primitive in turn).

    python scripts/recover_annotator_atlas.py     # needs cv2; a few seconds
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np

LW_MAX = 32  # Annotator's default width reaches 32 at about 108 MP (12000 x 9000); wider raises
CHARS = [chr(c) for c in range(32, 127)]
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the port's drawing, for the check
OUT = ROOT / "yolov3_tpu_torch" / "utils" / "fonts" / "annotator_atlas.npz"
THICKNESSES = list(range(1, LW_MAX + 1)) + [-1]


def size(text, lw):
    (w, h), base = cv2.getTextSize(text, 0, lw / 3, max(lw - 1, 1))
    return w, h, base


def recover(lw):
    """Per-glyph advance, descent and (dy, dx, mask) for line width lw, plus (height, extra width)."""
    sc, th = lw / 3, max(lw - 1, 1)
    w_ref = size("H", lw)[0]
    adv = {c: size(c + "H", lw)[0] - w_ref for c in CHARS}
    extra = {size(c, lw)[0] - adv[c] for c in CHARS}
    assert len(extra) == 1, f"lw {lw}: getTextSize is not sum(advance) + constant: {extra}"
    height = {size(c, lw)[1] for c in CHARS}
    assert len(height) == 1, f"lw {lw}: text height depends on the text: {height}"
    p = 8 * lw + 16
    glyphs = {}
    for c in CHARS:
        img = np.zeros((4 * p, 4 * p), np.uint8)
        cv2.putText(img, c, (p, 2 * p), 0, sc, 255, th, cv2.LINE_AA)
        ys, xs = np.nonzero(img)
        if len(ys) == 0:
            glyphs[c] = (0, 0, np.zeros((0, 0), np.uint8))
            continue
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        assert 0 < y0 and y1 < 4 * p and 0 < x0 and x1 < 4 * p, f"glyph {c!r} at lw {lw} touches the canvas edge"
        glyphs[c] = (int(y0 - 2 * p), int(x0 - p), img[y0:y1, x0:x1].copy())
    return adv, {c: size(c, lw)[2] for c in CHARS}, glyphs, height.pop(), extra.pop()


def rect_margin(t):
    """Distance from a corner beyond which a side's cross-section is constant."""
    return max(t, 1) + 6


def rect_stamp(t, line):
    """Coverage (uint8) of a box of thickness t: corners at (m, m) and (m + 2m, m + 2m)."""
    m = rect_margin(t)
    img = np.zeros((5 * m, 5 * m), np.uint8)
    cv2.rectangle(img, (m + m // 2, m + m // 2), (m // 2 + 3 * m, m // 2 + 3 * m), 255, t, line)
    return img[m // 2:, m // 2:].copy(), m


def check_rects(stamps, n=60, seed=1):
    """Boxes drawn by the port (utils/plots.py rectangle) and by cv2."""
    from yolov3_tpu_torch.utils import plots

    rng = np.random.default_rng(seed)
    bad = total = 0
    for (t, line) in stamps:
        for _ in range(n // 6):
            canvas = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
            p1 = tuple(int(v) for v in rng.integers(20, 70, 2))
            p2 = (p1[0] + int(rng.integers(-15, 80)), p1[1] + int(rng.integers(-15, 40)))
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            ref, got = canvas.copy(), canvas.copy()
            cv2.rectangle(ref, p1, p2, color, t, line)
            plots.rectangle(got, p1, p2, color, t, line)
            touched = (ref != canvas).any(2) | (got != canvas).any(2)
            bad += int((np.abs(ref.astype(int) - got).max(2) > 2).sum())
            total += int(touched.sum())
    return bad, total


def pack(atlas):
    """Flat arrays for np.savez: one row of metrics per (lw, char), masks concatenated."""
    rows, blobs, off = [], [], 0
    fonts = []
    for lw, (adv, desc, glyphs, height, extra) in sorted(atlas.items()):
        fonts.append((lw, height, extra))
        for c in CHARS:
            dy, dx, m = glyphs[c]
            rows.append((lw, ord(c), adv[c], desc[c], dy, dx, m.shape[0], m.shape[1], off))
            blobs.append(m.ravel())
            off += m.size
    rects, rblobs, off = [], [], 0
    for t in THICKNESSES:
        for line in (cv2.LINE_AA, cv2.LINE_8):
            st, m = rect_stamp(t, line)
            rects.append((t, line, m, st.shape[0], st.shape[1], off))
            rblobs.append(st.ravel())
            off += st.size
    return dict(fonts=np.array(fonts, np.int32), glyphs=np.array(rows, np.int32),
                masks=np.concatenate(blobs).astype(np.uint8), rects=np.array(rects, np.int32),
                rect_masks=np.concatenate(rblobs).astype(np.uint8))


def check(atlas, n=40, seed=0):
    """Strings drawn by the port (utils/plots.py put_text, reading the written atlas) and by cv2."""
    from yolov3_tpu_torch.utils import plots

    rng = np.random.default_rng(seed)
    bad = ink = 0
    for lw in atlas:
        for _ in range(n):
            text = "".join(rng.choice(CHARS, rng.integers(1, 14)))
            w, h, base = size(text, lw)
            canvas = rng.integers(0, 256, (h + base + 8 * lw + 20, w + 8 * lw + 20, 3), dtype=np.uint8)
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            org = (4 * lw + 10, h + 4 * lw + 10)
            ref, got = canvas.copy(), canvas.copy()
            cv2.putText(ref, text, org, 0, lw / 3, color, max(lw - 1, 1), cv2.LINE_AA)
            plots.put_text(got, text, org, lw, color)
            bad += int((ref != got).any(2).sum())
            ink += int((ref != canvas).any(2).sum())
    return bad, ink


def main():
    atlas = {lw: recover(lw) for lw in range(1, LW_MAX + 1)}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **pack(atlas))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    bad, ink = check(atlas)
    print(f"glyphs, lw 1..{LW_MAX}: {bad} of {ink} drawn pixels differ from cv2.putText ({bad / max(ink, 1):.2e})")
    stamps = {(t, line): rect_stamp(t, line) for t in THICKNESSES for line in (cv2.LINE_AA, cv2.LINE_8)}
    bad, total = check_rects(stamps)
    print(f"rectangles: {bad} of {total} drawn pixels differ from cv2.rectangle by more than 2 levels "
          f"({bad / max(total, 1):.2e})")


if __name__ == "__main__":
    main()

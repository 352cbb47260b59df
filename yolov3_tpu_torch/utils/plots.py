"""Box drawing for detect and AutoShape: the colour palette, `Annotator` and
`save_one_box` (yolov3_tpu/utils/plots.py:18-86).

The JAX package draws with cv2.rectangle(..., LINE_AA) and cv2.putText
(font 0). The port draws the same pixels without OpenCV: the glyph masks,
advances and text sizes of font 0, and one box of each thickness, were read
from cv2 by scripts/recover_annotator_atlas.py into fonts/annotator_atlas.npz,
and csrc/host_ops.cpp blends them into the image (a glyph exactly as cv2
blends it; a box within 2 levels of cv2 on more than 99.5% of its pixels).
The atlas covers line widths 1..12; a wider Annotator draws at 12.
tests/test_torch_plots.py holds the drawing to the JAX package's.

Crops are written as PNG (`image_ops.imwrite_png`), where the JAX package
writes JPEG through cv2.imwrite.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.ops import host_build
from yolov3_tpu_torch.ops.boxes import xywh2xyxy

ATLAS = Path(__file__).resolve().parent / "fonts" / "annotator_atlas.npz"
LINE_AA, LINE_8 = 16, 8  # cv2.LINE_AA, cv2.LINE_8
_U8P = ctypes.POINTER(ctypes.c_uint8)


class Colors:
    """Ultralytics-style color palette keyed by class id."""

    def __init__(self):
        hexs = (
            "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17", "3DDB86", "1A9334", "00D4BB",
            "2C99A8", "00C2FF", "344593", "6473FF", "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
        )  # fmt: skip
        self.palette = [self._hex2rgb(f"#{c}") for c in hexs]
        self.n = len(self.palette)

    @staticmethod
    def _hex2rgb(h):
        return tuple(int(h[1 + i : 1 + i + 2], 16) for i in (0, 2, 4))

    def __call__(self, i, bgr=False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


@functools.lru_cache(maxsize=1)
def _atlas():
    """{lw: (height, extra width, {char: (advance, descent, dy, dx, mask)})} and
    {(thickness, line type): (margin, stamp)} from the atlas file."""
    z = np.load(ATLAS)
    masks = z["masks"]
    fonts = {int(lw): (int(h), int(e), {}) for lw, h, e in z["fonts"]}
    for lw, ch, adv, desc, dy, dx, mh, mw, off in z["glyphs"]:
        mask = np.ascontiguousarray(masks[off:off + mh * mw].reshape(mh, mw))
        fonts[int(lw)][2][chr(ch)] = (int(adv), int(desc), int(dy), int(dx), mask)
    rm = z["rect_masks"]
    rects = {(int(t), int(line)): (int(m), np.ascontiguousarray(rm[off:off + sh * sw].reshape(sh, sw)))
             for t, line, m, sh, sw, off in z["rects"]}
    return fonts, rects


def _lw_in_atlas(lw):
    """The atlas holds line widths 1..32: Annotator's default reaches 32 at
    about 108 MP (12000 x 9000). A wider line raises rather than differ from cv2."""
    top = max(_atlas()[0])
    if lw > top:
        raise ValueError(f"line width {lw} is wider than {top}, the widest in {ATLAS.name} "
                         f"(scripts/recover_annotator_atlas.py); pass a line_width of at most {top}")
    return max(int(lw), 1)


def _glyph(font, ch):
    return font.get(ch) or font["?"]


def text_size(text, lw):
    """cv2.getTextSize(text, 0, lw / 3, max(lw - 1, 1)): ((w, h), baseline)."""
    height, extra, font = _atlas()[0][_lw_in_atlas(lw)]
    glyphs = [_glyph(font, c) for c in text]
    return (sum(g[0] for g in glyphs) + extra, height), max((g[1] for g in glyphs), default=0)


def _check_image(im):
    if not (isinstance(im, np.ndarray) and im.dtype == np.uint8 and im.ndim == 3 and im.shape[2] == 3
            and im.flags.c_contiguous and im.flags.writeable):
        raise ValueError("drawing needs a writable C-contiguous uint8 (H, W, 3) image")


def put_text(im, text, org, lw, color):
    """cv2.putText(im, text, org, 0, lw / 3, color, max(lw - 1, 1), LINE_AA), in place."""
    _check_image(im)
    font = _atlas()[0][_lw_in_atlas(lw)][2]
    col = np.asarray(color, np.uint8)[:3].copy()
    lib = host_build.load()
    x = int(org[0])
    for c in text:
        adv, _, dy, dx, mask = _glyph(font, c)
        if mask.size:
            lib.blend_mask_u8(im.ctypes.data_as(_U8P), im.shape[0], im.shape[1], mask.ctypes.data_as(_U8P),
                              mask.shape[0], mask.shape[1], int(org[1]) + dy, x + dx, col.ctypes.data_as(_U8P))
        x += adv


def rectangle(im, p1, p2, color, thickness=1, line_type=LINE_8):
    """cv2.rectangle(im, p1, p2, color, thickness, line_type) at integer corners, in place;
    thickness -1 fills."""
    _check_image(im)
    t = -1 if thickness < 0 else _lw_in_atlas(max(thickness, 1))
    m, st = _atlas()[1][(t, LINE_AA if line_type == LINE_AA else LINE_8)]
    col = np.asarray(color, np.uint8)[:3].copy()
    host_build.load().draw_rect_stamp(im.ctypes.data_as(_U8P), im.shape[0], im.shape[1], st.ctypes.data_as(_U8P),
                                      st.shape[0], st.shape[1], m, int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]),
                                      col.ctypes.data_as(_U8P))


class Annotator:
    """Draw boxes and labels on a BGR uint8 (H, W, 3) image, in place."""

    def __init__(self, im, line_width=None, font_size=None):
        if not im.flags.c_contiguous:
            raise ValueError("Annotator input must be contiguous (np.ascontiguousarray(im))")
        self.im = im
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)

    def box_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255)):
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        rectangle(self.im, p1, p2, color, thickness=self.lw, line_type=LINE_AA)
        if label:
            (w, h), _ = text_size(label, self.lw)
            outside = p1[1] - h >= 3
            p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
            rectangle(self.im, p1, p2, color, -1, LINE_AA)
            put_text(self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), self.lw, txt_color)

    def rectangle(self, xy, fill=None, outline=(128, 128, 128), width=1):
        rectangle(self.im, (int(xy[0]), int(xy[1])), (int(xy[2]), int(xy[3])), outline, width)

    def result(self):
        return self.im


def save_one_box(xyxy, im, file=Path("im.png"), gain=1.02, pad=10, square=False, BGR=True, save=True):
    """Crop a box from an image with a margin and save it as PNG, `file` with
    the suffix .png (detect --save-crop)."""
    b = np.asarray(xyxy, np.float32).reshape(-1, 4)
    xywh = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, (b[:, 2:] - b[:, :2])], 1)
    if square:
        xywh[:, 2:] = xywh[:, 2:].max(1, keepdims=True)
    xywh[:, 2:] = xywh[:, 2:] * gain + pad
    b = xywh2xyxy(xywh).astype(int)
    h, w = im.shape[:2]
    x1, y1, x2, y2 = max(b[0, 0], 0), max(b[0, 1], 0), min(b[0, 2], w), min(b[0, 3], h)
    crop = im[y1:y2, x1:x2, :: (1 if BGR else -1)]
    if save:
        file = Path(file).with_suffix(".png")
        file.parent.mkdir(parents=True, exist_ok=True)
        image_ops.imwrite_png(file, crop)
    return crop

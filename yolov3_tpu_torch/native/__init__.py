"""Host ops of the JAX package's native layer (yolov3_tpu/native): the
greedy NMS loop, the INTER_LINEAR resize and the letterbox, for callers
that hold numpy arrays on the host (`non_max_suppression(engine="native")`,
and `engine="auto"` for numpy predictions).

The JAX package compiles a library of its own. Here they are entry points of
csrc/host_ops.cpp, the library of the data pipeline (ops/host_build.py):
`greedy_nms_batch` is the JAX loop; `resize_linear` and `letterbox` are the
pipeline's, byte-equal to cv2 (the JAX native resize is 1 level off cv2 on
the rows an upscale clamps to the image's edge; it equals cv2 elsewhere).
"""

from __future__ import annotations

import ctypes

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox as _letterbox
from yolov3_tpu_torch.ops import host_build


def available() -> bool:
    """True when the host library builds and loads (it needs a C++ compiler)."""
    try:
        host_build.load()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def greedy_nms_batch(boxes_off, boxes, scores, cls_ids, iou_thres=0.45, max_det=300):
    """Greedy NMS over (bs, K, ...) candidates, on the host: rows by
    descending score (equal scores keep the lower index first), suppression
    at IoU > iou_thres on the class-offset boxes `boxes_off`, candidates with
    a score <= 0 invalid. Equal to the NMS kernel and to the JAX native and
    XLA loops.

    Returns out (bs, max_det, 6) float32 [xyxy, conf, cls], zero-padded, and
    n_valid (bs,) int32.
    """
    boxes_off, boxes, scores, cls_ids = _f32(boxes_off), _f32(boxes), _f32(scores), _f32(cls_ids)
    bs, k = scores.shape
    out = np.zeros((bs, max_det, 6), np.float32)
    n_valid = np.zeros((bs,), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    host_build.load().greedy_nms_batch(
        boxes_off.ctypes.data_as(f32p), boxes.ctypes.data_as(f32p), scores.ctypes.data_as(f32p),
        cls_ids.ctypes.data_as(f32p), bs, k, float(iou_thres), int(max_det), out.ctypes.data_as(f32p),
        n_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, n_valid


def resize_linear(im, new_wh):
    """cv2.resize(im, new_wh, interpolation=cv2.INTER_LINEAR) for uint8 (H, W[, C])."""
    return image_ops.resize_linear(im, new_wh)


def letterbox(im, new_shape=(640, 640), color=(114, 114, 114), auto=True, scale_fill=False, scaleup=True,
              stride=32):
    """The letterbox of data/augment.py (resize and pad in one host call), for
    1 to 4 channels. Returns (image, ratio, (dw, dh))."""
    return _letterbox(np.ascontiguousarray(im, dtype=np.uint8), new_shape, color, auto, scale_fill, scaleup, stride)

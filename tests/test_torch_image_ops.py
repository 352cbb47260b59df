"""The port's host image layer (data/image_ops.py + csrc/host_ops.cpp)
against OpenCV on the same inputs.

Tolerance met: every op is byte-equal to cv2 here, so every assertion is
exact. The warps are held to OpenCV's float32 warp kernels (OpenCV >= 4.11,
as installed here); older OpenCV rounds the map to 1/32 px instead and
differs by a few levels.
"""

import math

import cv2
import numpy as np
import pytest

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox, rotation_matrix

RESIZES = [(480, 640, 384, 512), (1080, 810, 640, 480), (640, 640, 320, 320), (505, 303, 212, 202),
           (100, 100, 640, 640), (123, 457, 640, 640), (200, 300, 417, 555), (37, 51, 80, 91)]
AREA = [(480, 640, 384, 512), (640, 640, 320, 320), (900, 600, 300, 200), (505, 303, 212, 202),
        (800, 533, 640, 427), (777, 1001, 497, 640), (10, 10, 5, 5), (96, 96, 32, 32)]


def rand_image(rng, h, w, c=3, smooth=False):
    im = rng.integers(0, 256, (h, w, c) if c else (h, w), dtype=np.uint8)
    return cv2.GaussianBlur(im, (7, 7), 2) if smooth else im


@pytest.mark.parametrize("sh,sw,dh,dw", RESIZES)
def test_resize_linear_equals_cv2(sh, sw, dh, dw):
    im = rand_image(np.random.default_rng(sh * dw), sh, sw)
    want = cv2.resize(im, (dw, dh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(image_ops.resize_linear(im, (dw, dh)), want)


@pytest.mark.parametrize("sh,sw,dh,dw", AREA)
def test_resize_area_equals_cv2(sh, sw, dh, dw):
    im = rand_image(np.random.default_rng(sh * dw + 1), sh, sw)
    want = cv2.resize(im, (dw, dh), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(image_ops.resize_area(im, (dw, dh)), want)


def test_resize_area_refuses_upscale():
    with pytest.raises(ValueError, match="downscales only"):
        image_ops.resize_area(np.zeros((10, 10, 3), np.uint8), (20, 10))


def test_resize_gray_equals_cv2():
    im = rand_image(np.random.default_rng(9), 101, 77, c=0)
    np.testing.assert_array_equal(image_ops.resize_linear(im, (50, 64)), cv2.resize(im, (50, 64)))


def cv2_letterbox(im, new_shape, color=(114, 114, 114), auto=True, scale_fill=False, scaleup=True, stride=32):
    """yolov3_tpu/data/augment.py's letterbox, the cv2 original."""
    from yolov3_tpu.data.augment import letterbox as jax_letterbox

    return jax_letterbox(im, new_shape, color, auto, scale_fill, scaleup, stride)


@pytest.mark.parametrize("shape,kw", [((1080, 810, 3), {}), ((480, 640, 3), {"auto": False}),
                                      ((730, 1280, 3), {"scaleup": False}),
                                      ((200, 300, 3), {"scale_fill": True, "auto": False}),
                                      ((640, 640, 3), {"auto": False})])
def test_letterbox_equals_cv2(shape, kw):
    im = rand_image(np.random.default_rng(shape[0]), *shape)
    a, ra, pa = cv2_letterbox(im, 640, **kw)
    b, rb, pb = letterbox(im, 640, **kw)
    assert ra == rb and pa == pb
    np.testing.assert_array_equal(b, a)


def random_matrix(rng, im, persp):
    C = np.eye(3)
    C[0, 2], C[1, 2] = -im.shape[1] / 2, -im.shape[0] / 2
    P = np.eye(3)
    if persp:
        P[2, 0], P[2, 1] = rng.uniform(-1e-3, 1e-3, 2)
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-10, 10), center=(0, 0), scale=rng.uniform(0.5, 1.5))
    S = np.eye(3)
    S[0, 1], S[1, 0] = (math.tan(v * math.pi / 180) for v in rng.uniform(-5, 5, 2))
    T = np.eye(3)
    T[0, 2], T[1, 2] = rng.uniform(50, 300, 2)
    return T @ S @ R @ P @ C


@pytest.mark.parametrize("k", range(6))
def test_warp_affine_equals_cv2(k):
    rng = np.random.default_rng(100 + k)
    im = rand_image(rng, int(rng.integers(150, 700)), int(rng.integers(150, 700)), smooth=k % 2 == 0)
    m = random_matrix(rng, im, persp=False)[:2]
    size = [(640, 640), (320, 288), (64, 64)][k % 3]
    want = cv2.warpAffine(im, m, dsize=size, borderValue=(114, 114, 114))
    np.testing.assert_array_equal(image_ops.warp_affine(im, m, size), want)


@pytest.mark.parametrize("k", range(6))
def test_warp_perspective_equals_cv2(k):
    rng = np.random.default_rng(200 + k)
    im = rand_image(rng, int(rng.integers(150, 700)), int(rng.integers(150, 700)), smooth=k % 2 == 0)
    m = random_matrix(rng, im, persp=True)
    size = [(640, 640), (320, 288), (64, 64)][k % 3]
    want = cv2.warpPerspective(im, m, dsize=size, borderValue=(114, 114, 114))
    np.testing.assert_array_equal(image_ops.warp_perspective(im, m, size), want)


def random_polygon(rng, placement, h, w):
    """Integer vertices: a star inside the image, one reaching its edges
    x = 0, w and y = 0, h (what copy_paste's mirrored segments give), one
    across its borders, one far outside, or a random (self-crossing) one."""
    k = int(rng.integers(3, 14))
    c = rng.uniform([0, 0], [w, h])
    ang, r = np.sort(rng.uniform(0, 2 * np.pi, k)), rng.uniform(1, 60, k)
    star = c + np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
    p = {"inside": lambda: np.clip(star, 0, [w - 1, h - 1]), "edges": lambda: np.clip(star, 0, [w, h]),
         "across": lambda: star, "far": lambda: rng.integers(-5000, 6000, (k, 2)),
         "crossing": lambda: rng.integers(-40, max(w, h) + 40, (k, 2))}[placement]()
    return p.astype(np.int32)


@pytest.mark.parametrize("placement", ["inside", "edges", "across", "far", "crossing"])
def test_fill_poly_equals_cv2(placement):
    """fill_poly against cv2.drawContours(FILLED) and cv2.fillPoly: every
    pixel, 1 and 3 channels, 300 polygons an image placement."""
    rng = np.random.default_rng(["inside", "edges", "across", "far", "crossing"].index(placement))
    for t in range(300):
        h, w = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        p, cn = random_polygon(rng, placement, h, w), 1 + 2 * (t % 2)
        color = (7, 200, 31)[:cn]
        want = cv2.drawContours(np.zeros((h, w, cn), np.uint8), [p], -1, color, cv2.FILLED)
        got = image_ops.fill_poly(np.zeros((h, w, cn), np.uint8), p, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {p.tolist()}")
        np.testing.assert_array_equal(got, cv2.fillPoly(np.zeros((h, w, cn), np.uint8), [p], color))


def test_rotation_matrix_equals_cv2():
    for a, s, c in [(7.3, 1.21, (0, 0)), (-45.0, 0.5, (10.0, -3.5)), (0.0, 1.0, (0, 0))]:
        np.testing.assert_array_equal(rotation_matrix(a, s, c), cv2.getRotationMatrix2D(c, a, s))


def all_triples(step):
    v = np.arange(0, 256, step)
    return np.stack(np.meshgrid(np.arange(256), np.arange(256), v, indexing="ij"), -1).reshape(-1, 1, 3)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_bgr2hsv_equals_cv2(offset):
    bgr = np.ascontiguousarray(all_triples(4)[offset::4]).astype(np.uint8)  # a quarter of the colours each
    np.testing.assert_array_equal(image_ops.bgr2hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [1, 100, 1024])  # OpenCV's vector path takes 32-pixel runs of a row
def test_hsv2bgr_equals_cv2(offset, width):
    hsv = all_triples(4)[offset::4].astype(np.uint8)
    hsv = np.ascontiguousarray(hsv[: len(hsv) // width * width].reshape(-1, width, 3))
    np.testing.assert_array_equal(image_ops.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    out = np.zeros_like(hsv)
    assert image_ops.hsv2bgr(hsv, out=out) is out
    np.testing.assert_array_equal(out, cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_png_round_trip_and_cv2_reads_it(tmp_path):
    rng = np.random.default_rng(3)
    for i, im in enumerate([rand_image(rng, 57, 91), rand_image(rng, 33, 41, c=0)]):
        f = tmp_path / f"a{i}.png"
        image_ops.imwrite_png(f, im)
        want = im if im.ndim == 3 else np.repeat(im[..., None], 3, 2)
        np.testing.assert_array_equal(image_ops.imread(f), want)
        np.testing.assert_array_equal(cv2.imread(str(f)), want)


@pytest.mark.parametrize("kind", ["rgb0", "rgb9", "gray", "rgba", "gray16", "bmp24", "bmp32"])
def test_decode_equals_cv2_imread(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    f = tmp_path / ("x.bmp" if kind.startswith("bmp") else "x.png")
    if kind in ("rgb0", "rgb9"):
        cv2.imwrite(str(f), rand_image(rng, 57, 91), [cv2.IMWRITE_PNG_COMPRESSION, int(kind[-1])])
    elif kind == "gray":
        cv2.imwrite(str(f), rand_image(rng, 33, 41, c=0))
    elif kind == "rgba":
        cv2.imwrite(str(f), rand_image(rng, 33, 41, c=4))
    elif kind == "gray16":
        cv2.imwrite(str(f), rng.integers(0, 65536, (21, 19), dtype=np.uint16))
    elif kind == "bmp24":
        cv2.imwrite(str(f), rand_image(rng, 29, 31))
    else:
        cv2.imwrite(str(f), rand_image(rng, 29, 31, c=4))
    np.testing.assert_array_equal(image_ops.imread(f), cv2.imread(str(f)))


def test_image_size_from_headers(tmp_path):
    im = rand_image(np.random.default_rng(4), 57, 91)
    for ext in ("png", "bmp", "jpg"):
        f = tmp_path / f"s.{ext}"
        cv2.imwrite(str(f), im)
        assert tuple(image_ops.image_size(f)) == (91, 57)


def test_jpeg_without_a_decoder_names_the_file(tmp_path, monkeypatch):
    """Without cv2 and PIL a JPEG decodes in-tree (equal to cv2's decode); a
    format that still needs a library (WebP here) raises, naming the file."""
    import builtins

    f = tmp_path / "photo.jpg"
    cv2.imwrite(str(f), rand_image(np.random.default_rng(5), 16, 24))
    want = cv2.imread(str(f))
    g = tmp_path / "photo.webp"
    cv2.imwrite(str(g), np.zeros((16, 16, 3), np.uint8))
    real_import = builtins.__import__

    def no_image_libraries(name, *args, **kwargs):
        if name.split(".")[0] in ("cv2", "PIL"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_image_libraries)
    np.testing.assert_array_equal(image_ops.imread(f), want)
    with pytest.raises(RuntimeError, match="photo.webp.*convert the dataset's images to PNG"):
        image_ops.imread(g)


def test_corrupt_png_raises(tmp_path):
    f = tmp_path / "bad.png"
    f.write_bytes(image_ops.PNG_SIGNATURE + b"\x00" * 40)
    with pytest.raises(ValueError, match="bad.png"):
        image_ops.imread(f)


def test_pointer_arguments_are_validated():
    im = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="pads"):
        image_ops.resize_pad(im, (8, 8), -1, 0, 0, 0)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        image_ops.bgr2hsv(np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        image_ops.hsv2bgr(np.zeros((8, 8), np.uint8))

"""Host image layer of the data pipeline: decode, encode, resize, warp, HSV.

The JAX package does these with OpenCV. The port does them with its own C++
(csrc/host_ops.cpp, built at first use by ops/host_build.py), which
reproduces OpenCV's uint8 arithmetic: a run on a host without OpenCV
computes the pixels a run with it computes. tests/test_torch_image_ops.py
holds each op against cv2 and states the tolerance met.

Images are numpy uint8 (H, W, 3) in BGR order, cv2's layout.

Encoding: JPEG (`encode_jpeg`, byte-equal to cv2.imencode(".jpg") at
quality 95, 4:2:0) and PNG (`encode_png`); `imwrite` picks by suffix.

Decoding: JPEG (`decode_jpeg`: baseline and progressive Huffman, 8-bit,
gray or YCbCr, as libjpeg-turbo decodes it for cv2), PNG (8- and 16-bit
gray, gray+alpha, RGB, RGBA and palette; not interlaced) and BMP (24- and
32-bit, uncompressed) are decoded here, the PNG stream inflated by Python's
zlib. Any other format (TIFF, WebP, ...) goes through cv2 or PIL, imported
when such a file is read; without either, reading one raises and names the
file. A JPEG never goes to a library: a kind `decode_jpeg` does not decode
(arithmetic coding, 12-bit, lossless, CMYK) raises ValueError.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.ops import host_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _ptr(a):
    return a.ctypes.data_as(_U8P)


def _u8(im):
    im = np.ascontiguousarray(im, dtype=np.uint8)
    return im, im.shape[0], im.shape[1], 1 if im.ndim == 2 else im.shape[2]


def _like(im, h, w):
    return np.empty((h, w) + im.shape[2:], np.uint8)


def _color(color, cn):
    return np.resize(np.asarray(color, np.uint8), cn)


def _bgr(im):
    im = np.ascontiguousarray(im, dtype=np.uint8)
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"expected a (H, W, 3) image, got shape {im.shape}")
    return im


# --- resize and warps --------------------------------------------------------


def resize_linear(im, size):
    """cv2.resize(im, size, interpolation=cv2.INTER_LINEAR); size is (w, h)."""
    im, sh, sw, cn = _u8(im)
    dst = _like(im, int(size[1]), int(size[0]))
    host_build.load().resize_linear_u8(_ptr(im), sh, sw, cn, _ptr(dst), dst.shape[0], dst.shape[1])
    return dst


def resize_area(im, size):
    """cv2.resize(im, size, interpolation=cv2.INTER_AREA) for a downscale; size is (w, h)."""
    im, sh, sw, cn = _u8(im)
    dw, dh = int(size[0]), int(size[1])
    if dw > sw or dh > sh:
        raise ValueError(f"resize_area downscales only: ({sw}, {sh}) -> ({dw}, {dh})")
    dst = _like(im, dh, dw)
    host_build.load().resize_area_u8(_ptr(im), sh, sw, cn, _ptr(dst), dh, dw)
    return dst


def resize_pad(im, size, top, bottom, left, right, color=(114, 114, 114)):
    """Resize to size (w, h) with INTER_LINEAR (skipped when the size is the
    image's), then pad by (top, bottom, left, right) with `color`: cv2.resize
    followed by cv2.copyMakeBorder(BORDER_CONSTANT), in one call."""
    im, sh, sw, cn = _u8(im)
    rw, rh = int(size[0]), int(size[1])
    if min(top, bottom, left, right) < 0 or rw < 1 or rh < 1:
        raise ValueError(f"resize_pad to ({rw}, {rh}) with pads {(top, bottom, left, right)}")
    dst = _like(im, rh + top + bottom, rw + left + right)
    host_build.load().letterbox_u8(_ptr(im), sh, sw, cn, _ptr(dst), dst.shape[0], dst.shape[1], rh, rw,
                                   int(top), int(left), _ptr(_color(color, cn)))
    return dst


def warp_affine(im, m, size, border_value=(114, 114, 114)):
    """cv2.warpAffine(im, m, dsize=size, borderValue=border_value): m is the
    forward 2x3 matrix, size (w, h), bilinear, constant border."""
    return _warp("warp_affine_u8", im, m, (2, 3), size, border_value)


def warp_perspective(im, m, size, border_value=(114, 114, 114)):
    """cv2.warpPerspective(im, m, dsize=size, borderValue=border_value): m is
    the forward 3x3 matrix, size (w, h), bilinear, constant border."""
    return _warp("warp_perspective_u8", im, m, (3, 3), size, border_value)


def _warp(fn, im, m, mshape, size, border_value):
    im, sh, sw, cn = _u8(im)
    m = np.ascontiguousarray(np.asarray(m, np.float64).reshape(mshape))
    dst = _like(im, int(size[1]), int(size[0]))
    getattr(host_build.load(), fn)(_ptr(im), sh, sw, cn, _ptr(dst), dst.shape[0], dst.shape[1],
                                   m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                   _ptr(_color(border_value, cn)))
    return dst


def fill_poly(im, pts, color):
    """Fill the polygon of integer vertices `pts` (n, 2) [x, y] into the uint8
    image `im` in place, as cv2.fillPoly(im, [pts], color) and
    cv2.drawContours(im, [pts], -1, color, cv2.FILLED) do (8-connected
    edges, no anti-aliasing); returns `im`."""
    if not (im.flags.c_contiguous and im.dtype == np.uint8):
        raise ValueError("fill_poly draws into a C-contiguous uint8 image")
    pts = np.ascontiguousarray(np.asarray(pts).reshape(-1, 2), dtype=np.int32)
    cn = 1 if im.ndim == 2 else im.shape[2]
    if len(pts):
        host_build.load().fill_poly_u8(_ptr(im), im.shape[0], im.shape[1], cn,
                                       pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(pts),
                                       _ptr(_color(color, cn)))
    return im


# --- colour ------------------------------------------------------------------


def bgr2hsv(im):
    """cv2.cvtColor(im, cv2.COLOR_BGR2HSV) for a uint8 (H, W, 3) image (H in [0, 180))."""
    im = _bgr(im)
    dst = np.empty_like(im)
    host_build.load().bgr2hsv_u8(_ptr(im), _ptr(dst), im.size // 3)
    return dst


def hsv2bgr(hsv, out=None):
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR, dst=out) for a uint8 (H, W, 3)
    image. As in OpenCV, the result of a pixel depends on its column: each
    row's first multiple of 32 pixels truncate, the rest round (see
    csrc/host_ops.cpp)."""
    hsv = _bgr(hsv)
    direct = out is not None and out.flags.c_contiguous and out.dtype == np.uint8 and out.shape == hsv.shape
    dst = out if direct else np.empty_like(hsv)
    host_build.load().hsv2bgr_u8(_ptr(hsv), _ptr(dst), hsv.shape[0], hsv.shape[1])
    if out is not None and not direct:
        out[...] = dst
        return out
    return dst


# --- decode and encode -------------------------------------------------------


def imread(path):
    """Decode an image file to BGR uint8 (H, W, 3), as cv2.imread(path) does;
    raises when the file cannot be read."""
    path = str(path)
    return imdecode(np.fromfile(path, np.uint8).tobytes(), path)


def imdecode(data, name="<bytes>"):
    """Decode encoded image bytes to BGR uint8 (H, W, 3), as
    cv2.imdecode(..., IMREAD_COLOR) does; `name` goes into the error raised
    on bytes it cannot decode."""
    try:
        if data[:2] == JPEG_SIGNATURE:
            return decode_jpeg(data)
        if data[:8] == PNG_SIGNATURE:
            return decode_png(data)
        if data[:2] == b"BM":
            return decode_bmp(data)
        return _decode_with_library(data, name)
    except (ValueError, zlib.error, struct.error, IndexError) as e:
        raise ValueError(f"cannot decode {name}: {e}") from e


def decode_jpeg(data):
    """JPEG bytes -> BGR uint8 (H, W, 3), equal to cv2.imread's decode (the
    EXIF orientation applied, gray replicated). A stream that ends early
    decodes as libjpeg's does (the missing blocks gray); cv2.imdecode refuses
    such bytes, cv2.imread returns this image. Raises ValueError naming the
    feature for a JPEG kind it does not decode."""
    lib = host_build.load()
    buf = np.frombuffer(bytes(data), np.uint8)
    info = (ctypes.c_int * 4)()
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_info(_ptr(buf), buf.size, info, err, 256):
        raise ValueError(err.value.decode())
    w, h, _, orientation = info
    out = np.empty((h, w, 3), np.uint8)
    if lib.jpeg_decode_bgr(_ptr(buf), buf.size, _ptr(out), err, 256) < 0:
        raise ValueError(err.value.decode())
    return _exif_orient(out, orientation)


def _exif_orient(im, orientation):
    """OpenCV's ApplyExifOrientation: EXIF orientation 1-8 to the upright image."""
    if orientation >= 5:
        im = im.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(im, flip) if flip else im)


def _decode_with_library(data, path):
    """Every format other than JPEG, PNG and BMP: cv2, else PIL, imported only here."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        im = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if im is None:
            raise ValueError("cv2 cannot decode it")
        return im
    try:
        import io

        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: only JPEG, PNG and BMP are decoded without OpenCV or Pillow, and neither is installed; "
            "convert the dataset's images to PNG") from None
    with Image.open(io.BytesIO(data)) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])


def _png_chunks(data):
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def verify_png(data):
    """Walk a PNG's chunk stream through IEND and check every chunk's CRC32,
    without inflating the image data (what PIL's `Image.verify()` checks).
    Raises ValueError on a truncated stream or a bad checksum."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("Truncated File Read")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"truncated PNG file (chunk {kind!r})")
        crc, = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(data[pos + 4:end - 4]) != crc:
            raise ValueError(f"broken PNG file (bad header checksum in {kind!r})")
        if kind == b"IEND":
            return
        pos = end


def decode_png(data):
    """PNG bytes -> BGR uint8 (H, W, 3); alpha dropped, gray replicated,
    16-bit samples cut to their high byte (cv2.IMREAD_COLOR)."""
    ihdr, idat, palette = None, [], None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None or depth not in (8, 16) or interlace or (ctype == 3 and depth != 8):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits, interlace {interlace} is not decoded")
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG data is truncated")
    px = np.empty((h, stride), np.uint8)
    if host_build.load().png_unfilter(_ptr(np.ascontiguousarray(raw)), h, stride, bpp, _ptr(px)):
        raise ValueError("PNG row with an unknown filter type")
    px = px.reshape(h, w, channels, depth // 8)[..., 0]  # 16 bit: the big-endian high byte
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        rgb = palette[px[..., 0]]
    elif channels <= 2:
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def encode_png(im, level=6):
    """BGR uint8 (H, W, 3) (or gray (H, W)) -> PNG bytes, Sub-filtered rows."""
    im = np.ascontiguousarray(im, dtype=np.uint8)
    if im.ndim == 3:
        im = np.ascontiguousarray(im[..., ::-1])  # PNG stores RGB
    h, w = im.shape[:2]
    cn = 1 if im.ndim == 2 else im.shape[2]
    if cn not in (1, 3):
        raise ValueError(f"encode_png takes gray or 3-channel images, not {cn} channels")
    filtered = np.empty((h, w * cn + 1), np.uint8)
    host_build.load().png_filter_sub(_ptr(im), h, w * cn, cn, _ptr(filtered))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if cn == 1 else 2, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + chunk(b"IEND", b""))


def imwrite_png(path, im, level=6):
    """Write a BGR uint8 image as PNG."""
    Path(path).write_bytes(encode_png(im, level))


def encode_jpeg(im, quality=95):
    """BGR uint8 (H, W, 3) (or gray (H, W), or (H, W, 4) with its fourth
    channel dropped) -> JPEG bytes, equal to cv2.imencode(".jpg", im,
    [cv2.IMWRITE_JPEG_QUALITY, quality]) with OpenCV's other defaults
    (4:2:0 for colour, the islow DCT, the standard Huffman tables)."""
    im = np.ascontiguousarray(im, dtype=np.uint8)
    if im.ndim not in (2, 3):
        raise ValueError(f"encode_jpeg takes a (H, W) or (H, W, C) image, got shape {im.shape}")
    h, w = im.shape[:2]
    cn = 1 if im.ndim == 2 else im.shape[2]
    # the most a block can take: 22 bits of DC and 63 x 26 of AC, doubled by 0xFF stuffing (416 bytes);
    # 6 blocks a 16 x 16 MCU in colour (4:2:0), 1 an 8 x 8 in gray; the headers under 1 KiB
    blocks = -(-h // 8) * -(-w // 8) if cn == 1 else 6 * -(-h // 16) * -(-w // 16)
    out = np.empty(416 * blocks + 1024, np.uint8)
    err = ctypes.create_string_buffer(256)
    n = host_build.load().jpeg_encode_bgr(_ptr(im), h, w, cn, int(quality), _ptr(out), out.size, err, 256)
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:n].tobytes()


def imwrite_jpeg(path, im, quality=95):
    """Write a BGR uint8 image as JPEG (cv2.imwrite's bytes for a .jpg path)."""
    Path(path).write_bytes(encode_jpeg(im, quality))


WRITERS = {".jpg": imwrite_jpeg, ".jpeg": imwrite_jpeg, ".png": imwrite_png}


def imwrite(path, im):
    """Write a BGR uint8 image in the format its suffix names, as cv2.imwrite
    does: .jpg / .jpeg as JPEG (quality 95), .png as PNG. Any other suffix
    raises ValueError."""
    suffix = Path(str(path)).suffix.lower()
    if suffix not in WRITERS:
        raise ValueError(f"imwrite writes .jpg, .jpeg and .png, not {suffix!r} ({path})")
    WRITERS[suffix](path, im)


def decode_bmp(data):
    """Uncompressed 24- or 32-bit BMP bytes -> BGR uint8 (H, W, 3)."""
    off, = struct.unpack("<I", data[10:14])
    w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if bits not in (24, 32) or compression not in (0, 3):
        raise ValueError(f"BMP at {bits} bits, compression {compression} is not decoded")
    cn = bits // 8
    stride = (w * cn + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=stride * abs(h), offset=off).reshape(abs(h), stride)
    px = rows[:, : w * cn].reshape(abs(h), w, cn)[..., :3]
    return np.ascontiguousarray(px[::-1] if h > 0 else px)  # h > 0: bottom-up rows


def image_size(path):
    """(w, h) from the file header (PNG IHDR, BMP, JPEG SOF); another format
    is decoded to find it. Raises on a file it cannot read."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:2] == b"BM":
            w, h = struct.unpack("<ii", head[18:26])
            return w, abs(h)
        if head[:2] == b"\xff\xd8":
            return _jpeg_size(f)
    return _size_with_library(path)


def _jpeg_size(f):
    f.seek(2)
    while True:
        marker = f.read(2)
        if len(marker) < 2 or marker[0] != 0xFF:
            raise ValueError("JPEG without a frame header")
        kind = marker[1]
        if kind == 0xFF:  # fill byte
            f.seek(-1, 1)
            continue
        if kind in (0xD8, 0x01) or 0xD0 <= kind <= 0xD7:  # markers without a length
            continue
        n, = struct.unpack(">H", f.read(2))
        if 0xC0 <= kind <= 0xCF and kind not in (0xC4, 0xC8, 0xCC):  # SOFn
            h, w = struct.unpack(">xHH", f.read(5))
            return w, h
        f.seek(n - 2, 1)


def _size_with_library(path):
    im = _decode_with_library(np.fromfile(str(path), np.uint8).tobytes(), str(path))
    return im.shape[1], im.shape[0]

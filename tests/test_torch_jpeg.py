"""The port's JPEG decoder (data/image_ops.decode_jpeg, csrc/host_ops.cpp)
against cv2, which the JAX package reads images with.

The corpus in tests/data/jpeg/ (written by scripts/make_jpeg_corpus.py)
covers baseline 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 at odd sizes,
grayscale, progressive (spectral selection and successive approximation),
restart intervals, EXIF orientation 6 and a file cut short. Every file, and
both sample images, decodes byte-equal to cv2.imread and to
cv2.imdecode(..., IMREAD_COLOR) (which refuses the cut file; cv2.imread
decodes it, and so does the port), and to the SHA-256 pinned in
digests.json, which the card's host (without cv2) checks too. Kinds the
decoder does not decode raise ValueError naming the kind, and so do crafted
headers: a frame above OpenCV's 2^30-pixel limit (refused before anything is
allocated) and a refinement scan naming an undefined Huffman table.
"""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data import image_ops

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "data" / "jpeg"
SAMPLES = ROOT / "yolov3_tpu_torch" / "data" / "images"
FILES = sorted(CORPUS.glob("*.jpg")) + sorted(SAMPLES.glob("*.jpg"))
DIGESTS = json.loads((CORPUS / "digests.json").read_text())


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_decode_equals_cv2(path):
    got = image_ops.imread(path)
    want = cv2.imread(str(path))
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    data = path.read_bytes()
    np.testing.assert_array_equal(image_ops.imdecode(data), got)
    by_imdecode = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if path.name.startswith("truncated"):
        assert by_imdecode is None  # cv2.imdecode refuses a stream cut short; cv2.imread decodes it
    else:
        np.testing.assert_array_equal(got, by_imdecode)
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[path.name]["sha256"]
    assert list(got.shape) == DIGESTS[path.name]["shape"]


def test_corpus_covers_the_kinds_and_is_small():
    names = {p.name for p in FILES}
    for kind in ("baseline_444", "baseline_422", "baseline_420", "baseline_440", "gray", "progressive_420",
                 "restart", "exif_orientation6", "truncated", "sample1", "sample2"):
        assert any(n.startswith(kind) for n in names), kind
    assert set(DIGESTS) == names
    assert sum(p.stat().st_size for p in CORPUS.rglob("*") if p.is_file()) < 150_000
    assert image_ops.imread(CORPUS / "exif_orientation6_97x131.jpg").shape == (131, 97, 3)  # rotated upright


@pytest.mark.parametrize("name,match", [
    ("cmyk.jpg", "CMYK"),
    ("arithmetic.jpg", "arithmetic"),
    ("lossless.jpg", "lossless"),
    ("12bit.jpg", "12-bit"),
    ("progressive_truncated.jpg", "block smoothing"),
])
def test_unsupported_kinds_raise(name, match):
    path = CORPUS / "unsupported" / name
    with pytest.raises(ValueError, match=match):
        image_ops.imread(path)
    with pytest.raises(ValueError, match=match):
        image_ops.decode_jpeg(path.read_bytes())


def test_jpeg_never_reaches_a_library(monkeypatch):
    def refuse(*args):
        raise AssertionError("a JPEG went to cv2 / PIL")

    monkeypatch.setattr(image_ops, "_decode_with_library", refuse)
    assert image_ops.imread(SAMPLES / "sample1.jpg").shape == (480, 640, 3)
    with pytest.raises(ValueError, match="not a JPEG|frame header"):
        image_ops.decode_jpeg(b"\xff\xd8\xff\xd9")


def test_image_size_reads_jpeg_headers():
    for p in FILES:
        if not p.name.startswith(("truncated", "exif")):
            h, w = cv2.imread(str(p)).shape[:2]
            assert image_ops.image_size(p) == (w, h), p.name


def _segments(data):
    """(offset, marker) of each marker segment before the first scan's data, then of each SOS."""
    i, out = 2, []
    while i + 4 <= len(data):
        m = data[i + 1]
        out.append((i, m))
        if m == 0xD9:
            break
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        if m == 0xDA:  # skip the entropy data to the next marker
            while not (data[i] == 0xFF and data[i + 1] not in (0, *range(0xD0, 0xD8))):
                i += 1
    return out


@pytest.mark.parametrize("h,w", [(65535, 65535), (32768, 32769)])
def test_frame_above_the_pixel_limit_raises(h, w):
    data = bytearray((CORPUS / "baseline_420_333x517.jpg").read_bytes())
    sof = next(i for i, m in _segments(data) if m == 0xC0)
    data[sof + 5:sof + 9] = struct.pack(">HH", h, w)
    # cv2.imdecode refuses it too (validateInputImageSize: CV_IO_MAX_IMAGE_PIXELS = 2^30)
    try:
        assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR) is None
    except cv2.error as e:
        assert "CV_IO_MAX_IMAGE_PIXELS" in str(e)
    with pytest.raises(ValueError, match="exceeds the limit of 2\\^30 pixels"):
        image_ops.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match="cannot decode"):
        image_ops.imdecode(bytes(data))


def test_refinement_scan_without_its_huffman_table_raises():
    data = bytearray((CORPUS / "progressive_420_333x517.jpg").read_bytes())
    # the first AC refinement scan (Ss > 0, Ah > 0) of one component: point its AC table at slot 3, never defined
    for i, m in _segments(data):
        if m == 0xDA and data[i + 4] == 1 and data[i + 7] > 0 and data[i + 9] >> 4:
            data[i + 6] = (data[i + 6] & 0xF0) | 3
            break
    else:
        raise AssertionError("no AC refinement scan in the corpus file")
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="Huffman table not defined"):
        image_ops.decode_jpeg(bytes(data))

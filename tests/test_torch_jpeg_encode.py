"""The port's JPEG encoder (data/image_ops.encode_jpeg, csrc/host_ops.cpp)
against cv2.imencode(".jpg"), which the JAX package writes its images with.

Bar: byte-equal. Over the JPEG corpus and the sample images as decoded,
the synthetic images of chip_smoke.JPEG_SYNTHETIC (whose cv2 digests are
pinned in tests/data/jpeg/encode_digests.json for the card's host, which
has no cv2), and random images from 1x1 to 333x517 with 1, 3 and 4
channels; other qualities too. The image writers on top (image_ops.imwrite,
env.imwrite) pick the format by suffix.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

import chip_smoke
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data import image_ops

ROOT = Path(__file__).resolve().parents[1]
PINNED = json.loads((ROOT / "tests" / "data" / "jpeg" / "encode_digests.json").read_text())


def cv2_jpeg(im, *params):
    ok, buf = cv2.imencode(".jpg", im, list(params))
    assert ok
    return buf.tobytes()


def test_pinned_digests_are_cv2s_and_the_encoders():
    inputs = chip_smoke.jpeg_encode_inputs()
    assert sorted(n for n, _ in inputs) == sorted(PINNED) and len(inputs) >= 26
    for name, im in inputs:
        want = cv2_jpeg(im)
        got = image_ops.encode_jpeg(im)
        assert got == want, name
        assert hashlib.sha256(got).hexdigest() == PINNED[name]["sha256"] and len(got) == PINNED[name]["bytes"], name
        assert list(im.shape) == PINNED[name]["shape"]


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_random_sizes_match_cv2(seed, channels):
    """Noise, smooth gradients and flat blocks, from 1x1 up to 333x517."""
    rng = np.random.default_rng(100 * seed + channels)
    sizes = [(1, 1), (1, 2), (2, 1), (8, 8), (9, 17), (16, 16), (333, 517)]
    sizes += [tuple(int(v) for v in rng.integers(1, [333, 517])) for _ in range(8)]
    for h, w in sizes:
        shape = (h, w) if channels == 1 else (h, w, channels)
        noise = rng.integers(0, 256, shape, dtype=np.uint8)
        yy, xx = np.indices((h, w))
        smooth = np.broadcast_to(((yy * 3 + xx * 2) % 256)[..., None] if channels > 1 else (yy * 3 + xx * 2) % 256,
                                 shape).astype(np.uint8)
        flat = np.full(shape, int(rng.integers(0, 256)), np.uint8)
        for im in (noise, np.ascontiguousarray(smooth), flat):
            assert image_ops.encode_jpeg(im) == cv2_jpeg(im), (h, w, channels)


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
def test_qualities_match_cv2(quality):
    im = image_ops.imread(ROOT / "yolov3_tpu_torch" / "data" / "images" / "sample1.jpg")
    assert image_ops.encode_jpeg(im, quality) == cv2_jpeg(im, cv2.IMWRITE_JPEG_QUALITY, quality)


def test_encode_decode_round_trip_is_cv2s():
    im = chip_smoke.synthetic_jpeg_input(97, 131, 3)
    data = image_ops.encode_jpeg(im)
    np.testing.assert_array_equal(image_ops.decode_jpeg(data), cv2.imdecode(np.frombuffer(data, np.uint8), 1))


def test_non_contiguous_and_refused_inputs(tmp_path):
    im = chip_smoke.synthetic_jpeg_input(40, 60, 3)
    view = im[::2, 5:50]
    assert image_ops.encode_jpeg(view) == cv2_jpeg(np.ascontiguousarray(view))
    for bad in (np.zeros((4, 4, 2), np.uint8), np.zeros((0, 4, 3), np.uint8), np.zeros((4,), np.uint8),
                np.zeros((65536, 1), np.uint8)):
        with pytest.raises(ValueError):
            image_ops.encode_jpeg(bad)


@pytest.mark.parametrize("suffix", [".jpg", ".jpeg", ".JPG", ".png"])
def test_imwrite_picks_the_format_by_suffix(tmp_path, suffix):
    im = chip_smoke.synthetic_jpeg_input(33, 47, 3)
    f = tmp_path / f"a{suffix}"
    image_ops.imwrite(f, im)
    assert cv2.imwrite(str(tmp_path / f"cv2{suffix}"), im)
    if suffix == ".png":  # PNG is lossless: compare pixels (the deflate streams differ)
        np.testing.assert_array_equal(image_ops.imread(f), im)
    else:
        assert f.read_bytes() == (tmp_path / f"cv2{suffix}").read_bytes()
    with pytest.raises(ValueError, match="webp"):
        image_ops.imwrite(tmp_path / "a.webp", im)

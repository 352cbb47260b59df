"""Write the JPEG corpus of tests/test_torch_jpeg.py into tests/data/jpeg/.

Every kind of JPEG that data/image_ops.decode_jpeg decodes, encoded by cv2
(libjpeg-turbo) or Pillow from a downscaled sample image at odd sizes:
baseline 4:4:4, 4:2:2, 4:2:0 and 4:4:0, 4:1:1, grayscale, progressive
(spectral selection and successive approximation), restart intervals, an
EXIF orientation-6 file, a baseline file cut short, plus files of kinds
the decoder refuses (under unsupported/). digests.json pins the SHA-256 of
cv2.imread's decode of each supported file (and of the two sample images),
so a host without cv2 can check its decoder against them.

    python scripts/make_jpeg_corpus.py     # needs cv2 and Pillow; writes about 120 KB
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "jpeg"
SAMPLES = ROOT / "yolov3_tpu_torch" / "data" / "images"


def digest(im):
    return hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest()


def enc(im, *params):
    ok, buf = cv2.imencode(".jpg", im, list(params))
    assert ok
    return buf.tobytes()


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "unsupported").mkdir(exist_ok=True)
    src = cv2.imread(str(SAMPLES / "sample2.jpg"))
    big = cv2.resize(src, (517, 333), interpolation=cv2.INTER_AREA)
    small = cv2.resize(src, (131, 97), interpolation=cv2.INTER_AREA)
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    q = cv2.IMWRITE_JPEG_QUALITY
    files = {
        "baseline_444_333x517.jpg": enc(big, q, 70, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "baseline_422_333x517.jpg": enc(big, q, 70, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "baseline_420_333x517.jpg": enc(big, q, 70, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "baseline_440_97x131.jpg": enc(small, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "baseline_411_97x131.jpg": enc(small, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "gray_97x131.jpg": enc(cv2.cvtColor(small, cv2.COLOR_BGR2GRAY), q, 90),
        "progressive_420_333x517.jpg": enc(big, q, 70, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "progressive_gray_97x131.jpg": enc(cv2.cvtColor(small, cv2.COLOR_BGR2GRAY), q, 90,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "restart_420_97x131.jpg": enc(small, q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
        "quality100_444_97x131.jpg": enc(small, q, 100, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    }
    pil = Image.fromarray(small[:, :, ::-1])
    exif = pil.getexif()
    exif[0x0112] = 6  # rotate 90 degrees clockwise to display
    buf = io.BytesIO()
    pil.save(buf, "JPEG", quality=90, exif=exif.tobytes())
    files["exif_orientation6_97x131.jpg"] = buf.getvalue()
    full = enc(big, q, 70)
    files["truncated_420_333x517.jpg"] = full[: int(len(full) * 0.6)]
    for name, data in files.items():
        (OUT / name).write_bytes(data)

    # kinds the decoder refuses
    cmyk = io.BytesIO()
    Image.fromarray(small[:, :, ::-1]).convert("CMYK").save(cmyk, "JPEG", quality=80)
    base = bytearray(enc(small, q, 80))
    sof = base.index(b"\xff\xc0")
    arith, lossless, twelve = bytearray(base), bytearray(base), bytearray(base)
    arith[sof + 1] = 0xC9
    lossless[sof + 1] = 0xC3
    twelve[sof + 4] = 12
    prog = enc(big, q, 70, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    unsupported = {"cmyk.jpg": cmyk.getvalue(), "arithmetic.jpg": bytes(arith), "lossless.jpg": bytes(lossless),
                   "12bit.jpg": bytes(twelve), "progressive_truncated.jpg": prog[: len(prog) // 2]}
    for name, data in unsupported.items():
        (OUT / "unsupported" / name).write_bytes(data)

    digests = {}
    for p in sorted(OUT.glob("*.jpg")) + sorted(SAMPLES.glob("*.jpg")):
        im = cv2.imread(str(p))
        digests[p.name] = {"sha256": digest(im), "shape": list(im.shape)}
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {len(files)} + {len(unsupported)} files, {total} bytes, to {OUT}")


if __name__ == "__main__":
    main()

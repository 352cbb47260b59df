"""Write tests/data/jpeg/encode_digests.json: the SHA-256 and length of
cv2.imencode(".jpg", im) (OpenCV's defaults: quality 95, 4:2:0) for every
image of chip_smoke.jpeg_encode_inputs() (the sample images and the JPEG
corpus as decoded in-tree, which equals cv2's decode, and the synthetic
shapes). chip_smoke.py's JPEG phase and tests/test_torch_jpeg_encode.py hold
the in-tree encoder to these digests, on hosts without cv2 too.

    python scripts/make_jpeg_encode_digests.py     # needs cv2; a few seconds
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402 — the inputs are defined beside the phase that checks them


def main():
    out = {}
    for name, im in chip_smoke.jpeg_encode_inputs():
        if not name.startswith("synthetic_"):
            src = next(p for p in chip_smoke.detect_sources() if p.name == name)
            assert np.array_equal(im, cv2.imread(str(src))), f"{name}: the in-tree decode is not cv2's"
        ok, buf = cv2.imencode(".jpg", im)
        assert ok, name
        data = buf.tobytes()
        out[name] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data), "shape": list(im.shape)}
    f = ROOT / "tests" / "data" / "jpeg" / "encode_digests.json"
    f.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"{f}: {len(out)} digests (cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()

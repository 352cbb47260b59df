"""The port's `LoadImages` (data/loaders.py) against the JAX package's.

Over a directory, a glob, a list and a `.txt` list of the JPEG corpus and
the sample images: the same files in the same order, the same status
strings, and letterboxed RGB arrays and original BGR images byte-equal (the
JAX loader reads with cv2.imread and letterboxes with cv2.resize). The JAX
loader takes no `.txt` list (the reference's does): its side reads the list
itself. Video and stream sources need cv2 / mss and say so without them."""

import sys
from pathlib import Path

import numpy as np
import pytest

from yolov3_tpu.data.loaders import LoadImages as JaxLoadImages
from yolov3_tpu_torch.data import loaders
from yolov3_tpu_torch.data.loaders import VID_FORMATS, LoadImages

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "data" / "jpeg"
SAMPLES = ROOT / "yolov3_tpu_torch" / "data" / "images"


def sources(tmp_path):
    files = sorted(str(p) for p in CORPUS.glob("*.jpg"))[::2] + [str(p) for p in sorted(SAMPLES.glob("*.jpg"))]
    txt = tmp_path / "list.txt"
    txt.write_text("\n".join(files) + "\n")
    return {"dir": (str(CORPUS), str(CORPUS)), "glob": (str(CORPUS / "base*.jpg"),) * 2,
            "list": (files, files), "txt": (str(txt), files)}


@pytest.mark.parametrize("kind", ["dir", "glob", "list", "txt"])
@pytest.mark.parametrize("imgsz,auto", [(160, False), (224, True)])
def test_load_images_equals_jax(tmp_path, kind, imgsz, auto):
    port_src, jax_src = sources(tmp_path)[kind]
    got = list(LoadImages(port_src, img_size=imgsz, stride=32, auto=auto))
    want = list(JaxLoadImages(jax_src, img_size=imgsz, stride=32, auto=auto))
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) >= 3
    for (path, im, im0, cap, s), (_, jim, jim0, jcap, js) in zip(got, want):
        assert s == js and cap is None and jcap is None
        assert im.flags.c_contiguous and im.dtype == np.uint8
        np.testing.assert_array_equal(im, jim, err_msg=path)
        np.testing.assert_array_equal(im0, jim0, err_msg=path)


def test_missing_source_and_video_without_cv2(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        LoadImages(str(tmp_path / "nothing.jpg"))
    assert "mp4" in VID_FORMATS
    (tmp_path / "clip.mp4").write_bytes(b"\0" * 16)
    monkeypatch.setitem(sys.modules, "cv2", None)  # as on a host without OpenCV
    with pytest.raises(RuntimeError, match="'cv2' package"):
        LoadImages(str(tmp_path / "clip.mp4"))
    with pytest.raises(RuntimeError, match="'cv2' package"):
        loaders.LoadStreams("0")
    monkeypatch.setitem(sys.modules, "mss", None)
    with pytest.raises(RuntimeError, match="'mss' package"):
        loaders.LoadScreenshots("screen")

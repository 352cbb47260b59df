"""The port's drawing (utils/plots.py) against the JAX package's cv2 drawing.

- `colors` equals the JAX palette; `save_one_box` crops are byte-equal to
  the JAX function's arrays.
- `Annotator.box_label` on both sample images at line widths 1, 2 and 3,
  boxes with labels above (outside) and inside the box: the pixels that
  differ from the JAX Annotator's by more than 64 levels in any channel are
  at most 2% of the pixels the two draw on (box outlines plus label boxes);
  the test prints the share (the atlas of scripts/recover_annotator_atlas.py
  makes it 0 with the cv2 it was read from).
  Also at line widths 21 and 32, Annotator's defaults for 48 and 108 MP photos.
- the atlas's text sizes equal cv2.getTextSize at every line width it holds
  (1..32); a wider line raises instead of differing from cv2.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

from yolov3_tpu.utils import plots as jax_plots
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.utils import plots

ROOT = Path(__file__).resolve().parents[1]
SAMPLES = sorted((ROOT / "yolov3_tpu_torch" / "data" / "images").glob("*.jpg"))


def test_colors_equal_jax():
    assert plots.colors.palette == jax_plots.colors.palette and plots.colors.n == jax_plots.colors.n
    for i in range(45):
        assert plots.colors(i) == jax_plots.colors(i) and plots.colors(i, True) == jax_plots.colors(i, True)


def random_boxes(rng, shape, n):
    h, w = shape[:2]
    xy = rng.uniform([0, 0], [w - 20, h - 20], (n, 2))
    wh = rng.uniform(8, [w / 3, h / 3], (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1)


def test_save_one_box_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    im = image_ops.imread(SAMPLES[0])
    for box in random_boxes(rng, im.shape, 12):
        for square, bgr in ((False, True), (True, False)):
            got = plots.save_one_box(box, im, square=square, BGR=bgr, save=False)
            want = jax_plots.save_one_box(box, im, square=square, BGR=bgr, save=False)
            np.testing.assert_array_equal(got, want)
    crop = plots.save_one_box(box, im, file=tmp_path / "crops" / "a.jpg")
    jax_plots.save_one_box(box, im, file=tmp_path / "jax" / "a.jpg")
    assert (tmp_path / "crops" / "a.jpg").read_bytes() == (tmp_path / "jax" / "a.jpg").read_bytes()  # cv2's JPEG
    plots.save_one_box(box, im, file=tmp_path / "crops" / "a.png")
    np.testing.assert_array_equal(image_ops.imread(tmp_path / "crops" / "a.png"), crop)


@pytest.mark.parametrize("lw", [1, 2, 3, 21, 32])  # 21 and 32: the default widths at 48 and 108 MP
@pytest.mark.parametrize("path", SAMPLES, ids=lambda p: p.name)
def test_box_label_matches_jax(path, lw):
    rng = np.random.default_rng(lw)
    im0 = image_ops.imread(path)
    got, want = im0.copy(), im0.copy()
    a, b = plots.Annotator(got, line_width=lw), jax_plots.Annotator(want, line_width=lw)
    boxes = random_boxes(rng, im0.shape, 10)
    boxes[:3, 1] = rng.uniform(0, 6, 3)  # near the top edge: the label goes inside the box
    for i, box in enumerate(boxes):
        label = f"{['person', 'car', 'traffic light', 'dog'][i % 4]} {rng.uniform():.2f}" if i % 5 else ""
        a.box_label(box, label, color=plots.colors(i, True))
        b.box_label(box, label, color=jax_plots.colors(i, True))
    drawn = (want != im0).any(2) | (got != im0).any(2)
    far = (np.abs(got.astype(int) - want).max(2) > 64)
    share = far.sum() / max(drawn.sum(), 1)
    print(f"{path.name} lw {lw}: {far.sum()} of {drawn.sum()} drawn pixels off by > 64 ({share:.4%})")
    assert drawn.sum() > 1000 and share <= 0.02
    assert a.result() is got


@pytest.mark.parametrize("lw", range(1, 33))
def test_text_size_equals_cv2(lw):
    for text in ("person 0.87", "a", "Wg|_", "traffic light 1.00"):
        (w, h), base = plots.text_size(text, lw)
        (cw, ch), cbase = cv2.getTextSize(text, 0, lw / 3, max(lw - 1, 1))
        assert (w, h, base) == (cw, ch, cbase), text


def test_rectangle_line8_and_drawing_checks():
    im = np.zeros((60, 80, 3), np.uint8)
    ref = im.copy()
    plots.Annotator(im).rectangle((10, 12, 50, 40), outline=(10, 200, 30), width=2)
    cv2.rectangle(ref, (10, 12), (50, 40), (10, 200, 30), 2)
    assert (np.abs(im.astype(int) - ref).max(2) > 2).sum() <= 0.01 * (ref != 0).any(2).sum()
    with pytest.raises(ValueError, match="contiguous"):
        plots.Annotator(np.zeros((10, 10, 3), np.uint8)[:, ::2])


def test_default_widths_of_large_photos_are_in_the_atlas():
    def default_lw(shape):  # Annotator's default, without allocating the image
        return max(round(sum(shape) / 2 * 0.003), 2)

    assert default_lw((6048, 8064, 3)) == 21 and default_lw((9000, 12000, 3)) == 32
    im = np.zeros((64, 64, 3), np.uint8)
    plots.Annotator(im, line_width=32).box_label((4, 4, 40, 40), "a")
    with pytest.raises(ValueError, match="line width 33 is wider than 32"):
        plots.Annotator(im, line_width=33).box_label((4, 4, 40, 40), "a")

"""The port's autoanchor (utils/autoanchor.py) against the JAX package's on
the same labels and seeds: the port's RandomState passed in where the JAX
package reads the global np.random, seeded alike. Anchors rtol 1e-5."""

import numpy as np
import pytest

from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.utils import autoanchor as jax_autoanchor
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.utils import autoanchor


class Labels:
    """The two dataset fields check_anchors reads."""

    def __init__(self, seed, n=60, small=False):
        rng = np.random.default_rng(seed)
        self.shapes = rng.uniform(300, 800, (n, 2))
        scale = 0.05 if small else 1.0
        self.labels = [np.concatenate([rng.integers(0, 3, (k, 1)), rng.uniform(0.2, 0.8, (k, 2)),
                                       rng.uniform(0.02, 0.5, (k, 2)) * scale], 1).astype(np.float32)
                       for k in rng.integers(0, 5, n)]


@pytest.mark.parametrize("seed,small", [(0, False), (1, True), (2, True)])
def test_check_anchors_equals_jax(seed, small):
    ds = Labels(seed, small=small)
    np.random.seed(seed)
    want = jax_autoanchor.check_anchors(ds, jax_parse_spec("yolov3"), thr=4.0, imgsz=640)
    got = autoanchor.check_anchors(ds, parse_spec("yolov3"), thr=4.0, imgsz=640,
                                   np_rng=np.random.RandomState(seed))
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if small:  # tiny boxes: the default anchors fit badly and are refitted
        assert got is not None


def test_kmean_anchors_equals_jax():
    wh = np.random.default_rng(5).uniform(3, 300, (400, 2)).astype(np.float32)
    np.random.seed(9)
    want = jax_autoanchor.kmean_anchors(wh, n=9, gen=300)
    got = autoanchor.kmean_anchors(wh, n=9, gen=300, np_rng=np.random.RandomState(9))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (np.diff(got.prod(1)) >= 0).all()  # sorted by area


def test_anchor_metrics_equals_jax():
    wh = np.random.default_rng(6).uniform(3, 300, (100, 2)).astype(np.float32)
    anchors = np.array(parse_spec("yolov3").anchors, np.float32).reshape(-1, 2)
    np.testing.assert_allclose(autoanchor.anchor_metrics(wh, anchors), jax_autoanchor.anchor_metrics(wh, anchors))

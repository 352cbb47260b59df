"""The port's plots (utils/plots.py) against the JAX package's, on the same
seeded inputs.

- `plot_images` is a pure array function: its mosaic without boxes equals
  the JAX mosaic exactly; with boxes and labels, the pixels that differ from
  the JAX mosaic by more than 64 levels in any channel are at most 2% of
  the pixels either draws on (the Annotator's bar, tests/test_torch_plots.py;
  the JAX package draws with cv2, the port with its atlas). Both write
  JPEG, the port through its own encoder: equal mosaics give equal files,
  and the port's file is cv2's encoding of its mosaic, byte for byte.
- every matplotlib plot: the arrays each draws (every Axes.plot, scatter,
  hist, hist2d, imshow, bar and pcolormesh call, recorded) equal the JAX
  function's exactly, and the files it writes are the JAX function's (the
  correlogram's .jpg too, encoded in-tree from the rendered figure). Pixels
  are not compared: both draw through the same matplotlib.
- without matplotlib (or seaborn / pandas for the correlogram) each plot
  logs one warning, writes nothing and returns None; nothing is installed.
"""

import contextlib
import functools
import shutil
import sys

import numpy as np
import pytest
import torch

from yolov3_tpu.utils import plots as jax_plots
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.eval import metrics
from yolov3_tpu_torch.train.evolve import log_generation
from yolov3_tpu_torch.utils import plots
from yolov3_tpu_torch.utils.loggers import Loggers

DRAWN = ("plot", "scatter", "hist", "hist2d", "imshow", "bar", "pcolormesh")


@contextlib.contextmanager
def drawn_arrays():
    """The (method, [array args]) of every drawing call on any Axes inside the block."""
    from matplotlib.axes import Axes

    calls, originals = [], {n: getattr(Axes, n) for n in DRAWN}

    def recording(name):
        @functools.wraps(originals[name])  # seaborn picks default colours by the method's name
        def method(self, *args, **kwargs):
            calls.append((name, [np.ma.filled(np.asarray(a, dtype=float), np.nan) for a in args
                                 if not isinstance(a, str)]))
            return originals[name](self, *args, **kwargs)
        return method

    for n in DRAWN:
        setattr(Axes, n, recording(n))
    try:
        yield calls
    finally:
        for n, f in originals.items():
            setattr(Axes, n, f)


def both(tmp_path, jax_fn, port_fn):
    """Run jax_fn(dir) and port_fn(dir) in two directories; returns their
    drawing calls and the names of the files each wrote."""
    out = []
    for name, fn in (("jax", jax_fn), ("port", port_fn)):
        d = tmp_path / name
        d.mkdir()
        with drawn_arrays() as calls:
            fn(d)
        out.append((calls, sorted(p.name for p in d.iterdir())))
    return out


def assert_same(got, want):
    (g_calls, g_files), (w_calls, w_files) = got, want
    assert g_files == w_files
    assert g_files, "nothing written"
    assert [n for n, _ in g_calls] == [n for n, _ in w_calls] and g_calls
    for (name, ga), (_, wa) in zip(g_calls, w_calls):
        assert len(ga) == len(wa), name
        for g, w in zip(ga, wa):
            np.testing.assert_array_equal(g, w, err_msg=name)


def batch(rng, bs=5, h=64, w=80, m=6):
    images = rng.integers(0, 256, (bs, h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0.2, 0.8, (bs, m, 2))
    wh = rng.uniform(0.05, 0.4, (bs, m, 2))
    targets = np.concatenate([rng.integers(0, 3, (bs, m, 1)), xy, wh], 2).astype(np.float32)
    masks = rng.uniform(size=(bs, m)) < 0.7
    return images, targets, masks


@pytest.mark.parametrize("with_masks", [True, False])
def test_plot_images_matches_jax(tmp_path, with_masks):
    images, targets, masks = batch(np.random.default_rng(0))
    if not with_masks:  # without masks the rows of width > 0 are drawn
        targets[~masks, 3] = 0.0
    names = {0: "person", 1: "car", 2: "dog"}
    base = plots.plot_images(images, None, fname=tmp_path / "base.jpg")
    np.testing.assert_array_equal(base, jax_plots.plot_images(images, None, fname=str(tmp_path / "jax_base.jpg")))
    m = masks if with_masks else None
    got = plots.plot_images(images, targets, masks=m, fname=tmp_path / "port.jpg", names=names)
    want = jax_plots.plot_images(images, targets, masks=m, fname=str(tmp_path / "jax.jpg"), names=names)
    drawn = (got != base).any(2) | (want != base).any(2)
    far = np.abs(got.astype(int) - want).max(2) > 64
    print(f"{far.sum()} of {drawn.sum()} drawn pixels off by > 64 ({far.sum() / drawn.sum():.4%})")
    assert drawn.sum() > 500 and far.sum() <= 0.02 * drawn.sum()
    assert (got[~drawn] == base[~drawn]).all()
    import cv2

    assert (tmp_path / "base.jpg").read_bytes() == (tmp_path / "jax_base.jpg").read_bytes()
    assert (tmp_path / "port.jpg").read_bytes() == cv2.imencode(".jpg", got)[1].tobytes()


def test_plot_results_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    log = Loggers(tmp_path)
    for epoch in range(4):
        log.on_fit_epoch_end(rng.uniform(0, 1, 13), epoch)

    def run(fn):
        def go(d):
            shutil.copy(tmp_path / "results.csv", d / "results.csv")
            fn(d / "results.csv")
        return go

    assert_same(*reversed(both(tmp_path, run(jax_plots.plot_results), run(plots.plot_results))))


def curves_and_ap():
    rng = np.random.default_rng(2)
    n_det, n_gt, nc = 300, 120, 4
    tp = rng.uniform(size=(n_det, 10)) < np.linspace(0.8, 0.2, 10)
    stats = (tp, rng.uniform(0.001, 1.0, n_det), rng.integers(0, nc, n_det).astype(float),
             rng.integers(0, nc, n_gt).astype(float))
    *_, ap, ap_class, curves = metrics.ap_per_class(*stats, curves=True)
    return curves, ap, ap_class


@pytest.mark.parametrize("n_names", [4, 25])  # a legend line a class, or grey curves past 20 classes
def test_pr_and_mc_curves_match_jax(tmp_path, n_names):
    (px, py, p_curve, r_curve, f1_curve), ap, ap_class = curves_and_ap()
    names = [f"c{i}" for i in range(n_names)]

    def run(mod):
        def go(d):
            mod.plot_pr_curve(px, py, ap, d / "PR_curve.png", names[: len(ap_class)] if n_names < 21 else names)
            mod.plot_mc_curve(px, f1_curve, d / "F1_curve.png", names[: len(ap_class)] if n_names < 21 else names,
                              ylabel="F1")
        return go

    assert_same(*reversed(both(tmp_path, run(jax_plots), run(plots))))


def test_confusion_matrix_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    cm = metrics.ConfusionMatrix(nc=3)
    for _ in range(4):
        labels = np.concatenate([rng.integers(0, 3, (10, 1)), rng.uniform(0, 200, (10, 2))], 1)
        labels = np.concatenate([labels, labels[:, 1:] + rng.uniform(10, 60, (10, 2))], 1).astype(np.float32)
        dets = np.concatenate([labels[:, 1:] + rng.normal(0, 4, (10, 4)), rng.uniform(0.2, 1, (10, 1)),
                               rng.integers(0, 3, (10, 1))], 1).astype(np.float32)
        cm.process_batch(dets, labels)
    names = ["a", "b", "c"]
    assert_same(*reversed(both(
        tmp_path, lambda d: jax_plots.plot_confusion_matrix(cm.matrix, names, d / "confusion_matrix.png"),
        lambda d: plots.plot_confusion_matrix(cm.matrix, names, d / "confusion_matrix.png"))))


def seeded_labels(n=200):
    rng = np.random.default_rng(4)
    return np.concatenate([rng.integers(0, 5, (n, 1)), rng.uniform(0.05, 0.95, (n, 4))], 1).astype(np.float32)


def test_label_plots_match_jax(tmp_path):
    labels = seeded_labels()
    assert_same(*reversed(both(tmp_path, lambda d: jax_plots.plot_labels(labels, (), d),
                               lambda d: plots.plot_labels(labels, (), d))))


def test_labels_correlogram_matches_jax(tmp_path):
    labels = seeded_labels(120)
    got, want = reversed(both(tmp_path, lambda d: jax_plots.plot_labels_correlogram(labels, d),
                              lambda d: plots.plot_labels_correlogram(labels, d)))
    assert_same(got, want)
    assert plots.plot_labels_correlogram(labels[:0], tmp_path) is None


def test_plot_evolve_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    csv_file = tmp_path / "evolve.csv"
    for _ in range(5):
        hyp = {"lr0": rng.uniform(1e-3, 1e-1), "momentum": rng.uniform(0.6, 0.98), "box": rng.uniform(0.02, 0.2)}
        log_generation(csv_file, hyp, rng.uniform(0, 1, 4))

    def run(fn):
        def go(d):
            shutil.copy(csv_file, d / "evolve.csv")
            fn(d / "evolve.csv")
        return go

    assert_same(*reversed(both(tmp_path, run(jax_plots.plot_evolve), run(plots.plot_evolve))))


def test_feature_visualization_matches_jax(tmp_path):
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 12, 10, 9)).astype(np.float32))
    nhwc = x.permute(0, 2, 3, 1).numpy()
    assert_same(*reversed(both(
        tmp_path, lambda d: jax_plots.feature_visualization(nhwc, "models.common.Conv", 3, n=10, save_dir=d),
        lambda d: plots.feature_visualization(x, "models.common.Conv", 3, n=10, save_dir=d))))
    assert (tmp_path / "port" / "stage3_Conv_features.png").exists()
    for shape in ((1, 12, 1, 9), (12, 10, 9)):  # a 1-pixel map, or not a 4-D map: nothing written
        assert plots.feature_visualization(torch.zeros(shape), "Conv", 0, save_dir=tmp_path) is None
    assert not list(tmp_path.glob("stage0*"))


def test_plots_without_their_packages_log_and_write_nothing(tmp_path, monkeypatch):
    warnings = []
    monkeypatch.setattr(plots.LOGGER, "warning", lambda msg, *a, **k: warnings.append(msg))
    monkeypatch.setitem(sys.modules, "seaborn", None)
    labels = seeded_labels(50)
    assert plots.plot_labels_correlogram(labels, tmp_path) is None
    assert len(warnings) == 1 and "seaborn is not installed" in warnings[0]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    (px, py, p_curve, r_curve, f1_curve), ap, _ = curves_and_ap()
    Loggers(tmp_path, include=("csv",)).on_fit_epoch_end(np.zeros(13), 0)
    calls = [lambda: plots.plot_results(tmp_path / "results.csv"),
             lambda: plots.plot_pr_curve(px, py, ap, tmp_path / "PR_curve.png"),
             lambda: plots.plot_mc_curve(px, f1_curve, tmp_path / "F1_curve.png"),
             lambda: plots.plot_confusion_matrix(np.eye(3), save_path=tmp_path / "confusion_matrix.png"),
             lambda: plots.plot_labels(labels, (), tmp_path),
             lambda: plots.plot_labels_correlogram(labels, tmp_path),
             lambda: plots.feature_visualization(torch.ones(1, 2, 4, 4), "Conv", 0, save_dir=tmp_path)]
    warnings.clear()
    for call in calls:
        assert call() is None
    assert len(warnings) == len(calls) and all("matplotlib is not installed" in w for w in warnings)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["results.csv"]
    images, targets, masks = batch(np.random.default_rng(7), bs=2)
    plots.plot_images(images, targets, masks, fname=tmp_path / "mosaic.png")  # numpy and the atlas only
    assert (tmp_path / "mosaic.png").exists()

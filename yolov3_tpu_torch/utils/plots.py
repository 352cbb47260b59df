"""Drawing and plots (yolov3_tpu/utils/plots.py): the colour palette,
`Annotator`, `save_one_box`, the batch mosaics of `plot_images`, and the
training and validation plots.

The JAX package draws with cv2.rectangle(..., LINE_AA) and cv2.putText
(font 0). The port draws the same pixels without OpenCV: the glyph masks,
advances and text sizes of font 0, and one box of each thickness, were read
from cv2 by scripts/recover_annotator_atlas.py into fonts/annotator_atlas.npz,
and csrc/host_ops.cpp blends them into the image (a glyph exactly as cv2
blends it; a box within 2 levels of cv2 on more than 99.5% of its pixels).
The atlas covers line widths 1..32; a wider line raises.
tests/test_torch_plots.py holds the drawing to the JAX package's.

Images (crops, mosaics, the label correlogram) are written as the JAX
package writes them, JPEG by default, through the in-tree encoder
(`image_ops.imwrite`, which picks the format by suffix); the other plots are
PNG, as there. `plot_images` needs nothing beyond numpy, so it runs on any
host. The other plots draw with matplotlib (the correlogram with seaborn and pandas too),
imported inside the function: on a host without the package the function
logs one line, writes nothing and returns None. Nothing is installed.
"""

from __future__ import annotations

import contextlib
import csv
import ctypes
import functools
import importlib
import math
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.ops import host_build
from yolov3_tpu_torch.ops.boxes import xywh2xyxy
from yolov3_tpu_torch.utils.general import LOGGER

ATLAS = Path(__file__).resolve().parent / "fonts" / "annotator_atlas.npz"
LINE_AA, LINE_8 = 16, 8  # cv2.LINE_AA, cv2.LINE_8
_U8P = ctypes.POINTER(ctypes.c_uint8)


class Colors:
    """Ultralytics-style color palette keyed by class id."""

    def __init__(self):
        hexs = (
            "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17", "3DDB86", "1A9334", "00D4BB",
            "2C99A8", "00C2FF", "344593", "6473FF", "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
        )  # fmt: skip
        self.palette = [self._hex2rgb(f"#{c}") for c in hexs]
        self.n = len(self.palette)

    @staticmethod
    def _hex2rgb(h):
        return tuple(int(h[1 + i : 1 + i + 2], 16) for i in (0, 2, 4))

    def __call__(self, i, bgr=False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


@functools.lru_cache(maxsize=1)
def _atlas():
    """{lw: (height, extra width, {char: (advance, descent, dy, dx, mask)})} and
    {(thickness, line type): (margin, stamp)} from the atlas file."""
    z = np.load(ATLAS)
    masks = z["masks"]
    fonts = {int(lw): (int(h), int(e), {}) for lw, h, e in z["fonts"]}
    for lw, ch, adv, desc, dy, dx, mh, mw, off in z["glyphs"]:
        mask = np.ascontiguousarray(masks[off:off + mh * mw].reshape(mh, mw))
        fonts[int(lw)][2][chr(ch)] = (int(adv), int(desc), int(dy), int(dx), mask)
    rm = z["rect_masks"]
    rects = {(int(t), int(line)): (int(m), np.ascontiguousarray(rm[off:off + sh * sw].reshape(sh, sw)))
             for t, line, m, sh, sw, off in z["rects"]}
    return fonts, rects


def _lw_in_atlas(lw):
    """The atlas holds line widths 1..32: Annotator's default reaches 32 at
    about 108 MP (12000 x 9000). A wider line raises rather than differ from cv2."""
    top = max(_atlas()[0])
    if lw > top:
        raise ValueError(f"line width {lw} is wider than {top}, the widest in {ATLAS.name} "
                         f"(scripts/recover_annotator_atlas.py); pass a line_width of at most {top}")
    return max(int(lw), 1)


def _glyph(font, ch):
    return font.get(ch) or font["?"]


def text_size(text, lw):
    """cv2.getTextSize(text, 0, lw / 3, max(lw - 1, 1)): ((w, h), baseline)."""
    height, extra, font = _atlas()[0][_lw_in_atlas(lw)]
    glyphs = [_glyph(font, c) for c in text]
    return (sum(g[0] for g in glyphs) + extra, height), max((g[1] for g in glyphs), default=0)


def _check_image(im):
    if not (isinstance(im, np.ndarray) and im.dtype == np.uint8 and im.ndim == 3 and im.shape[2] == 3
            and im.flags.c_contiguous and im.flags.writeable):
        raise ValueError("drawing needs a writable C-contiguous uint8 (H, W, 3) image")


def put_text(im, text, org, lw, color):
    """cv2.putText(im, text, org, 0, lw / 3, color, max(lw - 1, 1), LINE_AA), in place."""
    _check_image(im)
    font = _atlas()[0][_lw_in_atlas(lw)][2]
    col = np.asarray(color, np.uint8)[:3].copy()
    lib = host_build.load()
    x = int(org[0])
    for c in text:
        adv, _, dy, dx, mask = _glyph(font, c)
        if mask.size:
            lib.blend_mask_u8(im.ctypes.data_as(_U8P), im.shape[0], im.shape[1], mask.ctypes.data_as(_U8P),
                              mask.shape[0], mask.shape[1], int(org[1]) + dy, x + dx, col.ctypes.data_as(_U8P))
        x += adv


def rectangle(im, p1, p2, color, thickness=1, line_type=LINE_8):
    """cv2.rectangle(im, p1, p2, color, thickness, line_type) at integer corners, in place;
    thickness -1 fills."""
    _check_image(im)
    t = -1 if thickness < 0 else _lw_in_atlas(max(thickness, 1))
    m, st = _atlas()[1][(t, LINE_AA if line_type == LINE_AA else LINE_8)]
    col = np.asarray(color, np.uint8)[:3].copy()
    host_build.load().draw_rect_stamp(im.ctypes.data_as(_U8P), im.shape[0], im.shape[1], st.ctypes.data_as(_U8P),
                                      st.shape[0], st.shape[1], m, int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]),
                                      col.ctypes.data_as(_U8P))


class Annotator:
    """Draw boxes and labels on a BGR uint8 (H, W, 3) image, in place."""

    def __init__(self, im, line_width=None, font_size=None):
        if not im.flags.c_contiguous:
            raise ValueError("Annotator input must be contiguous (np.ascontiguousarray(im))")
        self.im = im
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)

    def box_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255)):
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        rectangle(self.im, p1, p2, color, thickness=self.lw, line_type=LINE_AA)
        if label:
            (w, h), _ = text_size(label, self.lw)
            outside = p1[1] - h >= 3
            p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
            rectangle(self.im, p1, p2, color, -1, LINE_AA)
            put_text(self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), self.lw, txt_color)

    def rectangle(self, xy, fill=None, outline=(128, 128, 128), width=1):
        rectangle(self.im, (int(xy[0]), int(xy[1])), (int(xy[2]), int(xy[3])), outline, width)

    def result(self):
        return self.im


def save_one_box(xyxy, im, file=Path("im.jpg"), gain=1.02, pad=10, square=False, BGR=True, save=True):
    """Crop a box from an image with a margin and save it to `file`, JPEG or
    PNG by its suffix (detect --save-crop)."""
    b = np.asarray(xyxy, np.float32).reshape(-1, 4)
    xywh = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, (b[:, 2:] - b[:, :2])], 1)
    if square:
        xywh[:, 2:] = xywh[:, 2:].max(1, keepdims=True)
    xywh[:, 2:] = xywh[:, 2:] * gain + pad
    b = xywh2xyxy(xywh).astype(int)
    h, w = im.shape[:2]
    x1, y1, x2, y2 = max(b[0, 0], 0), max(b[0, 1], 0), min(b[0, 2], w), min(b[0, 3], h)
    crop = im[y1:y2, x1:x2, :: (1 if BGR else -1)]
    if save:
        file = Path(file)
        file.parent.mkdir(parents=True, exist_ok=True)
        image_ops.imwrite(file, crop)
    return crop


def plot_images(images, targets, masks=None, paths=None, fname="images.jpg", names=None, max_subplots=16):
    """A tiled mosaic of a batch with its boxes, written to `fname` (JPEG or
    PNG by its suffix); returns the BGR mosaic.

    images: (B, H, W, 3) uint8 RGB; targets: (B, M, 5) [cls, xywh normalised]
    with masks (B, M) of the valid rows (without masks, the rows of width > 0)."""
    bs = min(len(images), max_subplots)
    ns = math.ceil(bs**0.5)
    h, w = images.shape[1:3]
    grid = np.full((ns * h, ns * w, 3), 255, np.uint8)
    ann = Annotator(grid)
    for i in range(bs):
        y, x = (i // ns) * h, (i % ns) * w
        grid[y : y + h, x : x + w] = images[i][..., ::-1]  # to BGR
        if targets is not None:
            t = targets[i]
            valid = masks[i] if masks is not None else (t[:, 3] > 0)
            for cls, cx, cy, bw, bh in t[valid][:, :5]:
                box = [x + (cx - bw / 2) * w, y + (cy - bh / 2) * h, x + (cx + bw / 2) * w, y + (cy + bh / 2) * h]
                label = names.get(int(cls), str(int(cls))) if names else str(int(cls))
                ann.box_label(box, label, color=colors(cls, True))
    image_ops.imwrite(fname, grid)
    return grid


def _modules(what, *names):
    """The named modules, or None after one log line when one is not installed."""
    try:
        return [importlib.import_module(n) for n in names]
    except ImportError as e:
        LOGGER.warning(f"{what}: {e.name} is not installed; nothing written")
        return None


def _pyplot(what, *more):
    """matplotlib.pyplot on the Agg backend and the `more` modules, or None (see _modules)."""
    mods = _modules(what, "matplotlib", *more)
    if mods is None:
        return None
    mods[0].use("Agg")
    return [importlib.import_module("matplotlib.pyplot"), *mods[1:]]


def _read_csv(file):
    """A CSV of numbers with a header as {column: float array}; names stripped."""
    with open(file, newline="") as f:
        rows = list(csv.reader(f))
    header = [c.strip() for c in rows[0]]
    return {c: np.array([float(r[j]) for r in rows[1:]]) for j, c in enumerate(header)}


def plot_results(csv_file="results.csv", save_path=None):
    """The training curves of a results.csv, one panel a column, as results.png beside it."""
    mods = _pyplot("results plot")
    if mods is None:
        return None
    plt, = mods
    df = _read_csv(csv_file)
    cols = [c for c in df if c != "epoch"]
    ncols = 5
    nrows = math.ceil(len(cols) / ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.5 * nrows), tight_layout=True)
    for ax, c in zip(np.ravel(axes), cols):
        ax.plot(df["epoch"], df[c], marker=".", linewidth=1, markersize=4)
        ax.set_title(c, fontsize=9)
    out = save_path or Path(csv_file).with_name("results.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    LOGGER.info(f"Saved results plot to {out}")
    return out


def plot_pr_curve(px, py, ap, save_path=Path("pr_curve.png"), names=()):
    """Per-class precision-recall curves and their mean, with mAP@0.5."""
    mods = _pyplot("PR curve")
    if mods is None:
        return None
    plt, = mods
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if isinstance(py, list) else py
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue", label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_mc_curve(px, py, save_path=Path("mc_curve.png"), names=(), xlabel="Confidence", ylabel="Metric"):
    """Metric-against-confidence curves (F1, P, R) per class and their mean."""
    mods = _pyplot(f"{ylabel} curve")
    if mods is None:
        return None
    plt, = mods
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=str(names[i]))
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue", label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_confusion_matrix(matrix, names=(), save_path=Path("confusion_matrix.png"), normalize=True):
    """The confusion matrix (eval.metrics.ConfusionMatrix.matrix) as a heat map, columns normalised."""
    mods = _pyplot("confusion matrix")
    if mods is None:
        return None
    plt, = mods
    m = matrix.copy().astype(float)
    if normalize:
        m /= (m.sum(0, keepdims=True) + 1e-9)
    m[m < 0.005] = np.nan
    fig, ax = plt.subplots(figsize=(10, 8), tight_layout=True)
    im = ax.imshow(m, cmap="Blues", vmin=0.0)
    fig.colorbar(im)
    labels = [*names, "background"] if names else None
    n = m.shape[0]
    if labels and len(labels) == n:
        ax.set_xticks(range(n), labels=labels, rotation=90, fontsize=8)
        ax.set_yticks(range(n), labels=labels, fontsize=8)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_labels(labels, names=(), save_dir=Path(".")):
    """Label statistics as labels.png: the class histogram and the box centre and size distributions.
    labels: (n, 5) [cls, xywh normalised]."""
    mods = _pyplot("label plot")
    if mods is None:
        return None
    plt, = mods
    c = labels[:, 0]
    boxes = labels[:, 1:5]
    fig, axes = plt.subplots(2, 2, figsize=(10, 10), tight_layout=True)
    nc = int(c.max() + 1) if len(c) else 1
    axes[0, 0].hist(c, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axes[0, 0].set_xlabel("class")
    axes[0, 1].scatter(boxes[:, 0], boxes[:, 1], s=3, alpha=0.4)
    axes[0, 1].set_xlabel("x")
    axes[0, 1].set_ylabel("y")
    axes[1, 0].scatter(boxes[:, 2], boxes[:, 3], s=3, alpha=0.4)
    axes[1, 0].set_xlabel("width")
    axes[1, 0].set_ylabel("height")
    axes[1, 1].hist2d(boxes[:, 2], boxes[:, 3], bins=50, cmap="Blues")
    axes[1, 1].set_xlabel("width")
    axes[1, 1].set_ylabel("height")
    out = Path(save_dir) / "labels.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_labels_correlogram(labels, save_dir=Path(".")):
    """The pairwise (x, y, w, h) correlogram of the labels (seaborn's pairplot) as labels_correlogram.jpg:
    the figure is rendered to an array and encoded in-tree (matplotlib writes JPEG only through Pillow)."""
    labels = np.asarray(labels)
    if not len(labels):
        return None
    mods = _pyplot("labels correlogram", "pandas", "seaborn")
    if mods is None:
        return None
    plt, pd, sn = mods
    df = pd.DataFrame(labels[:, 1:5], columns=["x", "y", "width", "height"])
    sn.pairplot(df, corner=True, diag_kind="auto", kind="hist", diag_kws=dict(bins=50), plot_kws=dict(pmax=0.9))
    out = Path(save_dir) / "labels_correlogram.jpg"
    fig = plt.gcf()
    fig.set_dpi(200)
    fig.canvas.draw()
    image_ops.imwrite_jpeg(out, np.ascontiguousarray(np.asarray(fig.canvas.buffer_rgba())[..., 2::-1]))
    plt.close()
    return out


def plot_evolve(evolve_csv, save_path=None):
    """The hyper-parameter evolution's scatter matrix (fitness against each
    hyper-parameter), as the CSV's name with the suffix .png."""
    mods = _pyplot("evolve plot")
    if mods is None:
        return None
    plt, = mods
    df = _read_csv(evolve_csv)
    metrics = ("P", "R", "mAP50", "mAP50-95")
    keys = [c for c in df if c not in metrics]
    f = (np.stack([df[k] for k in metrics], 1) * [0.0, 0.0, 0.1, 0.9]).sum(1)
    ncols = 6
    nrows = int(np.ceil(len(keys) / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(2.5 * ncols, 2.5 * nrows), tight_layout=True)
    for ax, k in zip(np.ravel(axes), keys):
        ax.scatter(df[k], f, c=f, cmap="viridis", s=12, alpha=0.7)
        ax.set_title(f"{k} = {df[k][f.argmax()]:.3g}", fontsize=8)
    out = save_path or Path(evolve_csv).with_suffix(".png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def feature_visualization(x, module_type, stage, n=32, save_dir=Path("runs/detect/exp")):
    """The first `n` channels of the first image of a (B, C, H, W) feature
    map as a grid, stage{stage}_{module type}_features.png (detect --visualize)."""
    if x.ndim != 4:
        return None
    _, c, h, w = x.shape
    if h <= 1 or w <= 1:
        return None
    mods = _pyplot("feature visualization")
    if mods is None:
        return None
    plt, = mods
    x = x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    f = Path(save_dir) / f"stage{stage}_{module_type.split('.')[-1]}_features.png"
    n = min(n, c)
    fig, ax = plt.subplots(math.ceil(n / 8), 8, tight_layout=True)
    ax = np.ravel(ax)
    for i in range(n):
        ax[i].imshow(x[0, i])
        ax[i].axis("off")
    with contextlib.suppress(Exception):
        fig.savefig(f, dpi=300, bbox_inches="tight")
    plt.close(fig)
    LOGGER.info(f"Saved feature visualization to {f}")
    return f

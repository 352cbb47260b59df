"""Dataset and loader: the host pipeline that feeds fixed-shape batches
(yolov3_tpu/data/datasets.py).

Batches come out in the JAX package's layout: images (B, H, W, 3) uint8 RGB,
labels padded to (B, M, 5) float32 [cls, xywhn] with a (B, M) bool mask, and
each image's shapes meta. The trainer moves them to the card.

Kept semantics: image/label discovery (images/ -> labels/ path substitution),
the label cache (.cache.npz keyed by a hash of paths and sizes), label
verification (class bounds, normalised coordinates, dedup), the mosaic ->
mixup -> HSV -> flips chain, rect batches (aspect-ratio-sorted, per-batch
shapes rounded up to stride multiples with a pad margin), the RAM/disk image
cache, multi-scale resize in the workers and power-of-two label buckets.

Images are decoded and transformed by the host image layer
(data/image_ops.py), never OpenCV. Randomness comes from the dataset's
generators, `rng` (random.Random) and `np_rng` (np.random.RandomState),
which a trainer shares with the rest of its run. With `workers=1` the draws
come in the order the JAX package makes them from its global generators;
with more workers the threads interleave their draws in no fixed order, in
either package.
"""

from __future__ import annotations

import hashlib
import math
import os
import random
import threading
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import (Albumentations, augment_hsv, cutout, letterbox, mixup, mosaic4,
                                           random_perspective)
from yolov3_tpu_torch.ops.boxes import xywhn2xyxy, xyxy2xywhn
from yolov3_tpu_torch.utils.general import LOGGER

IMG_FORMATS = ("bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm")
CACHE_VERSION = "yolov3_tpu-cache-v2"  # the JAX package's: either package reads the other's cache


def img2label_paths(img_paths):
    """images/xxx.jpg -> labels/xxx.txt (reference convention)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def list_images(path):
    """Expand a dir / txt-list / glob into a sorted list of image files."""
    files = []
    for p in path if isinstance(path, list) else [path]:
        p = Path(p)
        if p.is_dir():
            files += [str(f) for f in sorted(p.rglob("*.*"))]
        elif p.is_file() and p.suffix == ".txt":
            parent = str(p.parent) + os.sep
            with open(p) as f:
                lines = f.read().strip().splitlines()
            files += [x.replace("./", parent, 1) if x.startswith("./") else x for x in lines]
        elif p.is_file():
            files.append(str(p))
        else:
            import glob as _glob

            files += sorted(_glob.glob(str(p), recursive=True))
    files = [x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
    if not files:
        raise FileNotFoundError(f"No images found in {path}")
    return files


def _paths_hash(paths):
    h = hashlib.sha256()
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getsize(p)).encode())
        except OSError:
            pass
    return h.hexdigest()


def _require(cond, msg):
    """A check of input from disk that holds under `python -O` too."""
    if not cond:
        raise ValueError(msg)


def verify_image_label(im_file, lb_file, num_cls):
    """Validate one image/label pair; returns (labels (n,5), shape (w,h), msg|None).
    The image's size comes from its header (image_ops.image_size); a PNG's
    chunk stream is walked through IEND with every CRC checked
    (image_ops.verify_png), so a truncated or corrupted PNG is dropped."""
    try:
        shape = tuple(int(v) for v in image_ops.image_size(im_file))  # (w, h)
        with open(im_file, "rb") as f:
            head = f.read(8)
            if head == image_ops.PNG_SIGNATURE:
                image_ops.verify_png(head + f.read())
        _require(shape[0] > 9 and shape[1] > 9, f"image size {shape} <10 pixels")
        lb = np.zeros((0, 5), dtype=np.float32)
        if os.path.isfile(lb_file):
            with open(lb_file) as f:
                rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
            if any(len(x) > 6 for x in rows):  # segments -> boxes
                classes = np.array([x[0] for x in rows], dtype=np.float32)
                segs = [np.array(x[1:], dtype=np.float32).reshape(-1, 2) for x in rows]
                boxes = np.array([[s[:, 0].min(), s[:, 1].min(), s[:, 0].max(), s[:, 1].max()] for s in segs],
                                 dtype=np.float32)
                cxy = (boxes[:, :2] + boxes[:, 2:]) / 2
                wh = boxes[:, 2:] - boxes[:, :2]
                rows = np.concatenate([classes[:, None], cxy, wh], 1)
            else:
                rows = np.array(rows, dtype=np.float32)
            if len(rows):
                lb = rows
                _require(lb.ndim == 2 and lb.shape[1] == 5, f"labels require 5 columns, {lb.shape[-1]} given")
                _require((lb >= 0).all(), "negative label values")
                _require((lb[:, 1:] <= 1).all(), "non-normalized coordinates")
                _require((lb[:, 0] < num_cls).all(), "class id out of range")
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < len(lb):
                    lb = lb[np.sort(idx)]
        return lb, shape, None
    except Exception as e:  # noqa: BLE001
        return None, None, f"ignoring corrupt image/label {im_file}: {e}"


class DetectionDataset:
    """Images + labels with the mosaic/augment pipeline producing fixed-shape samples.

    `rng` / `np_rng`: the generators of the augmentations (see the module
    docstring); when not given, both are seeded with 0."""

    def __init__(
        self,
        path,
        imgsz=640,
        augment=False,
        hyp=None,
        rect=False,
        stride=32,
        pad=0.0,
        batch_size=16,
        num_cls=80,
        max_labels=300,
        cache_dir=None,
        single_cls=False,
        cache_images=None,
        rng=None,
        np_rng=None,
    ):
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = hyp or {}
        self.rect = rect
        self.stride = stride
        self.pad = pad
        self.max_labels = max_labels
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = np_rng if np_rng is not None else np.random.RandomState(0)
        self.mosaic = augment and not rect and self.hyp.get("mosaic", 0) > 0
        self.mosaic_border = [-imgsz // 2, -imgsz // 2]
        # the reference applies albumentations to every train item (dataloaders.py:700)
        self.albumentations = Albumentations(size=imgsz) if augment else None

        self.im_files = list_images(path)
        self.label_files = img2label_paths(self.im_files)
        cache_path = Path(cache_dir or Path(self.label_files[0]).parent).with_suffix(".cache.npz")
        self.labels, shapes = self._load_or_build_cache(cache_path, num_cls)
        if single_cls:
            for lb in self.labels:
                if len(lb):
                    lb[:, 0] = 0
        self.shapes = np.array(shapes, dtype=np.float64)  # (n, 2) wh
        n = len(self.im_files)
        self.indices = np.arange(n)

        if rect:  # aspect-ratio sort + per-batch shapes (reference dataloaders.py:547-570)
            bi = np.floor(np.arange(n) / batch_size).astype(int)
            nb = bi[-1] + 1
            ar = self.shapes[:, 1] / self.shapes[:, 0]  # h/w
            irect = ar.argsort()
            self.im_files = [self.im_files[i] for i in irect]
            self.label_files = [self.label_files[i] for i in irect]
            self.labels = [self.labels[i] for i in irect]
            self.shapes = self.shapes[irect]
            ar = ar[irect]
            shapes_out = [[1, 1]] * nb
            for b in range(nb):
                ari = ar[bi == b]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes_out[b] = [maxi, 1]
                elif mini > 1:
                    shapes_out[b] = [1, 1 / mini]
            self.batch_shapes = np.ceil(np.array(shapes_out) * imgsz / stride + pad).astype(int) * stride
            self.batch_index = bi

        # RAM/disk image cache (reference dataloaders.py:572-608): the image
        # pre-resized to long side imgsz, which skips decode + resize per epoch
        self.ims = [None] * len(self.im_files)
        self.im_meta = [None] * len(self.im_files)  # ((h0, w0), (h, w)) per cached image
        self.cache_mode = cache_images if cache_images in ("ram", "disk") else None
        if self.cache_mode:
            self._cache_images(self.cache_mode)

    def _cache_images(self, mode):
        """Pre-decode every image into RAM (after a fit check) or .npy files."""
        n = len(self.im_files)
        if mode == "ram":
            est = 0  # bytes, estimated from a sample (reference check_cache_ram)
            for i in np.random.default_rng(0).choice(n, min(8, n), replace=False):
                im = image_ops.imread(self.im_files[int(i)])
                r = self.imgsz / max(im.shape[:2])
                est += im.nbytes * min(r, 1.0) ** 2
            need = est * n / min(8, n) * 1.1
            try:
                avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            except (ValueError, OSError):
                avail = float("inf")
            if need > avail * 0.8:
                LOGGER.warning(f"image cache needs ~{need / 1e9:.1f}GB RAM but only {avail / 1e9:.1f}GB "
                               "available — not caching")
                self.cache_mode = None
                return
        nbytes = 0
        for i in range(n):
            npy = Path(self.im_files[i]).with_suffix(".npy")
            if mode == "disk":
                if not npy.exists():
                    np.save(str(npy), self._read_resize(i)[0])
                nbytes += npy.stat().st_size
            else:
                self.ims[i], hw0, hw = self._read_resize(i)
                self.im_meta[i] = (hw0, hw)
                nbytes += self.ims[i].nbytes
        LOGGER.info(f"cached {n} images to {mode} ({nbytes / 1e9:.2f}GB)")

    def _read_resize(self, i):
        """Decode + pre-resize one image so the long side is imgsz."""
        im = image_ops.imread(self.im_files[i])  # BGR
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            size = (math.ceil(w0 * r), math.ceil(h0 * r))
            im = image_ops.resize_linear(im, size) if (self.augment or r > 1) else image_ops.resize_area(im, size)
        return im, (h0, w0), im.shape[:2]

    def _load_or_build_cache(self, cache_path, num_cls):
        key = _paths_hash(self.im_files + self.label_files)
        if cache_path.is_file():
            try:
                z = np.load(cache_path, allow_pickle=True)
                if str(z["version"]) == CACHE_VERSION and str(z["hash"]) == key:
                    # the corrupt-filtered file list too: labels and im_files stay index-aligned
                    self.im_files = [str(f) for f in z["im_files"]]
                    self.label_files = img2label_paths(self.im_files)
                    return list(z["labels"]), z["shapes"]
            except Exception:  # noqa: BLE001
                pass
        labels, shapes, keep, msgs = [], [], [], []
        for im_f, lb_f in zip(self.im_files, self.label_files):
            lb, shape, msg = verify_image_label(im_f, lb_f, num_cls)
            if msg:
                msgs.append(msg)
                continue
            labels.append(lb)
            shapes.append(shape)
            keep.append(im_f)
        if msgs:
            LOGGER.warning("\n".join(msgs[:10]) + (f"\n... {len(msgs)} total" if len(msgs) > 10 else ""))
        self.im_files = keep
        self.label_files = img2label_paths(keep)
        try:
            np.savez(cache_path.with_suffix(""), version=CACHE_VERSION, hash=key,
                     labels=np.array(labels, dtype=object), shapes=np.array(shapes, dtype=np.float64),
                     im_files=np.array(keep))
        except OSError as e:
            LOGGER.warning(f"cache not saved to {cache_path}: {e}")
        return labels, np.array(shapes, dtype=np.float64)

    def __len__(self):
        return len(self.im_files)

    def load_image(self, i):
        """Load + pre-resize so the long side is imgsz (reference dataloaders.py:736-754),
        from the RAM/disk image cache when it holds the image."""
        if self.ims[i] is not None:
            hw0, hw = self.im_meta[i]
            return self.ims[i], hw0, hw
        if self.cache_mode == "disk":
            npy = Path(self.im_files[i]).with_suffix(".npy")
            if npy.exists():
                im = np.load(str(npy))
                h0w0 = tuple(int(v) for v in self.shapes[i][::-1])  # shapes is (w, h)
                return im, h0w0, im.shape[:2]
        return self._read_resize(i)

    def __getitem__(self, index):
        """Returns (img HWC RGB uint8, labels (n,5) cls+xywhn, shapes_meta)."""
        hyp, rng = self.hyp, self.rng
        if self.mosaic and rng.random() < hyp.get("mosaic", 1.0):
            img, labels = self._get_mosaic(index)
            shapes_meta = None
            if rng.random() < hyp.get("mixup", 0.0):
                img2, labels2 = self._get_mosaic(rng.randint(0, len(self) - 1))
                img, labels = mixup(img, labels, img2, labels2, np_rng=self.np_rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = self.batch_shapes[self.batch_index[index]] if self.rect else (self.imgsz, self.imgsz)
            img, ratio, pad = letterbox(img, tuple(shape), auto=False, scaleup=self.augment)
            shapes_meta = (h0, w0), ((h / h0, w / w0), pad)
            labels = self.labels[index].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], ratio[0] * w, ratio[1] * h, pad[0], pad[1])
            if self.augment:
                img, labels = random_perspective(
                    img,
                    labels,
                    degrees=hyp.get("degrees", 0.0),
                    translate=hyp.get("translate", 0.1),
                    scale=hyp.get("scale", 0.5),
                    shear=hyp.get("shear", 0.0),
                    perspective=hyp.get("perspective", 0.0),
                    rng=rng,
                )

        nl = len(labels)
        if nl:
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], w=img.shape[1], h=img.shape[0], clip=True, eps=1e-3)

        if self.augment:
            if self.albumentations is not None:
                img, labels = self.albumentations(img, labels, rng=rng)
                nl = len(labels)
            augment_hsv(img, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4),
                        np_rng=self.np_rng)
            if rng.random() < hyp.get("flipud", 0.0):
                img = np.flipud(img)
                if nl:
                    labels[:, 2] = 1 - labels[:, 2]
            if rng.random() < hyp.get("fliplr", 0.5):
                img = np.fliplr(img)
                if nl:
                    labels[:, 1] = 1 - labels[:, 1]
            if hyp.get("cutout", 0.0) > 0:  # the reference ships cutout off (augmentations.py:243)
                img = np.ascontiguousarray(img)
                labels = cutout(img, labels, p=hyp["cutout"], rng=rng)
                nl = len(labels)

        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB, still HWC uint8
        return img, labels.astype(np.float32), shapes_meta

    def _get_mosaic(self, index):
        rng = self.rng
        idxs = [index] + [int(self.indices[rng.randrange(len(self.indices))]) for _ in range(3)]
        rng.shuffle(idxs)
        images, lbls = [], []
        for i in idxs:
            images.append(self.load_image(i)[0])
            lbls.append(self.labels[i])
        return mosaic4(images, lbls, self.imgsz, self.mosaic_border, self.hyp, rng=rng)


def label_bucket(n, max_labels, floor=32):
    """Smallest power-of-two bucket >= n (floored at `floor`, capped at
    max_labels): the label dimension of a batch sized to its data, from a
    handful of distinct widths."""
    if n >= max_labels:
        return max_labels
    m = floor
    while m < n:
        m *= 2
    return min(m, max_labels)


def collate_fixed(samples, max_labels=300, bucket=False, floor=32):
    """Stack samples into fixed-shape arrays: (B,H,W,3) u8, (B,M,5) f32, (B,M) bool.

    With bucket=True, M is the smallest power-of-two bucket covering this
    batch's largest label count instead of max_labels."""
    imgs = np.stack([s[0] for s in samples])
    B = len(samples)
    M = label_bucket(max(len(s[1]) for s in samples), max_labels, floor) if bucket else max_labels
    targets = np.zeros((B, M, 5), np.float32)
    mask = np.zeros((B, M), bool)
    for b, s in enumerate(samples):
        lb = s[1][:M]
        targets[b, : len(lb)] = lb
        mask[b, : len(lb)] = True
    shapes = [s[2] for s in samples]
    return imgs, targets, mask, shapes


def collate_quad(samples, max_labels=300, bucket=False, floor=32):
    """Quad collate (reference collate_fn4, dataloaders.py:832-858): each
    group of 4 samples stitched 2x2 into one image of twice the side, with
    the labels merged."""
    assert len(samples) % 4 == 0, "quad collate needs a batch divisible by 4"
    s = samples[0][0].shape[0]
    out = []
    for g in range(len(samples) // 4):
        quad = samples[g * 4 : (g + 1) * 4]
        im = np.zeros((2 * s, 2 * s, 3), np.uint8)
        lbs = []
        for j, (img, lb, _) in enumerate(quad):
            y0, x0 = (j // 2) * s, (j % 2) * s
            im[y0 : y0 + s, x0 : x0 + s] = img
            if len(lb):
                lb = lb.copy()
                lb[:, 1] = (lb[:, 1] + (j % 2)) / 2
                lb[:, 2] = (lb[:, 2] + (j // 2)) / 2
                lb[:, 3:5] /= 2
                lbs.append(lb)
        lbs = np.concatenate(lbs, 0) if lbs else np.zeros((0, 5), np.float32)
        out.append((im, lbs.astype(np.float32), quad[0][2]))
    return collate_fixed(out, max_labels, bucket=bucket, floor=floor)


class DataLoader:
    """Iterable loader with background prefetch: a producer thread collates
    batches into a queue `prefetch` deep; with `workers` > 1 the samples are
    made on a thread pool (the host ops release the GIL)."""

    def __init__(self, dataset, batch_size=16, shuffle=False, max_labels=300, seed=0, drop_last=False,
                 prefetch=2, quad=False, workers=1, label_buckets=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_labels = max_labels
        # pad the label dim to a per-batch power-of-two bucket instead of max_labels
        self.label_buckets = label_buckets
        self._label_hwm = 32  # monotone bucket floor (see __iter__)
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last or quad  # quad needs groups of 4
        self.prefetch = prefetch
        self.quad = quad
        self.workers = max(int(workers), 1)
        self._indices_override = None
        self._ms_sizes = None
        self.ms_offset = 0
        self._host_shard = (0, 1)  # (rank, world) of shard_per_host
        if quad:
            assert batch_size % 4 == 0, "--quad requires batch size divisible by 4"

    def __len__(self):
        n = len(self.dataset)
        nb = n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)
        # sharded: the count common to every rank (see _batches)
        return nb // self._host_shard[1]

    def set_indices(self, indices):
        """Override the sampling order of the next epoch (image-weights resampling)."""
        self._indices_override = np.asarray(indices)

    def set_multi_scale(self, sizes, seed=0, period=10):
        """Resize each batch square to a size drawn from `sizes`, in the
        workers. A new size every `period` batches; `ms_offset` (set by the
        trainer to the epoch's first global step) anchors the draws, so they
        are the same after a resume. Labels are normalised xywh: a square
        resize leaves them unchanged."""
        self._ms_sizes = [int(s) for s in sizes]
        self._ms_seed = int(seed)
        self._ms_period = max(int(period), 1)
        self.ms_offset = 0

    def _ms_for(self, nb):
        if not self._ms_sizes:
            return None
        step = int(self.ms_offset) + nb
        g = np.random.default_rng(self._ms_seed + step - step % self._ms_period)
        return int(g.choice(self._ms_sizes))

    def _get_sample(self, i, ms):
        sample = self.dataset[i]
        if ms is None or (sample[0].shape[0] == ms and sample[0].shape[1] == ms):
            return sample
        return (image_ops.resize_linear(sample[0], (ms, ms)), *sample[1:])

    def shard_per_host(self):
        """Restrict the batches to this rank's of the process group:
        round-robin batches, b = rank, rank + world, ..., so a rect
        dataset's batch-shape groups stay whole and balanced, over the count
        common to every rank (each step needs every rank). Label buckets
        must be off: every rank pads its labels alike."""
        from yolov3_tpu_torch.parallel import mesh

        self._host_shard = (mesh.rank(), mesh.world_size())
        return self

    def _batches(self):
        idx = self._indices_override
        if idx is None:
            idx = np.arange(len(self.dataset))
            if self.shuffle and not getattr(self.dataset, "rect", False):
                self.rng.shuffle(idx)
        else:
            self._indices_override = None
        n_batches = len(idx) // self.batch_size if self.drop_last else math.ceil(len(idx) / self.batch_size)
        i0, nh = self._host_shard
        n_batches = (n_batches // nh) * nh
        for b in range(i0, n_batches, nh):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self):
        import queue

        q = queue.Queue(maxsize=self.prefetch)
        stop = object()
        base = collate_quad if self.quad else collate_fixed
        if self.label_buckets:
            # high-water-mark floor: once a wider bucket is seen, stay there
            def collate(samples, max_labels):
                out = base(samples, max_labels, bucket=True, floor=self._label_hwm)
                self._label_hwm = max(self._label_hwm, out[1].shape[1])
                return out
        else:
            collate = base

        def produce():
            try:
                if self.workers > 1:
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(self.workers) as pool:
                        pending = []
                        for nb, batch_idx in enumerate(self._batches()):
                            ms = self._ms_for(nb)
                            pending.append([pool.submit(self._get_sample, i, ms) for i in batch_idx])
                            while len(pending) > self.prefetch:  # `prefetch` batches in flight beyond the queue
                                q.put(collate([f.result() for f in pending.pop(0)], self.max_labels))
                        for futs in pending:
                            q.put(collate([f.result() for f in futs], self.max_labels))
                else:
                    for nb, batch_idx in enumerate(self._batches()):
                        ms = self._ms_for(nb)
                        q.put(collate([self._get_sample(i, ms) for i in batch_idx], self.max_labels))
            except BaseException as e:  # noqa: BLE001 — a dead producer fails the epoch, not truncates it
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

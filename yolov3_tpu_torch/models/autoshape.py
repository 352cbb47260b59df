"""AutoShape and Detections: the "pass anything" inference API
(yolov3_tpu/models/autoshape.py, reference models/common.py:771-1029).

AutoShape takes file names, URLs, numpy arrays (RGB HWC), objects with
`.convert` (PIL images, by duck typing: PIL is never imported), or a list
of them; letterboxes them to a stride multiple; runs the BN-folded forward
(bf16 on the card, float32 on the CPU), the decode and `batched_nms` (the
NMS kernel on the card); and returns `Detections` with xyxy / xywh views
(pixels and normalised), crop / save / render and per-stage times. Images
and crops are saved as PNG.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox
from yolov3_tpu_torch.ops.boxes import scale_boxes, xyxy2xywh
from yolov3_tpu_torch.ops.nms import batched_nms
from yolov3_tpu_torch.utils.general import LOGGER, Profile, increment_path
from yolov3_tpu_torch.utils.plots import Annotator, colors, save_one_box


class AutoShape:
    """Input-robust wrapper around a DetectionModel or an Ensemble."""

    conf = 0.25
    iou = 0.45
    agnostic = False
    multi_label = False
    classes = None
    max_det = 1000

    def __init__(self, model):
        from yolov3_tpu_torch.models.detection import optimize_for_inference
        from yolov3_tpu_torch.models.ensemble import Ensemble

        if isinstance(model, Ensemble):
            model = Ensemble([optimize_for_inference(m) for m in model.models])
        elif hasattr(model, "fuse"):
            model = optimize_for_inference(model)
        self.model = model
        self.names = model.names
        self.stride = int(model.stride)

    @torch.inference_mode()
    def _infer(self, batch):
        device = self.model.device
        x = torch.as_tensor(batch).to(device).float() / 255.0
        pred = self.model.predict(x)
        return batched_nms(pred, conf_thres=self.conf, iou_thres=self.iou,
                           classes=tuple(self.classes) if self.classes else None, agnostic=self.agnostic,
                           multi_label=self.multi_label, max_det=self.max_det, max_nms=8192)

    def __call__(self, ims, size=640):
        """Run inference on one input or a list of them; returns Detections."""
        device = self.model.device
        dt = (Profile(device=device), Profile(device=device), Profile(device=device))
        with dt[0]:
            ims_list = ims if isinstance(ims, (list, tuple)) else [ims]
            loaded, files, shape0 = [], [], []
            for i, im in enumerate(ims_list):
                f = f"image{i}"
                if isinstance(im, (str, Path)):
                    f = str(im)
                    im = _imread_any(im)
                elif hasattr(im, "convert"):  # PIL
                    f = getattr(im, "filename", f) or f
                    im = np.asarray(im.convert("RGB"))
                im = np.asarray(im)
                if im.ndim == 2:
                    im = np.stack([im] * 3, -1)
                if im.shape[0] < 5 and im.ndim == 3:  # CHW -> HWC
                    im = im.transpose(1, 2, 0)
                im = im[..., :3]
                files.append(Path(Path(f).name or f"image{i}").with_suffix(".png").name)
                shape0.append(im.shape[:2])
                loaded.append(im)
            target = int(np.ceil(size / self.stride) * self.stride)
            batch = np.stack(
                [letterbox(np.ascontiguousarray(im[:, :, ::-1]), (target, target), auto=False)[0][:, :, ::-1]
                 for im in loaded])

        with dt[1]:
            dets, n_valid = self._infer(np.ascontiguousarray(batch))
            n_valid = n_valid.cpu().numpy()
            dets = dets.cpu().numpy()

        with dt[2]:
            preds = []
            for i in range(len(loaded)):
                p = dets[i, : n_valid[i]].copy()
                if len(p):
                    p[:, :4] = np.asarray(scale_boxes((target, target), p[:, :4], shape0[i]))
                preds.append(p)

        return Detections(loaded, preds, files, [d.t * 1e3 for d in dt], self.names, batch.shape)


def _imread_any(path):
    """An RGB image from a path or URL (a URL is fetched with urllib, so it fails offline)."""
    p = str(path)
    if p.startswith("http"):
        import urllib.request

        with urllib.request.urlopen(p) as r:
            data = r.read()
        return image_ops.imdecode(data, p)[:, :, ::-1]
    return image_ops.imread(p)[:, :, ::-1]  # BGR -> RGB


class Detections:
    """Inference results (reference common.py:881-1029)."""

    def __init__(self, ims, preds, files, times=(0, 0, 0), names=None, shape=None):
        self.ims = ims  # RGB numpy images
        self.pred = preds  # list of (n, 6) [xyxy, conf, cls]
        self.files = files
        self.names = names or {}
        self.times = times
        self.n = len(ims)
        self.t = tuple(t / max(self.n, 1) for t in times)
        self.s = shape

    @property
    def xyxy(self):
        return self.pred

    @property
    def xywh(self):
        return [np.concatenate([xyxy2xywh(p[:, :4]), p[:, 4:]], 1) if len(p) else p for p in self.pred]

    @property
    def xyxyn(self):
        out = []
        for p, im in zip(self.pred, self.ims):
            g = np.array([im.shape[1], im.shape[0], im.shape[1], im.shape[0], 1, 1])
            out.append(p / g if len(p) else p)
        return out

    @property
    def xywhn(self):
        out = []
        for p, im in zip(self.xywh, self.ims):
            g = np.array([im.shape[1], im.shape[0], im.shape[1], im.shape[0], 1, 1])
            out.append(p / g if len(p) else p)
        return out

    def pandas(self):
        """A namespace of DataFrames keyed by box format (needs pandas)."""
        import types

        try:
            import pandas as pd
        except ImportError:
            raise RuntimeError("Detections.pandas() needs the 'pandas' package, which is not installed") from None
        cols = ["xmin", "ymin", "xmax", "ymax", "confidence", "class"]
        cwh = ["xcenter", "ycenter", "width", "height", "confidence", "class"]
        out = types.SimpleNamespace()
        for attr, c in (("xyxy", cols), ("xyxyn", cols), ("xywh", cwh), ("xywhn", cwh)):
            dfs = []
            for p in getattr(self, attr):
                df = pd.DataFrame(np.asarray(p, np.float64), columns=c)
                df["name"] = [self.names.get(int(x), str(int(x))) for x in df["class"]] if len(df) else []
                dfs.append(df)
            setattr(out, attr, dfs)
        return out

    def _run(self, pprint=False, show=False, save=False, crop=False, render=False, labels=True, save_dir=Path("")):
        s = ""
        crops = []
        for i, (im, pred) in enumerate(zip(self.ims, self.pred)):
            s += f"\nimage {i + 1}/{self.n}: {im.shape[0]}x{im.shape[1]} "
            if len(pred):
                for c in np.unique(pred[:, 5]):
                    n = int((pred[:, 5] == c).sum())
                    s += f"{n} {self.names.get(int(c), int(c))}{'s' * (n > 1)}, "
                im_bgr = im[:, :, ::-1].copy()  # a copy: the image read from a path is a view of a BGR array
                annotator = Annotator(im_bgr)
                for *box, conf, cls in reversed(pred.tolist()):
                    label = f"{self.names.get(int(cls), int(cls))} {conf:.2f}"
                    if crop:
                        crops.append({"box": box, "conf": conf, "cls": cls, "label": label,
                                      "im": save_one_box(box, im_bgr, file=save_dir / "crops" / f"{self.files[i]}",
                                                         save=save)})
                    else:
                        annotator.box_label(box, label if labels else "", color=colors(cls, True))
                result = annotator.result()[:, :, ::-1]
            else:
                s += "(no detections)"
                result = im
            if render:
                self.ims[i] = result
            if show:
                LOGGER.warning("Detections.show() needs a display; use save() or render()")
            if save:
                save_dir.mkdir(parents=True, exist_ok=True)
                image_ops.imwrite_png(save_dir / Path(self.files[i]).with_suffix(".png").name,
                                      np.ascontiguousarray(result[:, :, ::-1]))
        if pprint:
            s += f"\nSpeed: {self.t[0]:.1f}ms pre, {self.t[1]:.1f}ms inference, {self.t[2]:.1f}ms post per image"
            LOGGER.info(s)
        return crops if crop else self

    def print(self):
        return self._run(pprint=True)

    def show(self, labels=True):
        return self._run(show=True, labels=labels)

    def save(self, labels=True, save_dir="runs/detect/exp", exist_ok=False):
        return self._run(save=True, labels=labels, save_dir=increment_path(save_dir, exist_ok, mkdir=True))

    def crop(self, save=True, save_dir="runs/detect/exp", exist_ok=False):
        return self._run(crop=True, save=save, save_dir=increment_path(save_dir, exist_ok, mkdir=True))

    def render(self, labels=True):
        self._run(render=True, labels=labels)
        return self.ims

    def tolist(self):
        """A list of single-image Detections."""
        return [Detections([self.ims[i]], [self.pred[i]], [self.files[i]], self.times, self.names, self.s)
                for i in range(self.n)]

    def __len__(self):
        return self.n

    def __repr__(self):
        self.print()
        return f"Detections(n={self.n})"

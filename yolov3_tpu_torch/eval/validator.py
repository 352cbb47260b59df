"""Validation engine: mAP of a DetectionModel over labelled batches
(yolov3_tpu/eval/validator.py, reference val.py:192-489).

Per batch, on the card: the float32 eval forward (or, with `half=True`, the
BN-folded bf16 model), `decode_predictions`, and the val-grade multi-label
`batched_nms` (conf 0.001, iou 0.6, max_det 300, max_nms 30000), whose
greedy suppression is the NMS kernel (csrc/nms.cu, at K = 30000 its
global-memory form). Then the counts, and only the valid prefix of the
detections, come to the host, where matching and AP run in numpy exactly as
in the JAX package (process_batch at 10 IoUs 0.5:0.95, ap_per_class with
101-point COCO integration). With `save_hybrid=True` the forward only
decodes, and each batch's labels join the predictions as candidates of
confidence 1 before the host-facing `non_max_suppression` (still the NMS
kernel on the card).

    from yolov3_tpu_torch.eval import validator
    (mp, mr, map50, map_, *losses), maps, speeds = validator.run(model=model, dataloader=batches)

`dataloader` is any iterable of (imgs (B, H, W, 3) uint8, targets (B, M, 5)
f32 [cls, xywh normalised], mask (B, M) bool, shapes) batches, the layout of
data.datasets.DataLoader; `shapes[i]` is None or ((h0, w0), ratio_pad).
Without one, `run` builds the loader of `data` (a dataset YAML or dict) as
the JAX validator does: the `task` split, letterboxed to imgsz, rect
batches with pad 0.5.

Spans (utils/tracing.py), a batch each: `val/copy_in`, `val/forward`,
`val/decode`, `val/nms` (the multi-label `batched_nms`, the NMS kernel),
`val/fetch` (the counts and the valid prefix to the host) and `val/match`
(the per-image host loop: scale-back, matching, callbacks); once a run,
`val/map` (the aggregation, `ap_per_class` included). `speeds` stay the
`Profile` times of the pre, inference+NMS and post stages.

With `plots=True` (as the JAX validator; utils/plots.py) it writes to
save_dir the label and prediction mosaics of the first three batches
(val_batch{i}_labels.jpg / _pred.jpg), the PR, F1, P and R curves where a
detection is right, and the confusion matrix.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from yolov3_tpu_torch.data.dataset_yaml import check_dataset
from yolov3_tpu_torch.data.datasets import DataLoader, DetectionDataset
from yolov3_tpu_torch.eval.metrics import ConfusionMatrix, ap_per_class, process_batch
from yolov3_tpu_torch.models.detect_head import decode_predictions
from yolov3_tpu_torch.models.detection import DetectionModel, optimize_for_inference, predict_augmented
from yolov3_tpu_torch.ops.boxes import scale_boxes, xywh2xyxy, xyxy2xywh
from yolov3_tpu_torch.ops.nms import batched_nms, non_max_suppression
from yolov3_tpu_torch.train.loss import compute_loss
from yolov3_tpu_torch.utils.general import LOGGER, Profile, coco80_to_coco91_class
from yolov3_tpu_torch.utils.plots import plot_confusion_matrix, plot_images, plot_mc_curve, plot_pr_curve
from yolov3_tpu_torch.utils.tracing import span


def run(
    data=None,
    model=None,
    batch_size=32,
    imgsz=640,
    conf_thres=0.001,
    iou_thres=0.6,
    max_det=300,
    task="val",
    single_cls=False,
    verbose=False,
    save_json=False,
    save_dir=Path("."),
    dataloader=None,
    loss_cfg=None,
    compute_loss_flag=False,
    rect=True,
    max_nms=30000,
    names=None,
    save_txt=False,
    save_conf=False,
    half=False,
    workers=1,
    callbacks=None,
    nms_fn=None,
    augment=False,
    plots=False,
    save_hybrid=False,
    sharded=False,
):
    """Evaluate `model` (a yolov3_tpu_torch DetectionModel) on `dataloader`.

    data: a dataset YAML or dict (its `val` entry marks COCO for the class id
    map, its `path` holds annotations/instances_val2017.json for save_json's
    COCO eval), or None when `dataloader` is given. batch_size, imgsz, rect
    and workers shape the loader `run` builds when `dataloader` is None.
    save_txt/save_conf: per-image prediction txt in save_dir/labels; they and
    save_json and callbacks read file names from `dataloader.dataset.im_files`.
    half: the BN-folded bf16 model. nms_fn: the greedy suppression,
    `ops.nms_cuda.greedy_nms` (the kernel) by default.
    save_hybrid: hybrid autolabelling (reference val.py:374): the labels are
    injected as detections of confidence 1; the losses are not computed.
    augment: test-time augmentation (`models.detection.predict_augmented`).
    `model` may also be an `Ensemble` (models/ensemble.py), whose members'
    decoded predictions are concatenated before the NMS, or a `MultiBackend`
    (models/backend.py) over an exported artifact: both take the JAX
    validator's non-native path (square letterbox, no loss, no TTA, half
    off), the artifact's predictions going straight to the multi-label
    `batched_nms` on the backend's device.
    sharded: data-parallel validation of a DetectionModel over a
    parallel.mesh.Mesh (`sharded` itself, or with True every local card):
    a replica of the model on each device, each batch's rows split evenly,
    each device running its rows' forward, decode and NMS (the NMS kernel
    once a shard), the detections gathered on the model's device (the
    mesh's first); a batch the mesh does not divide runs unsharded, and the
    loss, where asked for, is the whole batch's, as in the JAX validator.
    plots: the mosaics, curves and confusion matrix (see the module docstring).

    Returns ((mp, mr, map50, map, *losses), per_class_maps, speeds_ms).
    """
    from yolov3_tpu_torch.models.backend import MultiBackend
    from yolov3_tpu_torch.models.ensemble import Ensemble

    if not isinstance(model, (DetectionModel, Ensemble, MultiBackend)):
        raise TypeError(f"validator.run: model is a {type(model).__name__}; it takes yolov3_tpu_torch's "
                        "DetectionModel, an Ensemble or a MultiBackend (exported artifacts)")
    if isinstance(model, MultiBackend) and model.has_nms:
        raise ValueError("validator.run: this artifact was exported with nms=True (serving NMS at conf 0.25); "
                         "validate an artifact exported without nms")
    native = isinstance(model, DetectionModel)
    if not native:
        rect, augment, half = False, False, False  # the JAX validator's non-native path
    if dataloader is None:
        if data is None:
            raise ValueError("validator.run needs `data` (a dataset YAML or dict) or a `dataloader`")
        data = check_dataset(data)
        names = names or data["names"]
        dataset = DetectionDataset(
            data.get(task) or data["val"], imgsz=imgsz, augment=False, rect=rect,
            stride=int(model.stride), pad=0.5 if rect else 0.0, batch_size=batch_size,
            num_cls=data["nc"], single_cls=single_cls,  # the dataset's classes; single_cls collapses them after
        )
        dataloader = DataLoader(dataset, batch_size=batch_size, shuffle=False, workers=workers)
    elif data is not None and not isinstance(data, dict):
        data = check_dataset(data)
    model_nc = len(model.names) if isinstance(model, MultiBackend) else model.spec.nc
    names = names or {i: str(i) for i in range(model_nc)}
    nc = 1 if single_cls else model_nc
    device = model.device

    iouv = np.linspace(0.5, 0.95, 10)
    niou = iouv.shape[0]

    if task == "speed":  # benchmark settings (reference val.py:605-609)
        conf_thres, save_json = 0.25, False
    nms_iou = 0.45 if task == "speed" else iou_thres
    with_loss = bool(compute_loss_flag and loss_cfg is not None and not save_hybrid and native)
    mesh = None
    if sharded and native:
        from yolov3_tpu_torch.parallel.mesh import Mesh, create_mesh

        mesh = sharded if isinstance(sharded, Mesh) else create_mesh()
    forward = make_forward(model, conf_thres, nms_iou, max_det, max_nms, loss_cfg=loss_cfg if with_loss else None,
                           half=half, nms_fn=nms_fn, decode_only=save_hybrid, augment=augment, mesh=mesh)

    stats = []
    loss_sum = np.zeros(3)
    n_batches = 0
    confusion = ConfusionMatrix(nc=nc) if plots else None
    if plots:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
    jdict = []
    # COCO80->91 category remap applies only to the real COCO dataset
    # (reference val.py:311,344); a custom dataset's class ids pass through
    _val_split = (data or {}).get("val")
    is_coco = isinstance(_val_split, str) and _val_split.replace("\\", "/").endswith("coco/val2017.txt")
    class_map = coco80_to_coco91_class() if is_coco else list(range(1000))
    dt = (Profile(device=device), Profile(device=device), Profile(device=device))
    seen = n_plotted = 0

    for imgs, targets, mask, shapes in dataloader:
        with dt[0], span("val/copy_in"):
            imgs_dev = torch.as_tensor(imgs).to(device)
        with dt[1]:
            if save_hybrid:  # apriori label injection -> host-facing NMS (reference val.py:374)
                hb, wb = imgs.shape[1:3]
                gain = np.array([wb, hb, wb, hb], np.float32)
                lb = [np.concatenate([t[:, 0:1], t[:, 1:5] * gain], 1) if len(t) else np.zeros((0, 5), np.float32)
                      for t in (targets[si][mask[si]] for si in range(imgs.shape[0]))]
                pred = forward(imgs_dev)
                with span("val/nms"):
                    dets_list = non_max_suppression(pred, conf_thres, nms_iou, multi_label=True, labels=lb,
                                                    max_det=max_det, max_nms=max_nms, device=device, nms_fn=nms_fn)
                n_valid = np.array([len(d) for d in dets_list])
                dets = np.zeros((imgs.shape[0], max_det, 6), np.float32)
                for si, d in enumerate(dets_list):
                    dets[si, : len(d)] = d
            elif with_loss:
                dets, n_valid, comps = forward(imgs_dev, targets, mask)
                dets, n_valid = _fetch_valid(dets, n_valid, max_det)
            else:
                dets, n_valid = forward(imgs_dev)
                dets, n_valid = _fetch_valid(dets, n_valid, max_det)
        if with_loss:
            loss_sum += comps.cpu().numpy()
            n_batches += 1
        if plots and n_plotted < 3:  # label and prediction mosaics (reference val.py:417-419)
            _plot_val_batch(imgs, targets, mask, dets, n_valid, n_plotted, Path(save_dir), names)
            n_plotted += 1

        with dt[2], span("val/match"):
            h, w = imgs.shape[1:3]
            for si in range(imgs.shape[0]):
                seen += 1
                pred = dets[si, : n_valid[si]].copy()  # (n, 6) xyxy conf cls in letterbox space
                lbls = targets[si][mask[si]]  # (m, 5) cls xywhn
                nl = len(lbls)
                shape_meta = shapes[si]

                # labels -> native-space xyxy
                if nl:
                    tbox = xywh2xyxy(lbls[:, 1:5] * np.array([w, h, w, h], np.float32))
                    if shape_meta is not None:
                        (h0, w0), ratio_pad = shape_meta
                        tbox = scale_boxes((h, w), tbox, (h0, w0), ratio_pad)
                    labelsn = np.concatenate([lbls[:, 0:1], tbox], 1)
                else:
                    labelsn = np.zeros((0, 5), np.float32)

                if len(pred):
                    if single_cls:
                        pred[:, 5] = 0
                    if shape_meta is not None:
                        (h0, w0), ratio_pad = shape_meta
                        pred[:, :4] = scale_boxes((h, w), pred[:, :4], (h0, w0), ratio_pad)
                    correct = process_batch(pred, labelsn, iouv)
                else:
                    correct = np.zeros((0, niou), bool)
                stats.append((correct, pred[:, 4] if len(pred) else np.zeros(0),
                              pred[:, 5] if len(pred) else np.zeros(0), labelsn[:, 0]))
                if confusion is not None:
                    confusion.process_batch(pred, labelsn)
                if callbacks is not None:
                    # per-image hook with native-space predictions + labels
                    # (reference val.py:414 on_val_image_end)
                    callbacks.run("on_val_image_end", predn=pred, path=dataloader.dataset.im_files[seen - 1],
                                  names=names, labelsn=labelsn)
                if save_txt:  # save_conf only modifies the txt format (reference val.py:410)
                    h0w0 = shape_meta[0] if shape_meta is not None else (h, w)
                    _save_one_txt(pred, Path(save_dir) / "labels",
                                  Path(dataloader.dataset.im_files[seen - 1]).stem, h0w0, save_conf)
                if save_json and len(pred):
                    _append_coco_json(jdict, pred, Path(dataloader.dataset.im_files[seen - 1]), class_map)

    # aggregate (the zero-batch and zero-TP paths must not crash)
    with span("val/map"):
        if stats:
            stats_cat = [np.concatenate([s[i] for s in stats], 0) for i in range(4)]
        else:
            stats_cat = [np.zeros((0, niou), bool), np.zeros(0), np.zeros(0), np.zeros(0)]
        p = r = ap50 = ap_mean = np.zeros(0)
        curves = None
        if len(stats_cat) and stats_cat[0].any():
            tp, fp, p, r, f1, ap, ap_class, *curves = ap_per_class(*stats_cat, curves=plots)
            ap50, ap_mean = ap[:, 0], ap.mean(1)
            mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap_mean.mean()
        else:
            mp = mr = map50 = map_ = 0.0
            ap_mean = np.zeros(nc)
            ap_class = np.array([], int)
    if plots and curves is not None:
        _plot_curves(*curves, ap, [str(names.get(int(c), c)) for c in ap_class], Path(save_dir))
    if plots:  # whenever plots=True, with or without a right detection (reference val.py confusion_matrix.plot)
        _plot_or_warn("confusion matrix", plot_confusion_matrix, confusion.matrix,
                      [str(names.get(i, i)) for i in range(nc)], Path(save_dir) / "confusion_matrix.png")

    nt = np.bincount(stats_cat[3].astype(int), minlength=nc) if len(stats_cat[3]) else np.zeros(nc)
    LOGGER.info(f"{'all':>12}{seen:>11}{int(nt.sum()):>11}{mp:>11.3g}{mr:>11.3g}{map50:>11.3g}{map_:>11.3g}")
    if verbose and nc > 1 and len(ap_class):
        for i, c in enumerate(ap_class):
            LOGGER.info(f"{str(names.get(int(c), c)):>12}{seen:>11}{int(nt[c]):>11}{p[i]:>11.3g}{r[i]:>11.3g}"
                        f"{ap50[i]:>11.3g}{ap_mean[i]:>11.3g}")

    speeds = tuple(x.t / max(seen, 1) * 1e3 for x in dt)  # ms per image
    LOGGER.info(f"Speed: {speeds[0]:.1f}ms pre, {speeds[1]:.1f}ms inference+NMS, {speeds[2]:.1f}ms post per image")

    if save_json and jdict:
        pred_json = Path(save_dir) / "predictions.json"
        pred_json.parent.mkdir(parents=True, exist_ok=True)
        with open(pred_json, "w") as f:
            json.dump(jdict, f)
        LOGGER.info(f"COCO JSON saved to {pred_json}")
        try:
            map_, map50 = _coco_eval(pred_json, data)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"COCO eval not run: {e}")

    losses = tuple(loss_sum / max(n_batches, 1))
    maps = np.zeros(nc) + map_
    for i, c in enumerate(ap_class):
        maps[int(c)] = ap_mean[i]
    return (mp, mr, map50, map_, *losses), maps, speeds


def make_forward(model, conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000, loss_cfg=None, half=False,
                 nms_fn=None, decode_only=False, augment=False, mesh=None):
    """The per-batch device program of `run` (the JAX package's
    `_cached_forward`): uint8 (B, H, W, 3) images on the model's device ->
    (dets (B, max_det, 6), n (B,)), plus the loss components (3,) when
    `loss_cfg` is given (called with targets and mask then).

    The float32 eval forward, or with half=True the BN-folded bf16 model of
    `optimize_for_inference`; `decode_predictions` with the model's
    `anchor_table()` (augment=True: the TTA passes of `predict_augmented`);
    multi-label `batched_nms` through `nms_fn`.
    decode_only: return the decoded predictions (B, N, 5+nc) and stop there.
    mesh: a parallel.mesh.Mesh to shard each batch over (see `run`).
    An Ensemble's or a MultiBackend's decoded predictions come from calling it
    (a MultiBackend of an artifact exported with NMS cannot serve: its NMS is not
    the val-grade one)."""
    from yolov3_tpu_torch.models.backend import MultiBackend
    from yolov3_tpu_torch.models.ensemble import Ensemble

    if isinstance(model, (Ensemble, MultiBackend)):

        @torch.inference_mode()
        def forward_decoded(imgs_u8):
            with span("val/forward"):
                pred = model(imgs_u8)
            if decode_only:
                return pred
            with span("val/nms"):
                return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres, multi_label=True,
                                   max_det=max_det, max_nms=max_nms, nms_fn=nms_fn)

        return forward_decoded
    net = optimize_for_inference(model, bf16=True) if half else model
    strides = model.spec.strides

    def one(net_i, imgs_u8):
        """The forward, the decode and the NMS of one replica on its device:
        pred, or (dets, n_valid, *feats) (feats only where the loss is asked for)."""
        was_training = net_i.training
        net_i.eval()
        try:
            with span("val/forward"):
                x = torch.as_tensor(imgs_u8).to(next(net_i.parameters()).device).float() / 255.0
                if augment and loss_cfg is None:  # with the loss, the JAX validator runs the plain forward
                    feats, pred = None, predict_augmented(net_i, x)  # the TTA passes decode too
                else:
                    feats = net_i(x)
            if feats is not None:
                with span("val/decode"):
                    pred = decode_predictions(feats, net_i.anchor_table(), strides)
            if decode_only:
                return pred
            with span("val/nms"):
                dets, n_valid = batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres, multi_label=True,
                                            max_det=max_det, max_nms=max_nms, nms_fn=nms_fn)
            return (dets, n_valid) if loss_cfg is None else (dets, n_valid, *feats)
        finally:
            net_i.train(was_training)

    nets = mesh.replicas(net) if mesh is not None else None

    @torch.inference_mode()
    def forward(imgs_u8, targets=None, tmask=None):
        if mesh is None:
            out = one(net, torch.as_tensor(imgs_u8, device=model.device))
        else:
            out = mesh.apply(lambda i, x: one(nets[i], x), imgs_u8)
        if decode_only or loss_cfg is None:
            return out
        dets, n_valid, *feats = out
        _, comps = compute_loss(feats, targets, tmask, loss_cfg)  # the whole batch's loss
        return dets, n_valid, comps

    return forward


@span("val/fetch")
def _fetch_valid(dets, n_valid, max_det):
    """n-first device fetch: the counts, then only the valid score-sorted
    prefix dets[:, :n.max()]; every consumer reads dets[si, :n_valid[si]],
    so the max_det tail is zero padding."""
    n_valid = n_valid.cpu().numpy()
    return dets[:, : min(int(n_valid.max(initial=0)), max_det)].cpu().numpy(), n_valid


def _plot_or_warn(what, fn, *args, **kwargs):
    """fn(*args, **kwargs); a failure logs a warning and the validation goes on."""
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — a plot never stops a validation run
        LOGGER.warning(f"{what} plot failed: {e!r}")


def _plot_curves(curves, ap, cls_names, save_dir):
    """PR_curve.png, F1_curve.png, P_curve.png and R_curve.png from ap_per_class's curves."""
    px, py, p_curve, r_curve, f1_curve = curves
    n = len(cls_names)
    _plot_or_warn("PR curve", plot_pr_curve, px, py, ap, save_dir / "PR_curve.png", cls_names)
    for name, curve, ylabel in (("F1", f1_curve, "F1"), ("P", p_curve, "Precision"), ("R", r_curve, "Recall")):
        _plot_or_warn(f"{name} curve", plot_mc_curve, px, curve[:n], save_dir / f"{name}_curve.png", cls_names,
                      ylabel=ylabel)


def _plot_val_batch(imgs, targets, mask, dets, n_valid, bi, save_dir, names, conf=0.25, max_boxes=15):
    """val_batch{bi}_labels.jpg (the labels) and val_batch{bi}_pred.jpg (up to
    `max_boxes` detections above `conf` an image) of one batch (reference val.py:417-419)."""
    names = {int(k): v for k, v in dict(names).items()} if names else None
    _plot_or_warn("val batch labels", plot_images, imgs, targets, masks=mask,
                  fname=save_dir / f"val_batch{bi}_labels.jpg", names=names)
    h, w = imgs.shape[1:3]
    pt = np.zeros((imgs.shape[0], max_boxes, 5), np.float32)
    pm = np.zeros((imgs.shape[0], max_boxes), bool)
    for si in range(imgs.shape[0]):
        d = dets[si, : n_valid[si]]
        d = d[d[:, 4] > conf][:max_boxes]  # letterbox-space xyxy conf cls
        if len(d):
            pt[si, : len(d), 0] = d[:, 5]
            pt[si, : len(d), 1] = (d[:, 0] + d[:, 2]) / 2 / w
            pt[si, : len(d), 2] = (d[:, 1] + d[:, 3]) / 2 / h
            pt[si, : len(d), 3] = (d[:, 2] - d[:, 0]) / w
            pt[si, : len(d), 4] = (d[:, 3] - d[:, 1]) / h
            pm[si, : len(d)] = True
    _plot_or_warn("val batch predictions", plot_images, imgs, pt, masks=pm,
                  fname=save_dir / f"val_batch{bi}_pred.jpg", names=names)


def _save_one_txt(pred, labels_dir, stem, h0w0, save_conf):
    """Write one image's predictions as `cls xc yc w h [conf]` normalized to
    the native image (reference val.py:94-103 save_one_txt)."""
    labels_dir.mkdir(parents=True, exist_ok=True)
    gn = np.array([h0w0[1], h0w0[0], h0w0[1], h0w0[0]], np.float32)
    lines = []
    for row in pred:  # native-space xyxy conf cls
        xywh = xyxy2xywh(row[None, :4])[0] / gn
        vals = (int(row[5]), *xywh, row[4]) if save_conf else (int(row[5]), *xywh)
        lines.append(" ".join(f"{v:.6g}" for v in vals))
    (labels_dir / f"{stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))


def _append_coco_json(jdict, pred, path, class_map):
    """Accumulate COCO-format detections: xywh top-left boxes (reference val.py:106-144)."""
    image_id = int(path.stem) if path.stem.isnumeric() else path.stem
    box = pred[:, :4].copy()
    box[:, 2:] -= box[:, :2]  # xyxy -> xywh
    for p, b in zip(pred.tolist(), box.tolist()):
        jdict.append(
            {
                "image_id": image_id,
                "category_id": class_map[int(p[5])],
                "bbox": [round(x, 3) for x in b],
                "score": round(p[4], 5),
            }
        )


def _coco_eval(pred_json, data):
    """COCO-JSON eval through the port's own pycocotools-semantics evaluator
    (eval/cocoeval.py). Returns (mAP50-95, mAP50)."""
    from yolov3_tpu_torch.eval.cocoeval import evaluate_coco_json

    anno_json = str(Path(data["path"]) / "annotations" / "instances_val2017.json")
    return evaluate_coco_json(anno_json, str(pred_json))

"""Detection CLI (yolov3_tpu/cli/detect.py, reference detect.py:67-286).

    python -m yolov3_tpu_torch.cli.detect --weights yolov3.pt --source path/to/images
    python -m yolov3_tpu_torch.cli.detect --weights runs/train/exp/weights/best --device cpu

`--weights`: a port checkpoint directory, a reference `.pt`, or a cfg name
(seeded random weights); several make a concat-NMS Ensemble. `--source`: an
image file, a directory, a glob, a `.txt` list, a video file, a webcam id /
stream URL (cv2 needed) or `screen` (mss needed); the default is the
package's two sample images. `--device` unset means the card (and raises
without one); `--device cpu` runs on the CPU.

Per image: decode (data/image_ops.py, JPEG included) -> letterbox -> the
BN-folded forward (bf16 on the card, float32 on the CPU; --half forces
bf16) -> decode -> `batched_nms` (the NMS kernel on the card, max_nms
8192) -> boxes scaled to the image -> Annotator -> the annotated image
(`<stem>.png`), labels (`labels/<stem>.txt`) and crops
(`crops/<class>/<stem>.png`). The JAX package writes `<name>.jpg`; the port
writes PNG until it has a JPEG encoder (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolov3_tpu_torch.data.datasets import IMG_FORMATS
from yolov3_tpu_torch.data.loaders import VID_FORMATS, LoadImages, LoadScreenshots, LoadStreams
from yolov3_tpu_torch.ops.boxes import scale_boxes, xyxy2xywh
from yolov3_tpu_torch.ops.nms import batched_nms
from yolov3_tpu_torch.utils.general import LOGGER, Profile, check_img_size, increment_path, print_args
from yolov3_tpu_torch.utils.plots import Annotator, colors, save_one_box

DEFAULT_SOURCE = str(Path(__file__).resolve().parents[1] / "data" / "images")
EXPORTED = {".stablehlo": "stablehlo", ".tflite": "tflite", ".onnx": "onnx"}


def exported_format(weights):
    """The exported-artifact format of `weights` (the JAX MultiBackend's sniff), or None."""
    p = Path(str(weights))
    if p.is_dir() and str(p).endswith("_savedmodel"):
        return "savedmodel"
    return EXPORTED.get(p.suffix)


def run(
    weights="yolov3-tiny",
    source=DEFAULT_SOURCE,
    data=None,
    imgsz=(640, 640),
    conf_thres=0.25,
    iou_thres=0.45,
    max_det=1000,
    view_img=False,
    save_txt=False,
    save_conf=False,
    save_crop=False,
    nosave=False,
    classes=None,
    agnostic_nms=False,
    augment=False,
    visualize=False,
    project="runs/detect",
    name="exp",
    exist_ok=False,
    line_thickness=3,
    hide_labels=False,
    hide_conf=False,
    vid_stride=1,
    update=False,
    half=None,
    device=None,
):
    """Run detection over a source; returns the save_dir. device=None means
    "cuda" (and raises without one). `run.speed_ms` holds the last run's
    pre / inference / NMS / post milliseconds per image."""
    from yolov3_tpu_torch.models.detection import optimize_for_inference
    from yolov3_tpu_torch.models.ensemble import attempt_load
    from yolov3_tpu_torch.models.loading import load_weights

    if visualize:
        raise NotImplementedError("--visualize (feature-map plots) is not ported yet (ROADMAP.md queue 1 item 5)")
    source = str(source)
    save_img = not nosave and not source.endswith(".txt")
    is_file = Path(source).suffix[1:].lower() in (IMG_FORMATS + VID_FORMATS)
    is_url = source.lower().startswith(("rtsp://", "rtmp://", "http://", "https://"))
    webcam = source.isnumeric() or source.endswith(".streams") or (is_url and not is_file)
    screenshot = source.lower().startswith("screen")

    if isinstance(weights, (list, tuple)) and len(weights) == 1:
        weights = weights[0]
    members = weights if isinstance(weights, (list, tuple)) else [weights]
    for w in members:
        if exported_format(w):
            raise NotImplementedError(f"{w}: exported {exported_format(w)} artifacts are not ported yet "
                                      "(ROADMAP.md queue 1 item 6)")

    if isinstance(weights, (list, tuple)):  # concat-NMS ensemble (reference experimental.py:74-124)
        assert not augment, "--augment with an ensemble is not supported in detect"
        model = attempt_load(list(weights), device=device)
    else:
        # half=None: bf16 on the card, float32 on the CPU; --half forces bf16
        model = optimize_for_inference(load_weights(weights, device=device), bf16=half)
    dev = model.device
    stride = int(model.stride)
    names = model.names
    imgsz = check_img_size(list(imgsz) if not isinstance(imgsz, int) else [imgsz] * 2, s=stride)
    cls_filter = tuple(classes) if classes else None

    @torch.inference_mode()
    def infer(imgs_u8):
        x = torch.as_tensor(imgs_u8).to(dev).float() / 255.0
        return model.predict(x, augment=augment)

    @torch.inference_mode()
    def nms(pred):
        return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres, classes=cls_filter,
                           agnostic=agnostic_nms, max_det=max_det, max_nms=8192)

    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok)
    (save_dir / "labels" if save_txt else save_dir).mkdir(parents=True, exist_ok=True)

    if webcam:
        dataset = LoadStreams(source, img_size=imgsz[0], stride=stride, auto=False, vid_stride=vid_stride)
        bs = len(dataset)
    elif screenshot:
        dataset = LoadScreenshots(source, img_size=imgsz[0], stride=stride, auto=False)
        bs = 1
    else:
        dataset = LoadImages(source, img_size=imgsz[0], stride=stride, auto=False, vid_stride=vid_stride)
        bs = 1
    vid_path, vid_writer = [None] * bs, [None] * bs

    seen = 0
    dt = (Profile(device=dev), Profile(device=dev), Profile(device=dev), Profile(device=dev))
    for path, im, im0s, vid_cap, s in dataset:
        with dt[0]:
            if im.ndim == 3:
                im = im[None]
        with dt[1]:
            pred = infer(im)
        with dt[2]:
            dets, n_valid = nms(pred)
            n_valid = n_valid.cpu().numpy()
            dets = dets[:, : max(int(n_valid.max()), 0)].cpu().numpy()

        for i in range(im.shape[0]):
            seen += 1
            if webcam:
                p, im0 = path[i], im0s[i].copy()
                s_i = f"{s}{i}: "
            else:
                p, im0 = path, im0s.copy()
                s_i = s
            p = Path(p)
            save_path = str(save_dir / p.name)
            txt_path = str(save_dir / "labels" / p.stem) + (
                "" if dataset.mode == "image" else f"_{getattr(dataset, 'frame', 0)}")
            det = dets[i, : n_valid[i]].copy()
            s_i += "{:g}x{:g} ".format(*im.shape[1:3])
            annotator = Annotator(np.ascontiguousarray(im0), line_width=line_thickness)
            if len(det):
                with dt[3]:  # boxes back to the image's pixels
                    det[:, :4] = np.asarray(scale_boxes(im.shape[1:3], det[:, :4], im0.shape[:2])).round()
                for c in np.unique(det[:, 5]):
                    n = int((det[:, 5] == c).sum())
                    s_i += f"{n} {names.get(int(c), int(c))}{'s' * (n > 1)}, "
                for *xyxy, conf, cls in reversed(det.tolist()):
                    c = int(cls)
                    if save_txt:
                        gn = np.array([im0.shape[1], im0.shape[0], im0.shape[1], im0.shape[0]])
                        xywh = (xyxy2xywh(np.array(xyxy).reshape(1, 4)) / gn).reshape(-1).tolist()
                        line = (c, *xywh, conf) if save_conf else (c, *xywh)
                        with open(f"{txt_path}.txt", "a") as f:
                            f.write(("%g " * len(line)).rstrip() % line + "\n")
                    if save_img or save_crop or view_img:
                        label = None if hide_labels else (names.get(c, c) if hide_conf else f"{names.get(c, c)} {conf:.2f}")
                        annotator.box_label(xyxy, label, color=colors(c, True))
                    if save_crop:
                        save_one_box(xyxy, im0, file=save_dir / "crops" / str(names.get(c, c)) / f"{p.stem}.png")

            im0 = annotator.result()
            if view_img:
                LOGGER.warning("--view-img needs a display window, which the port does not open; use the saved images")
            if save_img:
                if dataset.mode == "image":
                    from yolov3_tpu_torch.data.image_ops import imwrite_png

                    imwrite_png(Path(save_path).with_suffix(".png"), im0)
                else:  # video / stream writer (cv2, present when the source could be read)
                    import cv2

                    if vid_path[i] != save_path:
                        vid_path[i] = save_path
                        if isinstance(vid_writer[i], cv2.VideoWriter):
                            vid_writer[i].release()
                        if vid_cap:
                            fps = vid_cap.get(cv2.CAP_PROP_FPS)
                            wv = int(vid_cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                            hv = int(vid_cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                        else:
                            fps, wv, hv = 30, im0.shape[1], im0.shape[0]
                        save_path = str(Path(save_path).with_suffix(".mp4"))
                        vid_writer[i] = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (wv, hv))
                    vid_writer[i].write(im0)

            LOGGER.info(f"{s_i}{'' if len(det) else '(no detections), '}{(dt[1].dt + dt[2].dt) * 1e3:.1f}ms")

    if update:  # strip the optimizer from the checkpoint after a successful run (reference detect.py:283-286)
        wp = Path(str(weights))
        if wp.is_dir() and (wp / "checkpoint.yaml").exists():
            from yolov3_tpu_torch.utils.checkpoint import strip_checkpoint

            strip_checkpoint(wp)

    t = tuple(x.t / max(seen, 1) * 1e3 for x in dt)
    run.speed_ms = dict(zip(("pre", "inference", "nms", "post"), t))
    LOGGER.info("Speed: %.1fms pre, %.1fms inference, %.1fms NMS, %.1fms post per image" % t)
    if save_txt or save_img:
        LOGGER.info(f"Results saved to {save_dir}")
    return save_dir


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, nargs="+", default="yolov3-tiny",
                        help="checkpoint dir(s), reference .pt file(s) or model cfg name; several -> concat-NMS ensemble")
    parser.add_argument("--source", type=str, default=DEFAULT_SOURCE, help="file/dir/URL/glob/.txt/screen/0(webcam)")
    parser.add_argument("--data", type=str, default=None, help="(optional) dataset.yaml for names")
    parser.add_argument("--imgsz", "--img", "--img-size", nargs="+", type=int, default=[640], help="inference size")
    parser.add_argument("--conf-thres", type=float, default=0.25)
    parser.add_argument("--iou-thres", type=float, default=0.45)
    parser.add_argument("--max-det", type=int, default=1000)
    parser.add_argument("--view-img", action="store_true")
    parser.add_argument("--save-txt", action="store_true")
    parser.add_argument("--save-conf", action="store_true")
    parser.add_argument("--save-crop", action="store_true")
    parser.add_argument("--nosave", action="store_true")
    parser.add_argument("--classes", nargs="+", type=int)
    parser.add_argument("--agnostic-nms", action="store_true")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--project", default="runs/detect")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--exist-ok", action="store_true")
    parser.add_argument("--line-thickness", default=3, type=int)
    parser.add_argument("--hide-labels", default=False, action="store_true")
    parser.add_argument("--hide-conf", default=False, action="store_true")
    parser.add_argument("--vid-stride", type=int, default=1)
    parser.add_argument("--update", action="store_true", help="strip optimizer from checkpoint after run")
    parser.add_argument("--half", action="store_true", default=None,
                        help="force bf16 inference (default: bf16 on the card, f32 on the CPU)")
    parser.add_argument("--device", default="", help="cuda (the default) or cpu")
    opt = parser.parse_args(argv)
    opt.imgsz = opt.imgsz * 2 if len(opt.imgsz) == 1 else opt.imgsz
    print_args(vars(opt))
    return opt


def main(opt=None):
    opt = opt or parse_opt()
    kw = vars(opt)
    kw["device"] = kw.get("device") or None  # unset: the card
    return run(**kw)


if __name__ == "__main__":
    main()

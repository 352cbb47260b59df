"""Model export (yolov3_tpu/export.py, reference export.py:164-653).

    python -m yolov3_tpu_torch.export --weights <checkpoint dir | .pt | cfg> --include pt2 onnx \
        [--nms] [--half] [--dynamic] [--device cpu]

| format     | produces                          | read back by                         |
|------------|-----------------------------------|--------------------------------------|
| checkpoint | a port checkpoint dir, stripped   | `models.loading.load_weights`        |
| pt2        | `<name>.pt2`, a `torch.export`ed program | `models.backend.MultiBackend`  |
| onnx       | `<name>.onnx` (models/onnx_native.py) | `MultiBackend` (models/onnx_runtime.py) |

`pt2` takes the place of the JAX package's `stablehlo`: the serving
function (uint8 NHWC -> /255 -> forward -> decode, or with `nms=True` the
`batched_nms` of the serving defaults) traced by `torch.export`. With
`nms=True` it carries the NMS kernel as the registered op
`yolov3_tpu_torch::greedy_nms` (ops/nms_cuda.py), so the loaded program
launches the kernel on the card. A program is traced on the device it is
exported on; `MultiBackend` moves it to its own. Every exported artifact
has a `<name>.meta.json` sidecar ({stride, names, imgsz}, the JAX keys).

`stablehlo` raises: the port's runtime never imports JAX, so its format
is `pt2`. `savedmodel`, `tflite`, `--int8` and `--data` (int8 calibration)
raise before anything is exported: they need a TensorFlow graph emitter
(ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.nn as nn

from yolov3_tpu_torch.utils.general import LOGGER, colorstr, file_size

EXPORT_FORMATS = ("checkpoint", "pt2", "onnx")
TF_FORMATS = "the TensorFlow formats (savedmodel, tflite, int8 calibration) are not ported yet (ROADMAP.md queue 1 item 7)"


def try_export(fn):
    """Decorator: time, log and catch a format's failure (reference export.py:138-161);
    a failed export returns None."""

    def wrapper(*args, **kwargs):
        prefix = colorstr(f"{fn.__name__.replace('export_', '')}:")
        t = time.time()
        try:
            out = fn(*args, **kwargs)
            LOGGER.info(f"{prefix} export success, {time.time() - t:.1f}s, saved as {out} ({file_size(out):.1f} MB)")
            return out
        except Exception as e:  # noqa: BLE001 — one format's failure must not stop the others
            LOGGER.warning(f"{prefix} export failure {time.time() - t:.1f}s: {e}")
            return None

    return wrapper


class ServingModule(nn.Module):
    """The exported serving function: uint8 (B, H, W, 3) -> float /255 ->
    forward -> `decode_predictions` (B, N, 5 + nc) float32, or with
    include_nms the `batched_nms` of the JAX package's serving function
    (conf 0.25, iou 0.45, max_det 300, max_nms 8192): (out, n)."""

    def __init__(self, model, include_nms=False, conf_thres=0.25, iou_thres=0.45, max_det=300):
        super().__init__()
        self.model = model
        self.include_nms = include_nms
        self.conf_thres, self.iou_thres, self.max_det = conf_thres, iou_thres, max_det

    def forward(self, imgs_u8):
        from yolov3_tpu_torch.models.detect_head import decode_predictions
        from yolov3_tpu_torch.ops.nms import batched_nms

        pred = decode_predictions(self.model(imgs_u8.float() / 255.0), self.model.anchors_px, self.model.spec.strides)
        if self.include_nms:
            return batched_nms(pred, conf_thres=self.conf_thres, iou_thres=self.iou_thres, max_det=self.max_det,
                               max_nms=8192)
        return pred


def _write_metadata(path, model, imgsz):
    meta = {"stride": int(model.stride), "names": {int(k): v for k, v in model.names.items()}, "imgsz": imgsz}
    Path(path).with_suffix(".meta.json").write_text(json.dumps(meta))


@try_export
def export_checkpoint(model, file, imgsz=640):
    """A stripped port checkpoint directory; `fused` round-trips (a folded
    state dict needs the folded graph: export --half folds the model)."""
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    out = Path(file).with_suffix("") if Path(file).suffix else Path(file)
    return save_checkpoint(out, {"model": model.state_dict()}, spec=model.spec,
                           meta={"names": {int(k): v for k, v in model.names.items()}, "stripped": True,
                                 "fused": bool(model.fused)})


@try_export
def export_pt2(model, file, imgsz=640, batch=1, include_nms=False, dynamic=False):
    """`<file>.pt2`: the serving function traced by torch.export on the
    model's device. dynamic=True makes the batch dimension symbolic (the
    reference's --dynamic, export.py:798): one artifact serves any batch."""
    import torch.export as texport

    x = torch.zeros((max(int(batch), 2) if dynamic else int(batch), imgsz, imgsz, 3), dtype=torch.uint8,
                    device=model.device)
    shapes = ({0: texport.Dim("batch", min=1, max=1024)},) if dynamic else None
    with torch.no_grad():
        program = texport.export(ServingModule(model.eval(), include_nms), (x,), dynamic_shapes=shapes)
    program.example_inputs = None  # else the artifact carries the example batch (39 MB at 32 x 640 px)
    out = Path(file).with_suffix(".pt2")
    texport.save(program, out)
    _write_metadata(out, model, imgsz)
    return out


@try_export
def export_onnx(model, file, imgsz=640, batch=1, include_nms=False, dynamic=False):
    """`<file>.onnx` from the in-tree writer (models/onnx_native.py): the
    graph and the full Detect decode, input "images" f32 (N, 3, H, W), output
    (N, M, nc + 5), optional dynamic batch. NMS stays outside the artifact,
    as in the reference's default onnx export."""
    if include_nms:
        raise NotImplementedError("the onnx export carries the decode only (NMS runs in the consumer, like the "
                                  "reference's default onnx export); export pt2 with nms for NMS in the artifact")
    from yolov3_tpu_torch.models.onnx_native import export_onnx_bytes

    out = Path(file).with_suffix(".onnx")
    out.write_bytes(export_onnx_bytes(model, imgsz=imgsz, batch=batch, dynamic=dynamic))
    _write_metadata(out, model, imgsz)
    return out


def check_formats(include, nms=False, int8=False, data=None):
    """Refuse what the port cannot export, before anything is exported."""
    if int8 or data is not None:
        raise NotImplementedError(f"--int8 / --data: {TF_FORMATS}")
    for fmt in include:
        if fmt == "stablehlo":
            raise ValueError("stablehlo needs JAX, which the port never imports; the port's program format is "
                             "'pt2' (torch.export)")
        if fmt in ("savedmodel", "tflite"):
            raise NotImplementedError(f"{fmt}: {TF_FORMATS}")
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"unknown export format {fmt!r}; choose from {EXPORT_FORMATS}")
    if nms and "onnx" in include:
        raise NotImplementedError("onnx with nms: the onnx export carries the decode only; use pt2 for NMS in the "
                                  "artifact")


def run(weights="yolov3-tiny", include=("checkpoint", "pt2"), imgsz=640, batch=1, nms=False, out_dir="runs/export",
        int8=False, data=None, half=False, dynamic=False, device=None):
    """Export a model to the requested formats; returns {format: path or None}.
    device=None means "cuda" (and raises without one); a pt2 runs on the
    device it was exported on unless `MultiBackend` moves it."""
    from yolov3_tpu_torch.models.detection import optimize_for_inference
    from yolov3_tpu_torch.models.loading import load_weights

    check_formats(include, nms, int8, data)
    model = load_weights(weights, device=device)
    if half:  # fused bf16 artifact (the reference exports fused fp16 with --half, export.py:719)
        model = optimize_for_inference(model, bf16=True)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    base = out_dir / model.spec.name
    results = {}
    for fmt in include:
        if fmt == "checkpoint":
            results[fmt] = export_checkpoint(model, base, imgsz)
        elif fmt == "pt2":
            results[fmt] = export_pt2(model, base, imgsz, batch, nms, dynamic)
        else:
            results[fmt] = export_onnx(model, base, imgsz, batch, nms, dynamic)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="yolov3-tiny")
    p.add_argument("--include", nargs="+", default=["checkpoint", "pt2"])
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--nms", action="store_true", help="embed NMS in the exported program (pt2)")
    p.add_argument("--out-dir", default="runs/export")
    p.add_argument("--int8", action="store_true", help="TFLite INT8 quantization (not ported: raises)")
    p.add_argument("--data", default=None, help="dataset YAML for int8 calibration (not ported: raises)")
    p.add_argument("--half", action="store_true", help="export fused bf16 weights")
    p.add_argument("--dynamic", action="store_true", help="symbolic batch dimension (pt2, onnx)")
    p.add_argument("--device", default="", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    return run(a.weights, a.include, a.imgsz, a.batch, a.nms, a.out_dir, a.int8, a.data, a.half, a.dynamic,
               a.device or None)


if __name__ == "__main__":
    main()

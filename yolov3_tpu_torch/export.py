"""Model export (yolov3_tpu/export.py, reference export.py:164-653).

    python -m yolov3_tpu_torch.export --weights <checkpoint dir | .pt | cfg> --include pt2 onnx savedmodel tflite \
        [--nms] [--half] [--dynamic] [--int8 --data dataset.yaml] [--device cpu]

| format     | produces                          | read back by                         |
|------------|-----------------------------------|--------------------------------------|
| checkpoint | a port checkpoint dir, stripped   | `models.loading.load_weights`        |
| pt2        | `<name>.pt2`, a `torch.export`ed program | `models.backend.MultiBackend`  |
| savedmodel | `<name>_savedmodel/`, a TF SavedModel (models/tf_graph.py) | `MultiBackend` (TensorFlow) |
| tflite     | `<name>.tflite` / `<name>-int8.tflite` from the SavedModel | `MultiBackend` (LiteRT / tf.lite) |
| onnx       | `<name>.onnx` (models/onnx_native.py) | `MultiBackend` (models/onnx_runtime.py) |

`pt2` takes the place of the JAX package's `stablehlo`: the serving
function (uint8 NHWC -> /255 -> forward -> decode, or with `nms=True` the
`batched_nms` of the serving defaults) traced by `torch.export`. With
`nms=True` it carries the NMS kernel as the registered op
`yolov3_tpu_torch::greedy_nms` (ops/nms_cuda.py), so the loaded program
launches the kernel on the card. A program is traced on the device it is
exported on; `MultiBackend` moves it to its own. Every exported artifact
has a `<name>.meta.json` sidecar ({stride, names, imgsz}, the JAX keys).

The TensorFlow formats are the same serving function as a TensorFlow graph
that models/tf_graph.py writes from the spec and the folded weights (the
JAX package converts its function with jax2tf), NMS included with `nms=True`;
`tflite` converts the SavedModel, and `--int8` quantizes it after
calibrating on `--data`'s val images (`_calibration_batches`). They need
tensorflow, imported only when they are exported or read, and run on the
host: TensorFlow runs no CUDA kernel of this package. `export_onnx_tf` is the
JAX package's second ONNX leg, tf2onnx over the SavedModel.

`stablehlo` raises: the port's runtime never imports JAX, so its format
is `pt2`.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from yolov3_tpu_torch.utils.general import LOGGER, colorstr, file_size

EXPORT_FORMATS = ("checkpoint", "pt2", "savedmodel", "tflite", "onnx")


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


@try_export
def export_savedmodel(model, file, imgsz=640, batch=1, include_nms=False, dynamic=False):
    """`<file>_savedmodel/`: a TF SavedModel whose `serve` is the serving
    function (`ServingModule`'s, NMS included with include_nms) as a
    TensorFlow graph written by models/tf_graph.py, on uint8
    (batch, imgsz, imgsz, 3); dynamic=True makes the batch dimension None
    (the reference's --dynamic). Needs tensorflow."""
    import tensorflow as tf

    from yolov3_tpu_torch.models.tf_graph import serving_tf_module

    module = serving_tf_module(model, imgsz, None if dynamic else int(batch), include_nms)
    out = str(Path(file).with_suffix("")) + "_savedmodel"
    tf.saved_model.save(module, out)
    _write_metadata(Path(out), model, imgsz)
    return out


def _calibration_batches(imgsz, batch, data=None, n=32, stride=32):
    """Uint8 NHWC batches for post-training quantization (the JAX
    package's, in the same bytes): with a dataset YAML, its val images (else
    train), the first n * batch, read by the port's decoders, letterboxed to
    imgsz with auto=False and flipped BGR -> RGB; an image that does not
    decode is skipped. Without data, or with no readable image, random uint8
    from default_rng(0), with the JAX package's warning. A short last batch
    repeats its last image."""
    from yolov3_tpu_torch.data import image_ops
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.data.dataset_yaml import check_dataset
    from yolov3_tpu_torch.data.datasets import list_images

    imgs = []
    if data is not None:
        d = check_dataset(data)
        for f in list_images(d.get("val") or d["train"])[: n * batch]:
            try:
                im = image_ops.imread(f)
            except (OSError, ValueError):  # what cv2.imread reads as None
                continue
            im = letterbox(im, imgsz, stride=stride, auto=False)[0]
            imgs.append(im[:, :, ::-1])  # BGR -> RGB
    if not imgs:
        if data is not None:
            LOGGER.warning("int8 calibration: no readable images found; using random data")
        else:
            LOGGER.warning("int8 calibration on random data — pass a dataset YAML for representative ranges")
        rng = np.random.default_rng(0)
        imgs = [rng.integers(0, 255, (imgsz, imgsz, 3), dtype=np.uint8) for _ in range(n * batch)]
    for i in range(0, max(len(imgs) - batch + 1, 1), batch):
        chunk = imgs[i : i + batch]
        while len(chunk) < batch:
            chunk.append(chunk[-1])
        yield np.ascontiguousarray(np.stack(chunk).astype(np.uint8))


@try_export
def export_tflite(model, file, imgsz=640, batch=1, include_nms=False, int8=False, data=None):
    """`<file>.tflite` converted from the SavedModel (TFLiteConverter, the
    TFLite builtins plus select TF ops). int8=True: post-training
    quantization (Optimize.DEFAULT) calibrated on `_calibration_batches` of
    `data`, written as `<file>-int8.tflite`; ops without an int8 kernel stay
    float. The static-batch SavedModel it converts is written to a temporary
    directory beside `file` and removed, so a `<file>_savedmodel/` exported
    in the same run (dynamic or not) is left as it was; the JAX package
    overwrites it (yolov3_tpu/export.py:195). Needs tensorflow."""
    import tempfile

    import tensorflow as tf

    out = Path(file).with_suffix("")
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        sm = export_savedmodel(model, Path(tmp) / out.name, imgsz, batch, include_nms)
        assert sm is not None, "savedmodel export failed"
        converter = tf.lite.TFLiteConverter.from_saved_model(str(sm))
        converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS, tf.lite.OpsSet.SELECT_TF_OPS]
        suffix = ".tflite"
        if int8:
            converter.optimizations = [tf.lite.Optimize.DEFAULT]
            converter.representative_dataset = lambda: (
                [b] for b in _calibration_batches(imgsz, batch, data, stride=int(model.stride)))
            suffix = "-int8.tflite"
        tflite = converter.convert()
    out = out.parent / (out.name + suffix)
    out.write_bytes(tflite)
    _write_metadata(out, model, imgsz)
    return out


@try_export
def export_onnx_tf(model, file, imgsz=640, batch=1, include_nms=False):
    """`<file>.onnx` by tf2onnx over the SavedModel, the JAX package's second
    ONNX leg (needs tensorflow and tf2onnx; the NMS rides along with
    include_nms). The first leg is `export_onnx`, which needs neither."""
    import subprocess
    import sys

    import tf2onnx  # noqa: F401 — its converter runs in a subprocess; fail here when it is missing

    sm = export_savedmodel(model, file, imgsz, batch, include_nms)
    assert sm is not None, "savedmodel export failed"
    out = Path(file).with_suffix(".onnx")
    subprocess.run([sys.executable, "-m", "tf2onnx.convert", "--saved-model", str(sm), "--output", str(out)],
                   check=True)
    _write_metadata(out, model, imgsz)
    return out


def check_formats(include, nms=False):
    """Refuse what the port cannot export, before anything is exported."""
    for fmt in include:
        if fmt == "stablehlo":
            raise ValueError("stablehlo needs JAX, which the port never imports; the port's program format is "
                             "'pt2' (torch.export)")
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"unknown export format {fmt!r}; choose from {EXPORT_FORMATS}")
    if nms and "onnx" in include:
        raise NotImplementedError("onnx with nms: the onnx export carries the decode only; use pt2 for NMS in the "
                                  "artifact")


def run(weights="yolov3-tiny", include=("checkpoint", "pt2"), imgsz=640, batch=1, nms=False, out_dir="runs/export",
        int8=False, data=None, half=False, dynamic=False, device=None):
    """Export a model to the requested formats; returns {format: path or None}.
    device=None means "cuda" (and raises without one); a pt2 runs on the
    device it was exported on unless `MultiBackend` moves it. The TensorFlow
    formats take a host copy of the weights; int8 and data apply to tflite."""
    from yolov3_tpu_torch.models.detection import optimize_for_inference
    from yolov3_tpu_torch.models.loading import load_weights

    check_formats(include, nms)
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
        elif fmt == "savedmodel":
            results[fmt] = export_savedmodel(model, base, imgsz, batch, nms, dynamic)
        elif fmt == "tflite":
            results[fmt] = export_tflite(model, base, imgsz, batch, nms, int8, data)
        else:
            results[fmt] = export_onnx(model, base, imgsz, batch, nms, dynamic)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="yolov3-tiny")
    p.add_argument("--include", nargs="+", default=["checkpoint", "pt2"])
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--nms", action="store_true", help="embed NMS in the exported program (pt2, savedmodel, tflite)")
    p.add_argument("--out-dir", default="runs/export")
    p.add_argument("--int8", action="store_true", help="TFLite INT8 post-training quantization")
    p.add_argument("--data", default=None, help="dataset YAML for int8 calibration images")
    p.add_argument("--half", action="store_true", help="export fused bf16 weights")
    p.add_argument("--dynamic", action="store_true", help="symbolic batch dimension (pt2, savedmodel, onnx)")
    p.add_argument("--device", default="", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    return run(a.weights, a.include, a.imgsz, a.batch, a.nms, a.out_dir, a.int8, a.data, a.half, a.dynamic,
               a.device or None)


if __name__ == "__main__":
    main()

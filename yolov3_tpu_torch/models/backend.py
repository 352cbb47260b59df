"""MultiBackend: one call over every format the port reads
(yolov3_tpu/models/backend.py, reference models/common.py:432-768).

| weights                   | backend                                           |
|---------------------------|---------------------------------------------------|
| checkpoint dir            | the port's DetectionModel, folded                 |
| reference `*.pt`          | the same, from the torch weights                  |
| `*.pt2`                   | the `torch.export`ed program (export.py)          |
| `*_savedmodel` dir        | TensorFlow's SavedModel loader, its `serve`       |
| `*.tflite`                | the LiteRT interpreter (`ai_edge_litert`, else `tf.lite`) |
| `*.onnx`                  | the in-tree executor (models/onnx_runtime.py)     |
| a cfg name (yolov3-tiny)  | seeded random weights                             |

`MultiBackend(weights)(imgs_u8)` returns the decoded (B, N, 5 + nc) float32
predictions on the backend's device, whatever the artifact; a `.pt2` or a
SavedModel exported with `nms=True` returns its (out, n) (`has_nms`). The
TensorFlow formats run on the host, the artifact's own runtime (TensorFlow
runs no kernel of this package): the images go there and the result comes
back to the backend's device. A dynamic-batch TFLite file is resized to each
batch. An exported artifact's stride and names come from the `.meta.json`
sidecar export.py writes; one without it raises. `.stablehlo` (JAX) raises,
naming what the port reads instead.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from yolov3_tpu_torch.ops import conv_pool_cuda  # noqa: F401 — registers conv_pool, which a bf16 pt2 calls
from yolov3_tpu_torch.ops import epilogue_cuda  # noqa: F401 — registers conv_epilogue, which a bf16 pt2 calls
from yolov3_tpu_torch.ops import nms_cuda  # noqa: F401 — registers greedy_nms, which a pt2 with NMS calls
from yolov3_tpu_torch.utils.general import LOGGER, select_device

EXPORTED = ("pt2", "savedmodel", "tflite", "onnx")


class MultiBackend:
    """Format-sniffing model loader with one `__call__`. device=None means
    "cuda" (and raises without one)."""

    def __init__(self, weights="yolov3-tiny", imgsz=640, device=None):
        w = Path(str(weights))
        self.format = self._sniff(w)
        self.device = select_device(device)
        self.stride = 32
        self.names = {i: str(i) for i in range(80)}
        self.imgsz = imgsz
        self.has_nms = False
        LOGGER.info(f"MultiBackend: loading {w} as {self.format}")

        meta_file = w.with_suffix(".meta.json") if w.suffix else w.parent / (w.name + ".meta.json")
        if meta_file.is_file():
            meta = json.loads(meta_file.read_text())
            self.stride = int(meta.get("stride", 32))
            self.names = {int(k): v for k, v in meta.get("names", {}).items()}
            self.imgsz = meta.get("imgsz", imgsz)
        elif self.format in EXPORTED:
            # an exported artifact carries no class map; invented numeric names would corrupt labels
            raise FileNotFoundError(
                f"missing metadata sidecar {meta_file} for {self.format} artifact {w}; re-export with "
                'yolov3_tpu_torch.export (it writes the sidecar) or write it: {"stride": 32, "names": {"0": ...}}')

        if self.format in ("checkpoint", "torch_pt", "config"):
            from yolov3_tpu_torch.models.detection import optimize_for_inference
            from yolov3_tpu_torch.models.loading import load_weights

            model = optimize_for_inference(load_weights(str(weights), device=self.device))
            self.model = model
            self.stride = int(model.stride)
            self.names = model.names
            self._call = lambda im: model.predict(im.float() / 255.0)
        elif self.format == "pt2":
            program = self._load_pt2(w)
            self.has_nms = len(program.graph_signature.user_outputs) == 2
            module = program.module()
            self._call = module
        elif self.format == "savedmodel":
            import tensorflow as tf

            m = tf.saved_model.load(str(w))
            self.has_nms = isinstance(m.serve.concrete_functions[0].structured_outputs, (tuple, list))
            self._call = lambda im: self._from_host(m.serve(tf.constant(im.cpu().numpy())))
        elif self.format == "tflite":
            self._call = self._tflite(w)
        else:
            from yolov3_tpu_torch.models.onnx_runtime import OnnxModel

            rt = OnnxModel(w, device=self.device)
            # the ONNX contract (reference export.py:196-264): f32 NCHW, /255 by the consumer
            self._call = lambda im: rt(im.permute(0, 3, 1, 2).float() / 255.0)

    @staticmethod
    def _sniff(w: Path):
        if w.is_dir() and (w / "checkpoint.yaml").exists():
            return "checkpoint"
        if w.suffix == ".stablehlo":
            raise ValueError(f"{w}: a StableHLO artifact needs JAX, which the port never imports; export the "
                             "model with yolov3_tpu_torch.export --include pt2 (or onnx) and load that")
        if w.is_dir() and str(w).endswith("_savedmodel"):
            return "savedmodel"
        return {".pt": "torch_pt", ".pt2": "pt2", ".onnx": "onnx", ".tflite": "tflite"}.get(w.suffix, "config")

    def _from_host(self, out):
        """TensorFlow's result(s) as tensors on this backend's device."""
        if isinstance(out, (tuple, list)):
            return tuple(self._from_host(o) for o in out)
        return torch.from_numpy(np.asarray(out)).to(self.device)

    def _tflite(self, w):
        """The interpreter's call on uint8 images; a batch of another size
        resizes the input first (a dynamic-batch artifact)."""
        try:
            from ai_edge_litert.interpreter import Interpreter
        except ImportError:
            import tensorflow as tf

            Interpreter = tf.lite.Interpreter
        interp = Interpreter(model_path=str(w))
        interp.allocate_tensors()
        self.has_nms = len(interp.get_output_details()) == 2

        def run(im):
            inp = interp.get_input_details()[0]
            x = im.cpu().numpy()
            if list(x.shape) != list(inp["shape"]):
                interp.resize_tensor_input(inp["index"], x.shape)
                interp.allocate_tensors()
                inp = interp.get_input_details()[0]
            interp.set_tensor(inp["index"], x)
            interp.invoke()
            outs = [interp.get_tensor(o["index"]) for o in interp.get_output_details()]
            if self.has_nms:  # (out, n): n is the int32 output
                outs.sort(key=lambda a: a.dtype == np.int32)
                return self._from_host(tuple(outs))
            return self._from_host(outs[0])

        return run

    def _load_pt2(self, w):
        """The exported program on this backend's device. A program traced on
        another device has that device in its graph; it is moved, or refused
        when this torch cannot move it: never run where it was not asked to."""
        import torch.export as texport

        program = texport.load(w)
        tensors = list(program.state_dict.values()) + list(program.constants.values())
        src = next((t.device for t in tensors if isinstance(t, torch.Tensor)), self.device)
        if src.type == self.device.type:
            return program
        try:
            from torch.export.passes import move_to_device_pass

            return move_to_device_pass(program, location=str(self.device))
        except (ImportError, RuntimeError, TypeError) as e:
            raise RuntimeError(f"{w} was exported on {src} and cannot be moved to {self.device} by torch "
                               f"{torch.__version__} ({e}); export it on {self.device.type}") from e

    @torch.inference_mode()
    def __call__(self, imgs_u8):
        """imgs_u8: (B, H, W, 3) uint8 array or tensor -> decoded (B, N, 5 + nc)
        float32 on this backend's device ((out, n) for an artifact with NMS)."""
        return self._call(torch.as_tensor(imgs_u8).to(self.device))

    def warmup(self, shape=(1, 640, 640, 3)):
        self(torch.zeros(shape, dtype=torch.uint8))
        return self

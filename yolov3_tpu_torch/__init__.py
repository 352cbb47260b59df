"""yolov3_tpu_torch — the PyTorch/CUDA port of yolov3_tpu, for NVIDIA Hopper.

The module layout mirrors the JAX package (`yolov3_tpu`) so each function's
counterpart is found under the same name. The port keeps the JAX package's
public layouts (NHWC uint8 images in, (B, max_det, 6) f32 detections and
(B,) counts out) and runs its hand-written kernels on the card:

    ops/nms_cuda.py + csrc/nms.cu           greedy NMS (CUDA C++, built with nvcc)
    ops/score_cuda.py + csrc/score.cu       candidate-score pass (CUDA C++)
    ops/conv_bn_cuda.py + csrc/conv_bn.cu   3x3 conv + BatchNorm statistics of the
                                            train-mode forward (CUDA C++)

Entry points take `device=None`, meaning "cuda"; without a CUDA device they
raise unless the caller passes `device="cpu"`, where every kernel wrapper
runs its plain PyTorch version.

    from yolov3_tpu_torch import load_model
    from yolov3_tpu_torch.serve import MicroBatcher, build_batched_infer
    model = load_model("yolov3")              # a cfg name: seeded random weights
    batcher = MicroBatcher(build_batched_infer(model), max_batch=32)
    dets, n = batcher.submit(frame_640x640x3_uint8)

Training (train/): `build_optimizer`, `LossConfig.from_model` and
`make_train_step(model, loss_cfg, optimizer)` give a step function over
uint8 image batches and padded labels; `train.loop.train(data="dataset.yaml",
cfg="yolov3")` trains from images on disk through the data pipeline (data/),
whose host image ops are the package's own C++ (csrc/host_ops.cpp, built
with the system C++ compiler at first use), validates every epoch and
writes checkpoints (utils/checkpoint.py).

`load_model`, `DetectionModel` and `build_model` are the package root's
names, as in the JAX package; they load on first use (a module
`__getattr__`), so importing a submodule does not import the model graph.
"""

__version__ = "0.1.0"

__all__ = ["DetectionModel", "build_model", "load_model"]


def load_model(weights, ch=3, nc=None, device=None):
    """A DetectionModel from a config name / YAML (seeded random weights), a
    port checkpoint directory or a reference `.pt` (models/loading.py), on
    `device` (None means "cuda" and raises without one)."""
    from yolov3_tpu_torch.models.loading import load_weights

    return load_weights(weights, ch=ch, nc=nc, device=device)


def __getattr__(name):
    if name in ("DetectionModel", "build_model"):
        from yolov3_tpu_torch.models import detection

        return getattr(detection, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""One weight loader behind detect, val, hub, AutoShape, Ensemble and serve
(yolov3_tpu/models/loading.py): a port checkpoint directory, a reference
torch `.pt`, or a model cfg name / YAML (seeded random weights)."""

from __future__ import annotations

from pathlib import Path

import torch

from yolov3_tpu_torch.models.convert import load_torch_checkpoint, match_torch_state_dict
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.utils.general import LOGGER, select_device


def load_weights(weights, ch=3, nc=None, device=None):
    """A DetectionModel from `weights`, on `device` (None means "cuda" and
    raises without one).

    A directory with checkpoint.yaml: a port checkpoint (EMA weights when it
    has them). A `.pt`: a reference checkpoint, its architecture the cfg its
    pickled model carries (the reference model's `yaml`: a YOLOv5 or any
    other zoo model), else the cfg named by the file's stem (yolov3,
    yolov3-spp, yolov3-tiny; another stem assumes yolov3); it raises when
    more tensors fail to load than load. A
    missing `.pt` raises: nothing is downloaded. Anything else: a cfg name or
    YAML path (seeded random weights). ch / nc apply to cfg and .pt builds."""
    from yolov3_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    p = Path(str(weights))
    if p.is_dir() and (p / "checkpoint.yaml").is_file():
        return load_model_from_checkpoint(p, device=device)
    if p.suffix == ".pt":
        if not p.is_file():
            raise FileNotFoundError(f"{p} does not exist; weights are never downloaded (this runs offline): "
                                    "copy the reference .pt to this path, or pass a port checkpoint or a cfg")
        device = select_device(device)
        sd, cfg = load_torch_checkpoint(p)
        if cfg is not None:
            cfg = {"name": p.stem, **cfg}
        elif "yolov3" in p.stem:
            cfg = p.stem
        else:
            cfg = "yolov3"
            LOGGER.warning(f"cannot infer the architecture from '{p.name}' — assuming the flagship "
                           "yolov3 cfg; rename the file to its cfg (e.g. yolov3-tiny.pt) if wrong")
        model = DetectionModel.from_config(cfg, ch=ch, nc=nc, device="cpu")
        matched, missed = match_torch_state_dict(model, sd)
        if len(missed) > len(matched):
            # a mostly-random model that "works" is worse than an error
            raise ValueError(f"{p}: {len(missed)} tensors failed to convert (only {len(matched)} matched) — "
                             "architecture mismatch; rename the file to its cfg or convert it explicitly")
        if missed:
            LOGGER.warning(f"{len(missed)} tensors failed to convert from {p}")
        model.load_state_dict(matched, strict=False)
        return model.to(device=device, memory_format=torch.channels_last).eval()
    return DetectionModel.from_config(str(weights), ch=ch, nc=nc, device=device)


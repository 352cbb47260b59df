"""Model ensembling (yolov3_tpu/models/ensemble.py): several DetectionModels
whose decoded predictions are concatenated along the candidate axis before
one shared NMS pass (the reference's nms-ensemble mode, experimental.py:83)."""

from __future__ import annotations

import torch

from yolov3_tpu_torch.utils.general import LOGGER


class Ensemble:
    """Concat-ensemble of DetectionModels with one predict()."""

    def __init__(self, models):
        assert len(models) >= 1
        self.models = list(models)
        self.stride = max(int(m.stride) for m in models)
        self.names = models[0].names
        self.spec = models[0].spec
        if len(models) > 1:
            LOGGER.info(f"Ensemble of {len(models)} models created (max stride {self.stride})")

    @property
    def device(self):
        return self.models[0].device

    @torch.inference_mode()
    def predict(self, x, augment=False):
        """Decoded predictions of every member on NHWC images in [0, 1], concatenated: (B, sum N, 5 + nc)."""
        return torch.cat([m.predict(x.to(m.device), augment=augment).to(self.device) for m in self.models], 1)

    def __call__(self, imgs_u8):
        """uint8 (B, H, W, 3) images -> decoded (B, N, 5 + nc) float32 on the first member's device."""
        x = torch.as_tensor(imgs_u8).to(self.device).float() / 255.0
        return self.predict(x)


def attempt_load(weights, autoshape=False, device=None):
    """Load one or several weights (models/loading.py); several become an
    Ensemble (reference experimental.py:88-136). device=None means "cuda"."""
    from yolov3_tpu_torch.models.loading import load_weights

    paths = weights if isinstance(weights, (list, tuple)) else [weights]
    models = [load_weights(w, device=device) for w in paths]
    out = models[0] if len(models) == 1 else Ensemble(models)
    if autoshape:
        from yolov3_tpu_torch.models.autoshape import AutoShape

        out = AutoShape(out)
    return out

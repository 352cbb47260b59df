"""Hub-style model factory (yolov3_tpu/hub.py, reference hubconf.py): the
torch.hub surface as plain functions.

    import yolov3_tpu_torch.hub as hub
    model = hub.yolov3_tiny()                      # seeded random weights + AutoShape, on the card
    model = hub.custom("runs/train/exp/weights/best", device="cpu")   # a checkpoint or a reference .pt
    results = model(["yolov3_tpu_torch/data/images/sample1.jpg"])
    results.print()
"""

from __future__ import annotations

from yolov3_tpu_torch.models.autoshape import AutoShape


def _create(name, channels=3, classes=80, autoshape=True, ckpt=None, device=None):
    """A model from a cfg name, a checkpoint directory or a reference .pt
    (models/loading.py). device=None means "cuda"."""
    from yolov3_tpu_torch.models.loading import load_weights

    model = load_weights(ckpt or name, ch=channels, nc=classes, device=device)
    return AutoShape(model) if autoshape else model


def custom(path, autoshape=True, channels=3, classes=80, device=None):
    """A trained checkpoint directory or a reference .pt."""
    return _create(path, channels, classes, autoshape=autoshape, ckpt=path, device=device)


def yolov3(channels=3, classes=80, autoshape=True, device=None):
    return _create("yolov3", channels, classes, autoshape, device=device)


def yolov3_spp(channels=3, classes=80, autoshape=True, device=None):
    return _create("yolov3-spp", channels, classes, autoshape, device=device)


def yolov3_tiny(channels=3, classes=80, autoshape=True, device=None):
    return _create("yolov3-tiny", channels, classes, autoshape, device=device)


def load(name, **kwargs):
    """load('yolov3-tiny') or load('path/to/checkpoint')."""
    fns = {"yolov3": yolov3, "yolov3-spp": yolov3_spp, "yolov3_spp": yolov3_spp,
           "yolov3-tiny": yolov3_tiny, "yolov3_tiny": yolov3_tiny}
    if str(name) in fns:
        return fns[str(name)](**kwargs)
    return custom(name, **kwargs)

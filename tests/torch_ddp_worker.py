"""One rank of the port's multi-process checks (tests/test_torch_ddp.py).

    python tests/torch_ddp_worker.py <config.json>

The config names the rank, the world size, the coordinator's port and a
directory holding the initial weights (init.pt), the global batch
(batch.npz) and, for the trainer, a dataset. The rank joins a gloo group,
runs the scenarios in order and writes what each gave to
<dir>/rank{rank}.pt. It imports torch and the port, never JAX: the test
process runs the same scenario functions without a group for the one-process
reference.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from yolov3_tpu_torch.models.convert import flatten_train_state  # noqa: E402
from yolov3_tpu_torch.models.detection import DetectionModel  # noqa: E402
from yolov3_tpu_torch.models.spec import parse_spec  # noqa: E402
from yolov3_tpu_torch.parallel import mesh  # noqa: E402
from yolov3_tpu_torch.train.loss import LossConfig  # noqa: E402
from yolov3_tpu_torch.train.optim import build_optimizer  # noqa: E402
from yolov3_tpu_torch.train.step import make_train_step  # noqa: E402

HYP = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.9, "weight_decay": 0.0005, "warmup_epochs": 0.0}
OPT_ARGS = dict(epochs=10, steps_per_epoch=10, batch_size=64, min_warmup_steps=0)  # nbs 64: no accumulation
# the trainer's hyper-parameters: every augmentation off, so a rank's images do not depend on
# which images its random draws went to (the draws differ between one process and two)
TRAIN_HYP = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.9, "weight_decay": 0.0005, "warmup_epochs": 0.0,
             "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0,
             "obj_pw": 1.0, "iou_t": 0.2, "anchor_t": 4.0, "fl_gamma": 0.0, "hsv_h": 0.0, "hsv_s": 0.0,
             "hsv_v": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0,
             "flipud": 0.0, "fliplr": 0.0, "mosaic": 0.0, "mixup": 0.0, "copy_paste": 0.0}


def one_step(spec, init, batch, dtype, remat=False, steps=1):
    """`steps` train steps from `init` on this rank's rows of the global
    `batch` (all of it without a group): the metrics of the last and the
    flattened state."""
    model = DetectionModel(parse_spec(spec))
    model.load_state_dict(init)
    model = model.to(dtype)
    optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
    step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer, compute_dtype=torch.float32,
                           remat=remat, mesh=torch.distributed.group.WORLD)
    imgs, targets, mask = mesh.shard_batch(batch)
    for _ in range(steps):
        metrics = step(imgs, targets, mask)
    return {k: float(v) for k, v in metrics.items()}, flatten_train_state(step.state)


def trainer(data_yaml, spec, init_path, save_dir, batch_size, epochs):
    """train() from the given weights with every augmentation off, then a
    resume one epoch further; the final model's state dict."""
    from yolov3_tpu_torch.train.loop import train
    from yolov3_tpu_torch.utils.checkpoint import load_checkpoint

    kw = dict(data=data_yaml, cfg=spec, hyp=TRAIN_HYP, batch_size=batch_size, imgsz=64, noautoanchor=True,
              workers=1, device="cpu", save_dir=save_dir, weights=init_path, seed=0)
    train(epochs=epochs, **kw)
    train(epochs=epochs + 1, resume=True, **kw)
    sd, _ = load_checkpoint(Path(save_dir) / "weights" / "last")
    return sd


def main(config_path):
    cfg = json.loads(Path(config_path).read_text())
    torch.set_num_threads(1)
    d = Path(cfg["dir"])
    mesh.initialize_distributed(f"127.0.0.1:{cfg['port']}", cfg["world"], cfg["rank"], device="cpu")
    try:
        init = torch.load(d / "init.pt")
        batch = tuple(np.load(d / "batch.npz")[k] for k in ("imgs", "targets", "mask"))
        out = {"backend": mesh.backend(), "world": mesh.world_size()}
        for name, kw in cfg["steps"].items():
            out[name] = one_step(cfg["spec"], init, batch, getattr(torch, kw["dtype"]), kw.get("remat", False),
                                 kw.get("steps", 1))
        if cfg.get("trainer"):
            t = cfg["trainer"]
            out["trainer"] = trainer(t["data"], cfg["spec"], t["weights"], t["save_dir"], t["batch_size"],
                                     t["epochs"])
        torch.save(out, d / f"rank{cfg['rank']}.pt")
    finally:
        mesh.destroy_distributed()


if __name__ == "__main__":
    main(sys.argv[1])

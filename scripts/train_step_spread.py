"""How far one bf16 train step's loss and grad norm move with the rounding of
the stride-1 3x3 convs (K3, yolov3_tpu_torch/csrc/conv_bn.cu), on one CUDA card.

    python3 scripts/train_step_spread.py                 # from the repo root, with the card
    python3 scripts/train_step_spread.py yolov5s:0 yolov3:0 yolov5s:1

For each model:seed (yolov5s is chip_smoke.YOLOV5S; other names are the
package's configs) a fresh full-width model trains on one seeded batch of 8
640x640 images (SGD, bf16 autocast, chip_smoke's settings). At each of its
first ten states the step runs three times from that state: through K3,
through its plain version, and through the plain version with the weights
rounded to bf16 as the kernel takes them; then the run advances one step
through K3. Prints each state's losses and grad norms and the relative
differences of the grad norms: kernel against plain, and the two plain
versions against each other (the spread that rounding alone makes), then the
card's name and power limit.
"""

from __future__ import annotations

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from yolov3_tpu_torch.models.detection import DetectionModel  # noqa: E402
from yolov3_tpu_torch.ops import cuda_build  # noqa: E402
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats, conv3x3_bn_stats_plain  # noqa: E402
from yolov3_tpu_torch.train.loss import LossConfig  # noqa: E402
from yolov3_tpu_torch.train.optim import build_optimizer  # noqa: E402
from yolov3_tpu_torch.train.step import make_train_step  # noqa: E402

STATES = 10
ROUTES = {"kernel": conv3x3_bn_stats, "plain": conv3x3_bn_stats_plain,
          "plain, bf16 weights": lambda x, w: conv3x3_bn_stats_plain(x, w.to(x.dtype))}


def spread(name, seed):
    cfg = chip_smoke.YOLOV5_MODELS.get(name, name)
    model = DetectionModel.from_config(cfg, seed=seed)
    hyp = {"warmup_epochs": 0.0}
    optimizer, _, _ = build_optimizer("sgd", model, hyp, epochs=300, steps_per_epoch=1000, batch_size=64,
                                      min_warmup_steps=0)
    loss_cfg = LossConfig.from_model(model.spec, hyp)
    step = make_train_step(model, loss_cfg, optimizer)
    rng = np.random.default_rng(seed)
    batch = tuple(torch.as_tensor(a, device="cuda") for a in chip_smoke.make_train_batch(rng, 8, 640, nc=model.spec.nc))
    for k in range(STATES):
        saved = copy.deepcopy((model.state_dict(), optimizer.state_dict()))
        res = {}
        for route, fn in ROUTES.items():
            model.load_state_dict(saved[0])
            optimizer.load_state_dict(copy.deepcopy(saved[1]))
            m = make_train_step(model, loss_cfg, optimizer, state=step.state, bn_stats_fn=fn)(*batch)
            res[route] = (float(m["loss"]), float(m["grad_norm"]))
        model.load_state_dict(saved[0])
        optimizer.load_state_dict(copy.deepcopy(saved[1]))
        step(*batch)
        (loss_k, norm_k), (loss_p, norm_p), (_, norm_w) = res.values()
        print(f"{name} seed {seed} state {k}: loss {loss_k:.5f} vs {loss_p:.5f}; grad norm kernel {norm_k:.4f} "
              f"plain {norm_p:.4f} plain with bf16 weights {norm_w:.4f}; kernel against plain "
              f"{abs(norm_k - norm_p) / norm_p:.4f}, the two plain versions {abs(norm_w - norm_p) / norm_p:.4f}",
              flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("train_step_spread: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    for item in argv or ["yolov5s:0", "yolov5s:1", "yolov3:0"]:
        name, seed = item.split(":")
        spread(name, int(seed))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

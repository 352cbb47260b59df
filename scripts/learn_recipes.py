"""Learning curves of chip_smoke.phase_learn's training run under other recipes, on the card.

    python3 scripts/learn_recipes.py > chiprun_out/learn_recipes.log 2>&1

Builds the kernels, then runs `chip_smoke.phase_learn` once a recipe below with
the per-epoch validation on (the EMA weights' mAP50 on the train split after
every epoch, the line "learn: per-epoch EMA mAP50 ..."), so a recipe's steps,
learning rate or image count can be chosen against the phase's bars before the
phase runs it. A bar that a recipe misses is printed, not raised.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from yolov3_tpu_torch.ops import cuda_build, host_build  # noqa: E402

RECIPES = {  # name -> phase_learn arguments
    "scratch-low lr, batch 32": dict(bs=32, hyp_overrides={"lr0": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
                                                           "lrf": 0.01}),
    "lr0 0.02, momentum 0.9, no weight decay, lrf 0.1, batch 32": dict(bs=32),
}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, torch.__version__, flush=True)
    host_build.build()
    cuda_build.build_all()
    chip_smoke.check = lambda cond, msg: print(("ok: " if cond else "MISSED: ") + msg, flush=True)
    for name, kw in RECIPES.items():
        t0 = time.perf_counter()
        print(f"=== recipe {name}", flush=True)
        chip_smoke.phase_learn(gpu, noval=False, **kw)
        print(f"=== recipe {name}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

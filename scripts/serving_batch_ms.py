"""The serving path's time per batch of 32 at yolov3@640 for the package under
ROOT, on one CUDA card: the number chip_smoke's "main path: ... ms per batch"
line reports, for comparing two trees in one call.

    python3 scripts/serving_batch_ms.py ROOT [ROOT ...]

For each ROOT in turn (run parent, change, change, parent), in a process of
its own: the kernels of ROOT's yolov3_tpu_torch are built, full-width yolov3
(seed 0) gets chip_smoke's planted detections on 8 seeded frames,
serve.build_batched_infer runs a batch of 32 frames already on the card
(warm-up 3, then 5 windows of 20 calls between CUDA events), and K1's wrapper
is timed alone at the serving shape (B=32, K=448) the same way. Prints one
JSON line per ROOT ({"root", "batch_ms": [5 windows], "k1_call_ms": [...]}),
then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def measure(root):
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(root).resolve()))  # ROOT's package ahead of the one beside this script
    import numpy as np
    import torch

    import chip_smoke
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.ops import cuda_build
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.serve import build_batched_infer

    import yolov3_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    rng = np.random.default_rng(0)
    model = DetectionModel.from_config("yolov3", seed=0)
    frames = rng.integers(0, 256, size=(32, 640, 640, 3), dtype=np.uint8)
    base = [(c.weight.detach().clone(), c.bias.detach().clone()) for c in model.model[-1].m]
    gains, deltas = chip_smoke.calibrate(model, frames[:8])
    chip_smoke.plant_detections(model, base, gains, deltas)
    infer = build_batched_infer(model)
    imgs = torch.as_tensor(frames, device="cuda")
    batch_ms = [chip_smoke.cuda_ms(lambda: infer(imgs), iters=20, warmup=3) for _ in range(5)]
    args = chip_smoke.make_candidates(rng, 32, 448, "cuda")
    k1_ms = [chip_smoke.cuda_ms(lambda: greedy_nms(*args, 0.45, 300), iters=200) for _ in range(5)]
    print(json.dumps({"root": str(root), "package": str(Path(yolov3_tpu_torch.__file__).parent),
                      "batch_ms": batch_ms, "k1_call_ms": k1_ms, "fallbacks": infer.fallbacks}), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        measure(argv[1])
        return 0
    for root in argv or ["."]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

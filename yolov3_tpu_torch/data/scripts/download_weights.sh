#!/bin/bash
# Download all released reference checkpoints (.pt), which the port loads
# through models/loading.py (load_weights, models/convert.py). Counterpart of reference
# data/scripts/download_weights.sh (which torch-hub-fetches every release
# asset); ours routes through the same attempt_download helper the CLIs use.
# Usage: bash yolov3_tpu_torch/data/scripts/download_weights.sh

python - <<'EOF'
from yolov3_tpu_torch.utils.downloads import attempt_download

for name in ("yolov3-tiny", "yolov3", "yolov3-spp"):
    try:
        print(attempt_download(f"{name}.pt"))
    except FileNotFoundError as e:
        print(f"{name}.pt: {e}")
EOF

#!/bin/bash
# Download COCO128 (128-image COCO subset, images + YOLO labels) into
# ../datasets/coco128. Counterpart of reference data/scripts/get_coco128.sh.
# Usage: bash yolov3_tpu_torch/data/scripts/get_coco128.sh

DIR="${YOLOV3_TPU_DATASETS_DIR:-$(dirname "$0")/../../../../datasets}"
mkdir -p "$DIR" && cd "$DIR" || exit 1

URL="https://github.com/ultralytics/assets/releases/download/v0.0.0/coco128.zip"
curl -L "$URL" -o coco128.zip && unzip -qo coco128.zip && rm coco128.zip
echo "COCO128 download complete -> $DIR/coco128"

#!/bin/bash
# Download COCO 2017 (images + YOLO-format labels) into ../datasets/coco.
# Counterpart of reference data/scripts/get_coco.sh.
# Usage: bash yolov3_tpu_torch/data/scripts/get_coco.sh [--train] [--val] [--test] [--segments]

DIR="${YOLOV3_TPU_DATASETS_DIR:-$(dirname "$0")/../../../../datasets}/coco"
mkdir -p "$DIR/images" && cd "$DIR" || exit 1

# labels
LABELS_URL="https://github.com/ultralytics/assets/releases/download/v0.0.0/coco2017labels.zip"
curl -L "$LABELS_URL" -o labels.zip && unzip -qo labels.zip -d .. && rm labels.zip &

# images
BASE="http://images.cocodataset.org/zips"
for f in train2017.zip val2017.zip; do
  curl -L "$BASE/$f" -o "$f" && unzip -qo "$f" -d images && rm "$f" &
done
wait
echo "COCO download complete -> $DIR"

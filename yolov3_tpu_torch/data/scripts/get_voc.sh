#!/bin/bash
# Download PASCAL VOC 2007+2012 and convert annotations to YOLO txt layout.
# Counterpart of the reference's inline-python VOC download (data/VOC.yaml:49-84).
# Usage: bash yolov3_tpu_torch/data/scripts/get_voc.sh

DIR="${YOLOV3_TPU_DATASETS_DIR:-$(dirname "$0")/../../../../datasets}/VOC"
mkdir -p "$DIR" && cd "$DIR" || exit 1

BASE="https://github.com/ultralytics/assets/releases/download/v0.0.0"
for f in VOCtrainval_06-Nov-2007.zip VOCtest_06-Nov-2007.zip VOCtrainval_11-May-2012.zip; do
  curl -L "$BASE/$f" -o "$f" && unzip -qo "$f" && rm "$f" &
done
wait

python3 - <<'PY'
"""Convert VOC XML annotations to YOLO txt + move images into images/<split>."""
import xml.etree.ElementTree as ET
from pathlib import Path
import shutil

NAMES = ["aeroplane","bicycle","bird","boat","bottle","bus","car","cat","chair","cow",
         "diningtable","dog","horse","motorbike","person","pottedplant","sheep","sofa","train","tvmonitor"]

root = Path(".")
for year, split in (("2012","train"),("2012","val"),("2007","train"),("2007","val"),("2007","test")):
    imgs = root / "images" / f"{split}{year}"
    lbls = root / "labels" / f"{split}{year}"
    imgs.mkdir(parents=True, exist_ok=True)
    lbls.mkdir(parents=True, exist_ok=True)
    voc = root / "VOCdevkit" / f"VOC{year}"
    ids = (voc / "ImageSets" / "Main" / f"{split}.txt").read_text().split()
    for i in ids:
        src = voc / "JPEGImages" / f"{i}.jpg"
        if src.exists():
            shutil.copy(src, imgs / f"{i}.jpg")
        xml = voc / "Annotations" / f"{i}.xml"
        t = ET.parse(xml).getroot()
        w = int(t.find("size/width").text); h = int(t.find("size/height").text)
        lines = []
        for obj in t.iter("object"):
            cls = obj.find("name").text
            if cls not in NAMES or (obj.find("difficult") is not None and obj.find("difficult").text == "1"):
                continue
            b = obj.find("bndbox")
            x1,y1,x2,y2 = (float(b.find(k).text) for k in ("xmin","ymin","xmax","ymax"))
            lines.append(f"{NAMES.index(cls)} {((x1+x2)/2)/w:.6f} {((y1+y2)/2)/h:.6f} {(x2-x1)/w:.6f} {(y2-y1)/h:.6f}")
        (lbls / f"{i}.txt").write_text("\n".join(lines))
print("VOC conversion complete")
PY
echo "VOC ready -> $DIR"

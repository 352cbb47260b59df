"""Dataset preparers (yolov3_tpu/data/converters.py): each dataset's
download and annotation-to-YOLO conversion as a named function, which a
dataset YAML names with `download: converter://<name>` (the reference
exec()s Python from the YAML instead, utils/general.py:420).

- visdrone          reference data/VisDrone.yaml:34-75
- argoverse         reference data/Argoverse.yaml:30-81
- sku110k           reference data/SKU-110K.yaml:30-58
- global_wheat_2020 reference data/GlobalWheat2020.yaml:36-57
- xview             reference data/xView.yaml:88-155
- objects365        reference data/Objects365.yaml:388-441

Each takes the dataset root and writes YOLO labels (`cls xc yc w h`,
normalised) where the YAML's train / val / test keys expect them. A
download happens only when the raw files are not on disk yet, through
utils/downloads.py; image sizes come from the file headers
(data/image_ops.py), without cv2.
"""

from __future__ import annotations

import csv
import json
import shutil
from collections import defaultdict
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.ops.boxes import xyxy2xywhn
from yolov3_tpu_torch.utils.downloads import download
from yolov3_tpu_torch.utils.general import LOGGER

CONVERTERS = {}


def register(name):
    def deco(fn):
        CONVERTERS[name] = fn
        return fn

    return deco


def prepare(name: str, root: Path):
    """Run the registered preparer `name` with dataset root `root`."""
    if name not in CONVERTERS:
        raise KeyError(f"unknown dataset converter {name!r}; have {sorted(CONVERTERS)}")
    return CONVERTERS[name](Path(root))


def _image_size(path: Path):
    """(width, height) from the file's header (JPEG, PNG, BMP), else by decoding it."""
    return tuple(int(v) for v in image_ops.image_size(path))


def autosplit(path: Path, weights=(0.9, 0.1, 0.0), seed=0):
    """Split an image dir into autosplit_{train,val,test}.txt lists.

    Counterpart of the ultralytics `autosplit` the reference xView recipe
    imports (reference data/xView.yaml:90). Deterministic: seeded rng over
    the sorted file list; paths written relative to the dataset root
    (`./<subdir>/<name>`), one file per non-zero weight.
    """
    path = Path(path)
    files = sorted(p for p in path.rglob("*.*")
                   if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"))
    rng = np.random.default_rng(seed)
    idx = rng.choice(3, size=len(files), p=np.asarray(weights, float) / sum(weights))
    names = ("autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt")
    root = path.parent
    for t in names:
        (root / t).unlink(missing_ok=True)
    for f, i in zip(files, idx):
        with open(root / names[i], "a") as fh:
            fh.write(f"./{f.relative_to(root).as_posix()}\n")
    return [root / t for t in names if (root / t).exists()]


@register("visdrone")
def visdrone(root: Path):
    """VisDrone2019-DET: download 3 split zips, convert annotations to YOLO.

    Annotation rows are `x,y,w,h,score,cls,...` in pixels; class 0 is
    'ignored regions' (dropped, score==0 rows), remaining classes shift down
    by 1 (reference data/VisDrone.yaml:38-60).
    """
    base = "https://github.com/ultralytics/assets/releases/download/v0.0.0"
    splits = ("VisDrone2019-DET-train", "VisDrone2019-DET-val", "VisDrone2019-DET-test-dev")
    missing = [s for s in splits if not (root / s).exists()]
    if missing:
        download([f"{base}/{s}.zip" for s in missing], dir=root, curl=True, threads=4)
    for s in splits:
        d = root / s
        (d / "labels").mkdir(parents=True, exist_ok=True)
        for f in sorted((d / "annotations").glob("*.txt")):
            w, h = _image_size((d / "images" / f.name).with_suffix(".jpg"))
            lines = []
            for row in csv.reader(f.read_text().strip().splitlines()):
                if row[4] == "0":  # ignored-regions pseudo-class
                    continue
                x, y, bw, bh = map(int, row[:4])
                cls = int(row[5]) - 1
                box = ((x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h)
                lines.append(f"{cls} {' '.join(f'{v:.6f}' for v in box)}\n")
            (d / "labels" / f.name).write_text("".join(lines))
        LOGGER.info(f"visdrone: converted {s}")


@register("argoverse")
def argoverse(root: Path):
    """Argoverse-HD: manual download required; convert HD JSONs to YOLO.

    Images are a fixed 1920x1200; labels land under
    Argoverse-1.1/labels/<seq_dir>/ mirroring the images tree
    (reference data/Argoverse.yaml:36-81)."""
    if not (root / "Argoverse-1.1").exists():
        raise FileNotFoundError(
            f"Argoverse dataset not found at {root} — it must be downloaded "
            "manually (https://www.argoverse.org) and extracted there")
    tracking = root / "Argoverse-1.1" / "tracking"
    if tracking.exists():
        tracking.rename(root / "Argoverse-1.1" / "images")
    for split in ("train.json", "val.json"):
        a = json.loads((root / "Argoverse-HD" / "annotations" / split).read_text())
        per_file = defaultdict(list)
        for ann in a["annotations"]:
            im = a["images"][ann["image_id"]]
            x, y, bw, bh = ann["bbox"]
            line = (f"{ann['category_id']} {(x + bw / 2) / 1920.0} "
                    f"{(y + bh / 2) / 1200.0} {bw / 1920.0} {bh / 1200.0}\n")
            seq = a["seq_dirs"][im["sid"]]
            per_file[(seq, Path(im["name"]).with_suffix(".txt").name)].append(line)
        for (seq, name), lines in per_file.items():
            d = root / "Argoverse-1.1" / "labels" / seq
            d.mkdir(parents=True, exist_ok=True)
            (d / name).write_text("".join(lines))
        LOGGER.info(f"argoverse: converted {split} ({len(per_file)} label files)")


@register("sku110k")
def sku110k(root: Path):
    """SKU-110K: download tarball, build split lists + single-class labels.

    CSV columns: image,x1,y1,x2,y2,class,image_width,image_height; all boxes
    are class 0 (reference data/SKU-110K.yaml:30-58)."""
    parent = root.parent
    if not (parent / "SKU110K_fixed").exists() and not root.exists():
        download(["https://trax-geometry.s3.amazonaws.com/cvpr_challenge/SKU110K_fixed.tar.gz"],
                 dir=parent, delete=False)
    if (parent / "SKU110K_fixed").exists():
        if root.exists():
            shutil.rmtree(root)
        (parent / "SKU110K_fixed").rename(root)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    for d in ("annotations_train.csv", "annotations_val.csv", "annotations_test.csv"):
        per_image = defaultdict(list)
        order = []
        with open(root / "annotations" / d, newline="") as fh:
            for r in csv.reader(fh):
                im, x1, y1, x2, y2, _, w, h = r[0], *map(float, r[1:5]), r[5], *map(float, r[6:8])
                if im not in per_image:
                    order.append(im)
                xywh = xyxy2xywhn(np.array([[x1, y1, x2, y2]], float), w=w, h=h)[0]
                per_image[im].append(
                    f"0 {xywh[0]:.5f} {xywh[1]:.5f} {xywh[2]:.5f} {xywh[3]:.5f}\n")
        split = d.replace("annotations_", "").replace(".csv", "")
        (root / f"{split}.txt").write_text("".join(f"./images/{s}\n" for s in order))
        for im, lines in per_image.items():
            (root / "labels" / im).with_suffix(".txt").write_text("".join(lines))
        LOGGER.info(f"sku110k: converted {d} ({len(per_image)} images)")


@register("global_wheat_2020")
def global_wheat_2020(root: Path):
    """GlobalWheat2020: download images+labels zips, regroup domain dirs
    under images/ and their JSONs under annotations/
    (reference data/GlobalWheat2020.yaml:36-57)."""
    domains = ("arvalis_1", "arvalis_2", "arvalis_3", "ethz_1", "rres_1", "inrae_1",
               "usask_1", "utokyo_1", "utokyo_2", "nau_1", "uq_1")
    if not any((root / d).exists() or (root / "images" / d).exists() for d in domains):
        download(["https://zenodo.org/record/4298502/files/global-wheat-codalab-official.zip",
                  "https://github.com/ultralytics/assets/releases/download/v0.0.0/GlobalWheat2020_labels.zip"],
                 dir=root)
    for p in ("annotations", "images", "labels"):
        (root / p).mkdir(parents=True, exist_ok=True)
    for d in domains:
        if (root / d).exists():
            (root / d).rename(root / "images" / d)
        j = (root / d).with_suffix(".json")
        if j.exists():
            j.rename((root / "annotations" / d).with_suffix(".json"))
    LOGGER.info("global_wheat_2020: regrouped domain dirs")


# xView type_id (11..94) -> contiguous 0..59; -1 entries are unassigned ids
# (reference data/xView.yaml:105-108).
XVIEW_CLASS2INDEX = [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 1, 2, -1, 3, -1, 4, 5, 6,
                     7, 8, -1, 9, 10, 11, 12, 13, 14, 15, -1, -1, 16, 17, 18, 19, 20, 21, 22,
                     -1, 23, 24, 25, -1, 26, 27, -1, 28, -1, 29, 30, 31, 32, 33, 34, 35, 36,
                     37, -1, 38, 39, 40, 41, 42, 43, 44, 45, -1, -1, -1, -1, 46, 47, 48, 49,
                     -1, 50, 51, -1, 52, -1, -1, -1, 53, 54, -1, 55, -1, -1, 56, -1, 57, -1,
                     58, 59]


@register("xview")
def xview(root: Path):
    """xView: manual download; geojson -> YOLO labels, image-tree regroup,
    then a 90/10 autosplit of train (reference data/xView.yaml:88-155)."""
    geojson = root / "xView_train.geojson"
    if not geojson.exists():
        raise FileNotFoundError(
            f"xView dataset not found at {root} — download train_images.zip, "
            "val_images.zip and xView_train.geojson manually from "
            "https://challenge.xviewdataset.org and extract there")
    data = json.loads(geojson.read_text())
    labels = root / "labels" / "train"
    if labels.exists():
        shutil.rmtree(labels)
    labels.mkdir(parents=True, exist_ok=True)
    sizes = {}
    n = 0
    for feature in data["features"]:
        p = feature["properties"]
        if not p["bounds_imcoords"]:
            continue
        iid = p["image_id"]
        file = root / "train_images" / iid
        if not file.exists():  # the released set has missing tifs
            continue
        try:
            box = np.array([int(v) for v in p["bounds_imcoords"].split(",")], float)
            assert box.shape[0] == 4, f"incorrect box shape {box.shape[0]}"
            cls = XVIEW_CLASS2INDEX[int(p["type_id"])]
            assert 0 <= cls <= 59, f"incorrect class index {cls}"
            if iid not in sizes:
                sizes[iid] = _image_size(file)
            w, h = sizes[iid]
            xywh = xyxy2xywhn(box[None], w=w, h=h, clip=True)[0]
            with open((labels / iid).with_suffix(".txt"), "a") as fh:
                fh.write(f"{cls} {' '.join(f'{v:.6f}' for v in xywh)}\n")
            n += 1
        except Exception as e:  # noqa: BLE001 — reference skips bad labels too
            LOGGER.warning(f"xview: skipping one label for {file}: {e}")
    (root / "images").mkdir(parents=True, exist_ok=True)
    for src, dst in (("train_images", "train"), ("val_images", "val")):
        if (root / src).exists():
            (root / src).rename(root / "images" / dst)
    autosplit(root / "images" / "train")
    LOGGER.info(f"xview: wrote {n} labels for {len(sizes)} images")


@register("objects365")
def objects365(root: Path):
    """Objects365: download annotation JSONs + image patch tarballs, flatten
    images, convert COCO-format annotations to YOLO labels.

    Class ids follow the JSON's category order sorted by category_id (the
    reference's pycocotools getCatIds order, data/Objects365.yaml:422-424);
    lines are written annotation-ordered per image (class-major order in the
    reference — same label set, order is irrelevant to training)."""
    base = "https://dorc.ks3-cn-beijing.ksyun.com/data-set/2020Objects365%E6%95%B0%E6%8D%AE%E9%9B%86"
    for p in ("images", "labels"):
        for q in ("train", "val"):
            (root / p / q).mkdir(parents=True, exist_ok=True)
    for split, patches in (("train", 51), ("val", 44)):
        images, labels = root / "images" / split, root / "labels" / split
        ann = root / f"zhiyuan_objv2_{split}.json"
        if not ann.exists():
            if split == "train":
                download([f"{base}/{split}/zhiyuan_objv2_{split}.tar.gz"], dir=root, delete=False)
                download([f"{base}/{split}/patch{i}.tar.gz" for i in range(patches)],
                         dir=images, curl=True, delete=False, threads=8)
            else:
                download([f"{base}/{split}/zhiyuan_objv2_{split}.json"], dir=root, delete=False)
                download([f"{base}/{split}/images/v1/patch{i}.tar.gz" for i in range(16)],
                         dir=images, curl=True, delete=False, threads=8)
                download([f"{base}/{split}/images/v2/patch{i}.tar.gz" for i in range(16, patches)],
                         dir=images, curl=True, delete=False, threads=8)
        for f in list(images.rglob("*.jpg")):  # flatten patch dirs (list(): we mutate the tree)
            if f.parent != images:
                f.rename(images / f.name)
        a = json.loads(ann.read_text())
        cat_to_cls = {c["id"]: i for i, c in
                      enumerate(sorted(a["categories"], key=lambda c: c["id"]))}
        dims = {im["id"]: (im["width"], im["height"], Path(im["file_name"]).name)
                for im in a["images"]}
        per_file = defaultdict(list)
        for an in a["annotations"]:
            if an.get("iscrowd"):
                continue
            w, h, name = dims[an["image_id"]]
            x, y, bw, bh = an["bbox"]
            xywh = xyxy2xywhn(np.array([[x, y, x + bw, y + bh]], float), w=w, h=h, clip=True)[0]
            per_file[name].append(
                f"{cat_to_cls[an['category_id']]} "
                f"{xywh[0]:.5f} {xywh[1]:.5f} {xywh[2]:.5f} {xywh[3]:.5f}\n")
        for name, lines in per_file.items():
            (labels / Path(name).stem).with_suffix(".txt").write_text("".join(lines))
        LOGGER.info(f"objects365: converted {split} ({len(per_file)} label files)")

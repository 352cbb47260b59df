"""ClearML: `clearml://` dataset versions, debug samples and images with
their boxes (yolov3_tpu/utils/loggers/clearml_utils.py, reference
utils/loggers/clearml/clearml_utils.py:21-150). clearml is imported inside
each function; images are read by the in-tree decoder."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.utils.general import LOGGER, yaml_load

CLEARML_PREFIX = "clearml://"


def construct_dataset(clearml_info_string):
    """A `clearml://<dataset_id>` spec as a dataset dict: the dataset
    version's local copy, whose root holds exactly one YAML with at least
    train, val and names; `path` points at the local copy."""
    assert str(clearml_info_string).startswith(CLEARML_PREFIX)
    dataset_id = str(clearml_info_string)[len(CLEARML_PREFIX):]
    from clearml import Dataset

    dataset_root = Path(Dataset.get(dataset_id=dataset_id).get_local_copy())
    yamls = sorted(list(dataset_root.glob("*.yaml")) + list(dataset_root.glob("*.yml")))
    assert len(yamls) == 1, ("A ClearML dataset must have exactly one yaml file at its root describing "
                             f"train/val/names; found {len(yamls)} in {dataset_root}")
    data = yaml_load(yamls[0])
    assert {"train", "val", "names"} <= set(data), "ClearML dataset yaml must define at least 'train', 'val' and 'names'"
    LOGGER.info(f"clearml:// dataset {dataset_id} resolved to {dataset_root}")
    return {**data, "path": str(dataset_root)}


def log_debug_samples(task, files, title="Debug Samples"):
    """Image files to the task's debug samples, the batch index read from a `_batch<i>` in the name."""
    for f in map(Path, files):
        if not f.exists():
            continue
        it = re.search(r"_batch(\d+)", f.name)
        iteration = int(it.groups()[0]) if it else 0
        task.get_logger().report_image(title=title, series=f.name.replace(f"_batch{iteration}", ""),
                                       local_path=str(f), iteration=iteration)


def log_image_with_boxes(task, image_path, boxes, class_names, conf_threshold=0.25, iteration=0):
    """An image with its detections (n, 6) [xyxy, conf, cls] above
    `conf_threshold` drawn on it, to the task as "Bounding Boxes"."""
    from yolov3_tpu_torch.data import image_ops
    from yolov3_tpu_torch.utils.plots import Annotator, colors

    try:
        im = image_ops.imread(image_path)
    except (OSError, ValueError):
        return
    annotator = Annotator(np.ascontiguousarray(im))
    for *xyxy, conf, cls in boxes:
        if float(conf) < conf_threshold:
            continue
        c = int(cls)
        annotator.box_label([int(v) for v in xyxy], label=f"{class_names.get(c, c)}: {round(100 * float(conf), 1)}%",
                            color=colors(c))
    task.get_logger().report_image(title="Bounding Boxes", series=Path(image_path).name, iteration=iteration,
                                   image=annotator.result()[:, :, ::-1])

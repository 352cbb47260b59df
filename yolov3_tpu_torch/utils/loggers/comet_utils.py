"""Comet: model logging, the `comet://` resume, per-image prediction
logging and an Optimizer sweep (yolov3_tpu/utils/loggers/comet_utils.py,
reference utils/loggers/comet/comet_utils.py:1-121, comet/__init__.py and
comet/hpo.py). comet_ml is imported inside each function."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from yolov3_tpu_torch.ops.boxes import box_iou
from yolov3_tpu_torch.utils.general import LOGGER, yaml_load

COMET_PREFIX = "comet://"
MODEL_NAME = "yolov3_tpu"


def log_model(experiment, ckpt_dir, epoch=0, fitness=0.0, best=False):
    """A checkpoint (directory or file) to the experiment's model registry."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    experiment.log_model(MODEL_NAME, file_or_folder=str(ckpt_dir),
                         metadata={"epoch": int(epoch), "fitness": float(fitness), "best": bool(best)}, overwrite=True)


def check_comet_resume(resume):
    """Resolve `comet://<experiment path>`: every model asset restored under
    runs/comet_resume/<path>/ at its relative path, and the run's opt.yaml.
    Returns {"weights": the directory holding checkpoint.yaml (else the newest
    single file), "opt": the saved options or None, "experiment": the path},
    or None when `resume` is not a comet:// spec."""
    if not isinstance(resume, str) or not resume.startswith(COMET_PREFIX):
        return None
    import comet_ml

    experiment_path = resume[len(COMET_PREFIX):]
    experiment = comet_ml.API().get(experiment_path)
    assert experiment is not None, f"comet experiment not found: {experiment_path}"
    save_dir = Path("runs") / "comet_resume" / experiment_path.replace("/", "_")
    save_dir.mkdir(parents=True, exist_ok=True)

    weights = None
    assets = experiment.get_model_asset_list(MODEL_NAME)
    if assets:
        for asset in assets:
            out = save_dir / asset["fileName"]
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(experiment.get_asset(asset["assetId"], return_type="binary"))
        metas = sorted(save_dir.rglob("checkpoint.yaml"), key=lambda p: len(p.parts))
        if metas:
            weights = metas[0].parent
        else:  # a checkpoint of one file (a reference .pt)
            weights = save_dir / sorted(assets, key=lambda a: a.get("step") or 0)[-1]["fileName"]

    opt = None
    for asset in experiment.get_asset_list(asset_type="all"):
        if asset.get("fileName") == "opt.yaml":
            f = save_dir / "opt.yaml"
            f.write_bytes(experiment.get_asset(asset["assetId"], return_type="binary"))
            opt = yaml_load(f)
            break
    LOGGER.info(f"comet:// resume resolved: weights={weights}, opt={'yes' if opt else 'no'}")
    return {"weights": weights, "opt": opt, "experiment": experiment_path}


def log_predictions(experiment, predn, labelsn, image_path, class_names, state, curr_epoch=0, conf_thres=0.25,
                    iou_thres=0.45, max_images=100):
    """One image's detections above `conf_thres` that match a label at IoU >
    `iou_thres`: the image logged once per (image, epoch) and its boxes
    (labels "<name>-gt" at score 100, detections at conf x 100) kept in
    `state` for the image-metadata.json asset at train end. `state` carries
    {"count", "names", "metadata"} across images and epochs."""
    if state.setdefault("count", 0) >= max_images:
        return
    predn = np.asarray(predn, np.float32)
    labelsn = (np.asarray(labelsn, np.float32) if labelsn is not None and len(labelsn)
               else np.zeros((0, 5), np.float32))
    detections = predn[predn[:, 4] > conf_thres]
    if not len(detections) or not len(labelsn):
        return
    label_idx, det_idx = np.where(box_iou(labelsn[:, 1:5], detections[:, :4]) > iou_thres)
    if not len(label_idx):
        return
    image_name = f"{Path(image_path).stem}_curr_epoch_{curr_epoch}"
    if image_name not in state.setdefault("names", []):
        experiment.log_image(str(image_path), name=image_name)
        state["names"].append(image_name)

    def box(x1, y1, x2, y2):
        return {"x": float(x1), "y": float(y1), "x2": float(x2), "y2": float(y2)}

    metadata = [{"label": f"{class_names.get(int(c), int(c))}-gt", "score": 100, "box": box(*xyxy)}
                for c, *xyxy in labelsn[np.unique(label_idx)].tolist()]
    metadata += [{"label": f"{class_names.get(int(c), int(c))}", "score": float(conf) * 100, "box": box(*xyxy)}
                 for *xyxy, conf, c in detections[np.unique(det_idx)].tolist()]
    state.setdefault("metadata", {})[image_name] = metadata
    state["count"] += 1


def flush_prediction_metadata(experiment, state, curr_epoch=0):
    """The prediction metadata gathered by log_predictions, as image-metadata.json."""
    if state.get("metadata"):
        experiment.log_asset_data(state["metadata"], "image-metadata.json", epoch=int(curr_epoch))


def run_comet_sweep(optimizer_config, train_fn):
    """A Comet Optimizer sweep: `train_fn(params, experiment)` for each
    suggested parameter set, its returned fitness logged. `optimizer_config`
    is a dict or the path of a YAML / JSON {algorithm, spec, parameters}.
    Returns [(params, fitness)]."""
    import comet_ml

    if isinstance(optimizer_config, (str, Path)):
        optimizer_config = yaml_load(optimizer_config)
    results = []
    for experiment in comet_ml.Optimizer(optimizer_config).get_experiments():
        params = {k: experiment.get_parameter(k) for k in optimizer_config.get("parameters", {})}
        fitness = float(train_fn(params, experiment))
        experiment.log_metric("fitness", fitness)
        experiment.end()
        results.append((params, fitness))
    return results

"""Validation CLI (yolov3_tpu/cli/val.py, reference val.py:565-629).

    python -m yolov3_tpu_torch.cli.val --weights runs/train/exp/weights/best --data coco128.yaml --imgsz 640

Tasks: val / test (mAP), speed (conf 0.25, iou 0.45), study (mAP against
imgsz 256..1536, saved to study_*.txt). Several `--weights` make a
concat-NMS Ensemble. `--device` unset means the card; `--device cpu` the
CPU. `--sharded` raises (multi-GPU validation, ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.utils.general import LOGGER, check_yaml, increment_path, print_args


def run(
    data,
    weights="yolov3-tiny",
    batch_size=32,
    imgsz=640,
    conf_thres=0.001,
    iou_thres=0.6,
    max_det=300,
    task="val",
    single_cls=False,
    augment=False,
    verbose=False,
    save_json=False,
    save_txt=False,
    save_conf=False,
    save_hybrid=False,
    half=False,
    workers=1,
    project="runs/val",
    name="exp",
    exist_ok=False,
    sharded=False,
    device=None,
):
    """Validate `weights` on `data`; returns (results, maps, speeds) for the
    val tasks, None for study. device=None means "cuda"."""
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.models.ensemble import attempt_load

    model = attempt_load(weights, device=device)  # several weights: a concat-NMS Ensemble
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)

    if task in ("val", "test", "train", "speed"):
        if task == "speed":  # speed-task settings (reference val.py:605-609)
            conf_thres, iou_thres, save_json = 0.25, 0.45, False
        return validator.run(
            data, model=model, batch_size=batch_size, imgsz=imgsz, conf_thres=conf_thres,
            iou_thres=iou_thres, max_det=max_det, task="val" if task == "speed" else task,
            single_cls=single_cls, augment=augment, verbose=verbose, save_json=save_json,
            save_txt=save_txt, save_conf=save_conf, save_hybrid=save_hybrid, half=half,
            workers=workers, save_dir=save_dir, sharded=sharded,
        )

    if task == "study":  # mAP against latency (reference val.py:611-622)
        w = weights[0] if isinstance(weights, (list, tuple)) else weights
        f = save_dir / f"study_{Path(str(data)).stem}_{Path(str(w)).stem}.txt"
        x, y = list(range(256, 1536 + 128, 128)), []
        for sz in x:
            LOGGER.info(f"Running study imgsz={sz}...")
            t0 = time.time()
            r, _, spd = validator.run(data, model=model, batch_size=batch_size, imgsz=sz, task="val",
                                      save_dir=save_dir)
            y.append(list(r[:4]) + list(spd) + [time.time() - t0])
        np.savetxt(f, y, fmt="%10.4g")
        LOGGER.info(f"Study results saved to {f}")
        return None
    raise ValueError(f"unknown task {task}")


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="coco128.yaml")
    parser.add_argument("--weights", type=str, nargs="+", default="yolov3-tiny",
                        help="checkpoint(s), reference .pt file(s) or a cfg; several -> concat-NMS ensemble")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.001)
    parser.add_argument("--iou-thres", type=float, default=0.6)
    parser.add_argument("--max-det", type=int, default=300)
    parser.add_argument("--task", default="val")
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--save-json", action="store_true")
    parser.add_argument("--save-txt", action="store_true", help="save predictions to save_dir/labels/*.txt")
    parser.add_argument("--save-conf", action="store_true", help="append confidences to --save-txt rows")
    parser.add_argument("--save-hybrid", action="store_true",
                        help="inject ground-truth boxes into NMS (hybrid autolabelling)")
    parser.add_argument("--half", action="store_true", help="bf16 inference (reference --half fp16 analog)")
    parser.add_argument("--sharded", action="store_true",
                        help="data-parallel validation over several GPUs (not ported yet: raises)")
    parser.add_argument("--workers", type=int, default=1, help="dataloader decode threads")
    parser.add_argument("--device", default="", help="cuda (the default) or cpu")
    parser.add_argument("--project", default="runs/val")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--exist-ok", action="store_true")
    opt = parser.parse_args(argv)
    opt.data = check_yaml(opt.data)
    print_args(vars(opt))
    return opt


def main(opt=None):
    opt = opt or parse_opt()
    kw = vars(opt)
    kw["device"] = kw.get("device") or None  # unset: the card
    return run(**kw)


if __name__ == "__main__":
    main()

"""Training CLI (yolov3_tpu/cli/train.py, reference train.py:533-687).

    python -m yolov3_tpu_torch.cli.train --data coco128.yaml --cfg yolov3-tiny --imgsz 640 --batch-size 16 --epochs 3

`--device` unset means the card; `--device cpu` the CPU. `--evolve N` runs
the genetic hyper-parameter search (train/evolve.py). Not ported, and
raising: `--sync-bn` and multi-process runs (`--num-processes`,
`--coordinator`; ROADMAP.md queue 1 item 8), `--entity` / `--upload_dataset`
and a Comet resume (item 7), `--s2d-stem` (item 9). Plots are not ported
(item 5): the run trains without them, as with `--noplots`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from yolov3_tpu_torch.utils.general import LOGGER, check_yaml, print_args


def parse_opt(known=False, argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, default="", help="initial weights checkpoint dir")
    parser.add_argument("--cfg", type=str, default="yolov3-tiny", help="model config name/path")
    parser.add_argument("--data", type=str, default="coco128.yaml")
    parser.add_argument("--hyp", type=str, default="", help="hyperparameters yaml")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=16, help="global batch size across all devices")
    parser.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    parser.add_argument("--noval", action="store_true")
    parser.add_argument("--nosave", action="store_true")
    parser.add_argument("--noautoanchor", action="store_true")
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--optimizer", type=str, choices=["sgd", "adam", "adamw", "rmsprop"], default="sgd")
    parser.add_argument("--quad", action="store_true", help="quad collate: 4 images stitched per sample")
    parser.add_argument("--remat", action="store_true", help="recompute activations in the backward")
    parser.add_argument("--s2d-stem", action="store_true", help="space-to-depth stem (a TPU layout; not ported: raises)")
    parser.add_argument("--rect", action="store_true", help="rectangular training (aspect-ratio batches)")
    parser.add_argument("--noplots", action="store_true", help="save no plot image artifacts")
    parser.add_argument("--label-smoothing", type=float, default=0.0, help="label smoothing epsilon")
    parser.add_argument("--sync-bn", action="store_true", help="SyncBatchNorm (multi-GPU; not ported: raises)")
    parser.add_argument("--workers", type=int, default=2, help="dataloader decode threads")
    parser.add_argument("--cache", type=str, nargs="?", const="ram", default=None,
                        choices=["ram", "disk"], help="cache pre-resized images")
    parser.add_argument("--cos-lr", action="store_true")
    parser.add_argument("--resume", nargs="?", const=True, default=False)
    parser.add_argument("--evolve", type=int, nargs="?", const=300, default=None,
                        help="evolve hyperparameters for N generations")
    parser.add_argument("--multi-scale", action="store_true", help="vary imgsz +/-50%% (bucketed)")
    parser.add_argument("--image-weights", action="store_true")
    parser.add_argument("--freeze", nargs="+", type=int, default=[],
                        help="freeze layers: single N = first N layers, or an explicit list")
    parser.add_argument("--patience", type=int, default=100)
    parser.add_argument("--project", default="runs/train")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--entity", default=None, help="W&B entity (team/user; not ported: raises)")
    parser.add_argument("--upload_dataset", nargs="?", const=True, default=False,
                        help='upload dataset as a tracker artifact (not ported: raises)')
    parser.add_argument("--bbox_interval", type=int, default=-1,
                        help="bbox-image logging interval in epochs (-1: epochs//10)")
    parser.add_argument("--exist-ok", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save-period", type=int, default=-1)
    parser.add_argument("--device", default="", help="cuda (the default) or cpu")
    parser.add_argument("--coordinator", type=str, default=None, help="host:port of process 0 (not ported: raises)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser.parse_known_args(argv)[0] if known else parser.parse_args(argv)


def main(opt=None):
    """Train as `opt` says; returns train()'s (best_fitness, results, save_dir),
    or evolve()'s (best hyp, best fitness) with --evolve."""
    from yolov3_tpu_torch.train.loop import train
    from yolov3_tpu_torch.utils.general import yaml_load

    opt = opt or parse_opt()
    device = opt.device or None  # unset: the card
    if opt.num_processes or opt.coordinator:
        raise NotImplementedError("multi-process training is not ported yet (ROADMAP.md queue 1 item 8)")
    if opt.sync_bn:
        raise NotImplementedError("--sync-bn (SyncBatchNorm across GPUs) is not ported yet (ROADMAP.md queue 1 item 8)")
    print_args(vars(opt))
    if not opt.noplots:
        LOGGER.warning("plots are not ported yet (ROADMAP.md queue 1 item 5): training as with --noplots")
    save_dir = None
    if isinstance(opt.resume, str) and opt.resume.startswith("comet://"):
        raise NotImplementedError("a Comet resume is not ported yet (ROADMAP.md queue 1 item 7)")
    if opt.resume:  # the run dir to resume (reference train.py:642-654)
        if isinstance(opt.resume, str) and Path(opt.resume).exists():
            save_dir = Path(opt.resume)
            if save_dir.parent.name == "weights":  # the checkpoint path itself: its run dir
                save_dir = save_dir.parent.parent
        else:
            import glob
            import os

            items = glob.glob(f"{opt.project}/**/last*", recursive=True)
            assert items, f"no checkpoint found under {opt.project} to resume from"
            save_dir = Path(max(items, key=os.path.getctime)).parent.parent  # .../exp/weights/last -> .../exp

    if opt.evolve:  # genetic hyper-parameter search (reference train.py:689-798)
        from yolov3_tpu_torch.train.evolve import evolve

        base_hyp = yaml_load(check_yaml(opt.hyp)) if opt.hyp else yaml_load(
            Path(__file__).parents[1] / "data" / "hyps" / "scratch-low.yaml")

        def train_fn(hyp_gen):
            _, results, _ = train(
                data=check_yaml(opt.data), cfg=opt.cfg, hyp=hyp_gen, epochs=opt.epochs,
                batch_size=opt.batch_size, imgsz=opt.imgsz, noautoanchor=True, nosave=True,
                single_cls=opt.single_cls, project=opt.project, name="evolve_gen", exist_ok=True,
                seed=opt.seed, patience=opt.patience, device=device,
            )
            return results[:4]

        return evolve(train_fn, base_hyp, generations=opt.evolve, save_dir=Path(opt.project) / "evolve")

    return train(
        save_dir=save_dir,
        data=check_yaml(opt.data),
        cfg=opt.cfg,
        hyp=check_yaml(opt.hyp) if opt.hyp else None,
        weights=opt.weights or None,
        epochs=opt.epochs,
        batch_size=opt.batch_size,
        imgsz=opt.imgsz,
        optimizer=opt.optimizer,
        cos_lr=opt.cos_lr,
        noautoanchor=opt.noautoanchor,
        noval=opt.noval,
        nosave=opt.nosave,
        single_cls=opt.single_cls,
        patience=opt.patience,
        project=opt.project,
        name=opt.name,
        exist_ok=opt.exist_ok,
        seed=opt.seed,
        resume=bool(opt.resume),
        save_period=opt.save_period,
        multi_scale=opt.multi_scale,
        image_weights=opt.image_weights,
        freeze=tuple(opt.freeze),
        quad=opt.quad,
        workers=opt.workers,
        cache_images=opt.cache,
        remat=opt.remat,
        s2d_stem=opt.s2d_stem,
        rect=opt.rect,
        noplots=True,
        label_smoothing=opt.label_smoothing,
        sync_bn=opt.sync_bn,
        entity=opt.entity,
        upload_dataset=opt.upload_dataset,
        bbox_interval=opt.bbox_interval,
        device=device,
    )


if __name__ == "__main__":
    main()

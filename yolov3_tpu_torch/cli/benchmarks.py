"""Format benchmark (yolov3_tpu/cli/benchmarks.py, reference benchmarks.py:44-118).

    python -m yolov3_tpu_torch.cli.benchmarks --weights <checkpoint dir | .pt | cfg> --data coco128.yaml

Exports the model to each format of export.py, validates each artifact
through `MultiBackend` (the checkpoint row validates the model itself),
and logs the table [Format, Size (MB), mAP50-95, ms/img]. `--hard-fail
FLOOR` raises when the checkpoint's mAP50-95 is not above FLOOR (reference
benchmarks.py:114-117). Exports go to runs/export; a pt2 is exported with a
dynamic batch, so a short last batch runs through it too.
"""

from __future__ import annotations

import argparse
import time

from yolov3_tpu_torch import export as export_mod
from yolov3_tpu_torch.utils.general import LOGGER, file_size


def run(weights="yolov3-tiny", data="coco128.yaml", imgsz=640, batch_size=8, hard_fail=None, formats=None,
        pt_only=False, test=False, half=False, device=None):
    """Rows (format, size MB, mAP50-95, ms per image) for each format.
    pt_only: the checkpoint row only; test: export only, no validation (rows
    carry the size); half: bf16 validation and exports (reference
    benchmarks.py --pt-only / --test / --half). A format that fails gives a
    row of None. device=None means "cuda" (and raises without one)."""
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.models.backend import MultiBackend
    from yolov3_tpu_torch.models.loading import load_weights

    results = []
    model = load_weights(weights, device=device)
    fmts = ("checkpoint",) if pt_only else tuple(formats or export_mod.EXPORT_FORMATS)
    for fmt in fmts:
        t0 = time.time()
        try:
            if fmt == "checkpoint":
                if test:
                    results.append((fmt, 0.0, None, None))
                    continue
                r, _, speeds = validator.run(data, model=model, batch_size=batch_size, imgsz=imgsz, half=half)
                size = 0.0
            else:
                out = export_mod.run(weights, include=(fmt,), imgsz=imgsz, batch=batch_size, half=half,
                                     dynamic=fmt == "pt2", device=device)[fmt]
                if out is None:
                    raise RuntimeError(f"{fmt} export failed")
                size = file_size(out)
                if test:  # export-only sweep: sizes, no validation
                    results.append((fmt, size, None, None))
                    LOGGER.info(f"benchmark {fmt}: exported in {time.time() - t0:.1f}s")
                    continue
                backend = MultiBackend(out, imgsz=imgsz, device=device)
                r, _, speeds = validator.run(data, model=backend, batch_size=batch_size, imgsz=imgsz)
            results.append((fmt, size, r[3], speeds[1]))
            LOGGER.info(f"benchmark {fmt}: ok in {time.time() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 — one format's failure is its row, the sweep goes on
            LOGGER.warning(f"benchmark {fmt}: failed — {e}")
            results.append((fmt, None, None, None))

    LOGGER.info(f"\n{'Format':<14}{'Size (MB)':>10}{'mAP50-95':>10}{'ms/img':>10}")
    for fmt, size, mAP, ms in results:
        LOGGER.info(f"{fmt:<14}{(f'{size:.1f}' if size is not None else '-'):>10}"
                    f"{(f'{mAP:.3f}' if mAP is not None else '-'):>10}{(f'{ms:.1f}' if ms is not None else '-'):>10}")

    if hard_fail is not None and not test:
        native = [r for r in results if r[0] == "checkpoint"]
        if not native or native[0][2] is None or native[0][2] <= float(hard_fail):
            raise RuntimeError(f"HARD FAIL: checkpoint mAP50-95 {native[0][2] if native else None} "
                               f"<= floor {hard_fail}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="yolov3-tiny")
    p.add_argument("--data", default="coco128.yaml")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--hard-fail", type=float, default=None)
    p.add_argument("--formats", nargs="+", default=None)
    p.add_argument("--pt-only", action="store_true", help="the checkpoint row only")
    p.add_argument("--test", action="store_true", help="exports only, no validation")
    p.add_argument("--half", action="store_true", help="bf16 validation and exports")
    p.add_argument("--device", default="", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    return run(a.weights, a.data, a.imgsz, a.batch_size, a.hard_fail, a.formats, a.pt_only, a.test, a.half,
               a.device or None)


if __name__ == "__main__":
    main()

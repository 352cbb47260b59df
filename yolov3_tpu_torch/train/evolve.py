"""Hyperparameter evolution: genetic search over the hyp space
(yolov3_tpu/train/evolve.py, reference train.py:689-798).

Per key a (mutation gain, min, max) bound; the parent is drawn from the top
5 rows of evolve.csv by fitness (0.1 * mAP50 + 0.9 * mAP50-95), either one
row weighted by fitness or their weighted mean; each key mutates with
probability 0.8 by a gaussian factor (sigma 0.2), clipped to its bounds.

    from yolov3_tpu_torch.train.evolve import evolve, make_train_fn
    best_hyp, best_fit = evolve(make_train_fn("dataset.yaml", cfg="yolov3", epochs=10), base_hyp,
                                generations=300, save_dir="runs/evolve")

Randomness: the JAX package draws the parent method and row from the
global `random` module and the mutation from np.random.default_rng(seed);
here the first come from `rng` (a random.Random), so a run seeded alike
replays the JAX draws. At the end the evolution's scatter plot is drawn
beside the CSV (evolve.png, utils/plots.plot_evolve; matplotlib needed).
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.utils.general import LOGGER, yaml_save
from yolov3_tpu_torch.utils.plots import plot_evolve

# {key: (mutation gain, min, max)}: the JAX package's table
META = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0),
}
FITNESS_WEIGHTS = np.array([0.0, 0.0, 0.1, 0.9])  # P, R, mAP50, mAP50-95


def mutate(hyp, evolve_csv: Path, mp=0.8, s=0.2, seed=None, rng=None):
    """A mutated copy of `hyp` from the top-5 parents in evolve.csv (when it
    exists). `rng` (random.Random, default one seeded with `seed`) picks the
    parent; np.random.default_rng(seed) draws the mutation."""
    rng = rng if rng is not None else random.Random(seed)
    np_rng = np.random.default_rng(seed)
    keys = [k for k in META if k in hyp]
    evolve_csv = Path(evolve_csv)
    if evolve_csv.exists():
        x = np.loadtxt(evolve_csv, ndmin=2, delimiter=",", skiprows=1)
        n = min(5, len(x))
        x = x[np.argsort(-fitness_col(x))][:n]
        w = fitness_col(x) - fitness_col(x).min() + 1e-6
        method = rng.choices(["single", "weighted"], k=1)[0]
        if method == "single" or len(x) == 1:
            parent = x[rng.choices(range(n), weights=w)[0]]
        else:
            parent = (x * w.reshape(-1, 1)).sum(0) / w.sum()
        for i, k in enumerate(keys):
            hyp[k] = float(parent[i + 4])

    g = np.array([META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (g * (np_rng.random(len(keys)) < mp) * np_rng.normal(0, 1, len(keys)) * np_rng.random() * s
             + 1).clip(0.3, 3.0)
    out = dict(hyp)
    for i, k in enumerate(keys):
        _, lo, hi = META[k]
        out[k] = round(float(np.clip(float(hyp[k]) * v[i], lo, hi)), 5)
    return out


def fitness_col(x):
    """Fitness of evolve.csv rows: columns [P, R, mAP50, mAP50-95, ...]."""
    return (x[:, :4] * FITNESS_WEIGHTS).sum(1)


def log_generation(evolve_csv: Path, hyp, results, keys=None):
    """Append one generation's results and hyps to evolve.csv (the header first)."""
    keys = keys or [k for k in META if k in hyp]
    header = ["P", "R", "mAP50", "mAP50-95", *keys]
    vals = [*results[:4], *[hyp[k] for k in keys]]
    evolve_csv = Path(evolve_csv)
    new = not evolve_csv.exists()
    with open(evolve_csv, "a") as f:
        if new:
            f.write(",".join(header) + "\n")
        f.write(",".join(f"{float(v):.6g}" for v in vals) + "\n")


def evolve(train_fn, base_hyp, generations=300, save_dir=Path("runs/evolve"), seed=0, rng=None):
    """The evolution loop: mutate -> train_fn(hyp) -> results[:4] -> log.
    Writes save_dir/evolve.csv, the best generation's hyp_evolve.yaml and
    the scatter plot evolve.png; returns (best hyp, best fitness). `rng`: the parent draws' random.Random
    (default: one seeded with `seed`), shared across generations as the
    JAX package's global `random` is."""
    rng = rng if rng is not None else random.Random(seed)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    evolve_csv = save_dir / "evolve.csv"
    best_fit, best_hyp = -1.0, dict(base_hyp)
    for gen in range(generations):
        hyp = mutate(dict(base_hyp), evolve_csv, seed=seed + gen, rng=rng)
        results = train_fn(hyp)
        log_generation(evolve_csv, hyp, results)
        fit = float(np.array(results[:4]) @ FITNESS_WEIGHTS)
        if fit > best_fit:
            best_fit, best_hyp = fit, hyp
            yaml_save(save_dir / "hyp_evolve.yaml", hyp)
        LOGGER.info(f"evolve gen {gen + 1}/{generations}: fitness {fit:.4f} (best {best_fit:.4f})")
    try:  # the evolution's scatter plot (reference train.py:778 -> plots.py:243-267)
        plot_evolve(evolve_csv)
    except Exception as e:  # noqa: BLE001 — a plot never stops the search's result
        LOGGER.warning(f"evolve plot failed: {e!r}")
    return best_hyp, best_fit


def make_train_fn(data, project="runs/evolve", **train_kwargs):
    """hyp -> (P, R, mAP50, mAP50-95) of one `train.loop.train` run, as the
    JAX package's train CLI builds it for --evolve: no autoanchor, no
    checkpoints, each generation in project/evolve_gen. `train_kwargs` go to
    `train` (cfg, epochs, batch_size, imgsz, device, ...)."""
    from yolov3_tpu_torch.train.loop import train

    def train_fn(hyp):
        _, results, _ = train(data=data, hyp=hyp, noautoanchor=True, nosave=True, project=project,
                              name="evolve_gen", exist_ok=True, **train_kwargs)
        return results[:4]

    return train_fn

"""Hyperparameter evolution (train/evolve.py) against the JAX package's.

`mutate` with the same seed (the JAX package's global `random` seeded as
the port's random.Random) gives the same hyp, with and without parents in
evolve.csv; `log_generation` and `evolve` over a stub train function write
byte-equal evolve.csv files and the same best hyp; `make_train_fn` runs the
port's `train()` for a generation.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import yaml

from yolov3_tpu.train import evolve as jax_evolve
from yolov3_tpu_torch.data import synthetic
from yolov3_tpu_torch.train import evolve

ROOT = Path(__file__).resolve().parents[1]
BASE = yaml.safe_load((ROOT / "yolov3_tpu_torch/data/hyps/scratch-low.yaml").read_text())


def stub_results(hyp):
    """A deterministic (P, R, mAP50, mAP50-95) of a hyp: a smooth score of a few keys."""
    s = 0.5 + 0.2 * np.tanh(10 * hyp["lr0"]) - 0.1 * abs(hyp["momentum"] - 0.9) + 0.05 * hyp["mosaic"]
    return [s * 0.9, s * 0.8, s, s * 0.6]


def write_parents(path, n=7, seed=3):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        hyp = {k: float(np.clip(v * rng.uniform(0.7, 1.3), *evolve.META[k][1:])) if k in evolve.META else v
               for k, v in BASE.items()}
        jax_evolve.log_generation(path, hyp, list(rng.uniform(0, 1, 4)))


def test_meta_table_equals_jax():
    assert evolve.META == jax_evolve.META


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11])
@pytest.mark.parametrize("parents", [False, True], ids=["no-csv", "csv"])
def test_mutate_matches_jax(tmp_path, seed, parents):
    csv = tmp_path / "evolve.csv"
    if parents:
        write_parents(csv)
    random.seed(seed)
    want = jax_evolve.mutate(dict(BASE), csv, seed=seed)
    got = evolve.mutate(dict(BASE), csv, seed=seed, rng=random.Random(seed))
    assert got == want
    assert got != BASE
    for k, (_, lo, hi) in evolve.META.items():
        if k in got:
            assert lo <= got[k] <= hi, k


def test_fitness_col_equals_jax():
    x = np.random.default_rng(0).uniform(size=(9, 30))
    np.testing.assert_array_equal(evolve.fitness_col(x), jax_evolve.fitness_col(x))


def test_log_generation_is_byte_equal(tmp_path):
    hyp = dict(BASE, lr0=0.0123456789)
    for mod, name in ((jax_evolve, "jax.csv"), (evolve, "port.csv")):
        for r in ([0.1, 0.2, 0.3, 0.4], [1e-7, 0.5, 0.25, 0.125]):
            mod.log_generation(tmp_path / name, hyp, r)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_evolve_is_byte_equal_to_jax(tmp_path):
    random.seed(7)
    want_hyp, want_fit = jax_evolve.evolve(stub_results, dict(BASE), generations=6, save_dir=tmp_path / "jax",
                                           seed=3)
    got_hyp, got_fit = evolve.evolve(stub_results, dict(BASE), generations=6, save_dir=tmp_path / "port", seed=3,
                                     rng=random.Random(7))
    got_csv, want_csv = ((tmp_path / k / "evolve.csv").read_bytes() for k in ("port", "jax"))
    assert got_csv == want_csv and len(got_csv.splitlines()) == 7
    assert got_hyp == want_hyp and got_fit == want_fit
    assert yaml.safe_load((tmp_path / "port/hyp_evolve.yaml").read_text()) == got_hyp


def test_make_train_fn_runs_the_port_trainer(tmp_path):
    data = synthetic.generate(tmp_path / "shapes", n_images=4, imgsz=64, seed=0, n_val=2)
    train_fn = evolve.make_train_fn(data, project=str(tmp_path / "runs"), cfg="yolov3-tiny", epochs=1,
                                    batch_size=2, imgsz=64, workers=1, device="cpu")
    best, fit = evolve.evolve(train_fn, dict(BASE), generations=1, save_dir=tmp_path / "evolve", seed=0)
    rows = np.loadtxt(tmp_path / "evolve" / "evolve.csv", ndmin=2, delimiter=",", skiprows=1)
    assert rows.shape[0] == 1 and ((rows[0, :4] >= 0) & (rows[0, :4] <= 1)).all()
    assert fit == pytest.approx(float(rows[0, :4] @ evolve.FITNESS_WEIGHTS), abs=1e-6)
    assert (tmp_path / "runs" / "evolve_gen" / "results.csv").is_file()
    assert not (tmp_path / "runs" / "evolve_gen" / "weights" / "last").exists()  # nosave

"""Multi-process data-parallel training of the port (parallel/mesh.py,
train/step.py's `mesh`, train.loop.train under a process group) on the CPU.

Two gloo processes (tests/torch_ddp_worker.py, which imports no JAX), each
holding half of a global batch of 4 64x64 images of a narrowed yolov3-tiny,
against one process on the whole batch and against the JAX step on the
global batch. The halves hold different numbers of targets (3 a picture in
the first, 1 in the second), which is where the global-batch loss and a mean
of per-rank losses part.

 - float64: one step at world 2 equals world 1 at rtol 1e-9 (loss, its
   components, grad norm, parameters, momentum, running statistics, EMA);
   remat at world 2 equals plain world 2 alike (atol 1e-12 where an element
   is near 0); both ranks hold the same bits.
 - float32: world 2 equals the JAX step on the global batch, on one device
   and on a 2-device mesh, at tests/test_torch_train_step.py's bars (loss
   rtol 1e-3, state atol 1e-4).
 - the sum of per-rank losses (the reference DDP's mean times its world
   size) is not the global loss: they part by more than 1e-3.
 - train(): one epoch and a resume of a second at world 2 (2 images a rank)
   equal one process at batch 4 (state atol 1e-4), every augmentation off.
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yolov3_tpu.parallel.mesh import replicate as jax_replicate
from yolov3_tpu.parallel.mesh import shard_batch as jax_shard_batch
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolov3_tpu.train.step import init_train_state as jax_init_train_state
from yolov3_tpu.train.step import make_train_step as jax_make_train_step
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from torch_ddp_worker import HYP, OPT_ARGS, one_step, trainer
from yolov3_tpu_torch.data import synthetic
from yolov3_tpu_torch.models.convert import from_jax_train_state, load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.train.loss import LossConfig, compute_loss
from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ddp_worker.py"
STEPS = {"f64": {"dtype": "float64"}, "f64_remat": {"dtype": "float64", "remat": True},
         "f32": {"dtype": "float32"}}
METRICS = ("loss", "lbox", "lobj", "lcls", "grad_norm")


def narrow_tiny():
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3-tiny.yaml").read_text())
    d.update(name="yolov3-tiny", width_multiple=0.125, nc=5)
    return d


def global_batch():
    """4 images; 3 targets a picture in the first half, 1 in the second."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(4, 64, 64, 3), dtype=np.uint8)
    targets = np.zeros((4, 4, 5), np.float32)
    mask = np.zeros((4, 4), bool)
    for i in range(4):
        n = 3 if i < 2 else 1
        targets[i, :n, 0] = rng.integers(0, 5, n)
        targets[i, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        targets[i, :n, 3:5] = rng.uniform(0.15, 0.5, (n, 2))
        mask[i, :n] = True
    return imgs, targets, mask


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(d, world, extra):
    port = free_port()
    procs = []
    for rank in range(world):
        cfg = d / f"config{rank}.json"
        cfg.write_text(json.dumps({"rank": rank, "world": world, "port": port, "dir": str(d), **extra}))
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(cfg)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def collect(procs, d):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def jax_step(devices, variables, batch):
    model = JaxModel.from_config(narrow_tiny(), imgsz=64)
    model = model.replace_variables(jax.tree.map(np.asarray, variables))
    tx, _, _ = jax_build_optimizer("sgd", model.params, HYP, **OPT_ARGS)
    cfg = JaxLossConfig.from_model(model.spec, HYP)
    if devices is None:
        step = jax_make_train_step(model.module, cfg, tx)
        state, metrics = step(jax_init_train_state(model, tx), *batch)
    else:
        mesh = jax_create_mesh(devices)
        step = jax_make_train_step(model.module, cfg, tx, mesh=mesh)
        state, metrics = step(jax_replicate(mesh, jax_init_train_state(model, tx)), *jax_shard_batch(mesh, batch))
    return {k: float(v) for k, v in metrics.items()}, from_jax_train_state(jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp")
    spec = narrow_tiny()
    ref = JaxModel.from_config(spec, imgsz=64)
    variables = jax.tree.map(np.asarray, ref.variables)
    model = load_jax_variables(DetectionModel(parse_spec(spec)), variables)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(init, d / "init.pt")
    batch = global_batch()
    np.savez(d / "batch.npz", imgs=batch[0], targets=batch[1], mask=batch[2])
    data = synthetic.generate(d / "shapes", n_images=8, imgsz=64, seed=2)
    data_yaml = str(d / "shapes" / "dataset.yaml")
    weights = save_checkpoint(d / "init_ckpt", {"model": init}, spec=model.spec)
    assert len(data["names"]) == spec["nc"]
    train_kw = {"data": data_yaml, "weights": str(weights), "epochs": 1}
    procs = launch(d, 2, {"spec": spec, "steps": STEPS,
                          "trainer": {**train_kw, "save_dir": str(d / "w2"), "batch_size": 2}})
    try:  # the one-process references meanwhile
        world1 = {name: one_step(spec, init, batch, getattr(torch, kw["dtype"]), kw.get("remat", False))
                  for name, kw in STEPS.items()}
        world1["trainer"] = trainer(data_yaml, spec, str(weights), str(d / "w1"), 4, 1)
        jax_runs = {"1 device": jax_step(None, variables, batch),
                    "2-device mesh": jax_step(jax.devices()[:2], variables, batch)}
    finally:
        ranks = collect(procs, d)
    return {"world1": world1, "ranks": ranks, "jax": jax_runs, "spec": spec, "init": init, "batch": batch}


def assert_states_close(got, want, rtol=0.0, atol=0.0):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w, key
        else:
            np.testing.assert_allclose(got[key].double().numpy(), w.double().numpy(), rtol=rtol, atol=atol,
                                       err_msg=key)


def test_two_ranks_ran_over_gloo(ddp):
    for r in ddp["ranks"]:
        assert r["backend"] == "gloo" and r["world"] == 2
    batch = ddp["batch"]
    assert batch[2][:2].sum() == 6 and batch[2][2:].sum() == 2  # uneven targets over the halves


@pytest.mark.parametrize("name", ["f64", "f64_remat", "f32"])
def test_ranks_hold_the_same_bits(ddp, name):
    (m0, s0), (m1, s1) = ddp["ranks"][0][name], ddp["ranks"][1][name]
    assert m0 == m1
    assert_states_close(s1, s0)


@pytest.mark.parametrize("name", ["f64", "f64_remat"])
def test_world2_step_equals_world1_in_float64(ddp, name):
    metrics, state = ddp["ranks"][0][name]
    want_metrics, want_state = ddp["world1"]["f64"]
    for key in METRICS:
        np.testing.assert_allclose(metrics[key], want_metrics[key], rtol=1e-9, err_msg=key)
    assert_states_close(state, want_state, rtol=1e-9, atol=1e-12)
    start = ddp["init"]
    moved = [k for k in start if k.endswith(("running_mean", "conv.weight")) and
             not torch.equal(state[f"model/{k}"].float(), start[k].float())]
    assert len(moved) > 10  # the comparison is not vacuous


@pytest.mark.parametrize("where", ["1 device", "2-device mesh"])
def test_world2_step_equals_the_jax_global_batch_step(ddp, where):
    metrics, state = ddp["ranks"][0]["f32"]
    want_metrics, want_state = ddp["jax"][where]
    for key in ("loss", "lbox", "lobj", "lcls"):
        np.testing.assert_allclose(metrics[key], want_metrics[key], rtol=1e-3, err_msg=key)
    state = {k: v for k, v in state.items() if k in want_state}
    assert_states_close(state, want_state, atol=1e-4)


def test_a_sum_of_per_rank_losses_is_another_function(ddp):
    """Each rank's loss on its own half (what DDP averages; the reference
    multiplies by the world size) does not add up to the global batch's loss
    that the world-2 step computes; the uneven targets part them."""
    model = DetectionModel(parse_spec(ddp["spec"]))
    model.load_state_dict(ddp["init"])
    model = model.double().train()
    imgs, targets, mask = ddp["batch"]
    cfg = LossConfig.from_model(model.spec, HYP)
    with torch.no_grad():
        feats = model(torch.from_numpy(imgs).double() / 255.0)
        whole = float(compute_loss(feats, targets, mask, cfg)[0])
        per_rank = [float(compute_loss([f[h] for f in feats], targets[h], mask[h], cfg)[0])
                    for h in (slice(0, 2), slice(2, 4))]
    np.testing.assert_allclose(ddp["ranks"][0]["f64"][0]["loss"], whole, rtol=1e-9)
    assert abs(2 * np.mean(per_rank) - whole) / whole > 1e-3, (per_rank, whole)


def test_two_rank_train_and_resume_equals_one_process(ddp):
    got0, got1 = ddp["ranks"][0]["trainer"]["model"], ddp["ranks"][1]["trainer"]["model"]
    want = ddp["world1"]["trainer"]["model"]
    assert set(got0) == set(want)
    for k, w in want.items():
        assert torch.equal(got0[k], got1[k]), k
        np.testing.assert_allclose(got0[k].double().numpy(), w.double().numpy(), atol=1e-4, err_msg=k)
    assert int(got0["model.0.bn.num_batches_tracked"]) == int(want["model.0.bn.num_batches_tracked"]) == 4

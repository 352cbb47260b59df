"""The port's logger sinks (utils/loggers/) against the JAX package's, on the
CPU, with the fake wandb / comet_ml / clearml modules of
tests/test_loggers_sdk.py installed under both packages.

- One hook sequence (mosaics, per-image val predictions, val plots, epoch
  metrics, a final checkpoint, train end) through both packages' `Loggers`:
  the calls each fake SDK records are equal, file paths compared by name.
- TensorBoard: the scalars read back through tensorboard's event reader
  equal JAX's (tag, step, value), and results.csv is byte-equal.
- Each adapter of wandb_utils / comet_utils / clearml_utils / clearml_hpo
  on the same inputs: equal calls and files.
- train(): `entity` reaches wandb.init and `upload_dataset` the dataset
  artifact as in the JAX train(), up to the first step that needs a model.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

from test_loggers_sdk import (_FakeCometAPIExperiment, _install_fake_clearml, _install_fake_comet,
                              _install_fake_wandb)
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu.utils import loggers as jax_loggers
from yolov3_tpu.utils.callbacks import Callbacks as JaxCallbacks
from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.utils import loggers
from yolov3_tpu_torch.utils.callbacks import Callbacks

OPT = dict(project="runs/train", name="exp", entity="team", resume=False, epochs=4, bbox_interval=2,
           upload_dataset=False)


def names(x):
    """A record with every path replaced by its file name (the two packages write to their own directories)."""
    if isinstance(x, dict):
        return {k: names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(names(v) for v in x)
    if isinstance(x, str) and ("/" in x or "\\" in x):
        return Path(x).name
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def install_all(monkeypatch, tmp_path):
    monkeypatch.setenv("WANDB_API_KEY", "x")
    monkeypatch.setenv("COMET_API_KEY", "x")
    monkeypatch.delenv("WANDB_RUN_ID", raising=False)
    wandb, run = _install_fake_wandb(monkeypatch)
    _, exp = _install_fake_comet(monkeypatch)
    _, task = _install_fake_clearml(monkeypatch, dataset_root=tmp_path)
    return run, exp, task


def drive(lg, cb, root, rng):
    """One short run's hooks; every image either package reads is written by cv2 beforehand."""
    import cv2

    imgs = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    targets = np.concatenate([rng.integers(0, 2, (4, 3, 1)), rng.uniform(0.3, 0.7, (4, 3, 2)),
                              np.full((4, 3, 2), 0.2)], 2).astype(np.float32)
    mask = np.ones((4, 3), bool)
    for ni in range(3):
        cb.run("on_train_batch_end", ni=ni, imgs=imgs, targets=targets, mask=mask)
    img = root / "000007.png"
    cv2.imwrite(str(img), imgs[0][..., ::-1])
    cv2.imwrite(str(root / "val_batch0_pred.jpg"), imgs[1])
    predn = np.array([[10, 10, 40, 40, 0.9, 1], [50, 50, 60, 60, 0.8, 0], [12, 12, 38, 38, 0.1, 1]], np.float32)
    labelsn = np.array([[1, 11, 11, 41, 41]], np.float32)
    ckpt = root / "weights" / "last"
    ckpt.mkdir(parents=True)
    (ckpt / "checkpoint.yaml").write_text("epoch: 0\n")
    for epoch in range(4):
        cb.run("on_train_epoch_end", epoch=epoch)
        cb.run("on_val_image_end", predn=predn, path=str(img), names={0: "cat", 1: "dog"}, labelsn=labelsn)
        cb.run("on_val_end", epoch=epoch)
        cb.run("on_fit_epoch_end", epoch=epoch, fitness=0.1 * epoch, vals=[0.5 / (epoch + 1)] * 13)
        cb.run("on_model_save", epoch=epoch, last=str(ckpt), fitness=0.1 * epoch, best=True,
               final=epoch == 3, save_period=-1)
    cb.run("on_train_end")


def records(run, exp, task):
    return names(dict(
        wandb_logged=run.logged,
        wandb_artifacts=[(a.name, a.type, a.metadata, a.dirs, a.files, aliases) for a, aliases in run.artifacts],
        wandb_finished=getattr(run, "finished", False),
        comet_metrics=exp.metrics, comet_models=exp.models, comet_others=exp.others,
        comet_images=getattr(exp, "images", []), comet_asset_data=getattr(exp, "asset_data", []),
        clearml_images=task.get_logger().images))


def test_hook_sequence_makes_the_same_sdk_calls(monkeypatch, tmp_path):
    got = {}
    for label, mod, bus in (("jax", jax_loggers, JaxCallbacks), ("port", loggers, Callbacks)):
        run, exp, task = install_all(monkeypatch, tmp_path)
        root = tmp_path / label
        root.mkdir()
        lg = mod.Loggers(save_dir=root, opt=types.SimpleNamespace(**OPT), hyp={"lr0": 0.01},
                         include=("csv", "wandb", "clearml", "comet"))
        assert lg.wandb is run and lg.comet is exp and lg.clearml is task and lg.tb is None
        drive(lg, lg.attach(bus()), root, np.random.default_rng(0))
        got[label] = records(run, exp, task)
        got[label + "_csv"] = (root / "results.csv").read_bytes()
        got[label + "_files"] = sorted(p.name for p in root.iterdir())
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key
    assert got["port"]["comet_images"] and got["port"]["clearml_images"] and got["port"]["wandb_artifacts"]
    assert got["port_csv"] == got["jax_csv"]
    assert {"train_batch0.jpg", "train_batch2.jpg", "results.csv"} <= set(got["port_files"])
    assert set(got["port_files"]) == set(got["jax_files"])


def scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    out = {}
    for label, mod in (("jax", jax_loggers), ("port", loggers)):
        lg = mod.Loggers(save_dir=tmp_path / label, include=("csv", "tb"), plots=False)
        assert lg.tb is not None
        for epoch in range(3):
            lg.on_fit_epoch_end([0.1 * (epoch + 1) + k * 0.01 for k in range(13)], epoch)
        lg.on_train_end()
        lg.tb.close()
        out[label] = scalars(tmp_path / label)
    assert out["port"] == out["jax"] and len(out["port"]) == 13 and len(out["port"]["x/lr2"]) == 3
    assert (tmp_path / "port" / "results.csv").read_bytes() == (tmp_path / "jax" / "results.csv").read_bytes()


def test_model_graph_goes_to_tensorboard_as_text(tmp_path):
    """log_model_graph writes the module tree as a TensorBoard text event (as the JAX package writes
    its StableHLO text), and is a no-op without the TensorBoard sink."""
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from yolov3_tpu_torch.models.detection import DetectionModel

    model = DetectionModel.from_config("yolov3-tiny", device="cpu")
    loggers.Loggers(save_dir=tmp_path / "off", include=("csv",)).log_model_graph(model, 64)
    lg = loggers.Loggers(save_dir=tmp_path / "on", include=("csv", "tb"))
    lg.log_model_graph(model, 64)
    lg.tb.close()
    acc = EventAccumulator(str(tmp_path / "on"), size_guidance={"tensors": 0})
    acc.Reload()
    (event,) = acc.Tensors("model/graph/text_summary")
    text = event.tensor_proto.string_val[0].decode()
    assert "input (1, 64, 64, 3) NHWC" in text and "Conv" in text
    assert not (tmp_path / "off").exists()


def test_tensorboard_falls_back_to_tensorflow_then_off(monkeypatch, tmp_path):
    """Without torch.utils.tensorboard the TF writer takes over (as in JAX); without either the sink is off."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    fake_tf = types.ModuleType("tensorflow")
    fake_tf.summary = types.SimpleNamespace(create_file_writer=lambda d: ("writer", d))
    monkeypatch.setitem(sys.modules, "tensorflow", fake_tf)
    lg = loggers.Loggers(save_dir=tmp_path, include=("csv", "tb"))
    assert isinstance(lg.tb, loggers._TFSummaryWriter) and lg.tb._writer == ("writer", str(tmp_path))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    assert loggers.Loggers(save_dir=tmp_path, include=("csv", "tb")).tb is None


def test_sinks_off_without_their_package_or_key(monkeypatch, tmp_path):
    for mod in ("wandb", "comet_ml", "clearml"):
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setenv("WANDB_API_KEY", "x")
    monkeypatch.setenv("COMET_API_KEY", "x")
    lg = loggers.Loggers(save_dir=tmp_path, include=("csv", "wandb", "clearml", "comet"))
    assert (lg.wandb, lg.clearml, lg.comet) == (None, None, None)
    _, _, task = install_all(monkeypatch, tmp_path)
    monkeypatch.delenv("WANDB_API_KEY")
    monkeypatch.delenv("COMET_API_KEY")
    lg = loggers.Loggers(save_dir=tmp_path, include=("csv", "wandb", "clearml", "comet"))
    assert (lg.wandb, lg.clearml, lg.comet) == (None, task, None)  # ClearML needs no key, as in the JAX package


# --- the adapters --------------------------------------------------------------


def both(monkeypatch, fn):
    """fn(package's loggers module path) for each package, each with fresh fake SDKs; returns (port, jax)."""
    out = {}
    for label in ("jax", "port"):
        out[label] = fn(label, "yolov3_tpu" if label == "jax" else "yolov3_tpu_torch")
    return out["port"], out["jax"]


def test_wandb_model_artifact_matches_jax(monkeypatch, tmp_path):
    import importlib

    def run(label, pkg):
        _, wrun = _install_fake_wandb(monkeypatch)
        ckpt = tmp_path / label / "weights" / "last"
        ckpt.mkdir(parents=True)
        (ckpt / "checkpoint.yaml").write_text("epoch: 3\n")
        log_model = importlib.import_module(f"{pkg}.utils.loggers.wandb_utils").log_model
        art = log_model(wrun, ckpt, epoch=3, fitness=0.42, best=True)
        missing = log_model(wrun, tmp_path / label / "none", epoch=1)
        return names([(a.name, a.type, a.metadata, a.dirs, al) for a, al in wrun.artifacts]), art.name, missing

    got, want = both(monkeypatch, run)
    assert got == want and got[1] == "run_abc123_model" and got[2] is None


@pytest.mark.parametrize("assets", [
    {"a1": ("last/checkpoint.yaml", b"epoch: 3\n", True), "a2": ("last/state.pt", b"STATE", True),
     "a3": ("opt.yaml", b"epochs: 7\nimgsz: 320\n", False)},
    {"a1": ("last.pt", b"WEIGHTS", True)}], ids=["checkpoint-dir", "single-file"])
def test_comet_resume_matches_jax(monkeypatch, tmp_path, assets):
    import importlib

    def run(label, pkg):
        _install_fake_comet(monkeypatch, api_experiment=_FakeCometAPIExperiment(assets))
        (tmp_path / label).mkdir()
        monkeypatch.chdir(tmp_path / label)
        check = importlib.import_module(f"{pkg}.utils.loggers.comet_utils").check_comet_resume
        assert check("runs/exp") is None
        out = check("comet://ws/proj/exp1")
        files = sorted((str(p.relative_to(tmp_path / label)), p.read_bytes()) for p in
                       (tmp_path / label / "runs").rglob("*") if p.is_file())
        return str(out["weights"]), out["opt"], out["experiment"], files

    got, want = both(monkeypatch, run)
    assert got == want and got[3]


def test_comet_sweep_and_predictions_match_jax(monkeypatch, tmp_path):
    import importlib

    sweep = [{"lr0": 0.01, "momentum": 0.9}, {"lr0": 0.02, "momentum": 0.95}]
    cfg = {"algorithm": "bayes", "parameters": {"lr0": {}, "momentum": {}}, "spec": {"metric": "fitness"}}

    def run(label, pkg):
        _, exp = _install_fake_comet(monkeypatch, sweep_params=sweep)
        cu = importlib.import_module(f"{pkg}.utils.loggers.comet_utils")
        results = cu.run_comet_sweep(cfg, lambda params, e: params["lr0"] * 10)
        state = {}
        predn = np.array([[10, 10, 40, 40, 0.9, 1], [50, 50, 60, 60, 0.8, 0]], np.float32)
        labelsn = np.array([[1, 11, 11, 41, 41], [0, 100, 100, 120, 120]], np.float32)
        for epoch in (0, 0, 1):
            cu.log_predictions(exp, predn, labelsn, "/a/000007.jpg", {0: "cat", 1: "dog"}, state, curr_epoch=epoch)
        cu.log_predictions(exp, predn[:0], labelsn, "/a/x.jpg", {}, state)
        cu.flush_prediction_metadata(exp, state, curr_epoch=1)
        cu.log_model(exp, tmp_path, epoch=2, fitness=0.5, best=True)
        return names((results, state, exp.images, exp.asset_data, exp.models))

    got, want = both(monkeypatch, run)
    assert got == want and got[1]["count"] == 3 and len(got[2]) == 2  # two (image, epoch) names


def test_clearml_adapters_match_jax(monkeypatch, tmp_path):
    import importlib

    import cv2

    im = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    for n in ("val_batch0_pred.jpg", "val_batch2_labels.jpg", "x.png"):
        cv2.imwrite(str(tmp_path / n), im)

    def run(label, pkg):
        _, task = _install_fake_clearml(monkeypatch, dataset_root=tmp_path)
        cu = importlib.import_module(f"{pkg}.utils.loggers.clearml_utils")
        cu.log_debug_samples(task, [tmp_path / "val_batch0_pred.jpg", tmp_path / "val_batch2_labels.jpg",
                                    tmp_path / "missing.jpg"], "Validation")
        boxes = [[4, 4, 40, 40, 0.9, 1], [2, 2, 10, 10, 0.1, 0]]
        cu.log_image_with_boxes(task, tmp_path / "x.png", boxes, {0: "cat", 1: "dog"}, iteration=3)
        cu.log_image_with_boxes(task, tmp_path / "unreadable.png", boxes, {0: "cat"})
        return names(task.get_logger().images)

    got, want = both(monkeypatch, run)
    assert got == want and len(got) == 3 and got[-1]["has_array"]


def test_clearml_dataset_matches_jax(monkeypatch, tmp_path):
    from yolov3_tpu.data.dataset_yaml import check_dataset as jax_check_dataset
    from yolov3_tpu_torch.data.dataset_yaml import check_dataset

    root = tmp_path / "dsroot"
    (root / "images" / "train").mkdir(parents=True)
    (root / "images" / "val").mkdir(parents=True)
    (root / "data.yaml").write_text("train: images/train\nval: images/val\nnames: [cat, dog]\n")
    _install_fake_clearml(monkeypatch, dataset_root=root)
    got, want = check_dataset("clearml://ds42"), jax_check_dataset("clearml://ds42", autodownload=False)
    assert got == want and got["nc"] == 2 and Path(got["val"]) == root / "images" / "val"
    (root / "extra.yml").write_text("names: [a]\n")
    with pytest.raises(AssertionError, match="exactly one yaml"):
        check_dataset("clearml://ds42")


def test_clearml_hpo_matches_jax(monkeypatch):
    def run(label, pkg):
        import importlib

        calls = {}

        class FakeHPO:
            def __init__(self, **kw):
                calls["init"] = {k: v for k, v in kw.items() if k != "hyper_parameters"}
                calls["ranges"] = [(r.name, r.min_value, r.max_value) for r in kw["hyper_parameters"]]

            def __getattr__(self, name):
                return lambda *a, **k: calls.setdefault("lifecycle", []).append((name, a, k))

        mod = types.ModuleType("clearml")
        mod.Task = types.SimpleNamespace(init=lambda **kw: calls.setdefault("task", kw),
                                         TaskTypes=types.SimpleNamespace(optimizer="optimizer"))
        auto = types.ModuleType("clearml.automation")
        auto.HyperParameterOptimizer = FakeHPO
        auto.UniformParameterRange = lambda name, min_value=None, max_value=None: types.SimpleNamespace(
            name=name, min_value=min_value, max_value=max_value)
        auto.RandomSearch = "random-search"
        monkeypatch.setitem(sys.modules, "clearml", mod)
        monkeypatch.setitem(sys.modules, "clearml.automation", auto)
        monkeypatch.delitem(sys.modules, "clearml.automation.optuna", raising=False)
        importlib.import_module(f"{pkg}.utils.loggers.clearml_hpo").run_clearml_hpo("task123", total_max_jobs=7)
        return calls

    got, want = both(monkeypatch, run)
    assert got == want and got["init"]["optimizer_class"] == "random-search" and len(got["ranges"]) > 20


@pytest.mark.parametrize("opt", [dict(project="runs/custom-proj", name="run7", entity="team", resume="wandb-run://r42"),
                                 dict(project="runs/train", name="exp", entity=None, resume=False)],
                         ids=["named", "defaults"])
def test_wandb_init_matches_jax(monkeypatch, tmp_path, opt):
    def run(label, pkg):
        import importlib

        mod, wrun = _install_fake_wandb(monkeypatch)
        seen = {}
        mod.init = lambda **kw: seen.update(kw) or wrun
        monkeypatch.setenv("WANDB_API_KEY", "x")
        monkeypatch.delenv("WANDB_RUN_ID", raising=False)
        importlib.import_module(f"{pkg}.utils.loggers").Loggers(save_dir=tmp_path, include=("wandb",),
                                                                opt=types.SimpleNamespace(**opt))
        return {k: v for k, v in seen.items() if k != "config"}

    got, want = both(monkeypatch, run)
    assert got == want


def test_wandb_failure_turns_the_sink_off(monkeypatch, tmp_path):
    _, wrun = _install_fake_wandb(monkeypatch)
    monkeypatch.setenv("WANDB_API_KEY", "x")
    lg = loggers.Loggers(save_dir=tmp_path, include=("csv", "wandb"))
    wrun.log = lambda d: (_ for _ in ()).throw(RuntimeError("network down"))
    lg.on_fit_epoch_end(list(range(13)), epoch=0)
    assert lg.wandb is None and wrun.finished
    lg.on_fit_epoch_end(list(range(13)), epoch=1)
    assert (tmp_path / "results.csv").read_text().count("\n") == 3


@pytest.mark.parametrize("epochs,bbox_interval,want", [(30, -1, 3), (5, -1, 1), (30, 7, 7)])
def test_bbox_interval_matches_jax(tmp_path, epochs, bbox_interval, want):
    opt = types.SimpleNamespace(epochs=epochs, bbox_interval=bbox_interval)
    got = loggers.Loggers(save_dir=tmp_path, include=("csv",), opt=opt).bbox_interval
    assert got == jax_loggers.Loggers(save_dir=tmp_path, include=("csv",), opt=opt).bbox_interval == want


def test_generic_logger_matches_jax(tmp_path):
    import cv2

    cv2.imwrite(str(tmp_path / "a.png"), np.zeros((8, 8, 3), np.uint8))
    for label, mod in (("jax", jax_loggers), ("port", loggers)):
        (tmp_path / label).mkdir()
        g = mod.GenericLogger(tmp_path / label, include=("csv",))
        g.log_metrics({"a": 1.0, "b": 2.0}, epoch=0)
        g.log_images([tmp_path / "a.png"])
    assert (tmp_path / "port" / "results.csv").read_bytes() == (tmp_path / "jax" / "results.csv").read_bytes()


def test_tensorboard_images_read_in_tree(tmp_path, monkeypatch):
    """The image sink decodes with image_ops (no cv2): an RGB array of the file's pixels."""
    seen = []
    lg = loggers.Loggers(save_dir=tmp_path, include=("csv",))
    lg.tb = types.SimpleNamespace(add_image=lambda tag, im, step, dataformats: seen.append((tag, im.copy(), step)))
    im = np.random.default_rng(1).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    image_ops.imwrite_png(tmp_path / "P_curve.png", im)
    lg.on_val_end(epoch=0)
    assert [(t, s) for t, _, s in seen] == [("Validation/P_curve", 0)]
    np.testing.assert_array_equal(seen[0][1], im[:, :, ::-1])


# --- train() ------------------------------------------------------------------


@pytest.fixture
def tiny_dataset(tmp_path):
    from yolov3_tpu_torch.data import synthetic

    out = tmp_path / "shapes"
    synthetic.generate(out, n_images=4, imgsz=64, seed=0, n_val=2)
    return out / "dataset.yaml"


@pytest.mark.parametrize("upload_dataset", ["val", True])
def test_train_entity_and_upload_dataset_match_jax(monkeypatch, tmp_path, tiny_dataset, upload_dataset):
    """train(entity=..., upload_dataset=...) of both packages, stopped at the
    model build (an unknown cfg): the same wandb.init arguments and the same
    dataset artifact."""
    from yolov3_tpu.train.loop import train as jax_train
    from yolov3_tpu_torch.train.loop import train

    out = {}
    for label, fn, extra in (("jax", jax_train, {}), ("port", train, {"device": "cpu"})):
        mod, wrun = _install_fake_wandb(monkeypatch)
        seen = {}
        mod.init = lambda **kw: seen.update(kw) or wrun
        monkeypatch.setenv("WANDB_API_KEY", "x")
        monkeypatch.delenv("WANDB_RUN_ID", raising=False)
        with pytest.raises(Exception):  # noqa: B017 — the unknown cfg stops each run after the artifact
            fn(str(tiny_dataset), cfg="no-such-cfg", epochs=3, batch_size=2, imgsz=32, entity="team",
               upload_dataset=upload_dataset, save_dir=tmp_path / label, project=str(tmp_path / "proj"),
               noplots=True, **extra)
        out[label] = names(({k: v for k, v in seen.items() if k != "config"},
                            [(a.name, a.type, a.metadata, a.dirs, a.files) for a, _ in wrun.artifacts]))
    assert out["port"] == out["jax"]
    init, artifacts = out["port"]
    assert init["entity"] == "team" and len(artifacts) == 1
    assert sorted(n for _, n in artifacts[0][3]) == (["val"] if upload_dataset == "val" else ["train", "val"])

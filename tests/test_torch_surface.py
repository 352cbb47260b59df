"""The port's public surface against the JAX package's.

1. A walk over the syntax trees of yolov3_tpu/**/*.py (nothing is imported):
   every public top-level function and class, and every public method of
   those classes, has a counterpart of the same name in the port's module at
   the same path (the Pallas modules map to their `*_cuda.py` wrappers), or
   is an entry of SURFACE_GAPS. Each entry gives a one-line reason and the
   port's counterparts, and each counterpart is checked to exist. An entry
   whose name the port has, or the JAX package no longer has, fails too.
2. The last public names, each held to its JAX counterpart on the CPU: the
   package root's `load_model`, `DetectionModel` and `build_model` (exported
   lazily), `models.detection.build_model`, `DetectionModel.info`,
   `models.detect_head.detect_bias_init` and `utils.autobatch.hbm_bytes`.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "yolov3_tpu", ROOT / "yolov3_tpu_torch"
# the JAX package's Pallas kernels and the port's wrappers of the hand-written CUDA kernels that replace them
PALLAS_TO_CUDA = {"ops/conv_bn_pallas.py": "ops/conv_bn_cuda.py", "ops/nms_pallas.py": "ops/nms_cuda.py",
                  "ops/score_pallas.py": "ops/score_cuda.py"}

# "<JAX module path>:<name>" -> (why the port has no same-named counterpart, its counterparts as
# "module:attribute[.attribute]" references, or () where the JAX name has no counterpart at all)
SURFACE_GAPS = {
    "cli/val.py:load_weights": (
        "the JAX val CLI's own checkpoint-or-cfg loader; the port's CLIs share the package's one",
        ("yolov3_tpu_torch.models.loading:load_weights",)),
    "export.py:export_stablehlo": (
        "StableHLO is XLA's program format; the port exports torch.export programs", ("yolov3_tpu_torch.export:export_pt2",)),
    "models/convert.py:convert_torch_checkpoint": (
        "a reference .pt is not converted into flax variables: its state dict loads into the port's modules",
        ("yolov3_tpu_torch.models.convert:load_torch_checkpoint",
         "yolov3_tpu_torch.models.convert:match_torch_state_dict")),
    "models/convert.py:load_torch_state_dict": (
        "reads a .pt's state dict (stub-unpickled module trees included)",
        ("yolov3_tpu_torch.models.convert:load_torch_checkpoint",)),
    "models/convert.py:torch_key_to_path": (
        "the port's state-dict keys are the reference's own; the inverse map carries JAX variables in",
        ("yolov3_tpu_torch.models.convert:from_jax_variables",)),
    "models/detection.py:DetectionModel.params": (
        "flax's parameter collection; an nn.Module holds its parameters",
        ("yolov3_tpu_torch.models.detection:DetectionModel.parameters",
         "yolov3_tpu_torch.models.detection:DetectionModel.state_dict")),
    "models/detection.py:DetectionModel.predict_augmented": (
        "test-time augmentation is `predict(augment=True)` over the module-level function",
        ("yolov3_tpu_torch.models.detection:DetectionModel.predict",
         "yolov3_tpu_torch.models.detection:predict_augmented")),
    "models/detection.py:DetectionModel.replace_variables": (
        "a flax handle is immutable; an nn.Module loads new weights in place",
        ("yolov3_tpu_torch.models.detection:DetectionModel.load_state_dict",)),
    "models/detection.py:YOLOGraph": (
        "the flax module graph behind the handle; in the port the handle is the nn.Module graph",
        ("yolov3_tpu_torch.models.detection:DetectionModel.forward",)),
    "models/detection.py:cast_variables_for_inference": (
        "casts a variables tree; the port casts the module's weights",
        ("yolov3_tpu_torch.models.detection:cast_for_inference",)),
    "models/detection.py:fuse_model": (
        "the functional form of the BN fold", ("yolov3_tpu_torch.models.detection:DetectionModel.fuse",)),
    "models/detection.py:predict_augmented_pure": (
        "the jit-pure form of test-time augmentation", ("yolov3_tpu_torch.models.detection:predict_augmented",)),
    "models/ensemble.py:Ensemble.variables": (
        "the members' flax variables; each member is an nn.Module holding its own",
        ("yolov3_tpu_torch.models.detection:DetectionModel.state_dict",)),
    "models/fuse.py:fuse_variables": (
        "folds a variables tree; the port folds a state dict",
        ("yolov3_tpu_torch.models.fuse:fuse_state_dict", "yolov3_tpu_torch.models.detection:DetectionModel.fuse")),
    "nn/modules.py:TorchBatchNorm": (
        "flax's BatchNorm made to follow torch's momentum and variance; the port uses torch's own",
        ("torch.nn:BatchNorm2d",)),
    "nn/modules.py:max_pool2d": (
        "torch's -inf-padded max pooling written for flax; the port's MaxPool calls torch's",
        ("torch.nn.functional:max_pool2d", "yolov3_tpu_torch.nn.modules:MaxPool")),
    "ops/nms_pallas.py:pallas_greedy_nms": (
        "the Pallas greedy NMS (K1); its port is the CUDA kernel csrc/nms.cu behind this wrapper",
        ("yolov3_tpu_torch.ops.nms_cuda:greedy_nms", "yolov3_tpu_torch.ops.nms_cuda:greedy_nms_plain")),
    "ops/score_pallas.py:masked_scores_pallas": (
        "the Pallas candidate-score pass (K2); its port is the CUDA kernel csrc/score.cu behind this wrapper",
        ("yolov3_tpu_torch.ops.score_cuda:masked_scores", "yolov3_tpu_torch.ops.score_cuda:masked_scores_plain")),
    "parallel/mesh.py:batch_sharding": (
        "a jax.sharding of the batch axis; the port's Mesh splits a batch over its devices",
        ("yolov3_tpu_torch.parallel.mesh:Mesh.map",)),
    "parallel/mesh.py:replicated": (
        "a replicated jax.sharding; the port's Mesh copies a module to each device",
        ("yolov3_tpu_torch.parallel.mesh:Mesh.replicas",)),
    "train/optim.py:freeze_mask": (
        "an optax mask of frozen leaves; the port leaves frozen parameters out of the optimizer",
        ("yolov3_tpu_torch.train.optim:frozen_names", "yolov3_tpu_torch.train.optim:build_optimizer")),
    "train/optim.py:is_bias_path": (
        "labels a flax leaf path; the port labels a state-dict key", ("yolov3_tpu_torch.train.optim:param_label",)),
    "train/optim.py:is_bn_scale_path": (
        "labels a flax leaf path; the port labels a state-dict key", ("yolov3_tpu_torch.train.optim:param_label",)),
    "train/optim.py:make_param_labels": (
        "optax's multi_transform labels; the port builds torch parameter groups from the labels",
        ("yolov3_tpu_torch.train.optim:param_label", "yolov3_tpu_torch.train.optim:build_optimizer")),
    "train/optim.py:sgd_with_schedules": (
        "an optax SGD chain with its schedules; the port wraps torch.optim.SGD",
        ("yolov3_tpu_torch.train.optim:build_optimizer", "yolov3_tpu_torch.train.optim:ScheduledOptimizer")),
    "utils/general.py:check_font": (
        "resolves a TrueType font for drawing; the port draws from its in-tree glyph atlas",
        ("yolov3_tpu_torch.utils.plots:Annotator",)),
    "utils/general.py:enable_compilation_cache": ("XLA's persistent compilation cache: JAX only", ()),
    "utils/profiling.py:compile_forward": ("XLA's ahead-of-time compile of the forward: JAX only", ()),
}


def public_names(path):
    """Public top-level functions and classes, and `Class.method` for their
    public methods (properties included)."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and not m.name.startswith("_")}
    return names


def bound_names(path):
    """Every name a module binds at top level (definitions, assignments and
    imports: its attributes), and its classes' public methods."""
    tree = ast.parse(path.read_text(), str(path))
    names = public_names(path)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def port_path(rel):
    return PORT_PKG / PALLAS_TO_CUDA.get(rel, rel)


def missing_names(rel):
    port = port_path(rel)
    ours = bound_names(port) if port.is_file() else set()
    return {f"{rel}:{name}" for name in public_names(JAX_PKG / rel) if name not in ours}


def resolve(ref):
    module, attr = ref.split(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def test_the_walk_sees_both_packages():
    assert len(JAX_MODULES) > 60 and "models/detection.py" in JAX_MODULES and "ops/nms_pallas.py" in JAX_MODULES
    assert {"DetectionModel", "DetectionModel.fuse", "build_model"} <= public_names(JAX_PKG / "models/detection.py")
    assert all(port_path(rel).is_file() for rel in PALLAS_TO_CUDA)
    # a name the port lacks is found
    assert "export.py:export_stablehlo" in missing_names("export.py")


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_public_name_has_a_port_counterpart(rel):
    """The module's public names the port lacks are exactly its SURFACE_GAPS entries."""
    missing = missing_names(rel)
    listed = {k for k in SURFACE_GAPS if k.split(":")[0] == rel}
    assert not missing - listed, f"JAX public names with no counterpart in the port and no SURFACE_GAPS entry: " \
                                 f"{sorted(missing - listed)}"
    assert not listed - missing, f"SURFACE_GAPS entries the port now has, or JAX no longer has: " \
                                 f"{sorted(listed - missing)}"


@pytest.mark.parametrize("key", sorted(SURFACE_GAPS))
def test_gap_reasons_name_port_counterparts_that_exist(key):
    reason, refs = SURFACE_GAPS[key]
    assert reason and "\n" not in reason
    for ref in refs:
        assert ref.split(".")[0] in ("yolov3_tpu_torch", "torch"), ref
        assert callable(resolve(ref)) or isinstance(resolve(ref), property), ref
    if not refs:
        assert "JAX only" in reason, "an entry without a counterpart says why: JAX only"


def test_gap_table_is_current():
    """The ported names of this slice are found by the walk, not listed."""
    for key in ("__init__.py:load_model", "models/detection.py:build_model", "models/detection.py:DetectionModel.info",
                "models/detect_head.py:detect_bias_init", "utils/autobatch.py:hbm_bytes"):
        assert key not in SURFACE_GAPS
        assert key not in missing_names(key.split(":")[0])


# --- 2. the last public names against the JAX package ---------------------------------------------------


def test_package_root_exports_lazily():
    """`yolov3_tpu_torch` has the JAX root's names, and importing it (or a
    utility submodule) does not import the model graph."""
    code = ("import sys, yolov3_tpu_torch, yolov3_tpu_torch.utils.general; "
            "assert 'yolov3_tpu_torch.models.detection' not in sys.modules, 'eager'; "
            "from yolov3_tpu_torch import DetectionModel, build_model, load_model; "
            "from yolov3_tpu_torch.models import detection; "
            "assert DetectionModel is detection.DetectionModel and build_model is detection.build_model")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    import yolov3_tpu_torch

    assert sorted(yolov3_tpu_torch.__all__) == ["DetectionModel", "build_model", "load_model"]
    with pytest.raises(AttributeError, match="no attribute 'missing'"):
        yolov3_tpu_torch.missing  # noqa: B018
    jax_root = ast.parse((JAX_PKG / "__init__.py").read_text())
    jax_names = {a.asname or a.name for n in jax_root.body if isinstance(n, ast.ImportFrom) for a in n.names}
    jax_names |= {n.name for n in jax_root.body if isinstance(n, ast.FunctionDef)}
    assert jax_names == set(yolov3_tpu_torch.__all__)


def logged(monkeypatch, logger, fn):
    lines = []
    monkeypatch.setattr(logger, "info", lambda msg, *a, **k: lines.append(str(msg)))
    out = fn()
    monkeypatch.undo()
    return out, lines


@pytest.mark.parametrize("entry", ["load_model", "build_model"])
def test_load_and_build_model_and_info_match_jax(entry, monkeypatch):
    import yolov3_tpu
    import yolov3_tpu_torch
    from yolov3_tpu.utils.general import LOGGER as JAX_LOGGER
    from yolov3_tpu_torch.models import detection
    from yolov3_tpu_torch.utils.general import LOGGER

    ref = getattr(yolov3_tpu, entry)("yolov3-tiny")
    model = getattr(yolov3_tpu_torch, entry)("yolov3-tiny", device="cpu")
    assert isinstance(model, detection.DetectionModel) and model.device.type == "cpu"
    want, want_lines = logged(monkeypatch, JAX_LOGGER, ref.info)
    got, got_lines = logged(monkeypatch, LOGGER, model.info)
    assert got == want == model.num_params() == 8852366
    assert got_lines == want_lines == ["yolov3-tiny: 21 spec layers, 8,852,366 parameters, strides [16, 32], nc=80"]
    # models.detection.build_model is the same function; nc and seeds pass through
    narrow = detection.build_model("yolov3-tiny", nc=3, seed=1, device="cpu")
    assert narrow.spec.nc == 3 and narrow.num_params() < model.num_params()


def test_load_model_takes_device_none_as_the_card(monkeypatch):
    import yolov3_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolov3_tpu_torch.load_model("yolov3-tiny")


@pytest.mark.parametrize("imgsz", [640.0, 320.0])
def test_detect_bias_init_matches_jax(imgsz):
    from yolov3_tpu.models.detect_head import detect_bias_init as jax_detect_bias_init
    from yolov3_tpu_torch.models.detect_head import detect_bias_init

    for nc, na, stride in ((80, 3, 8), (80, 3, 16), (80, 3, 32), (3, 2, 16)):
        want = np.asarray(jax_detect_bias_init(nc, na, stride, imgsz)(jax.random.PRNGKey(0), (na * (nc + 5),)))
        got = detect_bias_init(nc, na, stride, imgsz)
        assert got.dtype == torch.float32 and got.shape == (na * (nc + 5),)
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(detect_bias_init(80, 3, 8), detect_bias_init(80, 3, 8, 640.0))


def test_head_init_is_detect_bias_init():
    """The seeded init's head biases are detect_bias_init at 640 in their bits."""
    from yolov3_tpu_torch.models.detect_head import detect_bias_init
    from yolov3_tpu_torch.models.detection import DetectionModel

    model = DetectionModel.from_config("yolov3-tiny", nc=3, device="cpu")
    detect = model.model[-1]
    for conv, stride in zip(detect.m, detect.strides):
        assert torch.equal(conv.bias.detach(), detect_bias_init(3, detect.na, stride))


def test_hbm_bytes(monkeypatch):
    from yolov3_tpu_torch.utils import autobatch

    with pytest.raises(ValueError, match="not a CUDA device"):
        autobatch.hbm_bytes("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autobatch.hbm_bytes()
    seen = []

    class Props:
        total_memory = 85520809984

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: seen.append(d) or Props())
    assert autobatch.hbm_bytes() == 85520809984 and seen == [torch.device("cuda")]
    assert autobatch.hbm_bytes("cuda:1") == 85520809984 and seen[-1] == torch.device("cuda:1")

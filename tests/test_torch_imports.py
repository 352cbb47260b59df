"""Import hygiene of the PyTorch port: it never imports JAX, flax, optax or
the JAX package, nor OpenCV or Pillow at module level (JPEG, PNG and BMP
are decoded in-tree; other formats and video import one of them inside the
function that reads them), and its entry points refuse to drop to the CPU
on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "yolov3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "flax", "optax", "yolov3_tpu"}
TRAIN_MODULES = ("train/__init__.py", "train/loss.py", "train/optim.py", "train/step.py", "ops/conv_bn_cuda.py",
                 "train/loop.py", "data/__init__.py", "data/augment.py", "data/datasets.py", "data/dataset_yaml.py",
                 "data/image_ops.py", "data/synthetic.py", "ops/host_build.py", "utils/autoanchor.py",
                 "utils/autobatch.py", "utils/callbacks.py", "utils/checkpoint.py", "utils/loggers/__init__.py",
                 "train/evolve.py", "serve.py", "ops/nms.py")
IMAGE_LIBRARIES = {"cv2", "PIL"}
DETECT_MODULES = ("data/loaders.py", "utils/plots.py", "models/loading.py", "models/ensemble.py",
                  "models/autoshape.py", "hub.py", "cli/__init__.py", "cli/detect.py", "cli/val.py", "cli/train.py")


def imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append((node.module.split(".")[0], node.lineno))
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(m, line) for m, line in imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_image_library_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    roots = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & IMAGE_LIBRARIES, f"{path.relative_to(ROOT)} imports {roots & IMAGE_LIBRARIES} at module level"


def test_walk_covers_the_train_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(TRAIN_MODULES) <= walked


def test_walk_covers_the_detect_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(DETECT_MODULES) <= walked


def test_detect_import_loads_no_jax_cv2_or_pil():
    modules = ", ".join("yolov3_tpu_torch." + m[:-3].replace("/", ".").replace(".__init__", "")
                        for m in DETECT_MODULES)
    _assert_import_loads_no_jax(modules)
    code = (f"import sys, {modules}; "
            "from yolov3_tpu_torch.data import image_ops; "
            "image_ops.imread('yolov3_tpu_torch/data/images/sample1.jpg'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _assert_import_loads_no_jax(modules):
    code = (f"import sys, {modules}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'yolov3_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_serve_import_loads_no_jax():
    _assert_import_loads_no_jax("yolov3_tpu_torch.serve, yolov3_tpu_torch.models.convert")


def test_train_import_loads_no_jax():
    _assert_import_loads_no_jax("yolov3_tpu_torch.train.step, yolov3_tpu_torch.train.optim, "
                                "yolov3_tpu_torch.train.loss, yolov3_tpu_torch.ops.conv_bn_cuda")


def test_trainer_import_loads_no_jax_cv2_or_pil():
    modules = ("yolov3_tpu_torch.train.loop, yolov3_tpu_torch.data.datasets, yolov3_tpu_torch.data.synthetic, "
               "yolov3_tpu_torch.utils.autobatch, yolov3_tpu_torch.train.evolve, yolov3_tpu_torch.serve")
    _assert_import_loads_no_jax(modules)
    code = (f"import sys, {modules}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_eval_import_loads_no_jax():
    _assert_import_loads_no_jax("yolov3_tpu_torch.eval.validator, yolov3_tpu_torch.eval.cocoeval, "
                                "yolov3_tpu_torch.ops.score_cuda")


def test_device_none_raises_without_cuda(monkeypatch):
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.utils.general import select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionModel.from_config("yolov3-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device(None)
    from yolov3_tpu_torch.train.loop import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(data="unused.yaml")
    assert select_device("cpu") == torch.device("cpu")


def test_wrappers_reject_other_devices():
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores

    with pytest.raises(ValueError, match="unsupported device"):
        masked_scores(torch.zeros(1, 4, 255, device="meta"), 3, 85, 0.25)
    z = torch.zeros(1, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        greedy_nms(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 4, 4, device="meta"), z, z)
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_bn_stats(torch.zeros(1, 4, 4, 3, device="meta"), torch.zeros(3, 3, 3, 8, device="meta"))

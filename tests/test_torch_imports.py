"""Import hygiene of the PyTorch port: it never imports JAX, flax, optax or
the JAX package, nor OpenCV or Pillow at module level (JPEG, PNG and BMP
are decoded in-tree; other formats and video import one of them inside the
function that reads them), nor matplotlib, seaborn or pandas (the plots
import them inside the function that draws), and its entry points refuse to
drop to the CPU on their own."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

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
EXPORT_MODULES = ("export.py", "models/backend.py", "models/onnx_native.py", "models/onnx_runtime.py",
                  "models/tf_graph.py", "cli/benchmarks.py")
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py")
UTILITY_MODULES = ("utils/env.py", "utils/checks.py", "utils/profiling.py", "utils/plots.py")
PLOT_LIBRARIES = {"matplotlib", "seaborn", "pandas"}  # optional: imported inside the functions that draw
HOST_MODULES = ("native/__init__.py", "utils/downloads.py", "data/converters.py", "utils/loggers/__init__.py",
                "utils/loggers/wandb_utils.py", "utils/loggers/clearml_utils.py", "utils/loggers/clearml_hpo.py",
                "utils/loggers/comet_utils.py")
SDKS = ("wandb", "clearml", "comet_ml", "tensorboard", "tensorflow")  # optional: imported inside their sinks


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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_plot_library_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    roots = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & PLOT_LIBRARIES, f"{path.relative_to(ROOT)} imports {roots & PLOT_LIBRARIES} at module level"


def test_walk_covers_the_utility_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(UTILITY_MODULES) <= walked


def test_utility_import_loads_no_jax_cv2_pil_or_plot_library():
    modules = ", ".join("yolov3_tpu_torch." + m[:-3].replace("/", ".") for m in UTILITY_MODULES)
    _assert_import_loads_no_jax(modules)
    code = (f"import sys, {modules}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL', 'matplotlib', 'seaborn', "
            "'pandas')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_walk_covers_the_host_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(HOST_MODULES) <= walked


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_sdk_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    roots = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & set(SDKS), f"{path.relative_to(ROOT)} imports {roots & set(SDKS)} at module level"


def test_host_import_loads_no_jax_cv2_pil_or_sdk():
    """The host modules, a JPEG written and the host NMS run, with no cv2, PIL or tracker SDK loaded."""
    modules = ", ".join("yolov3_tpu_torch." + m[:-3].replace("/", ".").replace(".__init__", "")
                        for m in HOST_MODULES)
    _assert_import_loads_no_jax(modules)
    code = (f"import sys, tempfile, numpy as np, {modules}; "
            "from yolov3_tpu_torch.data import image_ops; from yolov3_tpu_torch.native import greedy_nms_batch; "
            "image_ops.imwrite(tempfile.mktemp(suffix='.jpg'), np.zeros((9, 9, 3), np.uint8)); "
            "b = np.zeros((1, 4, 4), np.float32); greedy_nms_batch(b, b, np.ones((1, 4), np.float32), "
            "np.zeros((1, 4), np.float32)); "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL') + {SDKS!r}); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_roadmap_items_cited_are_open():
    """Every "ROADMAP.md queue 1 item N" in the port (code, comments and
    messages, chip_smoke.py too) names an item that ROADMAP.md's queue 1
    still lists under that number. Queue 1 may be empty, and then no
    citation may be left."""
    import re

    def citations(text):
        text = re.sub(r'"\s*\n\s*f?"', "", text)  # join implicitly concatenated string literals
        return [int(n) for n in re.findall(r"ROADMAP\.md\s+queue\s+1,?\s+item\s+(\d+)", re.sub(r"\s+", " ", text))]

    # the search finds a citation split over lines and string literals
    assert citations('raise X("not ported (ROADMAP.md "\n    "queue 1 item 9)")') == [9]
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue = roadmap.split("### 1. Modules to port", 1)[1].split("\n### 2.", 1)[0]
    open_items = {int(n) for n in re.findall(r"^(\d+)\. \*\*", queue, flags=re.M)}
    cited = {}
    for path in PORT_FILES:
        for n in citations(path.read_text()):
            cited.setdefault(n, []).append(str(path.relative_to(ROOT)))
    stale = {n: files for n, files in cited.items() if n not in open_items}
    assert not stale, f"cited items {stale} are not open in ROADMAP.md queue 1 (open: {sorted(open_items)})"


def test_walk_covers_the_train_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(TRAIN_MODULES) <= walked


def test_walk_covers_the_detect_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(DETECT_MODULES) <= walked


def test_walk_covers_the_export_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(EXPORT_MODULES) <= walked


def test_walk_covers_the_parallel_modules():
    walked = {str(p.relative_to(ROOT / "yolov3_tpu_torch")) for p in PORT_FILES[:-1]}
    assert set(PARALLEL_MODULES) <= walked


def test_parallel_import_loads_no_jax():
    _assert_import_loads_no_jax("yolov3_tpu_torch.parallel, yolov3_tpu_torch.parallel.mesh")


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


def test_export_import_loads_no_jax():
    _assert_import_loads_no_jax(", ".join("yolov3_tpu_torch." + m[:-3].replace("/", ".") for m in EXPORT_MODULES))


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


# --- the port's YAMLs and scripts run and name the port's own files ------------

PORT_YAMLS = sorted((ROOT / "yolov3_tpu_torch").rglob("*.yaml"))
PORT_SCRIPTS = sorted((ROOT / "yolov3_tpu_torch").rglob("*.sh"))
JAX_PATH = re.compile(r"\byolov3_tpu(?!_torch)[/.]")  # a file path or module of the JAX package


def yaml_strings(node):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from yaml_strings(k)
            yield from yaml_strings(v)
    elif isinstance(node, list):
        for v in node:
            yield from yaml_strings(v)
    elif isinstance(node, str):
        yield node


def test_the_port_has_its_download_scripts():
    names = {p.name for p in PORT_SCRIPTS}
    assert {"get_coco.sh", "get_coco128.sh", "get_voc.sh", "download_weights.sh"} <= names
    assert all(p.parent == ROOT / "yolov3_tpu_torch/data/scripts" for p in PORT_SCRIPTS)
    recipes = [yaml.safe_load(p.read_text()).get("download") for p in PORT_YAMLS if p.parent.name == "data"]
    assert sum(str(r).startswith("bash ") for r in recipes) == 2  # coco.yaml and VOC.yaml


@pytest.mark.parametrize("path", PORT_YAMLS, ids=lambda p: str(p.relative_to(ROOT)))
def test_yaml_runs_and_names_only_port_files(path):
    """A `download: bash ...` recipe runs a script under yolov3_tpu_torch/
    (data/dataset_yaml.py runs it from the repository's root), and no value
    names a file or module of the JAX package."""
    d = yaml.safe_load(path.read_text()) or {}
    recipe = d.get("download") if isinstance(d, dict) else None
    if isinstance(recipe, str) and recipe.startswith("bash "):
        script = recipe.split()[1]
        assert script.startswith("yolov3_tpu_torch/") and (ROOT / script).is_file(), recipe
    bad = [v for v in yaml_strings(d) if JAX_PATH.search(v)]
    assert not bad, f"{path.relative_to(ROOT)} names the JAX package: {bad}"
    if path.parent.name == "data":  # the dataset YAMLs' comments too: their usage lines point at the port
        assert not JAX_PATH.search(path.read_text()), f"{path.relative_to(ROOT)} names the JAX package"


@pytest.mark.parametrize("path", PORT_SCRIPTS, ids=lambda p: str(p.relative_to(ROOT)))
def test_script_names_only_port_files(path):
    text = path.read_text()
    assert not JAX_PATH.search(text), f"{path.relative_to(ROOT)}: {JAX_PATH.findall(text)}"
    usage = [ln.split()[3] for ln in text.splitlines() if ln.startswith("# Usage: bash ")]
    assert usage == [str(path.relative_to(ROOT))]  # its usage line names the port's copy

"""The port's small utilities against the JAX package's: utils/general.py's
helpers, utils/env.py, utils/checks.py and the dataset YAMLs.

- general: one_cycle, clean_url, emojis and file_date equal JAX's; Timeout,
  TryExcept, threaded, WorkingDirectory and get_latest_run behave as JAX's
  (tests/test_aux_utils.py:14, 24).
- env: the probes answer as JAX's; imwrite / imread round-trip non-ASCII
  paths through the in-tree PNG codec, and the dataset reader takes such a
  path (tests/test_wired_features.py:277); imwrite refuses a JPEG name (no
  encoder yet) where the JAX package writes one with cv2.
- checks: check_version and check_requirements (JAX's with install=False:
  the port never installs) give JAX's answers; check_online tries JAX's
  hosts in order, here through a stand-in socket (no test opens a
  connection); check_bf16 on the same weights passes as JAX's does, both
  deltas below JAX's atol 0.1, the float32 decode within the forward bar
  (atol 2e-3, rtol 1e-3) of JAX's.
- each dataset YAML of the port resolves through the port's check_dataset
  to the dict JAX's gives once its val split exists; without it, the port
  raises at the download recipe, and JAX's (autodownload=False) at the
  missing split.
"""

import socket
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.data import dataset_yaml as jax_dataset_yaml
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.detect_head import decode_predictions as jax_decode
from yolov3_tpu.utils import checks as jax_checks
from yolov3_tpu.utils import env as jax_env
from yolov3_tpu.utils import general as jax_general
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data import dataset_yaml
from yolov3_tpu_torch.data.datasets import DetectionDataset
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detect_head import decode_predictions
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.utils import checks, env, general

ROOT = Path(__file__).resolve().parents[1]


# --- utils/general.py ----------------------------------------------------------


def test_small_helpers_equal_jax(tmp_path):
    for y1, y2, steps in ((0.0, 1.0, 100), (1.0, 0.01, 30)):
        f, g = general.one_cycle(y1, y2, steps), jax_general.one_cycle(y1, y2, steps)
        assert [f(x) for x in range(steps + 1)] == [g(x) for x in range(steps + 1)]
    for url in ("https://host/w.pt?auth=token123", "https://host/w.pt", "http://u:@h/x?y=1"):
        assert general.clean_url(url) == jax_general.clean_url(url)
    assert general.clean_url("https://host/w.pt?auth=token123") == "https://host/w.pt"
    assert general.emojis("ok ✅") == jax_general.emojis("ok ✅")
    f = tmp_path / "f.txt"
    f.write_text("x")
    assert general.file_date(f) == jax_general.file_date(f)


def test_timeout_context():
    """Timeout ends a slow block and suppresses the error (tests/test_aux_utils.py:14)."""
    t0 = time.time()
    with general.Timeout(1, timeout_msg="slow"):
        time.sleep(5)
    assert time.time() - t0 < 3
    with pytest.raises(TimeoutError, match="slower"):
        with general.Timeout(1, timeout_msg="slower", suppress_timeout_errors=False):
            time.sleep(5)


def test_tryexcept_threaded_workingdirectory_latest_run(tmp_path, monkeypatch):
    warnings = []
    monkeypatch.setattr(general.LOGGER, "warning", lambda msg, *a, **k: warnings.append(msg))
    with general.TryExcept("step"):
        raise ValueError("boom")
    assert warnings == ["step: boom"]

    done = threading.Event()
    t = general.threaded(lambda: done.set())()
    t.join(timeout=10)
    assert isinstance(t, threading.Thread) and t.daemon and not t.is_alive() and done.is_set()

    cwd = Path.cwd()
    with general.WorkingDirectory(tmp_path):
        assert Path.cwd() == tmp_path.resolve()
    assert Path.cwd() == cwd

    assert general.get_latest_run(tmp_path) == jax_general.get_latest_run(tmp_path) == ""
    for name in ("exp", "exp2"):
        (tmp_path / name / "weights" / "last").mkdir(parents=True)
        time.sleep(0.02)
    assert general.get_latest_run(tmp_path) == jax_general.get_latest_run(tmp_path)
    assert general.get_latest_run(tmp_path).endswith("exp2/weights/last")


# --- utils/env.py --------------------------------------------------------------


def test_env_probes_and_unicode_paths(tmp_path, monkeypatch):
    for probe in ("is_colab", "is_kaggle", "is_docker", "is_jupyter"):
        assert getattr(env, probe)() == getattr(jax_env, probe)(), probe
    assert env.is_writeable(tmp_path, test=True) and env.is_writeable(tmp_path)
    monkeypatch.setenv("YOLOV3_TPU_TORCH_CONFIG_DIR", str(tmp_path / "cfg"))
    assert env.user_config_dir() == tmp_path / "cfg" and (tmp_path / "cfg").is_dir()

    im = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    p = tmp_path / "изображение_テスト.png"
    assert env.imwrite(p, im)
    np.testing.assert_array_equal(env.imread(p), im)
    np.testing.assert_array_equal(env.imread(p), jax_env.imread(p))
    import cv2

    assert env.imwrite(tmp_path / "a.jpg", im) and env.imwrite(tmp_path / "b.JPEG", im)
    assert (tmp_path / "a.jpg").read_bytes() == cv2.imencode(".jpg", im)[1].tobytes()
    assert (tmp_path / "b.JPEG").read_bytes() == (tmp_path / "a.jpg").read_bytes()
    np.testing.assert_array_equal(env.imread(tmp_path / "a.jpg"), jax_env.imread(tmp_path / "a.jpg"))
    with pytest.raises(ValueError, match="tif"):
        env.imwrite(tmp_path / "a.tif", im)

    # the dataset reader takes non-ASCII image paths end to end
    root = tmp_path / "images" / "train"
    root.mkdir(parents=True)
    (tmp_path / "labels" / "train").mkdir(parents=True)
    env.imwrite(root / "картинка.png", np.full((32, 32, 3), 50, np.uint8))
    (tmp_path / "labels" / "train" / "картинка.txt").write_text("0 0.5 0.5 0.5 0.5")
    ds = DetectionDataset(str(root), imgsz=32, augment=False, batch_size=1, num_cls=1)
    img, labels, _ = ds[0]
    assert img.shape == (32, 32, 3) and len(labels) == 1


def test_notebook_init_reports_the_setup(monkeypatch):
    lines = []
    monkeypatch.setattr(env.LOGGER, "info", lambda msg, *a, **k: lines.append(msg))
    env.notebook_init()
    assert lines[0] == "Checking setup..." and f"torch-{torch.__version__}" in lines[-1]
    assert ("CPU" in lines[-1]) == (torch.cuda.device_count() == 0)


# --- utils/checks.py -----------------------------------------------------------


def test_check_version_equals_jax():
    for cur, minimum in (("1.10", "1.10.0"), ("1.9.1", "1.10"), ("2.0", "1.13.1"), ("0.1", "0.1")):
        assert checks.check_version(cur, minimum) == jax_checks.check_version(cur, minimum)
    with pytest.raises(ValueError, match="torch 9.0 required"):
        checks.check_version("2.0", "9.0", name="torch", hard=True)


def test_check_requirements_equals_jax():
    v = np.__version__.split("+")[0]
    short = ".".join(v.split(".")[:2])
    for reqs in (["numpy", "numpy>=1.0"], [f"numpy<={v}", f"numpy=={v}"], [f"numpy<={short}"],
                 ["numpy>=999.0", "definitely_not_a_real_pkg_xyz", "numpy"], "numpy>0.1"):
        assert checks.check_requirements(reqs) == jax_checks.check_requirements(reqs, install=False), reqs
    assert checks.check_requirements(["numpy>=999.0", "definitely_not_a_real_pkg_xyz"]) == [
        "numpy>=999.0", "definitely_not_a_real_pkg_xyz"]
    assert checks.check_requirements(["definitely_not_a_real_pkg_xyz"],
                                     exclude=("definitely_not_a_real_pkg_xyz",)) == []


def test_check_online_tries_the_hosts_in_order(monkeypatch):
    tried = []

    class Connection:
        def close(self):
            pass

    def offline(addr, timeout=None):
        tried.append(addr)
        raise OSError("unreachable")

    monkeypatch.setattr(socket, "create_connection", offline)
    assert checks.check_online(timeout=0.1) is False and jax_checks.check_online(timeout=0.1) is False
    assert tried == [("1.1.1.1", 53), ("8.8.8.8", 53)] * 2
    monkeypatch.setattr(socket, "create_connection", lambda addr, timeout=None: Connection())
    assert checks.check_online() is True and jax_checks.check_online() is True


def test_check_bf16_equals_jax():
    cfg = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3-tiny.yaml").read_text())
    cfg = dict(cfg, width_multiple=0.25, nc=3)
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64)
    model = load_jax_variables(DetectionModel(parse_spec(cfg)).eval(), ref.variables)
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_decode(ref.module.apply(ref.variables, x, train=False), ref.anchors_px,
                                 ref.spec.strides))
    with torch.no_grad():
        got = decode_predictions(model(torch.from_numpy(x)), model.anchors_px, model.spec.strides).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    db, dc = checks.bf16_deltas(model, imgsz=64)
    print(f"bf16 deltas: box {db:.5f} of imgsz, conf {dc:.5f}")
    assert db < 0.1 and dc < 0.1
    model.train()
    assert checks.check_bf16(model, imgsz=64) is jax_checks.check_bf16(ref, imgsz=64) is True
    assert model.training  # the check leaves the model's mode as it was


# --- the dataset YAMLs ---------------------------------------------------------

DATASET_YAMLS = ("Argoverse", "GlobalWheat2020", "Objects365", "SKU-110K", "VOC", "VisDrone", "coco", "xView")


@pytest.mark.parametrize("name", DATASET_YAMLS)
def test_dataset_yaml_loads_as_in_jax(name, tmp_path, monkeypatch):
    port_yaml = ROOT / "yolov3_tpu_torch" / "data" / f"{name}.yaml"
    # every value is JAX's, but a `download: bash` recipe runs the port's own copy of the script
    want_values = yaml.safe_load((ROOT / "yolov3_tpu" / "data" / f"{name}.yaml").read_text())
    if str(want_values.get("download", "")).startswith("bash yolov3_tpu/"):
        want_values["download"] = want_values["download"].replace("yolov3_tpu/", "yolov3_tpu_torch/", 1)
    assert yaml.safe_load(port_yaml.read_text()) == want_values
    datasets = tmp_path / "a" / "datasets"  # a relative `path: ../datasets/x` stays inside tmp_path
    datasets.mkdir(parents=True)
    monkeypatch.setattr(dataset_yaml, "DATASETS_DIR", datasets)
    monkeypatch.setattr(jax_dataset_yaml, "DATASETS_DIR", datasets)

    with pytest.raises(FileNotFoundError, match="no download recipe"):  # the recipe needs autodownload
        dataset_yaml.check_dataset(str(port_yaml), autodownload=False)
    with pytest.raises(FileNotFoundError, match="no download recipe"):
        jax_dataset_yaml.check_dataset(str(port_yaml), autodownload=False)

    d = yaml.safe_load(port_yaml.read_text())
    root = Path(d.get("path") or "")
    root = root if root.is_absolute() else (datasets / root).resolve()
    for v in d["val"] if isinstance(d["val"], list) else [d["val"]]:
        p = root / v
        if p.suffix == ".txt":
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text("")
        else:
            p.mkdir(parents=True, exist_ok=True)
    got = dataset_yaml.check_dataset(str(port_yaml))
    want = jax_dataset_yaml.check_dataset(str(port_yaml), autodownload=False)
    assert got == want and got["nc"] == len(got["names"]) > 0

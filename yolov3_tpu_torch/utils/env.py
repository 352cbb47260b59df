"""Environment probes and file helpers (yolov3_tpu/utils/env.py, reference
utils/general.py:92-155, 869-900).

`imread` and `imwrite` go through the port's in-tree codecs
(data/image_ops.py), which open files by Python path, so non-ASCII paths
work. `imwrite` writes JPEG (.jpg / .jpeg, the bytes cv2 writes) and PNG;
any other suffix raises.
"""

from __future__ import annotations

import os
import platform
import shutil
import tempfile
from pathlib import Path

import torch

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.utils.general import LOGGER

IMREAD_COLOR = 1  # cv2.IMREAD_COLOR: a BGR uint8 (H, W, 3) image, the only form `imread` gives


def is_colab() -> bool:
    """Running inside a Google Colab kernel."""
    return "google.colab" in str(os.environ.get("PYTHONPATH", "")) or "COLAB_RELEASE_TAG" in os.environ


def is_kaggle() -> bool:
    """Running inside a Kaggle kernel."""
    return os.environ.get("PWD") == "/kaggle/working" and "kaggle" in os.environ.get("KAGGLE_URL_BASE", "kaggle")


def is_docker() -> bool:
    """Running inside a Docker container."""
    if Path("/.dockerenv").exists():
        return True
    try:
        with open("/proc/self/cgroup") as f:
            return "docker" in f.read()
    except OSError:
        return False


def is_jupyter() -> bool:
    """Running inside an IPython or Jupyter kernel."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    return get_ipython() is not None


def is_writeable(path, test=False) -> bool:
    """The directory has write permission; `test=True` probes by creating and deleting a file."""
    if not test:
        return os.access(path, os.W_OK)
    probe = Path(path) / "tmp.txt"
    try:
        with open(probe, "w"):
            pass
        probe.unlink()
        return True
    except OSError:
        return False


def user_config_dir(dir_name="yolov3_tpu_torch", env_var="YOLOV3_TPU_TORCH_CONFIG_DIR") -> Path:
    """The platform's per-user config directory for `dir_name` (created), or
    `env_var`'s directory where it is set; the temporary directory when the
    home is not writeable."""
    if env_var in os.environ:
        p = Path(os.environ[env_var])
    else:
        base = {"Windows": "AppData/Roaming", "Linux": ".config", "Darwin": "Library/Application Support"}.get(
            platform.system(), ".config")
        p = Path.home() / base / dir_name
        if not is_writeable(p.parent.parent if p.parent.parent.exists() else Path.home()):
            p = Path(tempfile.gettempdir()) / dir_name
    p.mkdir(parents=True, exist_ok=True)
    return p


def imread(path, flags=None):
    """A BGR uint8 image from any path (JPEG, PNG and BMP in-tree)."""
    if flags not in (None, IMREAD_COLOR):
        raise ValueError(f"imread reads colour images only (flags {flags} given)")
    return image_ops.imread(path)


def imwrite(path, im) -> bool:
    """Write a BGR uint8 image to any path, as JPEG for .jpg / .jpeg and PNG
    for .png (any other suffix raises ValueError); True when written."""
    image_ops.imwrite(path, im)
    return True


def notebook_init(verbose=True):
    """Log the notebook's setup (package, Python, torch, the CUDA cards or the
    CPU, RAM and disk); returns IPython's display module, or None outside
    IPython (reference utils/__init__.py:9-46)."""
    LOGGER.info("Checking setup...")
    if is_colab():
        shutil.rmtree("/content/sample_data", ignore_errors=True)
    display = None
    if verbose:
        gb = 1 << 30
        try:
            import psutil

            ram = f"{psutil.virtual_memory().total / gb:.1f} GB RAM, "
        except ImportError:
            ram = ""
        total, _used, free = shutil.disk_usage("/")
        try:
            from IPython import display as _display

            display = _display
            display.clear_output()
        except ImportError:
            pass
        n = torch.cuda.device_count()
        hw = f"CUDA x{n} ({torch.cuda.get_device_name(0)})" if n else "CPU"
        import yolov3_tpu_torch

        LOGGER.info(f"yolov3_tpu_torch {yolov3_tpu_torch.__version__} py-{platform.python_version()} "
                    f"torch-{torch.__version__} {hw} ({ram}{free / gb:.1f}/{total / gb:.1f} GB disk)")
    return display

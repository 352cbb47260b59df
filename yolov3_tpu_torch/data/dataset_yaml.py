"""Dataset YAML contract: path / train / val / test / names
(yolov3_tpu/data/dataset_yaml.py).

`check_dataset` resolves relative split paths against `path` (itself
relative to DATASETS_DIR), turns a names list into {id: name}, sets nc and
checks that the val split exists. A missing val split runs the YAML's
`download:` recipe, as the JAX package does: `converter://<name>` (a
preparer of data/converters.py), an http(s) or file URL (fetched and
unzipped beside the dataset root) or a `bash ...` line; Python recipes are
refused. A `clearml://<dataset_id>` spec resolves through ClearML's dataset
store (utils/loggers/clearml_utils.py).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

from yolov3_tpu_torch.utils.general import DATASETS_DIR, LOGGER, yaml_load


def check_dataset(data, autodownload=True):
    """Resolve + validate a dataset YAML (path, dict or clearml:// spec).
    Returns the dict with absolute train/val/test paths, a names {id: name}
    map and nc. A missing val split runs the `download` recipe when
    `autodownload`, else raises FileNotFoundError."""
    if isinstance(data, str) and data.startswith("clearml://"):
        from yolov3_tpu_torch.utils.loggers.clearml_utils import construct_dataset

        data = construct_dataset(data)
    if isinstance(data, (str, Path)):
        data = yaml_load(data)
    data = dict(data)

    for k in ("train", "val", "names"):
        assert k in data, f"dataset yaml missing required key '{k}'"
    if isinstance(data["names"], (list, tuple)):
        data["names"] = dict(enumerate(data["names"]))
    data["nc"] = len(data["names"])

    path = Path(data.get("path") or "")
    if not path.is_absolute():
        path = (DATASETS_DIR / path).resolve()
    data["path"] = path
    for k in ("train", "val", "test"):
        if data.get(k):
            if isinstance(data[k], str):
                data[k] = str((path / data[k]).resolve())
            else:
                data[k] = [str((path / v).resolve()) for v in data[k]]

    val = data.get("val")
    if val:
        vals = [Path(v) for v in (val if isinstance(val, list) else [val])]
        missing = [str(v) for v in vals if not v.exists()]
        if missing:
            LOGGER.warning(f"Dataset not found, missing paths {missing}")
            recipe = data.get("download")
            if not (recipe and autodownload):
                raise FileNotFoundError(f"Dataset not found and no download recipe: {missing}")
            _run_download(recipe, path)
            if not all(v.exists() for v in vals):
                raise FileNotFoundError(f"Dataset download did not produce {missing}")
    return data


def _run_download(s, root: Path):
    """Run a download recipe for the dataset at `root`: `converter://<name>`,
    an http(s) / file URL (a .zip is unpacked into root's parent and
    removed) or a `bash ...` line."""
    root.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(s, str) and s.startswith("converter://"):
        from yolov3_tpu_torch.data.converters import prepare

        prepare(s[len("converter://"):], root)
    elif isinstance(s, str) and s.startswith(("http", "file://")):
        from yolov3_tpu_torch.utils.downloads import extract_archive, safe_download

        f = safe_download(root.parent / Path(s).name, s)
        if f.suffix == ".zip":
            extract_archive(f, root.parent)
            f.unlink()
    elif isinstance(s, str) and s.startswith("bash "):
        LOGGER.info(f"Running {s}")
        subprocess.run(s, shell=True, check=True, env={**os.environ})
    else:
        raise ValueError(f"unsupported download recipe: {s!r} (python exec recipes are not supported)")

"""Dataset YAML contract: path / train / val / test / names
(yolov3_tpu/data/dataset_yaml.py).

`check_dataset` resolves relative split paths against `path` (itself
relative to DATASETS_DIR), turns a names list into {id: name}, sets nc and
checks that the val split exists. The JAX package's download recipes and its
`clearml://` datasets need the network and raise NotImplementedError here.
"""

from __future__ import annotations

from pathlib import Path

from yolov3_tpu_torch.utils.general import DATASETS_DIR, LOGGER, yaml_load


def check_dataset(data):
    """Resolve + validate a dataset YAML (path or dict). Returns the dict with
    absolute train/val/test paths, a names {id: name} map and nc."""
    if isinstance(data, str) and data.startswith("clearml://"):
        raise NotImplementedError("clearml:// datasets need the network and are not ported "
                                  "(ROADMAP.md queue 1 item 7)")
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
            if data.get("download"):
                raise NotImplementedError(f"Dataset not found: {missing}; download recipes need the network and "
                                          "are not ported (prepare the dataset on disk first)")
            raise FileNotFoundError(f"Dataset not found and no download recipe: {missing}")
    return data

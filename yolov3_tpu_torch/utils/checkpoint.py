"""Checkpoints: a train state plus a metadata sidecar, in a directory
(yolov3_tpu/utils/checkpoint.py).

    <path>/state.pt         torch.save of {"model", "optimizer", "ema", "step", "balance"}
    <path>/checkpoint.yaml  epoch, best_fitness, names, hyp, results, date, git, model_yaml
                            (and stripped: true once stripped)

`model` and `ema/ema` are state dicts, `optimizer` is the ScheduledOptimizer's
(torch optimizer state with its update and accumulation counters), `ema`
holds the EMA's update count. Both files are written to a temporary name
and renamed, so a crash mid-save leaves the previous checkpoint whole.
`strip_checkpoint` keeps only the EMA weights, promoted to `model`: the
inference checkpoint (the reference's strip_optimizer).
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import torch

from yolov3_tpu_torch.nn.modules import REPEAT_ARG_OPS
from yolov3_tpu_torch.utils.general import LOGGER, check_git_info, yaml_load, yaml_save


def train_state_dict(state):
    """A TrainState (train/step.py) as the dict state.pt holds."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": {"ema": state.ema.ema, "updates": state.ema.updates},
        "step": state.step,
        "balance": state.balance,
    }


@torch.no_grad()
def restore_train_state(state, sd):
    """Load a state.pt dict into a TrainState in place. A stripped
    checkpoint ({"model"} only) restores the weights and restarts the EMA
    from them and the optimizer fresh; a full one restores everything."""
    state.model.load_state_dict(sd["model"])
    if "optimizer" not in sd:
        for k, v in state.model.state_dict().items():
            state.ema.ema[k].copy_(v)
        return state
    state.optimizer.load_state_dict(sd["optimizer"])
    for k, v in sd["ema"]["ema"].items():
        state.ema.ema[k].copy_(v)
    state.ema.updates = sd["ema"]["updates"]
    state.step = sd["step"]
    if sd.get("balance") is not None:
        state.balance = sd["balance"].to(state.model.device)
    return state


def _replace(path, write):
    """Write through `write(tmp)` to a temporary file, then rename it to `path`."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path, state, spec=None, meta=None):
    """Save a TrainState (or a state.pt dict) + model spec + metadata to directory `path`."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    sd = state if isinstance(state, dict) else train_state_dict(state)
    _replace(path / "state.pt", lambda f: torch.save(sd, f))
    md = dict(meta or {})
    md["date"] = datetime.datetime.now().isoformat()
    if "git" not in md:  # provenance, reference train.py:477 "git" field
        md["git"] = check_git_info()
    if spec is not None:
        md["model_yaml"] = spec_to_dict(spec)
    _replace(path / "checkpoint.yaml", lambda f: yaml_save(f, md))
    return path


def load_checkpoint(path, map_location="cpu"):
    """Restore (state.pt dict, meta) from a checkpoint directory."""
    path = Path(path)
    sd = torch.load(path / "state.pt", map_location=map_location, weights_only=True)
    meta = yaml_load(path / "checkpoint.yaml") if (path / "checkpoint.yaml").is_file() else {}
    return sd, meta


def strip_checkpoint(path, out=None):
    """Finalise a checkpoint for inference: EMA -> model, optimizer dropped."""
    sd, meta = load_checkpoint(path)
    model = sd["ema"]["ema"] if "ema" in sd else sd["model"]
    out = Path(out or path).resolve()
    out.mkdir(parents=True, exist_ok=True)
    _replace(out / "state.pt", lambda f: torch.save({"model": model}, f))
    meta["stripped"] = True
    _replace(out / "checkpoint.yaml", lambda f: yaml_save(f, meta))
    LOGGER.info(f"Checkpoint stripped for inference: {out}")
    return out


def spec_to_dict(spec):
    """A ModelSpec as a YAML dict that parse_spec loads back. A repeat-arg op
    (C3, BottleneckCSP, ...) holds its repeats as its second arg and n = 1;
    they go back to `n`, where parse_spec takes them from (the JAX package's
    spec_to_dict writes them twice, so a C3 comes back with n = 1)."""
    return {
        "name": spec.name,
        "nc": spec.nc,
        "ch": spec.ch_in,
        "depth_multiple": 1.0,
        "width_multiple": 1.0,
        **({"activation": spec.activation} if spec.activation else {}),
        "anchors": [list(a) for a in spec.anchors],
        "layers": [
            {
                "from": list(ls.f) if len(ls.f) > 1 else (ls.f[0] - ls.i if ls.f[0] != ls.i - 1 else -1),
                "n": ls.args[1] if ls.op in REPEAT_ARG_OPS else ls.n,
                "op": ls.op,
                "args": _de_tuple((ls.args[0], *ls.args[2:]) if ls.op in REPEAT_ARG_OPS else ls.args),
            }
            for ls in spec.layers[:-1]
        ]
        + [{"from": list(spec.detect_from), "n": 1, "op": "Detect", "args": ["nc", "anchors"]}],
    }


def _de_tuple(x):
    if isinstance(x, tuple):
        return [_de_tuple(v) for v in x]
    return x


def load_model_from_checkpoint(path, device=None, dtype=torch.float32):
    """Rebuild a DetectionModel from a checkpoint directory: the spec from
    `model_yaml`, the EMA weights when the checkpoint has them, else its
    model's; a checkpoint whose meta says `fused` (export_checkpoint of a
    folded model) builds the folded graph. device=None means "cuda" (and
    raises without one)."""
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.models.spec import parse_spec
    from yolov3_tpu_torch.utils.general import select_device

    path = Path(path)
    sd, meta = load_checkpoint(path)
    with torch.device("meta"):
        model = DetectionModel(parse_spec(meta["model_yaml"]), fused=bool(meta.get("fused", False)))
    model.load_state_dict(sd["ema"]["ema"] if "ema" in sd else sd["model"], assign=True)
    model = model.to(device=select_device(device), dtype=dtype, memory_format=torch.channels_last).eval()
    names = meta.get("names")
    if names:
        model.names = {int(k): v for k, v in names.items()} if isinstance(names, dict) else dict(enumerate(names))
    return model

"""W&B: a checkpoint as a model artifact, and a model artifact back to a
local checkpoint (yolov3_tpu/utils/loggers/wandb_utils.py, reference
utils/loggers/wandb/wandb_utils.py:34-175). wandb is imported inside each
function; tests/test_torch_loggers.py drives them through a fake SDK."""

from __future__ import annotations

from pathlib import Path

from yolov3_tpu_torch.utils.general import LOGGER


def log_model(run, ckpt_dir, epoch=0, fitness=0.0, best=False, metadata=None):
    """Upload a checkpoint (a port checkpoint directory, or a file) as the
    artifact run_{id}_model, aliases latest, "epoch N" and, when best, best."""
    import wandb

    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        LOGGER.warning(f"W&B model artifact skipped: {ckpt_dir} does not exist")
        return None
    art = wandb.Artifact(name=f"run_{run.id}_model", type="model",
                         metadata={"epoch": int(epoch), "fitness": float(fitness), "original_path": str(ckpt_dir),
                                   **(metadata or {})})
    if ckpt_dir.is_dir():
        art.add_dir(str(ckpt_dir), name=ckpt_dir.name)
    else:
        art.add_file(str(ckpt_dir), name=ckpt_dir.name)
    run.log_artifact(art, aliases=["latest", f"epoch {epoch}"] + (["best"] if best else []))
    return art


def download_model_artifact(weights):
    """A `wandb-artifact://entity/project/name:alias` weights spec as a local
    path (its one entry, or the artifact's directory); None for any other spec."""
    prefix = "wandb-artifact://"
    if not str(weights).startswith(prefix):
        return None
    import wandb

    local = Path(wandb.Api().artifact(str(weights)[len(prefix):]).download())
    entries = sorted(local.iterdir()) if local.is_dir() else [local]
    return entries[0] if len(entries) == 1 else local

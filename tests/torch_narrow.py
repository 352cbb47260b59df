"""The published configs narrowed for the tests of the served step.

yolov3 and yolov3-spp at width 0.125 and depth 0.33, yolov3-tiny at nc 3, as
tests/test_torch_model.py narrows them. The module imports no JAX, so a test
file that runs on a card without JAX shares it with those that do.
"""

from pathlib import Path

import yaml

CONFIGS = Path(__file__).resolve().parents[1] / "yolov3_tpu_torch/models/configs"


def narrow_cfg(name):
    d = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())
    d.update(name=name, **(dict(nc=3) if name == "yolov3-tiny" else dict(width_multiple=0.125, depth_multiple=0.33)))
    return d

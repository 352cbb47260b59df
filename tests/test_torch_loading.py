"""Weight loading (models/loading.py, models/convert.py) against the JAX
package's `load_weights`.

A yolov3-tiny `.pt` is written in the three forms reference checkpoints
take: a bare state dict, a pickled module tree whose classes live in
`models.yolo` / `models.common` (not importable when it is read: the port
unpickles it through stub classes), and a checkpoint dict of fp16 tensors.
The port's `load_weights` gives the decoded forward of the JAX package's
(atol 2e-3, rtol 1e-3). The JAX package's loader cannot read the module
tree (its stub test `hasattr(obj, "float")` is false for a stub, so it
takes the stub for a dict and fails; ROADMAP.md queue 3): for that form the
JAX side loads the same tensors as a state dict. A `.pt` whose tensors fit nowhere raises in both; a
missing `.pt` raises in the port without any download (the JAX package
would try one, so it is not called with a missing file). Both packages'
`DetectionModel.from_config()` without a cfg build yolov3-tiny."""

import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.loading import load_weights as jax_load_weights
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.loading import load_weights
from yolov3_tpu_torch.serve import load_weights as serve_load_weights

TINY_PARAMS = 8_852_366


def test_from_config_default_is_yolov3_tiny():
    port = DetectionModel.from_config(device="cpu")
    jax_model = JaxModel.from_config(imgsz=64)
    n_jax = sum(int(np.prod(v.shape)) for v in __import__("jax").tree_util.tree_leaves(jax_model.variables["params"]))
    assert port.spec.name == jax_model.spec.name == "yolov3-tiny"
    assert port.num_params() == n_jax == TINY_PARAMS


def reference_state_dict(seed=0):
    """The port's yolov3-tiny state dict (the reference's key names) with random BN statistics and affines."""
    g = torch.Generator().manual_seed(seed)
    sd = DetectionModel.from_config("yolov3-tiny", seed=seed, device="cpu").state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean") or k.endswith(".bn.bias"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_var") or k.endswith(".bn.weight"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
    sd["model.20.anchors"] = torch.rand(2, 3, 2)  # reference-only entries are skipped
    return sd


def module_tree(sd, cfg=None):
    """A torch module tree holding `sd`, its classes in modules `models.yolo` /
    `models.common`; the top module carries `cfg` as its `yaml`, as the reference's does."""
    yolo, common = types.ModuleType("models.yolo"), types.ModuleType("models.common")
    node = type("Conv", (nn.Module,), {"__module__": "models.common"})
    top = type("DetectionModel", (nn.Module,), {"__module__": "models.yolo"})
    common.Conv, yolo.DetectionModel = node, top
    root = top()
    if cfg is not None:
        root.yaml = cfg
    for k, v in sd.items():
        *path, leaf = k.split(".")
        m = root
        for p in path:
            if p not in m._modules:
                m.add_module(p, node())
            m = m._modules[p]
        if leaf.startswith("running") or leaf == "num_batches_tracked" or leaf == "anchors":
            m.register_buffer(leaf, v.clone())
        else:
            m.register_parameter(leaf, nn.Parameter(v.clone()))
    return root, {"models": types.ModuleType("models"), "models.yolo": yolo, "models.common": common}


def write_pt(path, form, sd, cfg=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    if form == "state_dict":
        torch.save(sd, path)
    elif form == "fp16":
        torch.save({"epoch": -1, "ema": None, "model": {k: v.half() for k, v in sd.items()}}, path)
    else:
        tree, mods = module_tree(sd, cfg)
        saved = {k: sys.modules.get(k) for k in mods}
        sys.modules.update(mods)
        try:
            torch.save({"epoch": -1, "model": tree, "ema": None}, path)
        finally:
            for k, v in saved.items():
                if v is None:
                    sys.modules.pop(k, None)
                else:
                    sys.modules[k] = v
    return path


@pytest.mark.parametrize("form", ["state_dict", "module_tree", "fp16"])
def test_pt_forms_load_like_jax(tmp_path, form):
    sd = reference_state_dict()
    pt = write_pt(tmp_path / form / "yolov3-tiny.pt", form, sd)
    port = load_weights(pt, device="cpu")
    jax_pt = pt if form != "module_tree" else write_pt(tmp_path / "sd" / "yolov3-tiny.pt", "state_dict", sd)
    jax_model = jax_load_weights(str(jax_pt))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        got = port.predict(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_model.predict(jnp.asarray(x))[0])
    assert got.shape == want.shape == (2, 3 * (4 * 6 + 2 * 3), 85)  # strides 16 and 32
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    if form == "fp16":  # the weights are the fp16 values, cast to float32
        assert port.model[0].conv.weight.dtype == torch.float32
        torch.testing.assert_close(port.model[0].conv.weight, sd["model.0.conv.weight"].half().float())
    else:
        torch.testing.assert_close(port.state_dict()["model.0.bn.running_var"], sd["model.0.bn.running_var"])
    # serve routes through the same loader
    torch.testing.assert_close(serve_load_weights(pt, device="cpu").state_dict()["model.15.conv.weight"],
                               port.state_dict()["model.15.conv.weight"])


def test_mismatched_pt_raises_in_both(tmp_path):
    sd = {k: v[..., :-1] if v.ndim else v for k, v in reference_state_dict().items()}  # every tensor the wrong shape
    pt = write_pt(tmp_path / "yolov3-tiny.pt", "state_dict", sd)
    with pytest.raises(ValueError, match="architecture mismatch"):
        load_weights(pt, device="cpu")
    with pytest.raises(ValueError, match="architecture mismatch"):
        jax_load_weights(str(pt))


def test_missing_pt_is_not_downloaded(tmp_path):
    with pytest.raises(FileNotFoundError, match="never downloaded"):
        load_weights(tmp_path / "yolov3.pt", device="cpu")


def test_checkpoint_dir_and_cfg(tmp_path):
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    model = DetectionModel.from_config("yolov3-tiny", seed=3, device="cpu")
    save_checkpoint(tmp_path / "ckpt", {"model": model.state_dict()}, spec=model.spec,
                    meta={"names": {i: f"c{i}" for i in range(80)}})
    loaded = load_weights(tmp_path / "ckpt", device="cpu")
    assert loaded.names[3] == "c3"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert load_weights("yolov3-tiny", device="cpu").num_params() == TINY_PARAMS
    assert Path(str(tmp_path / "ckpt")).is_dir()

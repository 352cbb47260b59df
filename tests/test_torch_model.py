"""Forward parity of the port's DetectionModel against the JAX model on the
same weights (JAX variables carried across by from_jax_variables), in f32 on
the CPU, at the raw/decoded-forward bar of test_parity_reference.py:133
(atol 2e-3, rtol 1e-3)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.models.convert import torch_key_to_path
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.convert import from_jax_variables, load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.fuse import fuse_state_dict
from yolov3_tpu_torch.models.spec import parse_spec

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-3, 1e-3


def narrow_cfg(name, **kw):
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs" / f"{name}.yaml").read_text())
    d.update(name=name, **kw)
    return d


CASES = {
    # darknet-53 + 3-scale head, narrowed; SPP pools; ZeroPad + stride-1 MaxPool
    "yolov3": narrow_cfg("yolov3", width_multiple=0.125, depth_multiple=0.33),
    "yolov3-spp": narrow_cfg("yolov3-spp", width_multiple=0.125, depth_multiple=0.33),
    "yolov3-tiny": narrow_cfg("yolov3-tiny", nc=3),
}


def _to_numpy_tree(tree):
    return {k: _to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v, np.float32)
            for k, v in tree.items()}


def randomized_variables(variables, rng):
    """JAX variables with non-trivial BN scale/bias/stats, so folding is exercised."""
    v = _to_numpy_tree(variables)

    def walk(p, s):
        for k in p:
            if k == "bn":
                c = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(p[k], dict):
                walk(p[k], s.get(k, {}))

    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX model, port model, input NHWC image batch) on the same weights."""
    cfg = CASES[request.param]
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64)
    ref = ref.replace_variables(randomized_variables(ref.variables, np.random.default_rng(1)))
    port = DetectionModel(parse_spec(cfg)).eval()
    load_jax_variables(port, ref.variables)
    x = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    return ref, port, x


def test_forward_matches_jax(pair):
    ref, port, x = pair
    want = jax.jit(ref.module.apply, static_argnames="train")(ref.variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_fused_raw_head_matches_jax(pair):
    ref, port, x = pair
    fused_ref = ref.fuse()
    want = jax.jit(fused_ref.serving_module().apply, static_argnames="train")(
        fused_ref.variables, jnp.asarray(x), train=False)
    fused = port.fuse()
    assert fused.fused and not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    with torch.no_grad():
        got = fused(torch.from_numpy(x), raw=True)
        unfused = port(torch.from_numpy(x), raw=True)
    for g, u, w in zip(got, unfused, want):
        assert tuple(g.shape) == w.shape  # (B, ny, nx, na*no) NHWC
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=ATOL, rtol=RTOL)


def test_fold_count_matches_jax(pair):
    ref, port, _ = pair
    n_bn = sum(1 for path in jax.tree_util.tree_leaves_with_path(ref.variables["batch_stats"])
               if str(getattr(path[0][-1], "key", "")) == "mean")
    _, n_folded = fuse_state_dict(port.state_dict())
    assert n_folded == n_bn > 0


def test_yolov3_folds_72_pairs():
    with torch.device("meta"):
        model = DetectionModel(parse_spec("yolov3"))
    assert fuse_state_dict(model.state_dict())[1] == 72


def test_from_jax_variables_inverts_torch_key_to_path(pair):
    ref, _, _ = pair
    sd = from_jax_variables(ref.variables)
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref.variables[coll]):
            flat[(coll, tuple(str(p.key) for p in path))] = np.asarray(leaf, np.float32)
    assert len(sd) == len(flat)
    for key, value in sd.items():
        coll, path, tf = torch_key_to_path(key)
        np.testing.assert_array_equal(tf(value.numpy()), flat[(coll, path)])


def test_activation_override_is_scoped():
    from yolov3_tpu_torch.nn import activations

    cfg = dict(CASES["yolov3-tiny"], activation="relu")
    relu_model = DetectionModel(parse_spec(cfg))
    plain = DetectionModel(parse_spec(CASES["yolov3-tiny"]))
    assert relu_model.model[0].act is activations.relu
    assert plain.model[0].act is activations.silu
    assert activations._DEFAULT_ACT[0] is activations.silu

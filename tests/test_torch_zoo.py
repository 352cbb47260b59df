"""The port's module zoo (nn/modules.py, nn/activations.py) against the JAX
package's modules, one module at a time, in f32 on the CPU.

Each case builds the JAX module, draws its variables (BatchNorm affines and
running statistics randomised so that they matter), carries them into the
port module with `from_jax_module_variables`, and runs both on the same
seeded input: in eval mode, and in train mode (batch statistics), where the
BatchNorm running statistics after the call are held too. Outputs at atol
2e-3 / rtol 1e-3 (test_parity_reference.py:133's forward bar); running
statistics at 1e-5 (FReLU's are flax's biased variance, the others torch's
Bessel-corrected one). A train-mode stride-1 3x3 Conv runs the port's
conv+statistics route (its plain version on the CPU).

Where the JAX module raises (a GhostBottleneck at s=2 passes `fused` to a
DWConv that has no such field), the port is held against the JAX parts
composed by hand on the same variables, and the JAX module is asserted to
still raise. DWConvTranspose2d is held to the JAX output size, not torch's.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from yolov3_tpu.nn import activations as jact
from yolov3_tpu.nn import modules as jm
from yolov3_tpu_torch.models.convert import from_jax_module_variables
from yolov3_tpu_torch.nn import activations as pact
from yolov3_tpu_torch.nn import modules as pm

ATOL, RTOL = 2e-3, 1e-3
STATS_ATOL = 1e-5


class HandGhostBottleneck(fnn.Module):
    """The JAX parts of GhostBottleneck(c2, k, s=2) composed as that module
    composes them (yolov3_tpu/nn/modules.py:711-723), minus the `fused`
    keyword its DWConvs refuse: the same variable tree."""

    c2: int
    k: int = 3
    s: int = 2

    @fnn.compact
    def __call__(self, x, train=False):
        c_ = self.c2 // 2
        y = jm.GhostConv(c_, 1, 1, act=True, name="gc1")(x, train)
        y = jm.DWConv(c_, self.k, self.s, act=False, name="dw")(y, train)
        y = jm.GhostConv(self.c2, 1, 1, act=False, name="gc2")(y, train)
        sc = jm.DWConv(x.shape[-1], self.k, self.s, act=False, name="dws")(x, train)
        return y + jm.Conv(self.c2, 1, 1, act=False, name="sc")(sc, train)


# id: (JAX module, port module, input channels, input side, inputs (Sum / Concat take a list))
CASES = {
    "Conv 1x3 s(1,2)": (lambda: jm.Conv(24, (1, 3), (1, 2)), lambda: pm.Conv(16, 24, (1, 3), (1, 2)), 16, 16, 1),
    "Conv 3x3 g4 d2": (lambda: jm.Conv(32, 3, 1, None, 4, 2), lambda: pm.Conv(16, 32, 3, 1, None, 4, 2), 16, 16, 1),
    "Conv 3x3 s1 (stats route)": (lambda: jm.Conv(24, 3, 1), lambda: pm.Conv(16, 24, 3, 1), 16, 16, 1),
    "DWConv 3x3 s2": (lambda: jm.DWConv(32, 3, 2), lambda: pm.DWConv(16, 32, 3, 2), 16, 16, 1),
    "DWConv 3x3 s1 g1 (stats route)": (lambda: jm.DWConv(21, 3, 1), lambda: pm.DWConv(16, 21, 3, 1), 16, 16, 1),
    "DWConvTranspose2d k4 s2 p1 1 p2 1": (lambda: jm.DWConvTranspose2d(32, 4, 2, 1, 1),
                                          lambda: pm.DWConvTranspose2d(16, 32, 4, 2, 1, 1), 16, 8, 1),
    "DWConvTranspose2d g1 k3": (lambda: jm.DWConvTranspose2d(9, 3, 1, 1, 0),
                                lambda: pm.DWConvTranspose2d(16, 9, 3, 1, 1, 0), 16, 8, 1),
    "Bottleneck": (lambda: jm.Bottleneck(16), lambda: pm.Bottleneck(16, 16), 16, 16, 1),
    "BottleneckCSP n2": (lambda: jm.BottleneckCSP(32, 2), lambda: pm.BottleneckCSP(16, 32, 2), 16, 16, 1),
    "C3 n2": (lambda: jm.C3(32, 2), lambda: pm.C3(16, 32, 2), 16, 16, 1),
    "C3 no shortcut": (lambda: jm.C3(32, 1, False), lambda: pm.C3(16, 32, 1, False), 16, 16, 1),
    "C3x n2": (lambda: jm.C3x(32, 2), lambda: pm.C3x(16, 32, 2), 16, 16, 1),
    "C3SPP": (lambda: jm.C3SPP(32, 1), lambda: pm.C3SPP(16, 32, 1), 16, 16, 1),
    "C3Ghost n2": (lambda: jm.C3Ghost(32, 2), lambda: pm.C3Ghost(16, 32, 2), 16, 16, 1),
    "C3TR n2": (lambda: jm.C3TR(32, 2), lambda: pm.C3TR(16, 32, 2), 16, 8, 1),
    "SPP": (lambda: jm.SPP(32), lambda: pm.SPP(16, 32), 16, 16, 1),
    "SPPF": (lambda: jm.SPPF(32, 5), lambda: pm.SPPF(16, 32, 5), 16, 16, 1),
    "Focus k3": (lambda: jm.Focus(32, 3), lambda: pm.Focus(16, 32, 3), 16, 16, 1),
    "CrossConv shortcut": (lambda: jm.CrossConv(16, 3, 1, 1, 1.0, True), lambda: pm.CrossConv(16, 16, 3, 1, 1, 1.0, True),
                           16, 16, 1),
    "CrossConv s2": (lambda: jm.CrossConv(32, 3, 2), lambda: pm.CrossConv(16, 32, 3, 2), 16, 16, 1),
    "GhostConv s2": (lambda: jm.GhostConv(32, 3, 2), lambda: pm.GhostConv(16, 32, 3, 2), 16, 16, 1),
    "GhostBottleneck s1": (lambda: jm.GhostBottleneck(16), lambda: pm.GhostBottleneck(16, 16), 16, 16, 1),
    "GhostBottleneck s1 sc": (lambda: jm.GhostBottleneck(32), lambda: pm.GhostBottleneck(16, 32), 16, 16, 1),
    "GhostBottleneck s2 (by hand)": (lambda: HandGhostBottleneck(32), lambda: pm.GhostBottleneck(16, 32, 3, 2),
                                     16, 16, 1),
    "TransformerBlock conv": (lambda: jm.TransformerBlock(32, 4, 2), lambda: pm.TransformerBlock(16, 32, 4, 2),
                              16, 8, 1),
    "TransformerBlock": (lambda: jm.TransformerBlock(16, 2, 1), lambda: pm.TransformerBlock(16, 16, 2, 1), 16, 8, 1),
    "MixConv2d k1-3-5": (lambda: jm.MixConv2d(30, (1, 3, 5)), lambda: pm.MixConv2d(16, 30, (1, 3, 5)), 16, 16, 1),
    "MixConv2d s2": (lambda: jm.MixConv2d(32, (1, 3), 2), lambda: pm.MixConv2d(16, 32, (1, 3), 2), 16, 16, 1),
    "Contract": (lambda: jm.Contract(2), lambda: pm.Contract(2), 16, 16, 1),
    "Expand": (lambda: jm.Expand(2), lambda: pm.Expand(2), 16, 16, 1),
    "Sum weighted": (lambda: jm.Sum(3, True), lambda: pm.Sum(3, True), 16, 16, 3),
    "Sum": (lambda: jm.Sum(2), lambda: pm.Sum(2), 16, 16, 2),
    "FReLU": (lambda: jact.FReLU(3), lambda: pact.FReLU(16, 3), 16, 16, 1),
    "AconC": (lambda: jact.AconC(), lambda: pact.AconC(16), 16, 16, 1),
    "MetaAconC": (lambda: jact.MetaAconC(1, 4), lambda: pact.MetaAconC(16, 1, 4), 16, 16, 1),
}


def randomized(variables, rng):
    """The variables as numpy, with every BatchNorm's affine and running statistics drawn at random."""
    v = jax.tree.map(lambda a: np.array(a, np.float32), variables)

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

    walk(v.setdefault("params", {}), v.setdefault("batch_stats", {}))
    return v


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(JAX module, its variables, port module with them, NHWC inputs)."""
    jax_fn, port_fn, c1, side, n_in = CASES[request.param]
    rng = np.random.default_rng(0)
    xs = [rng.normal(0, 1, (2, side, side, c1)).astype(np.float32) for _ in range(n_in)]
    arg = xs if n_in > 1 else xs[0]
    ref = jax_fn()
    variables = randomized(jax.jit(ref.init, static_argnames="train")(jax.random.PRNGKey(0), arg, train=False), rng)
    port = port_fn()
    missing, unexpected = port.load_state_dict(from_jax_module_variables(variables), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing), (missing, unexpected)
    return request.param, ref, variables, port, xs


def port_inputs(xs):
    ts = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
    return ts if len(ts) > 1 else ts[0]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_module_matches_jax(case, train):
    name, ref, variables, port, xs = case
    arg = xs if len(xs) > 1 else xs[0]
    if train:
        want, updated = jax.jit(lambda v, a: ref.apply(v, a, train=True, mutable=["batch_stats"]))(variables, arg)
    else:
        want = jax.jit(lambda v, a: ref.apply(v, a, train=False))(variables, arg)
    port = port.train(train)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(port_inputs(xs))
    assert to_nhwc(got).shape == want.shape, name
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=name)
    after = port.state_dict()
    stats = [k for k in after if "running_" in k]
    if train:
        want_stats = from_jax_module_variables({"batch_stats": updated["batch_stats"]})
        assert sorted(want_stats) == sorted(stats), name
        for k in stats:
            np.testing.assert_allclose(after[k].numpy(), want_stats[k].numpy(), atol=STATS_ATOL, err_msg=f"{name} {k}")
            assert not torch.equal(after[k], before[k]), f"{name} {k} did not move"
    else:
        assert all(torch.equal(after[k], before[k]) for k in stats), f"{name}: eval moved a running statistic"
    port.load_state_dict(before)


def test_jax_ghost_bottleneck_s2_still_raises():
    """The JAX package's fault that the port does not copy: GhostBottleneck(s=2)
    hands `fused` to DWConv, which has no such field."""
    x = np.zeros((1, 8, 8, 16), np.float32)
    with pytest.raises(TypeError, match="fused"):
        jm.GhostBottleneck(32, 3, 2).init(jax.random.PRNGKey(0), x)


def test_ghost_bottleneck_keys_are_the_reference_layout():
    s2 = pm.GhostBottleneck(16, 32, 3, 2).state_dict()
    assert {k.split(".bn.")[0].split(".conv.")[0] for k in s2 if k.endswith("weight")} >= {
        "conv.0.cv1", "conv.1", "conv.2.cv2", "shortcut.0", "shortcut.1"}
    s1 = pm.GhostBottleneck(16, 32).state_dict()
    assert any(k.startswith("sc.") for k in s1) and not any(k.startswith("shortcut.") for k in s1)


def test_dwconv_transpose_output_size_is_jax_not_torch():
    """flax ConvTranspose (explicit padding, unflipped kernel): a 16x16 map at
    k 4, s 2, p1 1 becomes 30x30; torch's ConvTranspose2d gives 32x32."""
    x = torch.zeros(1, 16, 16, 16)
    assert tuple(pm.DWConvTranspose2d(16, 32, 4, 2, 1)(x).shape[2:]) == (30, 30)
    assert tuple(torch.nn.ConvTranspose2d(16, 32, 4, 2, 1, groups=16)(x).shape[2:]) == (32, 32)


def test_sum_weight_starts_like_jax():
    v = jm.Sum(4, True).init(jax.random.PRNGKey(0), [np.zeros((1, 2, 2, 3), np.float32)] * 4)
    np.testing.assert_array_equal(pm.Sum(4, True).w.detach().numpy(), np.asarray(v["params"]["w"]))


def test_fused_forms_fold_nested_convs():
    """Every Conv (nested ones and DWConvs included) has a fused form whose
    output equals the unfused module's with the BN folded in; standalone BNs
    (BottleneckCSP, MixConv2d) are kept."""
    from yolov3_tpu_torch.models.fuse import fuse_state_dict

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, 16)).astype(np.float32)).permute(0, 3, 1, 2)
    for build in (lambda f: pm.C3(16, 32, 2, fused=f), lambda f: pm.BottleneckCSP(16, 32, 2, fused=f),
                  lambda f: pm.GhostBottleneck(16, 32, 3, 2, fused=f), lambda f: pm.C3TR(16, 32, 1, fused=f),
                  lambda f: pm.Focus(16, 32, 3, fused=f), lambda f: pm.DWConv(16, 32, 3, 2, fused=f),
                  lambda f: pm.C3x(16, 32, 1, fused=f), lambda f: pm.C3SPP(16, 32, 1, fused=f)):
        plain = build(False).eval()
        sd = plain.state_dict()
        for k, v in sd.items():
            if k.endswith("running_var") or k.endswith("bn.weight"):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif k.endswith("running_mean") or k.endswith("bn.bias"):
                v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32)))
        fused_sd, n = fuse_state_dict(sd)
        fused = build(True).eval()
        fused.load_state_dict(fused_sd)
        assert n == sum(isinstance(m, pm.Conv) for m in plain.modules()) > 0
        with torch.no_grad():
            np.testing.assert_allclose(fused(x).numpy(), plain(x).numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=type(plain).__name__)

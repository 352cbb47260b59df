"""The port's conv3x3 + BatchNorm-statistics function (plain version, autograd
function, train-mode Conv) against the JAX package: the Pallas kernel in
interpret mode, lax.conv, and the flax Conv in train mode. Inputs are made
with numpy from a seed and fed to both sides, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.nn.modules import Conv as JaxConv
from yolov3_tpu.ops.conv_bn_pallas import conv3x3_bn_stats as jax_conv3x3_bn_stats
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.nn.modules import Conv
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats, conv3x3_bn_stats_plain


def make_inputs(shape, seed=0):
    B, H, W, Cin, Cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, Cin, Cout)) * 0.1).astype(np.float32)
    return x, w


# the shapes of tests/test_conv_bn_pallas.py
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (1, 8, 24, 4, 8)])
def test_plain_matches_pallas_interpret(shape):
    """y rtol 1e-5, mean 1e-5, var 1e-4: f32 sums in another order."""
    x, w = make_inputs(shape)
    y_j, mean_j, var_j = jax_conv3x3_bn_stats(jnp.asarray(x), jnp.asarray(w), th=4, interpret=True)
    y, mean, var = conv3x3_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert y.dtype == torch.float32 and y.is_contiguous() and tuple(y.shape) == y_j.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 13, 19, 5, 7), (1, 7, 5, 3, 32)])
def test_plain_matches_lax_conv_at_odd_sizes(shape):
    """H and W that no row block divides, odd channel counts, the stem's Cin = 3."""
    x, w = make_inputs(shape, seed=1)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y, mean, var = conv3x3_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    rf = np.asarray(ref, np.float64).reshape(-1, shape[-1])
    np.testing.assert_allclose(mean.numpy(), rf.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), rf.var(0), rtol=1e-4, atol=1e-5)


def test_plain_keeps_bf16_storage_and_f32_statistics():
    x, w = make_inputs((2, 8, 8, 4, 8))
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    y, mean, var = conv3x3_bn_stats_plain(xb, wb)
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    y32, mean32, var32 = conv3x3_bn_stats_plain(xb.float(), wb.float())
    # the statistics come from the f32 result, before y is rounded to bf16
    torch.testing.assert_close(mean, mean32, rtol=0, atol=0)
    torch.testing.assert_close(var, var32, rtol=0, atol=0)
    torch.testing.assert_close(y, y32.bfloat16(), rtol=0, atol=0)


def test_function_gradcheck_float64():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 4, 5, 3)), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.normal(size=(3, 3, 3, 2)) * 0.3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(conv3x3_bn_stats, (x, w), eps=1e-6, atol=1e-6)


def test_function_gradient_matches_autograd_of_plain():
    """The hand-written backward (cotangent folding + library conv gradients)
    against autograd through the plain version, and against JAX's gradient of
    the same scalar; atol 1e-5 in f32."""
    x, w = make_inputs((2, 6, 7, 4, 6), seed=3)
    rng = np.random.default_rng(4)
    cy = rng.normal(size=(2, 6, 7, 6)).astype(np.float32)
    cm, cv = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)

    def scalar(fn, xt, wt):
        y, mean, var = fn(xt, wt)
        return (y * torch.from_numpy(cy)).sum() + (mean * torch.from_numpy(cm)).sum() \
            + (var * torch.from_numpy(cv)).sum()

    grads = []
    for fn in (conv3x3_bn_stats, conv3x3_bn_stats_plain):
        xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
        scalar(fn, xt, wt).backward()
        grads.append((xt.grad.numpy(), wt.grad.numpy()))

    def jax_scalar(xj, wj):
        y = jax.lax.conv_general_dilated(xj, wj, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        mean = y.mean((0, 1, 2))
        var = (y * y).mean((0, 1, 2)) - mean * mean
        return (y * cy).sum() + (mean * cm).sum() + (var * cv).sum()

    gx_j, gw_j = jax.grad(jax_scalar, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for gx, gw in grads:
        np.testing.assert_allclose(gx, np.asarray(gx_j), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(gw, np.asarray(gw_j), atol=2e-5, rtol=1e-5)


def test_function_checks_its_arguments():
    x, w = make_inputs((1, 4, 4, 3, 2))
    with pytest.raises(ValueError, match=r"not \(B, H, W, Cin\)"):
        conv3x3_bn_stats(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_bn_stats(torch.zeros(1, 4, 4, 3, device="meta"), torch.zeros(3, 3, 3, 2, device="meta"))
    assert conv3x3_bn_stats.launches == 0  # CPU tensors never launch the kernel


# (k, s): the 3x3 stride-1 conv takes the conv+statistics route, the others nn.BatchNorm2d
@pytest.mark.parametrize("k,s", [(3, 1), (1, 1), (3, 2)])
def test_train_mode_conv_matches_jax(k, s):
    """Output and new batch_stats at atol 1e-5, two steps in a row so the
    running statistics start from non-trivial values."""
    c1, c2 = 5, 8
    rng = np.random.default_rng(5)
    ref = JaxConv(c2=c2, k=k, s=s)
    x = rng.normal(size=(2, 9, 12, c1)).astype(np.float32)
    variables = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    params = {"conv": {"kernel": (rng.normal(size=(k, k, c1, c2)) * 0.2).astype(np.float32)},
              "bn": {"scale": rng.uniform(0.5, 1.5, c2).astype(np.float32),
                     "bias": rng.normal(0, 0.1, c2).astype(np.float32)}}
    stats = {"bn": {"mean": rng.normal(0, 0.1, c2).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c2).astype(np.float32)}}
    assert jax.tree.structure(params) == jax.tree.structure(variables["params"])

    port = Conv(c1, c2, k, s).train()
    assert port.stats_route == (k == 3 and s == 1)
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(params["conv"]["kernel"].transpose(3, 2, 0, 1)))
        port.bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
        port.bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))
        port.bn.running_mean.copy_(torch.from_numpy(stats["bn"]["mean"]))
        port.bn.running_var.copy_(torch.from_numpy(stats["bn"]["var"]))

    for step in range(2):
        xs = x * (1.0 + step)
        want, mut = ref.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs), train=True,
                              mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = port(torch.from_numpy(xs).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(stats["bn"]["mean"]), atol=1e-5)
        np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(stats["bn"]["var"]), atol=1e-5)
        assert int(port.bn.num_batches_tracked) == step + 1


def test_eval_mode_conv_does_not_take_the_stats_route():
    conv = Conv(4, 8, 3, 1).eval()

    def boom(*args):
        raise AssertionError("eval mode called the conv+statistics function")

    conv.bn_stats_fn = boom
    before = conv.bn.running_mean.clone()
    conv(torch.zeros(1, 4, 6, 6))
    torch.testing.assert_close(conv.bn.running_mean, before)
    assert not Conv(4, 8, 3, 1, fused=True).stats_route


def test_yolov3_has_33_stats_route_convs():
    """The stem, 29 Bottleneck.cv2 and layers 13, 15, 22 of yolov3.yaml."""
    with torch.device("meta"):
        model = DetectionModel(parse_spec("yolov3"))
    routed = [name for name, m in model.named_modules() if isinstance(m, Conv) and m.stats_route]
    assert len(routed) == 33
    assert {"model.0", "model.13", "model.15", "model.22"} <= set(routed)
    assert sum(name.endswith(".cv2") for name in routed) == 29

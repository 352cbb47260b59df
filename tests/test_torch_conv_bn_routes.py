"""What csrc/conv_bn.cu's kernels rest on, checked where no card is needed:
the stem kernel's one-step GEMM (K = 27 padded to 32, three 9-value runs per
pixel, the weight's own order within an output channel) against the plain
version and the JAX function, and the naming of the kernel ids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.conv_bn_pallas import conv3x3_bn_stats as jax_conv3x3_bn_stats
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.ops.conv_bn_cuda import ROUTES, conv3x3_bn_stats, conv3x3_bn_stats_plain, route_name


def stem_gemm(x, w):
    """The stem kernel's construction in numpy. x (B, H, W, 3), w (3, 3, 3, Cout).
    A[p][9r + i] = the zero-padded input row h + r - 1 at 3 * (w - 1) + i, i < 9;
    the weight tile is w as (Cout, 27) in (tap row, tap column, channel) order."""
    B, H, W, C = x.shape
    Cout = w.shape[3]
    xp = np.zeros((B, H + 2, (W + 2) * C), np.float32)
    xp[:, 1:-1, C:-C] = x.reshape(B, H, W * C)
    a = np.zeros((B, H, W, 32), np.float32)
    for r in range(3):
        for i in range(9):
            a[..., 9 * r + i] = xp[:, r:r + H, i:i + 3 * W:3]
    wt = np.zeros((Cout, 32), np.float32)
    wt[:, :27] = w.transpose(3, 0, 1, 2).reshape(Cout, 27)
    return a @ wt.T


@pytest.mark.parametrize("B,H,W,Cout", [(2, 8, 9, 32), (1, 4, 130, 16)])
def test_stem_gemm_construction(B, H, W, Cout):
    rng = np.random.default_rng(Cout)
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, Cout)) / 27 ** 0.5).astype(np.float32)
    y = stem_gemm(x, w)
    y_p, mean_p, var_p = conv3x3_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y, y_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(y.mean((0, 1, 2)), mean_p.numpy(), atol=1e-5)
    np.testing.assert_allclose((y * y).mean((0, 1, 2)) - y.mean((0, 1, 2)) ** 2, var_p.numpy(), atol=1e-5)
    # and, through the plain version's partner, the JAX function (Pallas in interpret mode)
    y_j, mean_j, var_j = jax_conv3x3_bn_stats(jnp.asarray(x), jnp.asarray(w), th=4, interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(mean_p.numpy(), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(var_p.numpy(), np.asarray(var_j), atol=1e-5)


def test_route_names():
    assert sorted(ROUTES) == [0, 1, 2, 3]
    assert route_name(2) == "bf16 stem mma.sync"
    assert route_name(3 | 64 << 8 | 128 << 16) == "bf16 wgmma bk64 tn128"
    assert route_name(3 | 16 << 8 | 64 << 16) == "bf16 wgmma bk16 tn64"
    assert route_name(77).startswith("unknown")


def test_cpu_call_names_no_kernel():
    launches, route = conv3x3_bn_stats.launches, conv3x3_bn_stats.last_route
    conv3x3_bn_stats(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 8))
    assert conv3x3_bn_stats.launches == launches and conv3x3_bn_stats.last_route == route

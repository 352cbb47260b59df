"""A folded 3x3 stride-1 conv and the 2x2 stride-2 max pool after it in one
launch: pooled = maxpool2x2(act(conv3x3(x, w) + bias)), and the unpooled
act(conv3x3(x, w) + bias) where a later layer reads it. The CUDA kernel of
csrc/conv_pool.cu and its plain version.

Replaces no TPU kernel: XLA fused this chain into the JAX package's
convolutions. On the card the port ran each pair as cuDNN's conv, the
epilogue pass of `ops/epilogue_cuda` and PyTorch's max pool, three passes
over the full-resolution tensor; `models.detection.conv_pool_pairs` picks
the pairs whose widths `route_of` takes (yolov3-tiny's first four),
`DetectionModel.forward` runs them here. The kernel's two routes, design and
bounds are in csrc/conv_pool.cu.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolov3_tpu_torch.ops import cuda_build
from yolov3_tpu_torch.ops.epilogue_cuda import ACT_FNS, ACTS, vector_layout

ROUTES = ("stem", "halo")  # csrc/conv_pool.cu's route ids 0 and 1


MAX_CIN = 64  # csrc/conv_pool.cu's MAX_CIN


def route_of(cin, cout):
    """The kernel's route for a conv of `cin` -> `cout` channels, or None where
    it has none: "stem" for 3 -> 16 or 32, "halo" for `cin` a multiple of 16
    up to MAX_CIN (both with `cout` a multiple of 8). The one place in Python
    that holds the kernel's widths. Wider inputs are left to cuDNN's conv:
    there the conv is bound by its operations, and the kernel's mma.sync
    products lose to cuDNN's wgmma (csrc/conv_pool.cu)."""
    if cout % 8:
        return None
    if cin == 3 and cout in (16, 32):
        return "stem"
    return "halo" if cin % 16 == 0 and cin <= MAX_CIN else None


def conv_pool_plain(x, weight, bias, act, keep=False):
    """Plain PyTorch version: the conv in float32 of x's and the weight's
    values, the bias, the activation, then the 2x2 max pool, each rounded to
    x's dtype once. Returns (pooled, unpooled), the second None unless
    `keep`; both channels_last."""
    y = ACT_FNS[act](F.conv2d(x.float(), weight.float(), None, 1, 1) + bias.float().view(1, -1, 1, 1))
    pooled = F.max_pool2d(y, 2, 2).to(x.dtype).contiguous(memory_format=torch.channels_last)
    return pooled, (y.to(x.dtype).contiguous(memory_format=torch.channels_last) if keep else None)


def conv_pool(x, weight, bias, act, keep=False):
    """(pooled, unpooled) of a folded 3x3 stride-1 conv with padding 1 and
    the `MaxPool(2, 2, 0)` after it; unpooled is None unless `keep`.

    x: (B, Cin, H, W), H and W even; weight: (Cout, Cin, 3, 3); bias:
    (Cout,); act: a name of `ACTS`. It calls the registered op
    `torch.ops.yolov3_tpu_torch.conv_pool`, so `torch.export` traces a
    program through it: a CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (bf16, x in channels_last, the weight in
    channels_last or copied there, a shape of `route_of`), which counts
    `conv_pool.launches` and `conv_pool.route_launches` (by `<route>_<act>`);
    any other device raises.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_pool: unsupported device {x.device}")
    if act not in ACTS:
        raise ValueError(f"conv_pool: activation {act!r} is not one of {sorted(ACTS)}")
    pooled, unpooled = torch.ops.yolov3_tpu_torch.conv_pool(x, weight, bias, act, keep)
    return pooled, (unpooled if keep else None)


def _outputs(x, cout, keep):
    b, _, h, w = x.shape
    pooled = torch.empty((b, cout, h // 2, w // 2), dtype=x.dtype, device=x.device,
                         memory_format=torch.channels_last)
    unpooled = (torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
                if keep else x.new_empty(0))
    return pooled, unpooled


@torch.library.custom_op("yolov3_tpu_torch::conv_pool", mutates_args=(), device_types="cpu")
def _conv_pool_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, act: str,
                  keep: bool) -> tuple[torch.Tensor, torch.Tensor]:
    pooled, unpooled = conv_pool_plain(x, weight, bias, act, keep)
    return pooled, (unpooled if keep else x.new_empty(0))


@_conv_pool_op.register_kernel("cuda")
def _conv_pool_cuda(x, weight, bias, act, keep):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv_pool: the kernel takes bf16, not {x.dtype}")
    if x.dim() != 4 or not vector_layout(x) or x.data_ptr() % 16 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"conv_pool: x {tuple(x.shape)} with strides {x.stride()} is not a 16-byte aligned "
                         "channels_last tensor of even height and width")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    route = route_of(cin, cout)
    if (weight.shape != (cout, cin, 3, 3) or weight.dtype != x.dtype or weight.device != x.device
            or route is None):
        raise ValueError(f"conv_pool: weight {tuple(weight.shape)} {weight.dtype} is not a 3x3 {x.dtype} weight "
                         f"of 3 to 16 or 32 channels, or of a multiple of 16 up to {MAX_CIN} to a multiple of 8")
    if bias.shape != (cout,) or bias.dtype != x.dtype or bias.device != x.device or not bias.is_contiguous():
        raise ValueError(f"conv_pool: bias {tuple(bias.shape)} {bias.dtype} is not ({cout},) {x.dtype} on {x.device}")
    if not weight.is_contiguous(memory_format=torch.channels_last) or weight.data_ptr() % 16:
        weight = weight.contiguous(memory_format=torch.channels_last)  # the (Cout, 3, 3, Cin) bytes the kernel reads
    pooled, unpooled = _outputs(x, cout, keep)
    if x.numel() == 0:
        return pooled, unpooled
    device = x.device
    taken = ctypes.c_int(-1)
    with torch.cuda.device(device):
        err = _library().conv_pool_launch(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), pooled.data_ptr(),
            unpooled.data_ptr() if keep else None, b, h, w, cin, cout, ACTS[act],
            torch.cuda.current_stream(device).cuda_stream, ctypes.byref(taken))
    if err:
        raise RuntimeError(f"conv_pool kernel launch failed: cudaError {err}")
    conv_pool.launches += 1
    conv_pool.route_launches[f"{ROUTES[taken.value]}_{act}"] += 1
    return pooled, unpooled


@_conv_pool_op.register_fake
def _conv_pool_fake(x, weight, bias, act, keep):
    return _outputs(x, weight.shape[0], keep)


conv_pool.launches = 0
conv_pool.route_launches = {f"{r}_{a}": 0 for r in ROUTES for a in ACTS}


def _library():
    lib = cuda_build.load("conv_pool")
    fn = lib.conv_pool_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib

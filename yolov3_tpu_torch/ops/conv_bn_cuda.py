"""3x3 conv fused with BatchNorm batch statistics: the CUDA kernel of
csrc/conv_bn.cu, its plain version, and the autograd function around them.

Replaces the TPU kernel `_conv3x3_stats_kernel` / `conv3x3_bn_stats` of
yolov3_tpu/ops/conv_bn_pallas.py; the kernel's design and bound are described
in csrc/conv_bn.cu. Layout is the JAX function's: x (B, H, W, Cin), w
(3, 3, Cin, Cout), y (B, H, W, Cout). The port's activations are NCHW tensors
in `channels_last`, the same bytes, so a caller passes `x.permute(0, 2, 3, 1)`
without a copy.

The JAX package has no backward kernel for this function (XLA differentiates
the prototype's inputs), so the gradient here is the ordinary convolution
gradients as library calls, fed with the cotangent that folds the statistics'
cotangents into y's.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolov3_tpu_torch.ops import cuda_build


def conv3x3_bn_stats_plain(x, w):
    """Plain PyTorch version; same arguments and results as `conv3x3_bn_stats`.

    The conv accumulates in f32 (f64 inputs stay f64), the statistics come
    from that result before y is cast to x's dtype. Differentiable by autograd
    as it stands; autocast is switched off inside so the upcast holds."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.autocast(x.device.type, enabled=False):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(acc), w.permute(3, 2, 0, 1).to(acc), padding=1)
        y = y.permute(0, 2, 3, 1)  # NHWC
        mean = y.mean((0, 1, 2))
        var = (y * y).mean((0, 1, 2)) - mean * mean
        return y.to(x.dtype).contiguous(), mean, var


def _forward(x, w):
    """y, mean, var without autograd: the plain version for CPU tensors, the
    kernel for CUDA tensors (or an error; never the plain version)."""
    if x.device.type == "cpu":
        return conv3x3_bn_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_stats: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_bn_stats: unsupported dtype {x.dtype} (bfloat16 or float32)")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"conv3x3_bn_stats: w is {w.dtype} on {w.device}, x is {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_bn_stats: x must be contiguous in (B, H, W, Cin) order "
                         "(an NCHW tensor in channels_last, permuted)")
    B, H, W, Cin = x.shape
    Cout = w.shape[3]
    if min(B, H, W, Cin, Cout) < 1 or B * H * W * max(Cin, Cout) >= 2 ** 40:
        raise ValueError(f"conv3x3_bn_stats: unsupported sizes x {tuple(x.shape)}, w {tuple(w.shape)}")
    # the kernel reads the weight as (Cout, 3, 3, Cin): for a view of an OIHW
    # conv weight in channels_last this is the parameter's own bytes, no copy
    w = w.permute(3, 0, 1, 2).contiguous()
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _library()
    rows = lib.conv3x3_bn_stats_partial_rows(B, H, W, is_bf16)
    y = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    partial = torch.empty((rows, 2, Cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, Cout), dtype=torch.float32, device=x.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_bn_stats_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), partial.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), B, H, W, Cin, Cout, is_bf16,
            torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(route))
    if err:
        raise RuntimeError(f"conv3x3_bn_stats kernel launch failed: cudaError {err} "
                           f"(20000 + a CUresult: a tensor map was refused), route {route_name(route.value)}")
    conv3x3_bn_stats.launches += 1
    conv3x3_bn_stats.last_route = route_name(route.value)
    return y, stats[0], stats[1]


class _Conv3x3BNStats(torch.autograd.Function):
    """Under CUDA autocast the inputs are cast to bf16 and the kernel runs in
    bf16, whatever the parameters' dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w):
        y, mean, var = _forward(x, w)
        ctx.save_for_backward(x, w, y, mean)
        return y, mean, var

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gy, gmean, gvar):
        x, w, y, mean = ctx.saved_tensors
        n = y.numel() // y.shape[-1]
        # cotangent on y: gy + gmean/n + gvar * 2 (y - mean) / n = gy + y * b + a, in
        # two passes over y's bytes; the per-channel a and b are made in the
        # statistics' f32 and rounded once to y's dtype
        b = gvar * (2.0 / n)
        a = gmean / n - b * mean
        g = torch.addcmul(gy, y, b.to(y.dtype)).add_(a.to(y.dtype)).permute(0, 3, 1, 2)
        # one library call for both gradients, on the real x and w (NCHW / OIHW
        # views, channels_last bytes), so it picks the layout they already have
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, (1, 1), (1, 1), (1, 1), False, (0, 0), 1,
            (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return (None if gx is None else gx.permute(0, 2, 3, 1),
                None if gw is None else gw.permute(2, 3, 1, 0))


def conv3x3_bn_stats(x, w):
    """Fused stride-1 SAME 3x3 conv + BatchNorm batch statistics.

    x: (B, H, W, Cin) activations, contiguous; w: (3, 3, Cin, Cout).
    Returns y (B, H, W, Cout) in x's dtype, and the f32 batch mean (Cout,) and
    biased batch variance (Cout,) of the conv's f32 result. The variance is
    E[y^2] - mean^2 and can dip below 0 by rounding when |mean| >> std; a
    normalising caller clamps it.

    Differentiable in x and w. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (bfloat16 or float32) or raises;
    `conv3x3_bn_stats.last_route` then names the kernel it took.
    """
    if w.dim() != 4 or x.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_bn_stats: x {tuple(x.shape)} / w {tuple(w.shape)} are not "
                         "(B, H, W, Cin) / (3, 3, Cin, Cout)")
    return _Conv3x3BNStats.apply(x, w)


conv3x3_bn_stats.launches = 0
conv3x3_bn_stats.last_route = None  # name of the kernel the last launch took

# kernel ids of csrc/conv_bn.cu (the low byte of what the launch function reports)
ROUTES = {0: "f32 fma", 1: "bf16 element-load wmma", 2: "bf16 stem mma.sync", 3: "bf16 wgmma"}


def route_name(route: int) -> str:
    """Name of a kernel id of csrc/conv_bn.cu; the wgmma kernel's carries its
    input channels a step (the swizzle width) and its channel tile."""
    name = ROUTES.get(route & 0xFF, f"unknown {route}")
    if route & 0xFF == 3:
        name += f" bk{(route >> 8) & 0xFF} tn{(route >> 16) & 0xFFFF}"
    return name


def _library():
    lib = cuda_build.load("conv_bn")
    fn = lib.conv3x3_bn_stats_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.conv3x3_bn_stats_partial_rows.argtypes = [ctypes.c_int] * 4
        lib.conv3x3_bn_stats_partial_rows.restype = ctypes.c_int
    return lib

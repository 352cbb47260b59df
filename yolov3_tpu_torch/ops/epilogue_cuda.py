"""Epilogue of a folded conv, out = act(y + bias) (+ residual), in place over
the conv's output y: the CUDA kernel of csrc/epilogue.cu and its plain
version.

Replaces no TPU kernel: XLA fused this epilogue into the JAX package's
convolutions. On the card the port's folded bf16 convs ran it as three
PyTorch passes (cuDNN's separate bias add, the activation, a Bottleneck's
residual add); `nn.modules.Conv` now runs it here in one (its route is
described there). The kernel's design and byte bound are in
csrc/epilogue.cu.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from yolov3_tpu_torch.nn.activations import identity, leaky_relu, silu
from yolov3_tpu_torch.ops import cuda_build

ACTS = {"identity": 0, "silu": 1, "leaky_relu": 2}  # csrc/epilogue.cu's Act
ACT_FNS = {"identity": identity, "silu": silu, "leaky_relu": leaky_relu}  # leaky_relu: slope 0.1, as the kernel's


def conv_epilogue_plain(y, bias, act, residual=None):
    """Plain PyTorch version: act(y + bias) (+ residual) computed in float32
    and rounded to y's dtype once; a new tensor (y is left as it is). In
    float32 it is the three passes the kernel replaces, in their order."""
    out = ACT_FNS[act](y.float() + bias.float().view(1, -1, 1, 1))
    if residual is not None:
        out = residual.float() + out
    return out.to(y.dtype)


def vector_layout(t):
    """Whether `t` is in the kernel's layout: 4-D, channels_last contiguous,
    its first element a multiple of 16 bytes into its storage (the launch
    checks the address itself; a traced tensor has none)."""
    return (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
            and t.storage_offset() * t.element_size() % 16 == 0)


def in_vector_layout(t):
    """`t` itself where it is in the kernel's layout, else a channels_last
    copy of it. cuDNN keeps a channels_last input's layout, so on the card
    a served conv's output and shortcut are never copied; `torch.export`'s
    shape propagation gives conv outputs NCHW strides, so an exported
    program copies them."""
    return t if vector_layout(t) else t.clone(memory_format=torch.channels_last)


def conv_epilogue(y, bias, act, residual=None):
    """y = act(y + bias) (+ residual), in place; returns y.

    y: (B, C, H, W) conv output without its bias, bf16 in channels_last
    memory (NHWC bytes), C a multiple of 8; bias: (C,) bf16; act: a name
    of `ACTS`; residual: None or a tensor of y's shape, dtype and layout,
    added after the activation.

    It calls the registered op `torch.ops.yolov3_tpu_torch.conv_epilogue`
    (in place on y), so `torch.export` traces a program through it: a CPU
    tensor runs the plain version; a CUDA tensor launches the kernel, which
    counts `conv_epilogue.launches` and `conv_epilogue.route_launches` (by
    `<act>` and `<act>_residual`); any other device raises.
    """
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: unsupported device {y.device}")
    if act not in ACTS:
        raise ValueError(f"conv_epilogue: activation {act!r} is not one of {sorted(ACTS)}")
    torch.ops.yolov3_tpu_torch.conv_epilogue(y, bias, residual, act)
    return y


@torch.library.custom_op("yolov3_tpu_torch::conv_epilogue", mutates_args=("y",), device_types="cpu")
def _conv_epilogue_op(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor], act: str) -> None:
    y.copy_(conv_epilogue_plain(y, bias, act, residual))


@_conv_epilogue_op.register_kernel("cuda")
def _conv_epilogue_cuda(y, bias, residual, act):
    if y.dtype != torch.bfloat16:
        raise ValueError(f"conv_epilogue: the kernel takes bf16, not {y.dtype}")
    c = y.shape[1] if y.dim() == 4 else 0
    if not vector_layout(y) or y.data_ptr() % 16 or c % 8:
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)} with strides {y.stride()} is not a 16-byte aligned "
                         "channels_last tensor with channels a multiple of 8")
    if (bias.shape != (c,) or bias.dtype != y.dtype or bias.device != y.device or not bias.is_contiguous()
            or bias.data_ptr() % 4):
        raise ValueError(f"conv_epilogue: bias {tuple(bias.shape)} {bias.dtype} is not ({c},) {y.dtype} on "
                         f"{y.device}")
    if residual is not None and (residual.shape != y.shape or residual.dtype != y.dtype
                                 or residual.device != y.device or not vector_layout(residual)
                                 or residual.data_ptr() % 16):
        raise ValueError(f"conv_epilogue: residual {tuple(residual.shape)} {residual.dtype} is not in y's shape, "
                         "dtype and layout")
    if y.numel() == 0:
        return
    device = y.device
    with torch.cuda.device(device):
        err = _library().conv_epilogue_launch(
            y.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(), y.numel(), c,
            ACTS[act], torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"conv_epilogue kernel launch failed: cudaError {err}")
    conv_epilogue.launches += 1
    conv_epilogue.route_launches[act if residual is None else f"{act}_residual"] += 1


@_conv_epilogue_op.register_fake
def _conv_epilogue_fake(y, bias, residual, act):
    return None


conv_epilogue.launches = 0
conv_epilogue.route_launches = {f"{a}{r}": 0 for a in ACTS for r in ("", "_residual")}


def _library():
    lib = cuda_build.load("epilogue")
    fn = lib.conv_epilogue_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib

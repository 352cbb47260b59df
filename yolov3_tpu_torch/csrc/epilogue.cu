// Epilogue of a folded conv: out = act(y + bias) (+ residual), in place over
// the conv's output y, in one pass.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses the bias, the
// activation and a Bottleneck's shortcut into the convolution that produces
// them, so no TPU kernel was written for them. The port runs its folded
// (BatchNorm-free) bf16 convs through cuDNN, which PyTorch follows with a
// separate bias pass; SiLU and the residual add were two more passes. Each
// read and wrote the whole conv output. This kernel is the one pass left.
//
// Layout: y is bf16 NHWC (an NCHW tensor in torch.channels_last), C a
// multiple of 8, so element i has channel i % C and the tensor is a run of
// 16-byte vectors of 8 channels of one pixel. The residual, where there is
// one, has y's shape and layout; the bias is C bf16 values. Only bf16 takes
// the kernel (nn.modules.Conv keeps PyTorch's passes for float32 and
// float16): the served and exported half models are bf16, and an f32 model's
// answers stay those of PyTorch's own arithmetic.
//
// Arithmetic: each element is widened to f32, the bias (widened exactly) is
// added, the activation is applied (SiLU x / (1 + exp(-x)) with the accurate
// expf and an IEEE division, as PyTorch's CUDA SiLU computes it, this file
// being built without --use_fast_math; leaky ReLU at slope 0.1; identity),
// the residual (widened) is added, and the sum is rounded to bf16 once, to
// nearest even, at the store. The three PyTorch passes also rounded to bf16
// after the bias and after the activation: this path drops those two
// roundings. Its f32 values are those of the plain version
// (ops/epilogue_cuda.py, the same math in f32 with one rounding), so the two
// agreed bit for bit at every shape measured on the card (chip_smoke.py
// holds them to one unit in the last place).
//
// Bound: bytes. A launch reads y (and the residual) and writes y once:
// (2 + has_residual) * numel * 2 + 2 * C bytes, against some 25 f32
// instructions an element. At yolov3's largest epilogue, 32 x 320 x 320 x 64,
// that is 839 MB, 0.250 ms at 3.35 TB/s. The design is PyTorch's own
// elementwise shape, which reads and writes at about 90% of that on an H100:
//  - one 16-byte vector (8 channels of one pixel) a thread, neighbouring
//    threads on neighbouring vectors, so a warp moves 512 contiguous bytes a
//    request; blocks of 128 threads, as many as there are vectors / 128, so
//    the card's scheduler keeps every SM full and streams the tensor in order;
//  - the thread's 8 bias values are 4 cached 4-byte loads at channel
//    (i % (C / 8)) * 8: the bias is C * 2 bytes, so they hit L1 or L2.
// Two forms measured slower on an H100 80GB HBM3 at 700 W (PERF.md):
// persistent blocks walking the tensor with a grid stride that kept a
// thread's channels (and its bias in registers) fixed read 76-85% of the
// bound where this one reads 86-92%, with 2 to 8 vectors in flight a thread
// or 128 to 1024 threads a block; and rounding such a grid up to a multiple
// of C / 8 blocks spilled a few blocks into a second wave, which streamed
// their share alone (63-70% of the bound at yolov5x6's widths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

enum Act { IDENTITY = 0, SILU = 1, LEAKY_RELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == SILU) return x / (1.0f + expf(-x));
  if (ACT == LEAKY_RELU) return x > 0.0f ? x : x * 0.1f;
  return x;
}

// One 16-byte vector (8 channels of one pixel) a thread.
template <int ACT, bool RES>
__global__ void __launch_bounds__(THREADS) conv_epilogue_kernel(uint4* __restrict__ y,
                                                                const __nv_bfloat162* __restrict__ bias,
                                                                const uint4* __restrict__ res, long long nvec,
                                                                int cvec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const uint4 a = y[i];
  uint4 r;
  if (RES) r = __ldg(res + i);
  const __nv_bfloat162* bp = bias + (int)(i % cvec) * 4;
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&r);
  uint4 o;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(ap[k]);
    const float2 b = __bfloat1622float2(__ldg(bp + k));
    float lo = activate<ACT>(x.x + b.x);
    float hi = activate<ACT>(x.y + b.y);
    if (RES) {
      const float2 s = __bfloat1622float2(rp[k]);
      lo = s.x + lo;  // the shortcut first, as the Bottleneck's x + y
      hi = s.y + hi;
    }
    op[k] = __floats2bfloat162_rn(lo, hi);
  }
  y[i] = o;
}

template <int ACT>
cudaError_t launch(void* y, const void* bias, const void* res, long long nvec, int cvec, cudaStream_t stream) {
  const long long blocks = (nvec + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  uint4* yv = static_cast<uint4*>(y);
  const __nv_bfloat162* b = static_cast<const __nv_bfloat162*>(bias);
  const uint4* r = static_cast<const uint4*>(res);
  if (r)
    conv_epilogue_kernel<ACT, true><<<(unsigned)blocks, THREADS, 0, stream>>>(yv, b, r, nvec, cvec);
  else
    conv_epilogue_kernel<ACT, false><<<(unsigned)blocks, THREADS, 0, stream>>>(yv, b, r, nvec, cvec);
  return cudaGetLastError();
}

}  // namespace

// y: numel bf16 elements (NHWC, C = channels, a multiple of 8), 16-byte aligned, written in place; bias: C bf16
// values, 4-byte aligned; residual: numel bf16 elements, 16-byte aligned, or null. act 0 identity, 1 SiLU, 2 leaky
// ReLU (0.1). Returns the cudaError of the launch.
extern "C" int conv_epilogue_launch(void* y, const void* bias, const void* residual, long long numel, int channels,
                                    int act, void* stream) {
  if (numel <= 0 || channels <= 0 || channels % 8 || numel % channels) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(residual)) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nvec = numel / 8;
  const int cvec = channels / 8;
  switch (act) {
    case IDENTITY: return (int)launch<IDENTITY>(y, bias, residual, nvec, cvec, st);
    case SILU: return (int)launch<SILU>(y, bias, residual, nvec, cvec, st);
    case LEAKY_RELU: return (int)launch<LEAKY_RELU>(y, bias, residual, nvec, cvec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

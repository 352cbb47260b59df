// A folded 3x3 stride-1 conv and the 2x2 stride-2 max pool after it, in one
// launch: pooled = maxpool2x2(act(conv3x3(x, w) + bias)), and where a later
// layer reads it, the unpooled act(conv3x3(x, w) + bias) too.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses the conv's bias,
// the activation and the pool into the convolution, so no TPU kernel was
// written for them. The port's served yolov3-tiny ran each such pair as
// cuDNN's conv (which writes the full-resolution tensor), the epilogue pass of
// csrc/epilogue.cu (which reads and writes it again) and PyTorch's max pool
// (which reads it once more and writes a quarter of it). Here the
// full-resolution tensor stays in registers: a launch reads x and writes the
// pooled output (and the unpooled one only where it is asked for).
//
// Layout: x (B, H, W, Cin), y (B, H, W, Cout) and pooled (B, H/2, W/2, Cout)
// are bf16 NHWC (NCHW tensors in torch.channels_last), the weight is
// (Cout, 3, 3, Cin), the bytes of PyTorch's OIHW weight in channels_last, the
// bias Cout bf16 values. H and W are even; Cout is a multiple of 8.
//
// Arithmetic, as csrc/epilogue.cu's: f32 accumulation of the bf16 products;
// the bias widened exactly and added; the activation in f32 (SiLU
// x / (1 + exp(-x)) with the accurate expf and an IEEE division, this file
// being built without --use_fast_math; leaky ReLU at slope 0.1; identity) on
// each of the four values of a window, and only then their max (SiLU is not
// monotonic, so pooling first would change the answer); one rounding to bf16,
// to nearest even, at the store. Rounding is monotonic, so the pooled value is
// the max of the rounded unpooled values, and the two stores agree. The three
// passes this replaces also rounded the conv's output to bf16 before the bias
// and again after the activation; this path drops those roundings.
//
// Bound at yolov3-tiny's five pairs (640 px, batch 32): bytes at the stem and
// at 320x320 16->32 (x read once, the pooled output written once), operations
// at the three narrower pairs (2 * 9 * Cin * Cout a pixel, 30.2 GFLOP each):
// 0.19 ms for all five at 3.35 TB/s and 989 TFLOP/s. In practice two more
// floors sit above it: mma.sync reaches 560 TFLOP/s on an H100 (the card's
// full rate needs wgmma), and the activation runs on every unpooled value
// (SiLU, about 20 instructions, 210 M of them at the stem). So the kernel
// takes inputs up to 64 channels: at 128 -> 256 (the fifth pair) the conv is
// bound by its operations, and cuDNN's wgmma conv with the epilogue pass and
// PyTorch's pool measured 0.126 ms against this kernel's 0.197. Two kernels,
// chosen by the launch function from the shape (conv_pool_launch reports
// which):
//
//  - Cin = 3, Cout = 16 or 32 (the stem): `conv_pool_stem_kernel`, from
//    csrc/conv_bn.cu's stem kernel. K = 27 padded to 32 is two mma.sync
//    m16n8k16 steps: in NHWC the 3 pixels x 3 channels of one input row under
//    a tap row are 9 contiguous values, so A[p][9r + i] = row r of the tile at
//    3p + i. A tile is 8 output rows of 128 pixels; a block stages the 10
//    input rows under them (masked at the borders) in shared memory, one tile
//    ahead through registers, keeps the weight fragments in registers and
//    takes the epilogue from the accumulators (below).
//  - Cin a multiple of 16 up to 64: `conv_pool_halo_kernel`, an implicit
//    GEMM on mma.sync m16n8k16 (bf16 -> f32). A block keeps the weight slice
//    of its TN output channels in shared memory, copied once (TN = 64, or 32
//    where Cout <= 32), and walks pixel tiles of TH x 16 (TH 8, or 16 with
//    TN 32). Its input is the tile's (TH + 2) x 18 pixel halo, 16 channels a
//    step, staged by 16-byte cp.async copies whose offsets each thread
//    computes once (zero-filled outside the image); the
//    block's steps run as one sequence with two in flight, so the next
//    tile's copies overlap this tile's products and epilogue. All nine taps
//    read the one halo tile through ldmatrix. Halo rows are padded to 48
//    bytes and the weight's 32-byte rows have their halves swapped in rows
//    4-7 of each 8, which puts the eight rows an ldmatrix reads in eight
//    different bank groups. The epilogue puts the f32 accumulators in a tile
//    of their own, from which each thread takes one channel pair of whole 2x2
//    windows: a short loop. Taken from the fragments' layout, the epilogue
//    unrolls the activation for every value a thread holds, some 4000
//    instructions a tile, and measured a quarter of this loop's speed.
//
// In the stem the rows of an m16 fragment are a 2 x 8 pixel patch: row g is
// pixel (2i, 8j + g) and row g + 8 is pixel (2i + 1, 8j + g). A thread's
// accumulators c[0..1] and c[2..3] are then vertical neighbours, so the
// vertical max is taken in registers and the horizontal one with the thread
// four lanes over (g ^ 1), and every 2x2 window is whole inside one warp. The
// pooled tile goes through shared memory to 16-byte stores.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md), batch 32 at 640 px,
// against the three kernels each pair replaces: the stem 0.36 ms (2.80),
// 16->32 0.28 (1.00), 32->64 0.18 (0.37) and 64->128 0.19 (0.20).
//
// The dynamic shared memory limit of a kernel and the occupancy found for it
// belong to one card's context: both are cached per card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

enum Act { IDENTITY = 0, SILU = 1, LEAKY_RELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == SILU) return x / (1.0f + expf(-x));
  if (ACT == LEAKY_RELU) return x > 0.0f ? x : x * 0.1f;
  return x;
}

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The epilogue of one n8 fragment held in registers: c[0..1] are pixel (2i, col) channels ch, ch + 1 and c[2..3]
// pixel (2i + 1, col). The activation is applied to all four values, then the max taken over the pixel pair and,
// through the lane four over (g ^ 1), over the column pair: in pooled[0..1], valid in lanes with g even. Where y0 is
// not null the rounded activations are stored to y0 (row 2i) and y1 (row 2i + 1).
template <int ACT>
__device__ __forceinline__ void pool_fragment(const float (&c)[4], float b0, float b1, __nv_bfloat16* y0,
                                              __nv_bfloat16* y1, float (&pooled)[2]) {
  const float v0 = activate<ACT>(c[0] + b0), v1 = activate<ACT>(c[1] + b1);
  const float v2 = activate<ACT>(c[2] + b0), v3 = activate<ACT>(c[3] + b1);
  if (y0 != nullptr) {
    *reinterpret_cast<__nv_bfloat162*>(y0) = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(y1) = __floats2bfloat162_rn(v2, v3);
  }
  float m0 = fmaxf(v0, v2), m1 = fmaxf(v1, v3);
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
  pooled[0] = m0;
  pooled[1] = m1;
}

// One channel pair of one 2x2 window: q[r][c] holds pixel (r, c)'s two f32 accumulators. The activation is applied to
// all four pixels, and only then the max taken (SiLU is not monotonic). Stores the pooled pair and, where y0 is not
// null, the four unpooled pairs (y0 row 0, y1 row 1; column c at + c * cstride), each rounded once.
template <int ACT>
__device__ __forceinline__ void pool_window(const float2 (&q)[2][2], float b0, float b1, __nv_bfloat16* pooled,
                                            __nv_bfloat16* y0, __nv_bfloat16* y1, long long cstride) {
  float2 v[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) v[r][c] = make_float2(activate<ACT>(q[r][c].x + b0), activate<ACT>(q[r][c].y + b1));
  const float m0 = fmaxf(fmaxf(v[0][0].x, v[0][1].x), fmaxf(v[1][0].x, v[1][1].x));
  const float m1 = fmaxf(fmaxf(v[0][0].y, v[0][1].y), fmaxf(v[1][0].y, v[1][1].y));
  *reinterpret_cast<__nv_bfloat162*>(pooled) = __floats2bfloat162_rn(m0, m1);
  if (y0 != nullptr) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(y0 + c * cstride) = __floats2bfloat162_rn(v[0][c].x, v[0][c].y);
      *reinterpret_cast<__nv_bfloat162*>(y1 + c * cstride) = __floats2bfloat162_rn(v[1][c].x, v[1][c].y);
    }
  }
}

// ------------------------------------------------ the stem (Cin = 3) ----

constexpr int STEM_PX = 128;                        // output pixels of one row per tile, 16 a warp
constexpr int STEM_ROWS = 8;                        // output rows of a stem tile
constexpr int STEM_LD = (STEM_PX + 2) * 3 + 2;      // bf16 elements of one staged input row
constexpr int STEM_PER = ((STEM_PX + 2) * 3 + THREADS - 1) / THREADS;  // elements a thread stages a row

// Cout = 8 * NT. A tile is STEM_ROWS output rows (STEM_ROWS / 2 row pairs), pixels w0 .. w0 + 127; warp k owns columns
// 16k .. 16k + 15 of each row pair as two m16 fragments of 2 x 8 pixels. The GEMM's k index is
// 9 * (tap row) + 3 * (tap column) + channel, the weight's own order within an output channel. The pooled pixels go
// through the warp's staging tile to 16-byte stores; the unpooled ones, where kept, from the registers (the stem of
// yolov3-tiny keeps none).
template <int NT, int ACT>
__global__ void __launch_bounds__(THREADS, 3)
conv_pool_stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ pooled,
                      __nv_bfloat16* __restrict__ y, int B, int H, int W) {
  constexpr int COUT = NT * 8;
  constexpr int LDS = COUT + 8;  // staging stride: rows stay 16-byte aligned, banks spread
  constexpr int IN_ROWS = STEM_ROWS + 2;
  __shared__ __align__(16) __nv_bfloat16 xs[IN_ROWS][STEM_LD];
  __shared__ __align__(16) __nv_bfloat16 ps[THREADS / 32][STEM_ROWS / 2][8][LDS];  // a warp's pooled pixels

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row (and the weight fragment's channel)
  const int t = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const bool keep = y != nullptr;

  // this thread's eight k indices, two steps of {2t, 2t+1, 2t+8, 2t+9}: where they
  // sit in the staged rows, and its weight fragments and biases, all fixed for the kernel
  int koff[8];
  uint32_t bfrag[NT][4];
  float bv[NT][2];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = (q >> 2) * 16 + 2 * t + (q & 1) + ((q >> 1) & 1) * 8;
    koff[q] = k < 27 ? (k / 9) * STEM_LD + k % 9 : -1;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat16* wn = w + (size_t)(nt * 8 + g) * 27;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = (q >> 1) * 16 + 2 * t + (q & 1) * 8;  // the pair (k, k + 1)
      bfrag[nt][q] = pack_bf16(k < 27 ? wn[k] : zero, k + 1 < 27 ? wn[k + 1] : zero);
    }
    bv[nt][0] = __bfloat162float(bias[nt * 8 + 2 * t]);
    bv[nt][1] = __bfloat162float(bias[nt * 8 + 2 * t + 1]);
  }

  const int Hp = H / 2, Wp = W / 2;
  const int tiles_w = (W + STEM_PX - 1) / STEM_PX, tiles_h = (H + STEM_ROWS - 1) / STEM_ROWS;
  const long long n_tiles = (long long)B * tiles_h * tiles_w;
  const __nv_bfloat16* xs_flat = &xs[0][0];
  // the input rows r0 - 1 .. r0 + STEM_ROWS of a tile, pixels w0 - 1 .. w0 + STEM_PX, zero outside the image: fetched
  // into registers one tile ahead, so the loads are in flight during the products of the tile before
  __nv_bfloat16 ahead[IN_ROWS][STEM_PER];
  auto fetch = [&](long long tile) {
    const int w0 = (int)(tile % tiles_w) * STEM_PX;
    const long long bt = tile / tiles_w;  // b * tiles_h + row tile
    const int h0 = (int)(bt % tiles_h) * STEM_ROWS - 1;
    const long long row0 = (bt / tiles_h) * H + h0;  // b * H + h0
#pragma unroll
    for (int r = 0; r < IN_ROWS; ++r) {
      const bool row_ok = (unsigned)(h0 + r) < (unsigned)H;
      const __nv_bfloat16* src = x + ((row0 + r) * W + (w0 - 1)) * 3;
#pragma unroll
      for (int k = 0; k < STEM_PER; ++k) {
        const int e = tid + k * THREADS;
        const int px = w0 - 1 + e / 3;
        ahead[r][k] = (e < (STEM_PX + 2) * 3 && row_ok && (unsigned)px < (unsigned)W) ? src[e] : zero;
      }
    }
  };
  if ((long long)blockIdx.x < n_tiles) fetch(blockIdx.x);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int w0 = (int)(tile % tiles_w) * STEM_PX;
    const long long bt = tile / tiles_w;
    const int b = (int)(bt / tiles_h);
    const int r0 = (int)(bt % tiles_h) * STEM_ROWS;  // the tile's first output row
#pragma unroll
    for (int r = 0; r < IN_ROWS; ++r)
#pragma unroll
      for (int k = 0; k < STEM_PER; ++k)
        if (tid + k * THREADS < (STEM_PX + 2) * 3) xs[r][tid + k * THREADS] = ahead[r][k];
    __syncthreads();
    if (tile + gridDim.x < n_tiles) fetch(tile + gridDim.x);

#pragma unroll
    for (int rp = 0; rp < STEM_ROWS / 2; ++rp)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = warp * 16 + j * 8 + g;  // this thread's fragment rows: pixel col of rows 2rp and 2rp + 1
        uint32_t afrag[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int half = 0; half < 2; ++half)    // k and k + 8
#pragma unroll
            for (int row = 0; row < 2; ++row) {   // output row 2rp and 2rp + 1
              const int q = ks * 4 + half * 2;
              const int p = (2 * rp + row) * STEM_LD + col * 3;
              const __nv_bfloat16 lo = koff[q] >= 0 ? xs_flat[koff[q] + p] : zero;
              const __nv_bfloat16 hi = koff[q + 1] >= 0 ? xs_flat[koff[q + 1] + p] : zero;
              afrag[ks][half * 2 + row] = pack_bf16(lo, hi);
            }
        const int yr = r0 + 2 * rp, yc = w0 + col;
        const bool store_y = keep && yr < H && yc < W;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_m16n8k16(c, afrag[0], bfrag[nt][0], bfrag[nt][1]);
          mma_m16n8k16(c, afrag[1], bfrag[nt][2], bfrag[nt][3]);
          __nv_bfloat16* y0 = store_y ? y + ((((long long)b * H + yr) * W + yc) * COUT + nt * 8 + 2 * t) : nullptr;
          float m[2];
          pool_fragment<ACT>(c, bv[nt][0], bv[nt][1], y0, store_y ? y0 + (long long)W * COUT : nullptr, m);
          if ((g & 1) == 0)
            *reinterpret_cast<__nv_bfloat162*>(&ps[warp][rp][j * 4 + g / 2][nt * 8 + 2 * t]) =
                __floats2bfloat162_rn(m[0], m[1]);
        }
      }
    __syncwarp();
    const int pc0 = (w0 + warp * 16) / 2;  // the warp's first pooled column
#pragma unroll
    for (int idx = lane; idx < (STEM_ROWS / 2) * 8 * NT; idx += 32) {  // STEM_ROWS / 2 x 8 pooled pixels x NT chunks of 16 bytes
      const int rp = idx / (8 * NT), px = (idx / NT) % 8, ch = idx % NT;
      const int pr = r0 / 2 + rp;
      if (pr < Hp && pc0 + px < Wp)
        *reinterpret_cast<uint4*>(pooled + ((((long long)b * Hp + pr) * Wp + pc0 + px) * COUT + ch * 8)) =
            *reinterpret_cast<const uint4*>(&ps[warp][rp][px][ch * 8]);
    }
    __syncthreads();  // xs and ps are overwritten by the next tile
  }
}

// ------------------------------------ Cin a multiple of 16: halo tiles ----

constexpr int MAX_CIN = 64;  // the widest input of the halo route (ops/conv_pool_cuda.py's MAX_CIN)
constexpr int TW = 16;      // output columns of a tile; its rows are TH, a template parameter (8 or 16)
constexpr int KS = 16;      // input channels a step
constexpr int LDK = KS + 8; // bf16 elements of a staged halo pixel: 48 bytes
constexpr int STAGES = 3;   // halo stages: two steps' copies in flight while one is computed

template <int TN, int TH>
struct HaloShape {
  static constexpr int HALO_H = TH + 2, HALO_W = TW + 2;    // the tile's input pixels
  static constexpr int HALO_BYTES = HALO_H * HALO_W * LDK * 2;  // one step's stage, a multiple of 16
  static constexpr int HALO_COPIES = HALO_H * HALO_W * 2;   // its 16-byte copies
  static constexpr int COPIES_PER_THREAD = (HALO_COPIES + THREADS - 1) / THREADS;
  static constexpr int PX = TH * TW;
  static constexpr int LDA = TN + 4;                        // f32 stride of the epilogue's tile
  static constexpr int SCRATCH_BYTES = PX * LDA * 4;
  static constexpr int WARPS_N = TN / 32;                 // a warp owns 32 channels ...
  static constexpr int WARPS_M = THREADS / 32 / WARPS_N;  // ... and MT of the tile's PX / 16 fragments of 2 x 8 pixels
  static constexpr int MT = PX / 16 / WARPS_M;
  // shared memory: the block's weight slice (Cin / 16 chunks x 9 taps x TN rows of 32 bytes), the halo stages and
  // the epilogue's f32 tile
  static constexpr int smem_bytes(int cin) { return 9 * TN * cin * 2 + STAGES * HALO_BYTES + SCRATCH_BYTES; }
};
static_assert(HaloShape<64, 8>::smem_bytes(MAX_CIN) <= 232448 && HaloShape<32, 16>::smem_bytes(MAX_CIN) <= 232448,
              "a block's shared memory fits an SM");

// Byte offset of half h (16 bytes) of row r of the resident weight: the halves of rows 4-7 of each 8 are swapped, so
// the 8 rows of 32 bytes an ldmatrix reads fall in 8 different 16-byte bank groups.
__device__ __forceinline__ uint32_t weight_at(int r, int h) { return (uint32_t)r * 32u + 16u * (h ^ ((r >> 2) & 1)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// 16 bytes from global to shared memory; src_bytes 0 writes zeros (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// grid (gx, channel tiles): block (bx, by) computes TN output channels from by * TN for the pixel tiles bx, bx + gx,
// ... Pixel tile (b, ty, tx) covers output rows TH ty .. TH ty + TH - 1 and columns 16 tx .. 16 tx + 15 of image b;
// fragment f of a tile is rows 2 (f / 2), 2 (f / 2) + 1 and columns 8 (f % 2) .. 8 (f % 2) + 7. The block's weight
// slice stays in shared memory; its steps (a pixel tile's 16 input channels) run as one sequence of halo copies,
// STAGES - 1 of them in flight ahead of the one computed, so the next tile's copies overlap this tile's last products
// and its epilogue. The epilogue puts the f32 accumulators in a tile of their own, from which each thread takes one
// channel pair of whole 2x2 windows.
template <int TN, int TH, int ACT>
__global__ void __launch_bounds__(THREADS, 2)
conv_pool_halo_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ pooled,
                      __nv_bfloat16* __restrict__ y, int B, int H, int W, int Cin, int Cout) {
  using S = HaloShape<TN, TH>;
  extern __shared__ __align__(16) unsigned char halo_smem[];
  const uint32_t wts = smem_u32(halo_smem);
  const int steps = Cin / KS;
  const uint32_t halos = wts + 9 * TN * Cin * 2;
  float* as = reinterpret_cast<float*>(halo_smem + 9 * TN * Cin * 2 + STAGES * S::HALO_BYTES);  // [PX][LDA]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % S::WARPS_M;
  const int wn = warp / S::WARPS_M;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool keep = y != nullptr;

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int n_tiles = B * tiles_x * tiles_y;
  const int n0 = blockIdx.y * TN;
  const int total = ((n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * steps;

  // the weight slice, once: row (c * 9 + tap) * TN + n holds channels 16c .. 16c + 15 of output channel n0 + n at the
  // tap (zero past Cout)
  for (int u = tid; u < steps * 9 * TN * 2; u += THREADS) {
    const int row = u >> 1, half = u & 1;
    const int n = n0 + row % TN, tap = (row / TN) % 9, c = row / (9 * TN);
    const bool ok = n < Cout;
    cp_async16(wts + weight_at(row, half), ok ? w + (((long long)n * 9 + tap) * Cin + c * KS + half * 8) : w,
               ok ? 16 : 0);
  }
  // this thread's halo copies, the same for every step: the halo pixel (hy, hx), its offset in x from the tile's
  // corner pixel and its place in the stage
  int hy[S::COPIES_PER_THREAD], hx[S::COPIES_PER_THREAD], hsrc[S::COPIES_PER_THREAD];
  uint32_t hdst[S::COPIES_PER_THREAD];
#pragma unroll
  for (int k = 0; k < S::COPIES_PER_THREAD; ++k) {
    const int u = tid + k * THREADS;
    const int p = u >> 1, half = u & 1;
    hy[k] = u < S::HALO_COPIES ? p / S::HALO_W : -(1 << 20);  // a copy past the halo is never in the image
    hx[k] = p % S::HALO_W;
    hsrc[k] = u < S::HALO_COPIES ? (hy[k] * W + hx[k]) * Cin + half * 8 : 0;
    hdst[k] = p * (LDK * 2) + half * 16;
  }
  // the copies of the block's step `it` into its stage: the halo tile's 16-channel slice, zero outside the image
  auto load_step = [&](int it) {
    if (it >= total) return;
    const int tile = (int)blockIdx.x + (it / steps) * (int)gridDim.x;
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const int y0 = ty * TH - 1, x0 = tx * TW - 1;  // the halo's corner pixel
    const __nv_bfloat16* corner = x + ((((long long)b * H + y0) * W + x0) * Cin + (it % steps) * KS);
    const uint32_t stage = halos + (it % STAGES) * S::HALO_BYTES;
#pragma unroll
    for (int k = 0; k < S::COPIES_PER_THREAD; ++k) {
      if (S::HALO_COPIES % THREADS != 0 && hy[k] < 0) continue;
      const bool ok = (unsigned)(y0 + hy[k]) < (unsigned)H && (unsigned)(x0 + hx[k]) < (unsigned)W;
      cp_async16(stage + hdst[k], ok ? corner + hsrc[k] : x, ok ? 16 : 0);
    }
  };

  // ldmatrix addresses of this lane, tap (0, 0), stage 0, chunk 0: matrix q = lane / 8 of an x4 load, row lane % 8.
  // A (a fragment): matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15).
  // B (two n8 fragments): (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
  const int q = lane >> 3, r = lane & 7;
  uint32_t a_addr[S::MT], b_addr[2];
#pragma unroll
  for (int j = 0; j < S::MT; ++j) {
    const int f = wm * S::MT + j;
    const int prow = 2 * (f >> 1) + (q & 1), pcol = 8 * (f & 1) + r;
    a_addr[j] = halos + (prow * S::HALO_W + pcol) * (LDK * 2) + (q >> 1) * 16;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) b_addr[p] = wts + weight_at(wn * 32 + p * 16 + (q >> 1) * 8 + r, q & 1);

  // the epilogue's share of a thread: channels n0 + 2 cp, + 1 of pooled pixels p0, p0 + PSTEP, ... of a tile
  constexpr int PAIRS = TN / 2, PSTEP = THREADS / PAIRS;
  const int cp = tid % PAIRS, p0 = tid / PAIRS;
  const int n = n0 + 2 * cp;
  const float b0 = n < Cout ? __bfloat162float(bias[n]) : 0.0f;
  const float b1 = n < Cout ? __bfloat162float(bias[n + 1]) : 0.0f;

  float acc[S::MT][4][4];
#pragma unroll
  for (int j = 0; j < S::MT; ++j)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_step(s);
    cp_async_commit();  // the weight slice lands with the first group
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();  // this step's copies have landed (a group is committed every step, empty or not)
    __syncthreads();              // ... for every thread, and the stage loaded next was read by all of them
    load_step(it + STAGES - 1);
    cp_async_commit();
    const int step = it % steps;
    const uint32_t a_stage = (it % STAGES) * S::HALO_BYTES;
    const uint32_t b_chunk = step * 9 * TN * 32;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t a_off = a_stage + ((tap / 3) * S::HALO_W + tap % 3) * (LDK * 2);
      const uint32_t b_off = b_chunk + tap * TN * 32;
      uint32_t bfrag[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) ldmatrix_x4(bfrag[p], b_addr[p] + b_off);
#pragma unroll
      for (int j = 0; j < S::MT; ++j) {
        uint32_t afrag[4];
        ldmatrix_x4(afrag, a_addr[j] + a_off);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_m16n8k16(acc[j][nt], afrag, bfrag[nt >> 1][(nt & 1) * 2], bfrag[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    if (step != steps - 1) continue;

    // the tile's epilogue (the previous tile's reads of `as` ended before the __syncthreads at the top of this step)
#pragma unroll
    for (int j = 0; j < S::MT; ++j) {
      const int f = wm * S::MT + j;
      const int px = (2 * (f >> 1)) * TW + 8 * (f & 1) + g;  // this thread's fragment rows: pixel px and px + TW
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = wn * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(as + px * S::LDA + ch) = make_float2(acc[j][nt][0], acc[j][nt][1]);
        *reinterpret_cast<float2*>(as + (px + TW) * S::LDA + ch) = make_float2(acc[j][nt][2], acc[j][nt][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.0f;
      }
    }
    __syncthreads();
    const int tile = (int)blockIdx.x + (it / steps) * (int)gridDim.x;
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const int Hp = H / 2, Wp = W / 2;
#pragma unroll 1
    for (int pp = p0; pp < S::PX / 4; pp += PSTEP) {
      const int pr = pp / (TW / 2), pc = pp % (TW / 2);            // in the tile
      const int Y = ty * (TH / 2) + pr, X = tx * (TW / 2) + pc;    // in the image
      if (Y >= Hp || X >= Wp || n >= Cout) continue;
      float2 qv[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          qv[rr][c] = *reinterpret_cast<const float2*>(as + ((2 * pr + rr) * TW + 2 * pc + c) * S::LDA + 2 * cp);
      __nv_bfloat16* y0 = keep ? y + ((((long long)b * H + 2 * Y) * W + 2 * X) * Cout + n) : nullptr;
      pool_window<ACT>(qv, b0, b1, pooled + ((((long long)b * Hp + Y) * Wp + X) * Cout + n), y0,
                       keep ? y0 + (long long)W * Cout : nullptr, Cout);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

constexpr int MAX_CARDS = 64;  // the cards of one process whose launches are cached

// The blocks of `kernel` that the current card holds at once with `smem` bytes of dynamic shared memory, or 0 on an
// error. The first call on a card sets the kernel's dynamic shared memory limit to `smem_max` there (where it is not
// 0), since the attribute holds in that card's context alone, and caches the count in cache[card].
template <typename K>
int resident_blocks(K kernel, int smem, int smem_max, int (&cache)[MAX_CARDS]) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS) return 0;
  if (cache[dev] > 0) return cache[dev];
  if ((smem_max > 0 &&
       cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max) != cudaSuccess) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) != cudaSuccess)
    return 0;
  return cache[dev] = sms * per_sm;
}

template <int TN, int TH, int ACT>
cudaError_t launch_halo(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                        __nv_bfloat16* pooled, __nv_bfloat16* y, int B, int H, int W, int Cin, int Cout,
                        cudaStream_t st) {
  using S = HaloShape<TN, TH>;
  const int smem = S::smem_bytes(Cin);
  auto kernel = conv_pool_halo_kernel<TN, TH, ACT>;
  static int resident_by_steps[MAX_CIN / KS + 1][MAX_CARDS];  // the blocks a card holds, by Cin / 16; 0 until asked
  const int resident = resident_blocks(kernel, smem, S::smem_bytes(MAX_CIN), resident_by_steps[Cin / KS]);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles * (Cin / KS) > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_tiles = (Cout + TN - 1) / TN;
  long long gx = resident / n_tiles;  // the card full once; every block of a column keeps its channel tile
  gx = gx < 1 ? 1 : (gx > tiles ? tiles : gx);
  kernel<<<dim3((unsigned)gx, n_tiles), THREADS, smem, st>>>(x, w, bias, pooled, y, B, H, W, Cin, Cout);
  return cudaGetLastError();
}

template <int NT, int ACT>
cudaError_t launch_stem(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                        __nv_bfloat16* pooled, __nv_bfloat16* y, int B, int H, int W, cudaStream_t st) {
  auto kernel = conv_pool_stem_kernel<NT, ACT>;
  static int resident_by_card[MAX_CARDS];  // they walk the tiles between them
  const int resident = resident_blocks(kernel, 0, 0, resident_by_card);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * ((H + STEM_ROWS - 1) / STEM_ROWS) * ((W + STEM_PX - 1) / STEM_PX);
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<(unsigned)blocks, THREADS, 0, st>>>(x, w, bias, pooled, y, B, H, W);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias, __nv_bfloat16* pooled,
                   __nv_bfloat16* y, int B, int H, int W, int Cin, int Cout, cudaStream_t st, int* route) {
  if (Cin == 3) {
    *route = 0;
    return Cout == 16 ? launch_stem<2, ACT>(x, w, bias, pooled, y, B, H, W, st)
                      : launch_stem<4, ACT>(x, w, bias, pooled, y, B, H, W, st);
  }
  *route = 1;
  // 64 channels a tile, or 32 in taller tiles where Cout is no wider
  return Cout > 32 ? launch_halo<64, 8, ACT>(x, w, bias, pooled, y, B, H, W, Cin, Cout, st)
                   : launch_halo<32, 16, ACT>(x, w, bias, pooled, y, B, H, W, Cin, Cout, st);
}

}  // namespace

// x (B, H, W, Cin), w (Cout, 3, 3, Cin), bias (Cout,), pooled (B, H/2, W/2, Cout) and y (B, H, W, Cout) or null: bf16,
// contiguous, on `stream`; x, w, pooled and y 16-byte aligned. H and W even; Cout a multiple of 8; Cin = 3 with
// Cout = 16 or 32 (route 0, the stem), or Cin a multiple of 16 up to MAX_CIN (route 1, halo tiles). act 0 identity,
// 1 SiLU, 2 leaky ReLU (0.1). Returns the cudaError of the launch and writes the route taken to *route.
extern "C" int conv_pool_launch(const void* x, const void* w, const void* bias, void* pooled, void* y, int B, int H,
                                int W, int Cin, int Cout, int act, void* stream, int* route) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || Cout <= 0 || Cout % 8) return (int)cudaErrorInvalidValue;
  if (!(Cin == 3 && (Cout == 16 || Cout == 32)) && !(Cin > 0 && Cin % 16 == 0 && Cin <= MAX_CIN))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(pooled) |
       reinterpret_cast<uintptr_t>(y)) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 2)
    return (int)cudaErrorMisalignedAddress;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(bias);
  __nv_bfloat16* pb = static_cast<__nv_bfloat16*>(pooled);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case IDENTITY: return (int)launch<IDENTITY>(xb, wb, bb, pb, yb, B, H, W, Cin, Cout, st, route);
    case SILU: return (int)launch<SILU>(xb, wb, bb, pb, yb, B, H, W, Cin, Cout, st, route);
    case LEAKY_RELU: return (int)launch<LEAKY_RELU>(xb, wb, bb, pb, yb, B, H, W, Cin, Cout, st, route);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Stride-1 SAME 3x3 convolution fused with BatchNorm's batch statistics.
//
// Replaces the TPU kernel `_conv3x3_stats_kernel` / `conv3x3_bn_stats` of
// yolov3_tpu/ops/conv_bn_pallas.py: y = conv3x3(x, w) in NHWC with f32
// accumulation, plus the per-channel sum and sum of squares of the f32
// accumulators (before y is rounded to its storage type), from which
// mean = sum / n and the biased var = sumsq / n - mean^2, n = B*H*W.
//
// The Pallas kernel holds the whole (9, Cin, Cout) weight in VMEM and walks a
// sequential grid that accumulates into one (2, Cout) block. Here the conv is
// an implicit GEMM over M = B*H*W output pixels (a flat index over (b, h, w),
// so any H and W are taken), K = 9 * Cin, N = Cout, and blocks run
// concurrently: each block writes its own per-channel partial sums and a
// second kernel adds them in a fixed order (in double). No float atomics: two
// runs on the same inputs give the same bits. The weight is read as
// (Cout, 3, 3, Cin), the bytes of PyTorch's OIHW conv weight in channels_last,
// which is the GEMM's B with K contiguous.
//
// Bound: operations at the model's wide layers (2*9*M*Cin*Cout flop against
// x + w + y bytes is far above the card's 295 flop/byte), y's bytes at the
// stem and at 320x320 32->64. Four kernels, chosen by the launch function from
// what it can observe (conv3x3_bn_stats_launch reports which):
//
//  - bf16, Cin % 16 == 0, x and w 16-byte aligned (every 3x3 conv of the
//    models but the stems): `conv3x3_stats_wgmma_kernel`, written for Hopper.
//    One persistent block an SM: a producer thread and two consumer
//    warpgroups. The producer keeps a ring of 5 to 8 shared-memory stages
//    full with two TMA copies a stage: the 128 pixels x BK channels of one
//    tap through an im2col-mode tensor map over x (the hardware walks the
//    flat pixel index, adds the tap's offset and zero-fills the halo and the
//    tail past the last pixel), and the TN channels x BK slice of the weight
//    through a tiled map over (Cout, 9*Cin) (rows past Cout zero-filled).
//    Both land in the 128-, 64- or 32-byte swizzled layout (BK = 64, 32, 16)
//    that wgmma reads. Stages are handed over with mbarriers ("full" by the
//    copies' byte count, "empty" by the consumers), so no block-wide barrier
//    and no address arithmetic sits in the loop. Each consumer warpgroup owns
//    64 pixels x TN (128 or 64) channels and issues wgmma.mma_async
//    m64nTNk16 bf16 -> f32 with both operands from shared memory, one group
//    in flight while the next stage is waited for; setmaxnreg moves the
//    producer's registers to the consumers. A block keeps one channel tile
//    and walks pixel tiles, so a thread's column sums and sums of squares
//    stay in registers, taken from the accumulators before the rounding, and
//    are reduced once (shuffles over a warp's rows, then the 8 warps in
//    order). y goes through a staging buffer of its own to 16-byte stores,
//    while the producer already fills the ring for the next tile.
//    Left out: a halo tile of x in shared memory read by all nine taps; the
//    nine re-reads come from L2.
//  - bf16, Cin = 3 and Cout = 32 or 16 (the stems): `conv3x3_stats_stem_kernel`.
//    Bound by y's bytes. K = 27 padded to 32 is two mma.sync m16n8k16 steps:
//    in NHWC the 3 pixels x 3 channels of one input row under a tap row are 9
//    contiguous values, so A[p][9r + i] = row r of the tile at 3p + i. A block
//    loads three input rows of 130 pixels into shared memory (masked at the
//    borders), keeps the weight fragments in registers, and stores y 16 bytes
//    a thread through a per-warp staging tile.
//  - bf16, any other shape: `conv3x3_stats_bf16_kernel`, 128 x 64 tiles of
//    nvcuda::wmma products with element-wise loads staged through registers.
//  - f32: 64 x 64 tiles with plain FMAs, no tensor cores: TF32 would not hold
//    the f32 tolerance of the plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int MAX_GRID_X = 1024;  // rows of the partial-sum buffer at most

// ---------------------------------------------------------------- bf16 ----

constexpr int BM = 128;      // output pixels per tile
constexpr int BN = 64;       // output channels per tile
constexpr int LDC = BN + 4;  // f32 staging stride

// The element-load bf16 kernel's epilogue. Cs is the block's BM x TN tile of f32
// accumulators in shared memory, row stride TN + 4. y is stored from it (16
// bytes a thread if VEC_N: Cout % 8 == 0 and y 16-byte aligned), and this
// thread's column sums grow by its group of rows. Rows past M and columns
// past Cout hold 0, because their inputs were zero-filled.
template <int TN, bool VEC_N>
__device__ __forceinline__ void store_y_and_sum(const float* Cs, __nv_bfloat16* __restrict__ y, int m0, int n0,
                                                int M, int Cout, float& s_acc, float& q_acc) {
  constexpr int LDT = TN + 4;
  const int tid = threadIdx.x;
  if constexpr (VEC_N) {
#pragma unroll
    for (int j = 0; j < BM * TN / 8 / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int r = idx / (TN / 8);
      const int col = (idx % (TN / 8)) * 8;
      const int m = m0 + r;
      if (m < M && n0 + col < Cout) {
        const float4 lo = *reinterpret_cast<const float4*>(Cs + r * LDT + col);
        const float4 hi = *reinterpret_cast<const float4*>(Cs + r * LDT + col + 4);
        __nv_bfloat162 p0 = __floats2bfloat162_rn(lo.x, lo.y);
        __nv_bfloat162 p1 = __floats2bfloat162_rn(lo.z, lo.w);
        __nv_bfloat162 p2 = __floats2bfloat162_rn(hi.x, hi.y);
        __nv_bfloat162 p3 = __floats2bfloat162_rn(hi.z, hi.w);
        uint4 out;
        out.x = *reinterpret_cast<uint32_t*>(&p0);
        out.y = *reinterpret_cast<uint32_t*>(&p1);
        out.z = *reinterpret_cast<uint32_t*>(&p2);
        out.w = *reinterpret_cast<uint32_t*>(&p3);
        *reinterpret_cast<uint4*>(y + (size_t)m * Cout + n0 + col) = out;
      }
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < BM * TN / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int r = idx / TN;
      const int col = idx % TN;
      const int m = m0 + r;
      if (m < M && n0 + col < Cout) y[(size_t)m * Cout + n0 + col] = __float2bfloat16(Cs[r * LDT + col]);
    }
  }
  // statistics from the f32 accumulators, before the rounding above
  constexpr int ROWS_PER_GROUP = BM / (THREADS / TN);
  const int col = tid % TN;
  const int r0 = (tid / TN) * ROWS_PER_GROUP;
#pragma unroll 8
  for (int r = r0; r < r0 + ROWS_PER_GROUP; ++r) {
    const float v = Cs[r * LDT + col];
    s_acc += v;
    q_acc += v * v;
  }
}

// The block's column sums: the THREADS / TN row groups of a column are added
// in order and written to this block's row of `partial` (rows, 2, Cout).
template <int TN>
__device__ __forceinline__ void write_partial_sums(float s_acc, float q_acc, float* __restrict__ partial, int n0,
                                                   int Cout) {
  __shared__ float red[2][THREADS / TN][TN];
  const int tid = threadIdx.x;
  red[0][tid / TN][tid % TN] = s_acc;
  red[1][tid / TN][tid % TN] = q_acc;
  __syncthreads();
  if (tid < TN && n0 + tid < Cout) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int g = 0; g < THREADS / TN; ++g) {
      s += red[0][g][tid];
      q += red[1][g][tid];
    }
    partial[((size_t)blockIdx.x * 2 + 0) * Cout + n0 + tid] = s;
    partial[((size_t)blockIdx.x * 2 + 1) * Cout + n0 + tid] = q;
  }
}

// Any Cin and Cout (what the wgmma and stem kernels do not take): element-wise
// loads, 16 input channels a step, register-staged double buffering. VEC_N: Cout % 8 == 0 and y 16-byte
// aligned (16-byte stores along Cout).
template <bool VEC_N>
__global__ void __launch_bounds__(THREADS)
conv3x3_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                          int M, int H, int W, int Cin, int Cout) {
  constexpr int BK = 16;
  constexpr int LDA = BK + 8;  // bf16 elements; +8 keeps rows 16-byte aligned and spreads the banks
  constexpr int LDB = LDA;
  constexpr int A_BYTES = BM * LDA * 2;
  constexpr int B_BYTES = BN * LDB * 2;
  constexpr int PIPE_BYTES = 2 * (A_BYTES + B_BYTES);
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  constexpr int ROWS_STEP = THREADS / BK;  // tile rows covered per pass, one element a thread
  constexpr int A_PER = BM / ROWS_STEP;    // passes = elements per thread
  constexpr int B_PER = BN / ROWS_STEP;    // the weight tile is [BN][BK], loaded like A

  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);                 // [2][BM][LDA]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * A_BYTES);   // [2][BN][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                                 // [BM][LDC]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;   // 4 warps along pixels, 32 rows each
  const int warp_n = warp >> 2;  // 2 warps along channels, 32 columns each
  const int n0 = blockIdx.y * BN;
  const int a_unit = tid % BK;
  const int a_row0 = tid / BK;
  const int kc = (Cin + BK - 1) / BK;
  const int n_iter = 9 * kc;
  const int tiles_m = (M + BM - 1) / BM;
  const int HW = H * W;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float s_acc = 0.0f, q_acc = 0.0f;  // this thread's column sums over all the block's pixel tiles

  for (int tile = blockIdx.x; tile < tiles_m; tile += gridDim.x) {
    const int m0 = tile * BM;

    // the pixels this thread loads: (h, w) for the halo test, flat offset into x
    int ph[A_PER], pw[A_PER];
    long long poff[A_PER];
    bool pok[A_PER];
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int m = m0 + a_row0 + j * ROWS_STEP;
      pok[j] = m < M;
      const int hw = m % HW;
      ph[j] = hw / W;
      pw[j] = hw % W;
      poff[j] = (long long)m * Cin;
    }

    __nv_bfloat16 a_el[A_PER], b_el[B_PER];

    auto load_tile = [&](int it) {
      const int tap = it / kc;
      const int c = (it - tap * kc) * BK + a_unit;
      const int di = tap / 3 - 1;
      const int dj = tap % 3 - 1;
      const long long shift = (long long)(di * W + dj) * Cin + c;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) {
        const bool ok = c < Cin && pok[j] && (unsigned)(ph[j] + di) < (unsigned)H &&
                        (unsigned)(pw[j] + dj) < (unsigned)W;
        a_el[j] = ok ? x[poff[j] + shift] : zero;
      }
#pragma unroll
      for (int j = 0; j < B_PER; ++j) {
        const int n = n0 + a_row0 + j * ROWS_STEP;
        b_el[j] = (n < Cout && c < Cin) ? w[((size_t)n * 9 + tap) * Cin + c] : zero;
      }
    };

    auto store_tile = [&](int buf) {
      __nv_bfloat16* a = As + buf * (BM * LDA) + a_row0 * LDA + a_unit;
      __nv_bfloat16* b = Bs + buf * (BN * LDB) + a_row0 * LDB + a_unit;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) a[j * ROWS_STEP * LDA] = a_el[j];
#pragma unroll
      for (int j = 0; j < B_PER; ++j) b[j * ROWS_STEP * LDB] = b_el[j];
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    load_tile(0);
    store_tile(0);
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      const int cur = it & 1;
      const bool more = it + 1 < n_iter;
      if (more) load_tile(it + 1);  // global loads in flight during the products
      const __nv_bfloat16* a = As + cur * (BM * LDA) + warp_m * 32 * LDA;
      const __nv_bfloat16* b = Bs + cur * (BN * LDB) + warp_n * 32 * LDB;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], a + i * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], b + j * 16 * LDB + kk, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      if (more) store_tile(cur ^ 1);  // the buffer read in step it - 1
      __syncthreads();
    }

    // epilogue: accumulators -> shared (the pipeline buffers are free now)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (warp_m * 32 + i * 16) * LDC + warp_n * 32 + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();

    store_y_and_sum<BN, VEC_N>(Cs, y, m0, n0, M, Cout, s_acc, q_acc);
    __syncthreads();  // Cs is overwritten by the next tile's loads
  }
  write_partial_sums<BN>(s_acc, q_acc, partial, n0, Cout);
}

// ------------------------------------------------ bf16, the stems (Cin = 3) ----

constexpr int STEM_PX = 128;                 // output pixels of one row per tile
constexpr int STEM_LD = (STEM_PX + 2) * 3 + 2;  // bf16 elements of one staged input row

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

// Cin = 3, Cout = 8 * NT, y 16-byte aligned. A tile is STEM_PX pixels of one
// output row, 16 a warp; the GEMM's k index is 9 * (tap row) + 3 * (tap
// column) + channel, which is the weight's own order within an output channel.
template <int NT>
__global__ void __launch_bounds__(THREADS)
conv3x3_stats_stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, float* __restrict__ partial, int B, int H, int W) {
  constexpr int COUT = NT * 8;
  constexpr int LDY = COUT + 8;  // staging stride: rows stay 16-byte aligned, banks spread
  __shared__ __align__(16) __nv_bfloat16 xs[3][STEM_LD];
  __shared__ __align__(16) __nv_bfloat16 ys[THREADS / 32][16][LDY];
  __shared__ float red[THREADS / 32][2][COUT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row (and the weight fragment's channel)
  const int t = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // this thread's eight k indices, two steps of {2t, 2t+1, 2t+8, 2t+9}: where they
  // sit in the staged rows, and its weight fragments, both fixed for the kernel
  int koff[8];
  uint32_t bfrag[NT][4];
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
  }

  float ssum[NT][2], ssq[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssum[nt][0] = ssum[nt][1] = ssq[nt][0] = ssq[nt][1] = 0.0f;

  const int tiles_w = (W + STEM_PX - 1) / STEM_PX;
  const int n_tiles = B * H * tiles_w;
  const __nv_bfloat16* xs_flat = &xs[0][0];
  // the three input rows of a tile, pixels w0 - 1 .. w0 + STEM_PX, zero outside the image: fetched
  // into registers one tile ahead, so the loads are in flight during the products of the tile before
  constexpr int PER = ((STEM_PX + 2) * 3 + THREADS - 1) / THREADS;
  __nv_bfloat16 ahead[3][PER];
  auto fetch = [&](int tile) {
    const int w0 = (tile % tiles_w) * STEM_PX;
    const int bh = tile / tiles_w;
    const int h = bh % H;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const bool row_ok = (unsigned)(h + r - 1) < (unsigned)H;
      const __nv_bfloat16* src = x + ((long long)(bh + r - 1) * W + (w0 - 1)) * 3;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = tid + k * THREADS;
        const int px = w0 - 1 + e / 3;
        ahead[r][k] = (e < (STEM_PX + 2) * 3 && row_ok && (unsigned)px < (unsigned)W) ? src[e] : zero;
      }
    }
  };
  if ((int)blockIdx.x < n_tiles) fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int w0 = (tile % tiles_w) * STEM_PX;
    const int bh = tile / tiles_w;  // b * H + h
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (tid + k * THREADS < (STEM_PX + 2) * 3) xs[r][tid + k * THREADS] = ahead[r][k];
    __syncthreads();
    if (tile + (int)gridDim.x < n_tiles) fetch(tile + gridDim.x);

    const int p0 = warp * 16 + g;  // this thread's pixels within the tile: p0 and p0 + 8
    uint32_t afrag[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)    // k and k + 8
#pragma unroll
        for (int row = 0; row < 2; ++row) {   // p0 and p0 + 8
          const int q = ks * 4 + half * 2;
          const int p3 = (p0 + row * 8) * 3;
          const __nv_bfloat16 lo = koff[q] >= 0 ? xs_flat[koff[q] + p3] : zero;
          const __nv_bfloat16 hi = koff[q + 1] >= 0 ? xs_flat[koff[q + 1] + p3] : zero;
          afrag[ks][half * 2 + row] = pack_bf16(lo, hi);
        }
    const bool ok0 = w0 + p0 < W, ok1 = w0 + p0 + 8 < W;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_m16n8k16(c, afrag[0], bfrag[nt][0], bfrag[nt][1]);
      mma_m16n8k16(c, afrag[1], bfrag[nt][2], bfrag[nt][3]);
      // statistics from the f32 accumulators; a pixel past the row's end is left out
      if (ok0) {
        ssum[nt][0] += c[0];
        ssum[nt][1] += c[1];
        ssq[nt][0] += c[0] * c[0];
        ssq[nt][1] += c[1] * c[1];
      }
      if (ok1) {
        ssum[nt][0] += c[2];
        ssum[nt][1] += c[3];
        ssq[nt][0] += c[2] * c[2];
        ssq[nt][1] += c[3] * c[3];
      }
      *reinterpret_cast<__nv_bfloat162*>(&ys[warp][g][nt * 8 + 2 * t]) = __floats2bfloat162_rn(c[0], c[1]);
      *reinterpret_cast<__nv_bfloat162*>(&ys[warp][g + 8][nt * 8 + 2 * t]) = __floats2bfloat162_rn(c[2], c[3]);
    }
    __syncwarp();
    __nv_bfloat16* y_row = y + ((long long)bh * W + w0 + warp * 16) * COUT;
#pragma unroll
    for (int i = 0; i < 16 * NT / 32; ++i) {  // 16 pixels x NT chunks of 16 bytes
      const int idx = lane + 32 * i;
      const int row = idx / NT;
      const int ch = idx % NT;
      if (w0 + warp * 16 + row < W)
        *reinterpret_cast<uint4*>(y_row + row * COUT + ch * 8) = *reinterpret_cast<const uint4*>(&ys[warp][row][ch * 8]);
    }
    __syncthreads();  // xs and ys are overwritten by the next tile
  }

  // column sums: over the warp's rows by shuffles, then the warps in order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ssum[nt][j] += __shfl_xor_sync(0xffffffffu, ssum[nt][j], off);
        ssq[nt][j] += __shfl_xor_sync(0xffffffffu, ssq[nt][j], off);
      }
      if (g == 0) {
        red[warp][0][nt * 8 + 2 * t + j] = ssum[nt][j];
        red[warp][1][nt * 8 + 2 * t + j] = ssq[nt][j];
      }
    }
  __syncthreads();
  if (tid < COUT) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int wp = 0; wp < THREADS / 32; ++wp) {
      s += red[wp][0][tid];
      q += red[wp][1][tid];
    }
    partial[((size_t)blockIdx.x * 2 + 0) * COUT + tid] = s;
    partial[((size_t)blockIdx.x * 2 + 1) * COUT + tid] = q;
  }
}

// ------------------------------------ bf16, Cin a multiple of 16: Hopper ----

constexpr int WG_THREADS = 128;                 // a warpgroup
constexpr int GM_THREADS = 3 * WG_THREADS;      // producer warpgroup + two consumer warpgroups
constexpr int GM_BM = 128;                      // output pixels per tile, 64 a consumer warpgroup
constexpr int RING_BYTES = 160 * 1024;          // the stages' share of shared memory at most
constexpr long long SPIN_CLOCKS = 4000000000LL; // a barrier that has not flipped after ~2 s is a fault

template <int BK, int TN>
struct GemmShape {
  static constexpr int A_BYTES = GM_BM * BK * 2;
  static constexpr int B_BYTES = TN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a multiple of 1024: every tile starts on a swizzle atom
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  static constexpr int LDY = TN + 8;                     // bf16 staging stride: 16-byte aligned rows, banks spread
  static constexpr int STAGING_BYTES = 2 * 64 * LDY * 2; // one 64-row tile per consumer warpgroup
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + STAGING_BYTES + 2 * STAGES * 8;
  // the swizzle of a row of BK bf16: 128, 64 or 32 bytes; 8 such rows are one atom
  static constexpr int SWIZZLE_BYTES = BK * 2;
  static constexpr uint64_t DESC_LAYOUT = BK == 64 ? 1 : (BK == 32 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the barrier's phase of this parity has completed. A wait that
// outlasts SPIN_CLOCKS traps: a lost copy becomes a launch error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 0 && clock64() - t0 > SPIN_CLOCKS) __trap();
  }
}

// The 128 pixels from flat pixel (n, h, w) on, BK channels from c on, of the
// tap (off_h, off_w): base coordinates are the tap window's corner, pixel - 1.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int w,
                                                int h, int n, int off_w, int off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"((unsigned short)off_w), "h"((unsigned short)off_h)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The accumulators are written by the tensor cores behind the compiler's back:
// this pins every read of them after the wait and every write before the issue.
template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are one swizzle
// span wide: start address, 8-row atom stride (SBO), swizzle mode.
template <int BK, int TN>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  using S = GemmShape<BK, TN>;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)((8 * S::SWIZZLE_BYTES) >> 4) << 32) |
         (S::DESC_LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int TN>
__device__ __forceinline__ void wgmma_tile(float (&d)[TN / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (TN == 128) wgmma_m64n128k16(d, desc_a, desc_b, scale_d);
  else wgmma_m64n64k16(d, desc_a, desc_b, scale_d);
}

// grid (gx, channel tiles): block (bx, by) keeps channel tile by and walks the
// pixel tiles bx, bx + gx, ... VEC_N (a launch argument): Cout % 8 == 0 and y
// 16-byte aligned. partial: (gx, 2, Cout).
template <int BK, int TN>
__global__ void __launch_bounds__(GM_THREADS, 1)
conv3x3_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                           __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                           int M, int H, int W, int Cin, int Cout, int vec_n) {
  using S = GemmShape<BK, TN>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char gm_smem[];
  const uint32_t ring = (smem_u32(gm_smem) + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  unsigned char* ring_ptr = gm_smem + (ring - smem_u32(gm_smem));
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(ring_ptr + STAGES * S::STAGE_BYTES);
  const uint32_t full_bar = ring + STAGES * S::STAGE_BYTES + S::STAGING_BYTES;
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * TN;
  const int m_tiles = (M + GM_BM - 1) / GM_BM;
  const int kc = Cin / BK;
  const int n_iter = 9 * kc;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + s * 8, 1);                       // the producer's arrive, plus the copies' bytes
      mbar_init(empty_bar + s * 8, 2 * WG_THREADS / 32);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG_THREADS) {
    // ---- producer warpgroup: one thread issues the copies, the rest only give up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      const int HW = H * W;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < m_tiles; tile += gridDim.x) {
        const int m0 = tile * GM_BM;
        const int img = m0 / HW;
        const int h0 = (m0 % HW) / W;
        const int w0 = m0 % W;
        for (int it = 0; it < n_iter; ++it) {
          const int tap = it / kc;
          const int c0 = (it - tap * kc) * BK;
          mbar_wait(empty_bar + stage * 8, phase ^ 1u);  // passes at once the first time round the ring
          mbar_expect_tx(full_bar + stage * 8, S::STAGE_BYTES);
          const uint32_t a_dst = ring + stage * S::STAGE_BYTES;
          tma_load_im2col(a_dst, &map_x, full_bar + stage * 8, c0, w0 - 1, h0 - 1, img, tap % 3, tap / 3);
          tma_load_2d(a_dst + S::A_BYTES, &map_w, full_bar + stage * 8, tap * Cin + c0, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = tid - WG_THREADS;  // 0..255 over both warpgroups
    const int wg = ctid / WG_THREADS;
    const int wtid = ctid % WG_THREADS;
    const int lane = tid & 31;
    const int cwarp = ctid >> 5;                           // 0..7
    const int r0 = (wtid >> 5) * 16 + (lane >> 2);         // this thread's accumulator rows: r0 and r0 + 8
    const int cq = (lane & 3) * 2;                         // and columns 8j + cq, 8j + cq + 1
    __nv_bfloat16* stage_y = staging + wg * 64 * S::LDY;

    float acc[TN / 2];  // 64 rows x TN columns over the warpgroup
    float ssum[TN / 4], ssq[TN / 4];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < TN / 4; ++i) ssum[i] = ssq[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < m_tiles; tile += gridDim.x) {
      const int m0 = tile * GM_BM;
      int prev = 0;
      fence_accumulators(acc);
      for (int it = 0; it < n_iter; ++it) {
        mbar_wait(full_bar + stage * 8, phase);
        wgmma_fence();
        const uint32_t a_src = ring + stage * S::STAGE_BYTES + wg * 64 * BK * 2;
        const uint32_t b_src = ring + stage * S::STAGE_BYTES + S::A_BYTES;
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)  // 16 channels are 32 bytes along a swizzled row
          wgmma_tile<TN>(acc, smem_desc<BK, TN>(a_src + k * 32), smem_desc<BK, TN>(b_src + k * 32),
                         (it > 0 || k > 0) ? 1 : 0);
        wgmma_commit();
        if (it > 0) {  // the products of the stage before are done: hand it back
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_bar + prev * 8);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty_bar + prev * 8);
      fence_accumulators(acc);

      // epilogue: statistics from the f32 accumulators, y through this warpgroup's staging tile.
      // Rows past M and columns past Cout are 0: their inputs were zero-filled.
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
        ssum[2 * j] += v0 + v2;
        ssum[2 * j + 1] += v1 + v3;
        ssq[2 * j] += v0 * v0 + v2 * v2;
        ssq[2 * j + 1] += v1 * v1 + v3 * v3;
        *reinterpret_cast<__nv_bfloat162*>(stage_y + r0 * S::LDY + 8 * j + cq) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(stage_y + (r0 + 8) * S::LDY + 8 * j + cq) = __floats2bfloat162_rn(v2, v3);
      }
      bar_sync(1 + wg, WG_THREADS);
      const int mw = m0 + wg * 64;  // this warpgroup's first pixel
      if (vec_n) {
        constexpr int CH = TN / 8;  // 16-byte chunks per row
#pragma unroll
        for (int p = 0; p < 64 * CH / WG_THREADS; ++p) {
          const int idx = p * WG_THREADS + wtid;
          const int row = idx / CH;
          const int col = (idx % CH) * 8;
          if (mw + row < M && n0 + col < Cout)
            *reinterpret_cast<uint4*>(y + (size_t)(mw + row) * Cout + n0 + col) =
                *reinterpret_cast<const uint4*>(stage_y + row * S::LDY + col);
        }
      } else {
        for (int idx = wtid; idx < 64 * TN; idx += WG_THREADS) {
          const int row = idx / TN;
          const int col = idx % TN;
          if (mw + row < M && n0 + col < Cout) y[(size_t)(mw + row) * Cout + n0 + col] = stage_y[row * S::LDY + col];
        }
      }
      bar_sync(1 + wg, WG_THREADS);  // the staging tile is free for the next tile
    }

    // the block's column sums: a warp's 16 rows by shuffles, then the 8 warps in order
    float* red = reinterpret_cast<float*>(staging);  // [8][2][TN], after both warpgroups' last reads
#pragma unroll
    for (int i = 0; i < TN / 4; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ssum[i] += __shfl_xor_sync(0xffffffffu, ssum[i], off);
        ssq[i] += __shfl_xor_sync(0xffffffffu, ssq[i], off);
      }
    }
    bar_sync(3, 2 * WG_THREADS);
    if ((lane >> 2) == 0) {
#pragma unroll
      for (int i = 0; i < TN / 4; ++i) {
        const int col = 8 * (i / 2) + cq + (i & 1);
        red[(cwarp * 2 + 0) * TN + col] = ssum[i];
        red[(cwarp * 2 + 1) * TN + col] = ssq[i];
      }
    }
    bar_sync(3, 2 * WG_THREADS);
    if (ctid < TN && n0 + ctid < Cout) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int wp = 0; wp < 8; ++wp) {
        s += red[(wp * 2 + 0) * TN + ctid];
        q += red[(wp * 2 + 1) * TN + ctid];
      }
      partial[((size_t)blockIdx.x * 2 + 0) * Cout + n0 + ctid] = s;
      partial[((size_t)blockIdx.x * 2 + 1) * Cout + n0 + ctid] = q;
    }
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int FM = 64;  // output pixels per tile
constexpr int FN = 64;  // output channels per tile
constexpr int FK = 8;   // input channels per step
constexpr int LDF = FN + 4;

__global__ void __launch_bounds__(THREADS)
conv3x3_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ y, float* __restrict__ partial,
                         int M, int H, int W, int Cin, int Cout) {
  __shared__ float As[FK][FM];  // k-major: a thread's 4 pixels are neighbours
  __shared__ float Bs[FK][FN];
  __shared__ float Cs[FM * LDF];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // pixels ty*4 .. ty*4+3
  const int tx = tid % 16;  // channels tx*4 .. tx*4+3
  const int n0 = blockIdx.y * FN;
  const int kc = (Cin + FK - 1) / FK;
  const int n_iter = 9 * kc;
  const int tiles_m = (M + FM - 1) / FM;
  const int HW = H * W;

  const int s_col = tid % FN;
  const int s_rg = tid / FN;
  float s_acc = 0.0f, q_acc = 0.0f;

  for (int tile = blockIdx.x; tile < tiles_m; tile += gridDim.x) {
    const int m0 = tile * FM;
    // each thread loads 2 elements of A (pixel row, channel c) and 2 of B
    int ph[2], pw[2];
    long long poff[2];
    bool pok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + (tid + j * THREADS) / FK;
      pok[j] = m < M;
      const int hw = m % HW;
      ph[j] = hw / W;
      pw[j] = hw % W;
      poff[j] = (long long)m * Cin;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int it = 0; it < n_iter; ++it) {
      const int tap = it / kc;
      const int k0 = (it - tap * kc) * FK;
      const int di = tap / 3 - 1;
      const int dj = tap % 3 - 1;
      const long long shift = (long long)(di * W + dj) * Cin;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = tid + j * THREADS;
        const int r = idx / FK;
        const int c = k0 + idx % FK;
        const int hh = ph[j] + di;
        const int ww = pw[j] + dj;
        const bool ok = pok[j] && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W && c < Cin;
        As[idx % FK][r] = ok ? x[poff[j] + shift + c] : 0.0f;
        const int n = n0 + r;  // the weight tile's channel: FN == FM rows of FK, like A
        Bs[idx % FK][r] = (n < Cout && c < Cin) ? w[((size_t)n * 9 + tap) * Cin + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 4 + i) * LDF + tx * 4 + j] = acc[i][j];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FM * FN / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int r = idx / FN;
      const int n = n0 + idx % FN;
      const int m = m0 + r;
      if (m < M && n < Cout) y[(size_t)m * Cout + n] = Cs[r * LDF + idx % FN];
    }
    constexpr int ROWS_PER_GROUP = FM / (THREADS / FN);
#pragma unroll
    for (int r = s_rg * ROWS_PER_GROUP; r < (s_rg + 1) * ROWS_PER_GROUP; ++r) {
      const float v = Cs[r * LDF + s_col];
      s_acc += v;
      q_acc += v * v;
    }
    __syncthreads();
  }

  write_partial_sums<FN>(s_acc, q_acc, partial, n0, Cout);
}

// ------------------------------------------------------------ finalize ----

// partial: (rows, 2, Cout) block sums. One thread column per channel, 32 row
// lanes, each summing its rows in order, then the lanes in order: the same
// order every run. mean = S / n, var = Q / n - mean^2 (biased), in double.
__global__ void bn_stats_finalize_kernel(const float* __restrict__ partial, float* __restrict__ mean,
                                         float* __restrict__ var, int rows, int Cout, double n) {
  __shared__ double ss[32][33];
  __shared__ double qq[32][33];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  double s = 0.0, q = 0.0;
  if (c < Cout) {
    for (int r = ty; r < rows; r += 32) {
      s += (double)partial[((size_t)r * 2 + 0) * Cout + c];
      q += (double)partial[((size_t)r * 2 + 1) * Cout + c];
    }
  }
  ss[ty][tx] = s;
  qq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && c < Cout) {
    double S = 0.0, Q = 0.0;
    for (int i = 0; i < 32; ++i) {
      S += ss[i][tx];
      Q += qq[i][tx];
    }
    const double mu = S / n;
    mean[c] = (float)mu;
    var[c] = (float)(Q / n - mu * mu);
  }
}

inline int grid_rows(long long M, int tile_m) {
  const long long tiles = (M + tile_m - 1) / tile_m;
  return (int)(tiles < MAX_GRID_X ? tiles : MAX_GRID_X);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// ---- tensor maps: libcuda's encoders, reached through the runtime (no libcuda at link time)

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);
using EncodeIm2colFn = decltype(&cuTensorMapEncodeIm2col);
constexpr int TENSOR_MAP_ERROR = 20000;  // + the CUresult, so it cannot be taken for a cudaError_t

struct CudaApi {
  EncodeTiledFn tiled = nullptr;
  EncodeIm2colFn im2col = nullptr;
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

const CudaApi& cuda_api() {
  static const CudaApi api = [] {
    CudaApi out;
    void* fn = nullptr;
    out.err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    out.tiled = reinterpret_cast<EncodeTiledFn>(fn);
    if (out.err == cudaSuccess) {
      out.err = cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &fn, cudaEnableDefault);
      out.im2col = reinterpret_cast<EncodeIm2colFn>(fn);
    }
    int dev = 0;
    if (out.err == cudaSuccess) out.err = cudaGetDevice(&dev);
    if (out.err == cudaSuccess) out.err = cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, dev);
    if (out.err == cudaSuccess && (out.tiled == nullptr || out.im2col == nullptr)) out.err = cudaErrorNotSupported;
    return out;
  }();
  return api;
}

inline CUtensorMapSwizzle swizzle_of(int bk) {
  return bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : (bk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// x (B, H, W, Cin) as the im2col source of a SAME 3x3 window: a load of GM_BM
// pixels x bk channels from a base pixel on, at a tap offset, halo zero-filled.
int encode_x_map(CUtensorMap* map, const void* x, int B, int H, int W, int Cin, int bk) {
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2, (cuuint64_t)H * W * Cin * 2};
  const int lower[2] = {-1, -1};  // the window's corner runs from -1 ...
  const int upper[2] = {-1, -1};  // ... to (size - 1) + 1 - 2: one base pixel per output pixel
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = cuda_api().im2col(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                                       lower, upper, (cuuint32_t)bk, (cuuint32_t)GM_BM, elem,
                                       CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk),
                                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

// w (Cout, 9 * Cin) in boxes of tn rows x bk columns, rows past Cout zero-filled.
int encode_w_map(CUtensorMap* map, const void* w, int Cin, int Cout, int bk, int tn) {
  const cuuint64_t dims[2] = {(cuuint64_t)9 * Cin, (cuuint64_t)Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * Cin * 2};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)tn};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = cuda_api().tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                                      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk),
                                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

// A map holds the pointer and the shape, not the data, so the weight's map is
// kept: a parameter's pointer comes back every step. x's map is made per launch.
struct WeightMap {
  const void* w;
  int Cin, Cout, bk, tn;
  CUtensorMap map;
};

int weight_map(CUtensorMap* map, const void* w, int Cin, int Cout, int bk, int tn) {
  static std::mutex lock;
  static std::vector<WeightMap> kept;
  std::lock_guard<std::mutex> guard(lock);
  for (const WeightMap& m : kept)
    if (m.w == w && m.Cin == Cin && m.Cout == Cout && m.bk == bk && m.tn == tn) {
      *map = m.map;
      return 0;
    }
  const int err = encode_w_map(map, w, Cin, Cout, bk, tn);
  if (err) return err;
  if (kept.size() >= 512) kept.clear();
  kept.push_back(WeightMap{w, Cin, Cout, bk, tn, *map});
  return 0;
}

template <int BK, int TN>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, float* partial, int* rows,
                 int B, int H, int W, int Cin, int Cout, bool vec_n, cudaStream_t st) {
  using S = GemmShape<BK, TN>;
  const CudaApi& api = cuda_api();
  if (api.err != cudaSuccess) return (int)api.err;
  CUtensorMap map_x, map_w;
  int err = encode_x_map(&map_x, x, B, H, W, Cin, BK);
  if (err) return err;
  if ((err = weight_map(&map_w, w, Cin, Cout, BK, TN)) != 0) return err;
  auto kernel = conv3x3_stats_wgmma_kernel<BK, TN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int M = B * H * W;
  const int m_tiles = (M + GM_BM - 1) / GM_BM;
  const int n_tiles = (Cout + TN - 1) / TN;
  int gx = api.sms / n_tiles;  // one block an SM; every block of a row shares its channel tile
  gx = gx < 1 ? 1 : (gx > m_tiles ? m_tiles : gx);
  *rows = gx;
  kernel<<<dim3(gx, n_tiles), GM_THREADS, S::SMEM_BYTES, st>>>(map_x, map_w, y, partial, M, H, W, Cin, Cout,
                                                               vec_n ? 1 : 0);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_wgmma_bk(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, float* partial, int* rows,
                    int B, int H, int W, int Cin, int Cout, bool vec_n, cudaStream_t st, int* bk) {
  *bk = Cin % 64 == 0 ? 64 : (Cin % 32 == 0 ? 32 : 16);  // the widest swizzle that divides a tap's channels
  if (*bk == 64) return launch_wgmma<64, TN>(x, w, y, partial, rows, B, H, W, Cin, Cout, vec_n, st);
  if (*bk == 32) return launch_wgmma<32, TN>(x, w, y, partial, rows, B, H, W, Cin, Cout, vec_n, st);
  return launch_wgmma<16, TN>(x, w, y, partial, rows, B, H, W, Cin, Cout, vec_n, st);
}

}  // namespace

// Kernel ids that conv3x3_bn_stats_launch reports in *route (low byte), with the
// input channels a step in the second byte and the channel tile in the third
// where the kernel is the wgmma one.
enum Route { ROUTE_F32 = 0, ROUTE_BF16_ELEMENT = 1, ROUTE_BF16_STEM = 2, ROUTE_BF16_WGMMA = 3 };

// Rows of the (rows, 2, Cout) f32 partial-sum scratch that
// conv3x3_bn_stats_launch needs at most for this problem.
extern "C" int conv3x3_bn_stats_partial_rows(int B, int H, int W, int is_bf16) {
  return grid_rows((long long)B * H * W, is_bf16 ? BM : FM);
}

// x (B, H, W, Cin) and w (Cout, 3, 3, Cin) contiguous, bf16 (is_bf16 = 1) or
// f32; y (B, H, W, Cout) in the same type; partial the f32 scratch above;
// mean, var (Cout,) f32. All device pointers on `stream`. Returns the
// cudaError_t of the launches (0 on success; 20000 + a CUresult if a tensor
// map could not be encoded) and writes the kernel taken to *route.
extern "C" int conv3x3_bn_stats_launch(const void* x, const void* w, void* y, void* partial, void* mean,
                                       void* var, int B, int H, int W, int Cin, int Cout, int is_bf16,
                                       void* stream, int* route) {
  const long long M = (long long)B * H * W;
  if (M <= 0 || M > 0x7fffffffLL || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rows = grid_rows(M, is_bf16 ? BM : FM);
  const dim3 grid(rows, (Cout + BN - 1) / BN);  // BN == FN
  float* part = static_cast<float*>(partial);
  int err = 0;
  if (is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    const bool vec_n = Cout % 8 == 0 && aligned16(y);
    if (Cin % 16 == 0 && aligned16(x) && aligned16(w)) {
      int bk = 0;
      const int tn = Cout > 64 ? 128 : 64;
      err = tn == 128 ? launch_wgmma_bk<128>(xb, wb, yb, part, &rows, B, H, W, Cin, Cout, vec_n, st, &bk)
                      : launch_wgmma_bk<64>(xb, wb, yb, part, &rows, B, H, W, Cin, Cout, vec_n, st, &bk);
      *route = ROUTE_BF16_WGMMA | (bk << 8) | (tn << 16);
    } else if (Cin == 3 && (Cout == 32 || Cout == 16) && aligned16(y)) {
      const long long tiles = (long long)B * H * ((W + STEM_PX - 1) / STEM_PX);
      rows = (int)(tiles < rows ? tiles : rows);
      if (Cout == 32)
        conv3x3_stats_stem_kernel<4><<<rows, THREADS, 0, st>>>(xb, wb, yb, part, B, H, W);
      else
        conv3x3_stats_stem_kernel<2><<<rows, THREADS, 0, st>>>(xb, wb, yb, part, B, H, W);
      err = (int)cudaGetLastError();
      *route = ROUTE_BF16_STEM;
    } else {
      if (vec_n)
        conv3x3_stats_bf16_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, yb, part, (int)M, H, W, Cin, Cout);
      else
        conv3x3_stats_bf16_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, yb, part, (int)M, H, W, Cin, Cout);
      err = (int)cudaGetLastError();
      *route = ROUTE_BF16_ELEMENT;
    }
  } else {
    conv3x3_stats_f32_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                                       static_cast<float*>(y), part, (int)M, H, W, Cin, Cout);
    err = (int)cudaGetLastError();
    *route = ROUTE_F32;
  }
  if (err) return err;
  bn_stats_finalize_kernel<<<(Cout + 31) / 32, dim3(32, 32), 0, st>>>(
      part, static_cast<float*>(mean), static_cast<float*>(var), rows, Cout, (double)M);
  return (int)cudaGetLastError();
}

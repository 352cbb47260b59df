// Stride-1 SAME 3x3 convolution fused with BatchNorm's batch statistics.
//
// Replaces the TPU kernel `_conv3x3_stats_kernel` / `conv3x3_bn_stats` of
// yolov3_tpu/ops/conv_bn_pallas.py: y = conv3x3(x, w) in NHWC with f32
// accumulation, plus the per-channel sum and sum of squares of the f32
// accumulators (before y is rounded to its storage type), from which
// mean = sum / n and the biased var = sumsq / n - mean^2, n = B*H*W.
//
// What differs from the TPU kernel, and why:
//  - The Pallas kernel holds the whole (9, Cin, Cout) weight in VMEM and walks
//    a sequential grid that accumulates into one (2, Cout) block. Here the
//    conv is an implicit GEMM over M = B*H*W output pixels: a block owns a
//    tile of 128 pixels x 128 (or 64) channels, loops over the 9 taps and
//    over Cin in chunks, and the weight is tiled over Cout.
//  - The pixel index is flat over (b, h, w), so any H and W are taken; the
//    halo is masked in the tile load (zero fill) instead of a padded copy of
//    x, and the Cin / Cout tails are zero-filled, so any channel count works
//    (the stem's Cin = 3 included).
//  - The weight is read as (Cout, 3, 3, Cin), the bytes of PyTorch's OIHW conv
//    weight in channels_last, so the train step hands its parameter over
//    without a transposing copy; the tile is the GEMM's B in column-major.
//  - Blocks run concurrently, so each block writes its own per-channel
//    partial sums and a second kernel reduces them in a fixed order (in
//    double): no float atomics, and a run repeats bit for bit. A block walks
//    several pixel tiles (a grid-stride loop) and keeps its sums in registers
//    across them, so the partial-sum buffer has at most MAX_GRID_X rows.
//
// Three kernels, chosen by the launch function from what it can observe:
//  - bf16, Cin % 8 == 0 (every conv but the stem): tensor cores through
//    nvcuda::wmma (16x16x16, f32 accumulators), tiles brought into a ring of
//    three shared buffers by 16-byte cp.async copies, two steps ahead of the
//    products;
//  - bf16, any other Cin (the stem): the same products on 128 x 64 tiles with
//    element-wise loads staged through registers;
//  - f32: 64 x 64 tiles with plain FMAs, no tensor cores: TF32 would not hold
//    the f32 tolerance of the plain version.
// All three stage the f32 accumulators in shared memory, store y from there
// (16 bytes a thread where Cout % 8 == 0) and take the statistics from there.
//
// Bound: operations at the model's wide layers (2*9*M*Cin*Cout flop against
// x + w + y bytes is far above the card's 295 flop/byte), bytes at the stem.
// x is re-read once per tap through L2 and the products are wmma from padded
// shared tiles; wgmma, TMA and a halo tile kept in shared memory are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int MAX_GRID_X = 1024;  // rows of the partial-sum buffer at most

// ---------------------------------------------------------------- bf16 ----

constexpr int BM = 128;      // output pixels per tile
constexpr int BN = 64;       // output channels per tile
constexpr int LDC = BN + 4;  // f32 staging stride

// The bf16 kernels' epilogue. Cs is the block's BM x TN tile of f32
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

// Any Cin (the stem's 3): element-wise loads, 16 input channels a step,
// register-staged double buffering. VEC_N: Cout % 8 == 0 and y 16-byte
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

// ------------------------------------------- bf16, Cin a multiple of 8 ----
//
// The form the model's wide layers take: TN = 128 (or 64) output channels a
// tile, 32 input channels a step, a ring of STAGES shared buffers filled by
// cp.async (16 bytes a copy, zero-filled where the halo or a tail masks it),
// so the loads of step i + 2 are in flight during the products of step i and
// no register holds a tile. Warps are 2 x 4 (4 x 2 at TN = 64), a warp owns
// 64 x 32 (32 x 32) of the tile.

constexpr int PK = 32;       // input channels per step
constexpr int PLD = PK + 8;  // bf16 row stride of the A and B tiles: 16-byte aligned rows, banks spread
constexpr int STAGES = 3;

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int TN>
constexpr int pipelined_smem_bytes() {
  constexpr int pipe = STAGES * (BM + TN) * PLD * 2;
  constexpr int stage_c = BM * (TN + 4) * 4;
  return pipe > stage_c ? pipe : stage_c;
}

// x, w 16-byte aligned and Cin % 8 == 0. VEC_N: Cout % 8 == 0 and y 16-byte aligned.
template <int TN, bool VEC_N>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_stats_bf16_pipelined_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                                    int M, int H, int W, int Cin, int Cout) {
  constexpr int WARPS_N = TN / 32;
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // pixel rows of a warp
  constexpr int FRAG_M = WM / 16;
  constexpr int LDT = TN + 4;  // f32 staging stride
  constexpr int A_ELEMS = BM * PLD;
  constexpr int B_ELEMS = TN * PLD;
  constexpr int ROWS_STEP = THREADS / (PK / 8);  // tile rows covered by one pass of 16-byte chunks
  constexpr int A_PER = BM / ROWS_STEP;
  constexpr int B_PER = TN / ROWS_STEP;

  extern __shared__ __align__(128) unsigned char dsmem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(dsmem);  // [STAGES][BM][PLD]
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;                     // [STAGES][TN][PLD]
  float* Cs = reinterpret_cast<float*>(dsmem);                   // [BM][LDT], after the last step

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp % WARPS_M;
  const int warp_n = warp / WARPS_M;
  const int n0 = blockIdx.y * TN;
  const int unit = tid % (PK / 8);  // which 8 channels of a step
  const int row0 = tid / (PK / 8);
  const int kc = (Cin + PK - 1) / PK;
  const int n_iter = 9 * kc;
  const int tiles_m = (M + BM - 1) / BM;
  const int HW = H * W;

  float s_acc = 0.0f, q_acc = 0.0f;  // this thread's column sums over all the block's pixel tiles

  for (int tile = blockIdx.x; tile < tiles_m; tile += gridDim.x) {
    const int m0 = tile * BM;
    int ph[A_PER], pw[A_PER];  // this thread's pixels; a row past M gets h = -2, which no tap accepts
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int m = m0 + row0 + j * ROWS_STEP;
      const int hw = m % HW;
      ph[j] = m < M ? hw / W : -2;
      pw[j] = hw % W;
    }
    const long long poff0 = (long long)(m0 + row0) * Cin;

    auto fetch = [&](int it, int stage) {
      const int tap = it / kc;
      const int c = (it - tap * kc) * PK + unit * 8;
      const int di = tap / 3 - 1;
      const int dj = tap % 3 - 1;
      const long long shift = (long long)(di * W + dj) * Cin + c;
      const bool c_ok = c < Cin;
      __nv_bfloat16* a = As + stage * A_ELEMS + row0 * PLD + unit * 8;
      __nv_bfloat16* b = Bs + stage * B_ELEMS + row0 * PLD + unit * 8;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) {
        const bool ok = c_ok && (unsigned)(ph[j] + di) < (unsigned)H && (unsigned)(pw[j] + dj) < (unsigned)W;
        cp_async_16(a + j * ROWS_STEP * PLD, ok ? x + poff0 + (long long)j * ROWS_STEP * Cin + shift : x, ok);
      }
#pragma unroll
      for (int j = 0; j < B_PER; ++j) {
        const int n = n0 + row0 + j * ROWS_STEP;
        const bool ok = c_ok && n < Cout;
        cp_async_16(b + j * ROWS_STEP * PLD, ok ? w + ((size_t)n * 9 + tap) * Cin + c : w, ok);
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_M][2];
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {  // n_iter >= 9 > STAGES
      fetch(s, s);
      cp_async_commit();
    }
    for (int it = 0; it < n_iter; ++it) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of step `it` have landed
      __syncthreads();              // everyone's have, and everyone is done with step it - 1
      const int nxt = it + STAGES - 1;
      if (nxt < n_iter) fetch(nxt, nxt % STAGES);  // into the buffer of step it - 1
      cp_async_commit();
      const int stage = it % STAGES;
      const __nv_bfloat16* a = As + stage * A_ELEMS + warp_m * WM * PLD;
      const __nv_bfloat16* b = Bs + stage * B_ELEMS + warp_n * 32 * PLD;
#pragma unroll
      for (int kk = 0; kk < PK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], b + j * 16 * PLD + kk, PLD);
#pragma unroll
        for (int i = 0; i < FRAG_M; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, a + i * 16 * PLD + kk, PLD);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: stage the accumulators in it

#pragma unroll
    for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (warp_m * WM + i * 16) * LDT + warp_n * 32 + j * 16, acc[i][j], LDT,
                                wmma::mem_row_major);
    __syncthreads();

    store_y_and_sum<TN, VEC_N>(Cs, y, m0, n0, M, Cout, s_acc, q_acc);
    __syncthreads();  // Cs is overwritten by the next tile's copies
  }
  write_partial_sums<TN>(s_acc, q_acc, partial, n0, Cout);
}

template <int TN, bool VEC_N>
cudaError_t launch_pipelined(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, float* partial,
                             int rows, int M, int H, int W, int Cin, int Cout, cudaStream_t st) {
  auto kernel = conv3x3_stats_bf16_pipelined_kernel<TN, VEC_N>;
  constexpr int smem = pipelined_smem_bytes<TN>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(rows, (Cout + TN - 1) / TN), THREADS, smem, st>>>(x, w, y, partial, M, H, W, Cin, Cout);
  return cudaGetLastError();
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

}  // namespace

// Rows of the (rows, 2, Cout) f32 partial-sum scratch that
// conv3x3_bn_stats_launch needs for this problem.
extern "C" int conv3x3_bn_stats_partial_rows(int B, int H, int W, int is_bf16) {
  return grid_rows((long long)B * H * W, is_bf16 ? BM : FM);
}

// x (B, H, W, Cin) and w (Cout, 3, 3, Cin) contiguous, bf16 (is_bf16 = 1) or
// f32; y (B, H, W, Cout) in the same type; partial the f32 scratch above;
// mean, var (Cout,) f32. All device pointers on `stream`. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int conv3x3_bn_stats_launch(const void* x, const void* w, void* y, void* partial, void* mean,
                                       void* var, int B, int H, int W, int Cin, int Cout, int is_bf16,
                                       void* stream) {
  const long long M = (long long)B * H * W;
  if (M <= 0 || M > 0x7fffffffLL || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = grid_rows(M, is_bf16 ? BM : FM);
  const dim3 grid(rows, (Cout + BN - 1) / BN);  // BN == FN
  float* part = static_cast<float*>(partial);
  cudaError_t err = cudaSuccess;
  if (is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    const bool vec_k = Cin % 8 == 0 && aligned16(x) && aligned16(w);
    const bool vec_n = Cout % 8 == 0 && aligned16(y);
    if (vec_k && Cout > 64) {  // the wide layers: 128-channel tiles
      err = vec_n ? launch_pipelined<128, true>(xb, wb, yb, part, rows, (int)M, H, W, Cin, Cout, st)
                  : launch_pipelined<128, false>(xb, wb, yb, part, rows, (int)M, H, W, Cin, Cout, st);
    } else if (vec_k) {
      err = vec_n ? launch_pipelined<64, true>(xb, wb, yb, part, rows, (int)M, H, W, Cin, Cout, st)
                  : launch_pipelined<64, false>(xb, wb, yb, part, rows, (int)M, H, W, Cin, Cout, st);
    } else {  // a Cin that is no multiple of 8 (the stem): element-wise loads
      if (vec_n)
        conv3x3_stats_bf16_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, yb, part, (int)M, H, W, Cin, Cout);
      else
        conv3x3_stats_bf16_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, yb, part, (int)M, H, W, Cin, Cout);
      err = cudaGetLastError();
    }
  } else {
    conv3x3_stats_f32_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                                       static_cast<float*>(y), part, (int)M, H, W, Cin, Cout);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  bn_stats_finalize_kernel<<<(Cout + 31) / 32, dim3(32, 32), 0, st>>>(
      part, static_cast<float*>(mean), static_cast<float*>(var), rows, Cout, (double)M);
  return (int)cudaGetLastError();
}

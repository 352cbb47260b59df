// Candidate-score pass of the top-k decode: masked obj * max-class score and
// the class argmax of every anchor of one scale's raw head output.
//
// Replaces the TPU kernel `_score_kernel` / `masked_scores_pallas` of
// yolov3_tpu/ops/score_pallas.py. It computes what that kernel computes, per
// (cell, anchor) row of no = 5 + nc logits:
//   score = sigmoid(obj) * sigmoid(max class logit), stored where score >
//   conf_thres and sigmoid(obj) > conf_thres, else -1;
//   arg = the lowest class index of the max.
// Output order is (cell, anchor), cell = b * M + y * nx + x: the (y, x, a)
// order of the port's decode (ops/score_cuda.py).
//
// Bound: bytes. Every head byte is read once (137 MB at yolov3@640, batch 32,
// bf16) and 8 bytes are written per anchor; the arithmetic is a few
// instructions per byte. A bf16 row of a cell is 255 * 2 = 510 bytes, so rows
// are not 16-byte aligned and a kernel that walks rows can only make 2-byte
// loads. This one does not walk rows:
//  - Flat cells. The B * M cells of a scale are one run of R-byte rows. A
//    tile is `tile_cells` cells, a multiple of 16 / gcd(R, 16) (8 for 510-byte
//    rows: 8 * 510 = 255 * 16 bytes), so a tile of a tensor whose data starts
//    on a 16-byte boundary starts and ends on one too. Tiles may cross images.
//  - Loads. One thread moves a tile's 16-byte-aligned bytes into shared
//    memory with one 1-D bulk async copy (cp.async.bulk, completing on an
//    mbarrier; no tensor map). The pieces under 16 bytes before and after it
//    (the end of the last tile; every tile of a tensor that starts off a
//    16-byte boundary) are copied by 2-byte loads of one warp. The bytes land
//    in shared memory at their offset from the 16-byte boundary below the
//    tile's first byte, so row r of the tile starts at (start % 16) + r * R.
//  - Pipeline. Persistent blocks (three an SM), each walking tiles
//    blockIdx.x, + gridDim.x, ... through a ring of STAGES = 2 tiles of about
//    32 KB (64 bf16 cells): while one tile is reduced, the next is in flight.
//    Deeper rings of smaller tiles (4 x 16 KB, 3 x 16 KB) kept more bytes in
//    flight and were 12-18% slower at 80x80 on an H100 80GB HBM3 at 700 W
//    (scripts/k2_sweep.py, PERF.md): fewer, larger copies suit the copy
//    engine and DRAM better here.
//  - Reduction. One thread per (cell, anchor) row (192 rows a bf16 tile)
//    reads its class logits from shared memory as 4-byte words (two bf16 or
//    f16 each; a row that starts 2 bytes past a word skips the element before
//    it), and keeps the max and the lowest index of it in four accumulators,
//    so the dependent chain is a quarter of the row. A first form with eight
//    threads a row, 2-byte loads and shuffles spent about three times the
//    instructions and ran at 43% of the bound on the same card (PERF.md).
//    The sigmoids are 1 / (1 + expf(-x)) with the accurate expf and an IEEE
//    division (this file is built without --use_fast_math), the arithmetic of
//    PyTorch's CUDA sigmoid, so the scores match the plain version.
//  - Writes. A tile's scores and args are contiguous (tile_cells * na each)
//    and thread r writes row r: consecutive threads, consecutive words.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 192;  // a thread per (cell, anchor) row of a 64-cell tile of yolov3
constexpr int STAGES = 2;
constexpr long long SPIN_CLOCKS = 4000000000LL;  // a barrier that has not flipped after ~2 s is a fault

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
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
// The copy carries an L2 evict-first policy: the head output is read once, so
// its lines should leave L2 before anything else (6% faster at 80x80 on an
// H100 80GB HBM3 at 700 W, scripts/k2_sweep.py).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The byte range [start, end) of a tile, split as the kernel moves it: the
// bulk copy [a0, a1) (16-byte aligned, possibly empty), the head [start, h1)
// and the tail [t0, end) by 2-byte loads; `base` = start rounded down to 16
// is shared memory offset 0 of the stage. ops/score_cuda.tile_plan is this
// arithmetic in Python, and tests/test_torch_score_tiles.py checks it.
struct TileBytes {
  uintptr_t base, a0, a1, h1, t0;
};

__device__ __forceinline__ TileBytes split_tile(uintptr_t start, uintptr_t end) {
  TileBytes t;
  t.base = start & ~(uintptr_t)15;
  const uintptr_t up = (start + 15) & ~(uintptr_t)15, down = end & ~(uintptr_t)15;
  if (down >= up) {
    t.a0 = up, t.a1 = down, t.h1 = up, t.t0 = down;
  } else {  // the tile lies inside one 16-byte line, or across one boundary with no whole line
    t.a0 = t.a1 = up, t.h1 = end, t.t0 = end;
  }
  return t;
}

// Issue tile `tile` into stage `s`: thread 0 arms the barrier and starts the
// bulk copy; lanes of warp 1 copy the head (at most 15 2-byte units) and the
// tail (at most 7). The caller's next __syncthreads orders those stores
// before the stage is read.
__device__ __forceinline__ void issue_tile(const uint8_t* x, long long n_cells, int R, int tile_cells,
                                           long long tile, uint8_t* stage, uint32_t bar) {
  const long long c0 = tile * tile_cells;
  const long long c1 = min(c0 + tile_cells, n_cells);
  const uintptr_t start = reinterpret_cast<uintptr_t>(x) + (uintptr_t)c0 * R;
  const uintptr_t end = reinterpret_cast<uintptr_t>(x) + (uintptr_t)c1 * R;
  const TileBytes t = split_tile(start, end);
  if (threadIdx.x == 0) {
    // earlier generic-proxy reads of this stage come before the async-proxy writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t bytes = (uint32_t)(t.a1 - t.a0);
    mbar_expect_tx(bar, bytes);
    if (bytes) bulk_load(smem_u32(stage + (t.a0 - t.base)), reinterpret_cast<const void*>(t.a0), bytes, bar);
  } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
    const int lane = threadIdx.x - 32;
    const uintptr_t g = lane < 16 ? start + 2 * lane : t.t0 + 2 * (lane - 16);
    if (g < (lane < 16 ? t.h1 : end)) {
      *reinterpret_cast<uint16_t*>(stage + (g - t.base)) = __ldg(reinterpret_cast<const uint16_t*>(g));
    }
  }
}

// Running max of a row's class logits and the lowest index of it. Each
// accumulator sees its indices in ascending order, so a strict > keeps the
// first of equal values; two accumulators are merged by value, then index.
struct Best {
  float v;
  int k;
};
__device__ __forceinline__ void take(Best& b, float v, int k) {
  if (v > b.v) b.v = v, b.k = k;
}
__device__ __forceinline__ Best merge(Best a, Best b) { return (b.v > a.v || (b.v == a.v && b.k < a.k)) ? b : a; }
constexpr Best NONE = {-INFINITY, 0x7fffffff};

__device__ __forceinline__ float lo_half(uint32_t w, __nv_bfloat16) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(uint32_t w, __nv_bfloat16) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float lo_half(uint32_t w, __half) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float hi_half(uint32_t w, __half) { return __half2float(__ushort_as_half((unsigned short)(w >> 16))); }

// argmax of nc 2-byte logits from `cls` (shared memory, 2-byte aligned), read
// as 4-byte words: word j holds classes 2j - s and 2j + 1 - s, where s = 1
// when `cls` is 2 bytes past a word (the element before class 0 is skipped).
// Four accumulators (word parity x half) keep the dependent chain a quarter
// of the row.
template <typename T>
__device__ __forceinline__ Best row_argmax(const uint8_t* cls, int nc) {
  const int s = (int)((reinterpret_cast<uintptr_t>(cls) >> 1) & 1);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(cls - 2 * s);
  const int nw = (s + nc + 1) / 2;
  Best acc[4] = {NONE, NONE, NONE, NONE};
  uint32_t w = wp[0];
  if (s == 0) take(acc[0], lo_half(w, T()), 0);
  if (1 - s < nc) take(acc[1], hi_half(w, T()), 1 - s);
  int j = 1;
  for (; j + 1 < nw - 1; j += 2) {
    const uint32_t w0 = wp[j], w1 = wp[j + 1];
    take(acc[2], lo_half(w0, T()), 2 * j - s);
    take(acc[3], hi_half(w0, T()), 2 * j + 1 - s);
    take(acc[0], lo_half(w1, T()), 2 * j + 2 - s);
    take(acc[1], hi_half(w1, T()), 2 * j + 3 - s);
  }
  for (; j < nw - 1; ++j) {
    w = wp[j];
    take(acc[2], lo_half(w, T()), 2 * j - s);
    take(acc[3], hi_half(w, T()), 2 * j + 1 - s);
  }
  if (nw > 1) {
    const int k = 2 * (nw - 1) - s;
    w = wp[nw - 1];
    take(acc[0], lo_half(w, T()), k);
    if (k + 1 < nc) take(acc[1], hi_half(w, T()), k + 1);
  }
  return merge(merge(acc[0], acc[1]), merge(acc[2], acc[3]));
}

template <>
__device__ __forceinline__ Best row_argmax<float>(const uint8_t* cls, int nc) {
  const float* v = reinterpret_cast<const float*>(cls);
  Best even = NONE, odd = NONE;
#pragma unroll 8
  for (int k = 0; k + 1 < nc; k += 2) {
    take(even, v[k], k);
    take(odd, v[k + 1], k + 1);
  }
  if (nc & 1) take(even, v[nc - 1], nc - 1);
  return merge(even, odd);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) score_kernel(const uint8_t* __restrict__ x, float* __restrict__ scores,
                                                        int32_t* __restrict__ args, long long n_cells, int na, int no,
                                                        int tile_cells, int stage_bytes, float conf_thres) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int R = na * no * (int)sizeof(T);
  const int row_bytes = no * (int)sizeof(T);  // one (cell, anchor) row: rows are contiguous over cells and anchors
  const int nc = no - 5;
  uint8_t* stages = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)STAGES * stage_bytes);
  const long long n_tiles = (n_cells + tile_cells - 1) / tile_cells;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < STAGES; ++s) {
    const long long tile = blockIdx.x + (long long)s * gridDim.x;
    if (tile < n_tiles) issue_tile(x, n_cells, R, tile_cells, tile, stages + (size_t)s * stage_bytes, smem_u32(&full[s]));
  }
  __syncthreads();

  long long i = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int s = (int)(i % STAGES);
    uint8_t* stage = stages + (size_t)s * stage_bytes;
    mbar_wait(smem_u32(&full[s]), (uint32_t)((i / STAGES) & 1));

    const long long c0 = tile * tile_cells;
    const int rows = (int)min((long long)tile_cells, n_cells - c0) * na;
    const uint8_t* first = stage + ((reinterpret_cast<uintptr_t>(x) + (uintptr_t)c0 * R) & 15);
    const long long o = c0 * na;
    for (int r = threadIdx.x; r < rows; r += THREADS) {  // a thread per row; its outputs are consecutive threads'
      const uint8_t* row = first + (size_t)r * row_bytes;
      Best b = row_argmax<T>(row + 5 * sizeof(T), nc);
      if (b.k == NONE.k) b.k = 0;  // every logit -inf: torch.argmax gives 0
      const float obj = sigmoid(to_float(*reinterpret_cast<const T*>(row + 4 * sizeof(T))));
      float out = -1.0f;
      if (obj > conf_thres) {  // else no score is stored, so its sigmoid is not needed
        const float score = obj * sigmoid(b.v);
        if (score > conf_thres) out = score;
      }
      scores[o + r] = out;
      args[o + r] = b.k;
    }
    __syncthreads();  // the stage is read: refill it with the block's tile STAGES ahead
    const long long next = tile + (long long)STAGES * gridDim.x;
    if (next < n_tiles) issue_tile(x, n_cells, R, tile_cells, next, stage, smem_u32(&full[s]));
  }
}

template <typename T>
cudaError_t launch(const void* x, float* scores, int32_t* args, long long n_cells, int na, int no, int tile_cells,
                   float conf_thres, cudaStream_t stream) {
  const long long R = (long long)na * no * sizeof(T);
  // a stage holds the tile's bytes from the 16-byte line below its first byte
  // to the line above its last: at most tile bytes + 30
  const int stage_bytes = (int)(((R * tile_cells + 32) + 127) / 128 * 128);
  const size_t smem = (size_t)STAGES * stage_bytes + STAGES * sizeof(uint64_t);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_kernel<T>, THREADS, smem)) != cudaSuccess)
    return err;
  const long long n_tiles = (n_cells + tile_cells - 1) / tile_cells;
  const long long grid = std::min(n_tiles, (long long)sms * std::max(per_sm, 1));
  score_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(static_cast<const uint8_t*>(x), scores, args, n_cells, na,
                                                             no, tile_cells, stage_bytes, conf_thres);
  return cudaGetLastError();
}

}  // namespace

// x: (n_cells, na * no) head output on `stream`, dtype 0 bf16, 1 f16, 2 f32,
// at least 2-byte aligned (4 for f32); scores (n_cells * na) f32 and args
// (n_cells * na) int32 outputs. tile_cells from ops/score_cuda.tile_cells.
// Returns the launch's cudaError_t (0 on success).
extern "C" int masked_scores_launch(const void* x, void* scores, void* args, long long n_cells, int na, int no,
                                    int dtype, int tile_cells, float conf_thres, void* stream) {
  if (n_cells <= 0 || na <= 0 || no < 6 || tile_cells <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scores);
  int32_t* a = static_cast<int32_t*>(args);
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(x, s, a, n_cells, na, no, tile_cells, conf_thres, st);
    case 1: return (int)launch<__half>(x, s, a, n_cells, na, no, tile_cells, conf_thres, st);
    case 2: return (int)launch<float>(x, s, a, n_cells, na, no, tile_cells, conf_thres, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

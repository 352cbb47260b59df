// Batched greedy NMS over prefiltered candidates, candidates resident on chip.
//
// Replaces the TPU kernel `_nms_kernel` / `pallas_greedy_nms` of
// yolov3_tpu/ops/nms_pallas.py (one Pallas program for the batch, or a grid
// over images). One image never needs another's data, so an image is one
// warp or one block here, and each image stops on its own.
//
// Per step t (at most max_det steps):
//   1. argmax of the live scores over (score, -index): the lowest index wins
//      ties, as jnp.argmax does;
//   2. stop when that score is not > 0;
//   3. the selected index goes to a list in shared memory (the output rows
//      are gathered from it after the loop, off the dependent chain);
//   4. the IoU of the selected class-offset box against every live
//      candidate, inter / (sarea + area - inter + 1e-7) in f32; those with
//      IoU > iou_thres (and the selected slot) are marked -1, and the same
//      pass folds the survivors into the argmax of step t + 1.
// Rows from the last step to max_det are zeroed, and n[b] = the step count,
// which is count(conf > 0) of the output.
//
// Bound: latency. The steps are sequential (up to max_det of them), and a
// step is one dependent chain: argmax, broadcast of the selected box, IoU,
// compare. The byte and operation counts are tiny beside it. So the design
// takes everything off that chain that need not be on it:
//  - K <= 512 (the serving shape): candidates (box, area, live score) in
//    registers, at most four a thread: one warp per image up to K = 32 (no
//    barrier at all), four warps above that. A warp issues one instruction a
//    clock, and at 14 candidates a lane the tests' instructions, not the
//    chain, would set the step's time; four warps on the SM's four schedulers pay
//    one barrier a step for a quarter of them. Selectable scores are positive
//    floats, whose bits order as unsigned integers, so a warp's argmax is one
//    redux.sync max over the score bits and one redux.sync min over the
//    indices of the lanes that hold the maximum. The selected box is one
//    broadcast read of a copy of the boxes in shared memory.
//  - K <= 8192 (the overflow fallback): one block per image, boxes, areas and
//    live scores in up to 192 KB of dynamic shared memory, loaded once. One
//    barrier a step: every warp leaves its winner in a double-buffered array
//    and every warp reduces that array for itself.
//  - larger K (val-grade): the same block kernel with the candidates left in
//    global memory (L2) and the live scores in a scratch buffer.
//  - the areas are computed once (the plain version does the same, the same
//    f32 value), and the IEEE division is taken only where it can decide:
//    inter > union * iou_thres * (1 + 2e-5) means IoU > iou_thres and
//    inter < union * iou_thres * (1 - 2e-5) means it is not, whatever the
//    rounding of the division and of these products (2^-24 each, relative);
//    in between, the division itself is computed and compared, so the result
//    is the division's in every case. That leaves the loop over a lane's
//    candidates without a branch, so their tests overlap in the pipeline.
//
// Build: this file is compiled with -fmad=false and without --use_fast_math
// (yolov3_tpu_torch/ops/cuda_build.py). A fused multiply-add in the area or
// the union would round differently from the plain PyTorch version and the
// TPU kernel and could move an IoU across iou_thres, which changes which
// boxes survive; the division must be IEEE for the same reason.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 0x7fffffff;
constexpr int REG_MAX_K = 512;         // candidates in registers up to here
constexpr int ON_CHIP_MAX_K = 8192;    // candidates in shared memory up to here: 24 bytes each

// iou_thres with its margins: hi = iou_thres * (1 + 2e-5), lo = iou_thres *
// (1 - 2e-5), each rounded once; ok says whether they may be used at all (a
// threshold well above 0).
struct Margins {
  float thres, hi, lo;
  bool ok;
};

__device__ __forceinline__ Margins make_margins(float iou_thres) {
  return Margins{iou_thres, iou_thres * 1.00002f, iou_thres * 0.99998f, iou_thres > 1e-3f && iou_thres < 1e3f};
}

// Numerator and denominator of the IoU of the selected box `sb` (area `sarea`)
// and the box `ob` (area `area`), as the plain version computes them.
__device__ __forceinline__ void iou_parts(const float4 sb, float sarea, const float4 ob, float area,
                                          float& inter, float& uni) {
  const float iw = fmaxf(fminf(sb.z, ob.z) - fmaxf(sb.x, ob.x), 0.0f);
  const float ih = fmaxf(fminf(sb.w, ob.w) - fmaxf(sb.y, ob.y), 0.0f);
  inter = iw * ih;
  uni = sarea + area - inter + 1e-7f;
}

// What the margins (see the note above) can say of inter / uni > iou_thres
// without the division: 1 it is, 0 it is not, -1 only the division can tell.
// No branch, so a loop over candidates can overlap their tests.
__device__ __forceinline__ int margin_verdict(float inter, float uni, const Margins mg) {
  const bool above = inter > uni * mg.hi;
  const bool below = inter < uni * mg.lo;
  const bool decided = mg.ok && uni > 1e-30f && (above || below);
  return decided ? (above ? 1 : 0) : -1;
}

// IoU(sb, ob) > iou_thres; the value compared is always that of the IEEE f32 division.
__device__ __forceinline__ bool iou_above(const float4 sb, float sarea, const float4 ob, float area,
                                          const Margins mg) {
  float inter, uni;
  iou_parts(sb, sarea, ob, area, inter, uni);
  const int verdict = margin_verdict(inter, uni, mg);
  return verdict >= 0 ? verdict == 1 : inter / uni > mg.thres;
}

// Warp argmax over (score, lowest index) of each lane's (v, i): the score and
// index of the winner in every lane; score 0 if no lane holds a score > 0.
__device__ __forceinline__ void warp_argmax(float v, int i, float& smax, int& imax) {
  const unsigned bits = v > 0.0f ? __float_as_uint(v) : 0u;
  const unsigned top = __reduce_max_sync(FULL, bits);
  imax = (int)__reduce_min_sync(FULL, (unsigned)(bits == top ? i : NO_INDEX));
  smax = __uint_as_float(top);
}

// Rows [0, n) of an image's output from the selected indices, the rest zero.
__device__ __forceinline__ void write_rows(const int* sel, int n, int max_det, const float4* __restrict__ boxes,
                                           const float* __restrict__ scores, const float* __restrict__ cls,
                                           float* __restrict__ out_b, int tid, int threads) {
  for (int t = tid; t < max_det; t += threads) {
    float4 ob = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float conf = 0.0f, c = 0.0f;
    if (t < n) {
      const int i = sel[t];
      ob = boxes[i];
      conf = scores[i];
      c = cls[i];
    }
    float2* row = reinterpret_cast<float2*>(out_b + (size_t)t * 6);  // 24-byte rows of a 16-byte aligned buffer
    row[0] = make_float2(ob.x, ob.y);
    row[1] = make_float2(ob.z, ob.w);
    row[2] = make_float2(conf, c);
  }
}

// WARPS warps per image, CPL candidates a thread in registers (thread t holds
// candidates t, t + 32 * WARPS, ...). K <= 32 * WARPS * CPL. A warp issues one
// instruction a clock at most and the IoU tests of a step are some 25
// instructions a candidate, so four warps (on the SM's four schedulers) take a
// step's tests in a quarter of the time; what they pay for it is one barrier a
// step, as in the block kernel below. Dynamic shared memory: K float4 (the
// class-offset boxes, for the broadcast of the selected one) and max_det ints
// (the selected indices).
template <int CPL, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
greedy_nms_reg_kernel(const float4* __restrict__ boxes_off, const float4* __restrict__ boxes,
                      const float* __restrict__ scores, const float* __restrict__ cls,
                      float* __restrict__ out, int32_t* __restrict__ n_out,
                      int K, int max_det, float iou_thres) {
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ float4 smem4[];
  __shared__ unsigned warp_bits[2][WARPS];
  __shared__ int warp_idx[2][WARPS];
  float4* sbox = smem4;
  int* sel = reinterpret_cast<int*>(smem4 + K);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t base = (size_t)b * K;
  const Margins mg = make_margins(iou_thres);

  float4 bx[CPL];
  float area[CPL], sc[CPL];
  float best_v = 0.0f;
  int best_i = NO_INDEX;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = tid + THREADS * c;
    if (j < K) {
      bx[c] = boxes_off[base + j];
      sc[c] = scores[base + j];
      sbox[j] = bx[c];
    } else {
      bx[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      sc[c] = -1.0f;
    }
    area[c] = (bx[c].z - bx[c].x) * (bx[c].w - bx[c].y);
    if (sc[c] > best_v) {
      best_v = sc[c];
      best_i = j;
    }
  }
  if constexpr (WARPS == 1) __syncwarp();  // else the first step's barrier orders sbox

  int t = 0;
  for (; t < max_det; ++t) {
    float smax;
    int i;
    warp_argmax(best_v, best_i, smax, i);
    if constexpr (WARPS > 1) {  // one barrier: see the block kernel
      const int half = t & 1;
      if (lane == 0) {
        warp_bits[half][tid >> 5] = __float_as_uint(smax);
        warp_idx[half][tid >> 5] = i;
      }
      __syncthreads();
      const unsigned bits = lane < WARPS ? warp_bits[half][lane] : 0u;
      const int idx = lane < WARPS ? warp_idx[half][lane] : NO_INDEX;
      const unsigned top = __reduce_max_sync(FULL, bits);
      i = (int)__reduce_min_sync(FULL, (unsigned)(bits == top ? idx : NO_INDEX));
      smax = __uint_as_float(top);
    }
    if (!(smax > 0.0f)) break;  // the same value in every thread
    if (tid == 0) sel[t] = i;
    const float4 sb = sbox[i];
    const float sarea = (sb.z - sb.x) * (sb.w - sb.y);
    // suppression without a branch, so that the CPL tests overlap in the pipeline;
    // a slot at <= 0 can never be selected again and stays as it is
    unsigned unsure = 0u;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float inter, uni;
      iou_parts(sb, sarea, bx[c], area[c], inter, uni);
      const int verdict = margin_verdict(inter, uni, mg);
      const bool alive = sc[c] > 0.0f;
      if (alive && verdict < 0) unsure |= 1u << c;
      if (alive && (verdict == 1 || tid + THREADS * c == i)) sc[c] = -1.0f;
    }
    if (__any_sync(FULL, unsure != 0u)) {  // rare: an IoU within 2e-5 of the threshold
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float inter, uni;
        iou_parts(sb, sarea, bx[c], area[c], inter, uni);
        if (((unsure >> c) & 1u) && inter / uni > iou_thres) sc[c] = -1.0f;
      }
    }
    best_v = 0.0f;
    best_i = NO_INDEX;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (sc[c] > best_v) {  // the index grows with c: the lowest index of a tie stays
        best_v = sc[c];
        best_i = tid + THREADS * c;
      }
  }
  if constexpr (WARPS == 1) __syncwarp();
  else __syncthreads();  // sel is complete
  write_rows(sel, t, max_det, boxes + base, scores + base, cls + base, out + (size_t)b * max_det * 6, tid, THREADS);
  if (tid == 0) n_out[b] = t;
}

// One block per image. ON_CHIP: boxes, areas and live scores in dynamic shared
// memory (K * 24 bytes), else boxes read from global memory and live scores in
// the scratch `live`. After them in shared memory: max_det ints.
template <bool ON_CHIP>
__global__ void greedy_nms_block_kernel(const float4* __restrict__ boxes_off, const float4* __restrict__ boxes,
                                        const float* __restrict__ scores, const float* __restrict__ cls,
                                        float* __restrict__ live, float* __restrict__ out,
                                        int32_t* __restrict__ n_out, int K, int max_det, float iou_thres) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned warp_bits[2][32];
  __shared__ int warp_idx[2][32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t base = (size_t)b * K;
  const Margins mg = make_margins(iou_thres);

  const float4* bx;
  float* sc;
  [[maybe_unused]] float* area = nullptr;
  int* sel;
  float best_v = 0.0f;
  int best_i = NO_INDEX;
  if constexpr (ON_CHIP) {
    float4* sbox = smem4;
    area = reinterpret_cast<float*>(smem4 + K);
    sc = area + K;
    sel = reinterpret_cast<int*>(sc + K);
    for (int j = tid; j < K; j += blockDim.x) {
      const float4 ob = boxes_off[base + j];
      const float v = scores[base + j];
      sbox[j] = ob;
      area[j] = (ob.z - ob.x) * (ob.w - ob.y);
      sc[j] = v;
      if (v > best_v) {
        best_v = v;
        best_i = j;
      }
    }
    bx = sbox;
  } else {
    bx = boxes_off + base;
    sc = live + base;
    sel = reinterpret_cast<int*>(smem4);
    for (int j = tid; j < K; j += blockDim.x) {
      const float v = scores[base + j];
      sc[j] = v;
      if (v > best_v) {
        best_v = v;
        best_i = j;
      }
    }
  }
  // a thread reads and writes only its own slots j = tid (mod blockDim) of sc
  // and area; the boxes are read by all, after the first barrier below

  int t = 0;
  for (; t < max_det; ++t) {
    // block argmax with one barrier: each warp's winner goes to this step's
    // half of the array, and every warp reduces the whole array for itself
    const int half = t & 1;
    float wv;
    int wi;
    warp_argmax(best_v, best_i, wv, wi);
    if (lane == 0) {
      warp_bits[half][warp] = __float_as_uint(wv);
      warp_idx[half][warp] = wi;
    }
    __syncthreads();
    const unsigned bits = lane < n_warps ? warp_bits[half][lane] : 0u;
    const int idx = lane < n_warps ? warp_idx[half][lane] : NO_INDEX;
    const unsigned top = __reduce_max_sync(FULL, bits);
    const int i = (int)__reduce_min_sync(FULL, (unsigned)(bits == top ? idx : NO_INDEX));
    if (top == 0u) break;  // the same value in every thread
    if (tid == 0) sel[t] = i;

    const float4 sb = bx[i];
    const float sarea = (sb.z - sb.x) * (sb.w - sb.y);
    best_v = 0.0f;
    best_i = NO_INDEX;
    if constexpr (ON_CHIP) {
      // 32 warps share the SM's four schedulers: the instructions of the tests set the
      // step's time, so the loop is the shortest one, a candidate at a time
      for (int j = tid; j < K; j += blockDim.x) {
        float v = sc[j];
        if (v > 0.0f) {  // a slot at <= 0 can never be selected again: no IoU, no write
          if (j == i || iou_above(sb, sarea, bx[j], area[j], mg)) {
            v = -1.0f;
            sc[j] = v;
          }
          if (v > best_v) {
            best_v = v;
            best_i = j;
          }
        }
      }
    } else {
      // L2's latency sets the step's time: four candidates at a time, their loads and
      // tests independent of each other, so that the latencies overlap
      for (int j0 = tid; j0 < K; j0 += 4 * blockDim.x) {
        float v[4];
        bool any_alive = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * blockDim.x;
          v[u] = j < K ? sc[j] : -1.0f;
          any_alive = any_alive || v[u] > 0.0f;
        }
        if (!any_alive) continue;  // slots at <= 0 can never be selected again: no IoU, no write
        float4 ob[4];
        float a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = min(j0 + u * (int)blockDim.x, K - 1);
          ob[u] = bx[j];
          a[u] = (ob[u].z - ob[u].x) * (ob[u].w - ob[u].y);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * blockDim.x;
          float inter, uni;
          iou_parts(sb, sarea, ob[u], a[u], inter, uni);
          int verdict = margin_verdict(inter, uni, mg);
          if (verdict < 0 && v[u] > 0.0f) verdict = inter / uni > iou_thres ? 1 : 0;  // rare
          if (v[u] > 0.0f && (verdict == 1 || j == i)) {
            v[u] = -1.0f;
            sc[j] = -1.0f;
          }
          if (v[u] > best_v) {  // j grows with u and j0: the lowest index of a tie stays
            best_v = v[u];
            best_i = j;
          }
        }
      }
    }
  }
  __syncthreads();  // sel is complete
  write_rows(sel, t, max_det, boxes + base, scores + base, cls + base, out + (size_t)b * max_det * 6, tid,
             blockDim.x);
  if (tid == 0) n_out[b] = t;
}

// Block size of the block kernels: about eight candidates a thread, 256 to 1024 threads.
inline int block_threads(int K) {
  int t = 256;
  while (t < 1024 && 8 * t < K) t *= 2;
  return t;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Which kernel greedy_nms_launch takes at K candidates: 1 one or four warps
// per image (registers), 2 block per image (shared memory), 3 block per image
// (global memory; the only one that needs the `live` scratch).
extern "C" int greedy_nms_route(int K) { return K <= REG_MAX_K ? 1 : (K <= ON_CHIP_MAX_K ? 2 : 3); }

// All pointers are device pointers on `stream`, 16-byte aligned; boxes are
// (B, K, 4) f32, scores / cls (B, K) f32, live a (B, K) f32 scratch (read only
// where greedy_nms_route(K) == 3, else it may be null), out (B, max_det, 6)
// f32, n (B,) int32. Returns the launch's cudaError_t (0 on success).
extern "C" int greedy_nms_launch(const void* boxes_off, const void* boxes, const void* scores,
                                 const void* cls, void* live, void* out, void* n, int B, int K,
                                 int max_det, float iou_thres, void* stream) {
  if (B <= 0 || K <= 0 || max_det <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* bo = static_cast<const float4*>(boxes_off);
  const float4* bx = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  const float* cl = static_cast<const float*>(cls);
  float* o = static_cast<float*>(out);
  int32_t* no = static_cast<int32_t*>(n);
  const size_t sel_bytes = (size_t)max_det * sizeof(int);
  cudaError_t err = cudaSuccess;
  const int route = greedy_nms_route(K);
  if (route == 1) {
    const size_t smem = (size_t)K * sizeof(float4) + sel_bytes;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // max_det beyond ~10000
    if (K <= 32) {  // one candidate a lane: the bare chain of a step
      greedy_nms_reg_kernel<1, 1><<<B, 32, smem, st>>>(bo, bx, sc, cl, o, no, K, max_det, iou_thres);
    } else {
      greedy_nms_reg_kernel<4, 4><<<B, 128, smem, st>>>(bo, bx, sc, cl, o, no, K, max_det, iou_thres);
    }
  } else if (route == 2) {
    const size_t smem = (size_t)K * 24 + sel_bytes;
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if ((err = allow_smem(greedy_nms_block_kernel<true>, smem)) != cudaSuccess) return (int)err;
    greedy_nms_block_kernel<true><<<B, block_threads(K), smem, st>>>(bo, bx, sc, cl, nullptr, o, no, K, max_det,
                                                                     iou_thres);
  } else {
    if (live == nullptr || sel_bytes > 200 * 1024) return (int)cudaErrorInvalidValue;
    if ((err = allow_smem(greedy_nms_block_kernel<false>, sel_bytes)) != cudaSuccess) return (int)err;
    greedy_nms_block_kernel<false><<<B, 1024, sel_bytes, st>>>(bo, bx, sc, cl, static_cast<float*>(live), o, no, K,
                                                               max_det, iou_thres);
  }
  return static_cast<int>(cudaGetLastError());
}

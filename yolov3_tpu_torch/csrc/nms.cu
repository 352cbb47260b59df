// Batched greedy NMS over prefiltered candidates, one thread block per image.
//
// Replaces the TPU kernel `_nms_kernel` / `pallas_greedy_nms` of
// yolov3_tpu/ops/nms_pallas.py (one Pallas program for the batch, or a grid
// over images). On Hopper a block is already per image, so one kernel covers
// both Pallas modes, and each image stops on its own.
//
// Per step t (at most max_det steps):
//   1. block-wide argmax of the live scores over (score, -index): the lowest
//      index wins ties, as jnp.argmax does;
//   2. stop when that score is not > 0;
//   3. thread 0 writes row t = [x1, y1, x2, y2, conf, cls] from the
//      un-offset box;
//   4. every thread takes the IoU of the selected class-offset box against
//      its own candidates, inter / (sarea + area - inter + 1e-7) in f32, marks
//      those with IoU > iou_thres (and the selected slot) as -1, and folds
//      the survivors into its argmax for step t + 1: one pass over K a step.
// Rows from the last step to max_det are zeroed, and n[b] = the step count,
// which is count(conf > 0) of the output.
//
// Live scores go to a scratch buffer the caller allocates (B, K); each thread
// reads and writes only the slots j = tid (mod blockDim), so the buffer needs
// no barrier of its own, and at K <= 30000 it stays in L2.
//
// Bound: latency, not bytes. The inputs are read once per step through L2,
// about n_det sequential steps, each one block-wide reduction (two
// __syncthreads) plus K IoU evaluations spread over the block. Faster forms
// (a warp per image at small K, persistent blocks, scores in shared memory)
// are later work.
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

__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, v2, i2);
  }
}

__global__ void greedy_nms_kernel(const float4* __restrict__ boxes_off,
                                  const float4* __restrict__ boxes,
                                  const float* __restrict__ scores,
                                  const float* __restrict__ cls,
                                  float* __restrict__ live,
                                  float* __restrict__ out,
                                  int32_t* __restrict__ n_out,
                                  int K, int max_det, float iou_thres) {
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ float sel_v;
  __shared__ int sel_i;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t base = (size_t)b * K;
  const float4* bo = boxes_off + base;
  float* s = live + base;

  float best_v = -INFINITY;
  int best_i = K;
  for (int j = tid; j < K; j += blockDim.x) {
    float v = scores[base + j];
    s[j] = v;
    take_better(best_v, best_i, v, j);
  }

  float* out_b = out + (size_t)b * max_det * 6;
  int t = 0;
  for (; t < max_det; ++t) {
    // block argmax: warps, then warp 0 over the warp winners
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < n_warps ? warp_v[lane] : -INFINITY;
      best_i = lane < n_warps ? warp_i[lane] : K;
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        sel_v = best_v;
        sel_i = best_i;
      }
    }
    __syncthreads();
    const float smax = sel_v;
    const int i = sel_i;
    if (!(smax > 0.0f)) break;  // the same value in every thread

    if (tid == 0) {
      const float4 ob = boxes[base + i];
      float* row = out_b + (size_t)t * 6;
      row[0] = ob.x;
      row[1] = ob.y;
      row[2] = ob.z;
      row[3] = ob.w;
      row[4] = smax;
      row[5] = cls[base + i];
    }
    const float4 sb = bo[i];
    const float sarea = (sb.z - sb.x) * (sb.w - sb.y);
    best_v = -INFINITY;
    best_i = K;
    for (int j = tid; j < K; j += blockDim.x) {
      float v = s[j];
      // a slot at <= 0 can never be selected again (the loop stops first),
      // so it needs no IoU and no write
      if (v > 0.0f) {
        const float4 ob = bo[j];
        const float iw = fmaxf(fminf(sb.z, ob.z) - fmaxf(sb.x, ob.x), 0.0f);
        const float ih = fmaxf(fminf(sb.w, ob.w) - fmaxf(sb.y, ob.y), 0.0f);
        const float inter = iw * ih;
        const float area = (ob.z - ob.x) * (ob.w - ob.y);
        const float iou = inter / (sarea + area - inter + 1e-7f);
        if (j == i || iou > iou_thres) {
          v = -1.0f;
          s[j] = v;
        }
      }
      take_better(best_v, best_i, v, j);
    }
  }

  for (int idx = tid; idx < (max_det - t) * 6; idx += blockDim.x) out_b[(size_t)t * 6 + idx] = 0.0f;
  if (tid == 0) n_out[b] = t;
}

}  // namespace

// All pointers are device pointers on `stream`; boxes are (B, K, 4) f32,
// scores / cls (B, K) f32, live a (B, K) f32 scratch, out (B, max_det, 6) f32,
// n (B,) int32. threads: a multiple of 32, at most 1024. Returns the launch's
// cudaError_t (0 on success).
extern "C" int greedy_nms_launch(const void* boxes_off, const void* boxes, const void* scores,
                                 const void* cls, void* live, void* out, void* n, int B, int K,
                                 int max_det, float iou_thres, int threads, void* stream) {
  greedy_nms_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes_off), static_cast<const float4*>(boxes),
      static_cast<const float*>(scores), static_cast<const float*>(cls), static_cast<float*>(live),
      static_cast<float*>(out), static_cast<int32_t*>(n), K, max_det, iou_thres);
  return static_cast<int>(cudaGetLastError());
}

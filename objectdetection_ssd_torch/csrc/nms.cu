// Greedy-NMS suppression for batches of fixed-size candidate sets (sm_90a).
//
// Replaces the retired Pallas TPU kernel objectdetection_ssd_tpu/infer/
// nms_pallas.py (`_nms_kernel`, `_nms_kernel_multiclass`, launched by
// `greedy_nms_keep` / `greedy_nms_keep_batched`, in git at eb1d1b7).  Its
// live JAX oracle is infer/postprocess.py `greedy_nms_mask` applied to
// ops/boxes.py `pairwise_iou`.
//
// What it computes.  For each (image, class) set of K candidates sorted by
// descending score: the relation "IoU(i, j) >= thr", then the greedy
// recurrence.  Candidate i is kept iff it is valid and no earlier kept
// candidate overlaps it with IoU >= thr; a box never suppresses itself.
//
// Why one triangle is enough.  The IoU expression
//   inter / ((area_i + area_j) - inter)
// is bitwise symmetric in (i, j): min, max, * and + commute exactly in IEEE
// f32.  The JAX recurrence (postprocess.py:69-82) ORs a kept row into the
// whole suppress vector, so it also marks EARLIER boxes; every earlier box
// it can reach is already decided not kept (had it been kept, it would
// have suppressed i by symmetry), so those marks change no output.  Hence
// only pairs j > i are computed, each once.
//
// Arithmetic.  Every step uses the _rn intrinsics and the file is built
// with -fmad=false, without --use_fast_math: the IoU is the same IEEE f32
// expression, in the same operand order, as ops/boxes.py, and the
// threshold arrives as an f32, so the keep mask is bit-equal to the plain
// version's.
//
// Bound on the H100.  Per set the kernel reads K boxes (16 B) and K valid
// flags (1 B) and writes K keep flags: B*20*K*18 bytes in all, 5.9 MB at
// B=256, K=64, i.e. about 1.8 us at 3.35 TB/s.  The pairwise tests are
// K(K-1)/2 * 13 f32 operations per set, about 134 MFLOP there, i.e. 2.0 us
// at 67 TFLOP/s of non-tensor f32, so the two bounds are close.  On top of
// both, the scan is K dependent steps per set.
//
// Design.  One thread block per set (B*20 blocks, enough to fill 132 SMs
// at B >= 8).  The block stages the set's boxes, areas and valid flags in
// shared memory; thread i computes row i of the upper triangle and packs
// it into ceil(K/64) 64-bit words in shared memory, so the K x K relation
// never touches device memory.  One warp then runs the K-step scan over
// the words: lane w holds word w of the "removed" set, the owner lane of
// bit i is read with one shuffle per step, and an active candidate ORs its
// row into the removed words.  K <= 256 (4 words) covers the serving path
// (K = 64) and the exact evaluation path (K = 200).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 256;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Same operand order as ops/boxes.py pairwise_intersection + pairwise_iou.
__device__ __forceinline__ float pair_iou(float4 a, float area_a, float4 b,
                                          float area_b) {
  const float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni);
}

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k,
                                float thr) {
  const int words = (k + 63) / 64;
  // Dynamic shared memory: boxes (16 B) | over rows (8*words B) | areas
  // (4 B) | valid (1 B) | keep (1 B), each K long; 16-byte aligned first.
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  unsigned long long* s_over =
      reinterpret_cast<unsigned long long*>(s_box + k);
  float* s_area = reinterpret_cast<float*>(s_over + k * words);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_area + k);
  uint8_t* s_keep = s_valid + k;

  const size_t set = blockIdx.x;
  const float* b = boxes + set * k * 4;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 v = make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2],
                                 b[4 * i + 3]);
    s_box[i] = v;
    s_area[i] = box_area(v);
    s_valid[i] = valid[set * k + i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    for (int w = 0; w < words; ++w) {
      unsigned long long bits = 0ull;
      const int j1 = min(64 * w + 64, k);
      for (int j = max(64 * w, i + 1); j < j1; ++j) {
        if (pair_iou(bi, ai, s_box[j], s_area[j]) >= thr) {
          bits |= 1ull << (j - 64 * w);
        }
      }
      s_over[i * words + w] = bits;
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long removed = 0ull;   // lane w < words holds word w
    for (int i = 0; i < k; ++i) {
      const unsigned long long owner =
          __shfl_sync(0xffffffffu, removed, i >> 6);
      const bool active = s_valid[i] && !((owner >> (i & 63)) & 1ull);
      if (active && lane < words) removed |= s_over[i * words + lane];
      if (lane == 0) s_keep[i] = active;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    keep[set * k + i] = s_keep[i];
  }
}

}  // namespace

extern "C" {

// boxes (num_sets, k, 4) f32, valid / keep (num_sets, k) bool (1 byte),
// all contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
int ssd_nms_keep(const void* boxes, const void* valid, void* keep,
                 long long num_sets, int k, float thr, void* stream) {
  if (num_sets <= 0 || num_sets > 0x7fffffffLL || k <= 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (k + 63) / 64;
  const int threads = ((k + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(k) * (16 + 8 * words + 4 + 1 + 1);
  nms_keep_kernel<<<static_cast<unsigned>(num_sets), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// Why the valid candidates' upper triangle is enough.  An invalid candidate
// is never active and never kept, so its row is never ORed in and its own
// bit is never read: only pairs among valid candidates can change the
// mask, and the boxes of invalid rows take part in no test.  The IoU
// expression inter / ((area_i + area_j) - inter) is bitwise symmetric in
// (i, j): min, max, * and + commute exactly in IEEE f32.  The JAX
// recurrence (postprocess.py:69-82) ORs a kept row into the whole suppress
// vector, so it also marks EARLIER boxes; every earlier box it can reach is
// already decided not kept (had it been kept, it would have suppressed i by
// symmetry), so those marks change no output.  Hence only pairs j > i of
// valid candidates are computed, each once.
//
// Arithmetic.  Every step uses the _rn intrinsics and the file is built
// with -fmad=false, without --use_fast_math: the IoU is the same IEEE f32
// expression, in the same operand order, as ops/boxes.py, and the
// threshold arrives as an f32, so the keep mask is bit-equal to the plain
// version's.  The two fused multiply-adds of `screen` only ever decide a
// comparison the division would decide the same way.
//
// Bound on the H100, counted from what the inputs need.  The kernel must
// read every valid flag (1 B) and each valid candidate's box (16 B) and
// write every keep flag (1 B); the pairwise tests are n_v(n_v - 1)/2 * 13
// f32 operations per set of n_v valid candidates (67 TFLOP/s outside the
// tensor cores).  On the serving path's inputs (B = 256, 20 classes,
// K = 64, 5.9 valid per set on average in chip_smoke.py's seeded run) the
// bytes bound it, at 0.34 us; counting all K(K-1)/2 pairs of every set
// would give 2.0 us.  On top of either, the scan is one dependent step per kept
// box, and a set's work is one warp's: the largest set sets the time.
//
// Design.
// - One warp per set, kSetsPerBlock sets per 128-thread block, and no
//   block-wide barrier: each set's boxes, areas and row words stay in the
//   warp's slice of shared memory (sized by K; above 48 KB per block the
//   launch raises the kernel's limit), so the K x K relation never reaches
//   device memory.  The kernel is instantiated per 64-bit word count
//   (K <= 64, 128, 192, 256), so that the scan's words stay in registers.
// - Valid candidates only.  The warp stages the valid candidates' boxes
//   (every load in flight at once), compacts them in order with
//   __ballot_sync and __popc prefix counts, and runs the triangle and the
//   scan over the n_v compacted positions; the keep flags are mapped back
//   at the end and are 0 at every invalid position.
// - The triangle by blocks of 32 columns.  Lane t holds column 32 cb + t's
//   box in registers; the warp walks the rows below the block's last
//   column, kRows rows per step: one broadcast load of each row's box and
//   kRows independent IoUs per lane.  A row's ballot over the block is its
//   32-bit word cb, stored once by one lane: no shifts, no read-modify-
//   write, no atomics.  Lanes whose column is not above the row idle (the
//   32 x 32 diagonal blocks, and columns past n_v): 33% of the slots at
//   n_v = 64.  Designs that balanced the pairs exactly over the lanes (a
//   flat walk, 32 pairs per step with a ballot; each lane its own 1/32 of
//   the pairs; folded row pairs, 32 entries per step) spent 2-3x the
//   instructions per pair on index arithmetic and bit placement and were
//   slower on the card (PERF.md).
// - Fewer divisions.  One fused multiply-add against thr and one against
//   the float below it decide most pairs exactly; only IoUs from the float
//   below thr up to thr, and unions that are not positive and finite,
//   take the IEEE division (`screen`).
// - A scan over kept boxes only.  The "available" words (valid, not
//   removed, above the last kept box) live in registers, the same in
//   every lane.  Each step takes the lowest available bit (__ffsll), flags
//   it kept and clears its row's bits and every bit up to it: the serial
//   chain has one step per kept box, not K.  Row i holds only bits j > i,
//   so a box never suppresses itself.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxK = 256;
constexpr int kSetsPerBlock = 4;
constexpr int kThreads = 32 * kSetsPerBlock;
constexpr int kRows = 4;   // rows per step of the triangle
constexpr unsigned kFull = 0xffffffffu;

// One set's slice of shared memory: boxes (16 B) | row words (8 B per
// word) | areas (4 B), K each, then one validity ballot (4 B) per 32
// candidates; 16-byte aligned so that the next set's boxes are.
__host__ __device__ inline int set_bytes(int k, int words) {
  return (k * (16 + 8 * words + 4) + 4 * 2 * words + 15) / 16 * 16;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The IoU's parts in the same operand order as ops/boxes.py
// pairwise_intersection + pairwise_iou, and whether fl(inter / uni) >= thr
// is decided without the division.  Where the union is positive and
// finite, the sign of one fused multiply-add decides most pairs exactly:
// fma rounds once, so it keeps the sign of inter - thr * uni, and
//   inter - thr * uni > 0        =>  inter / uni > thr, fl(q) >= thr;
//   inter - thr_below * uni < 0  =>  inter / uni < thr_below, fl(q) < thr,
// thr_below being the float below thr (rounding is monotone).  What is
// left (q between thr_below and thr, a zero, negative, infinite or NaN
// union, an underflow to 0) is `open` and takes the IEEE division.
__device__ __forceinline__ void screen(float4 a, float area_a, float4 b,
                                       float area_b, float thr,
                                       float thr_below, bool& hit,
                                       bool& open, float& inter,
                                       float& uni) {
  const float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  inter = __fmul_rn(ix, iy);
  uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const bool finite = uni > 0.0f && uni <= FLT_MAX;
  hit = finite && __fmaf_rn(-thr, uni, inter) > 0.0f;
  open = !hit && !(finite && __fmaf_rn(-thr_below, uni, inter) < 0.0f);
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
nms_warp_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, long long num_sets, int k,
                float thr, float thr_below) {
  constexpr int kChunks = 2 * kWords;   // 32-candidate chunks, 32-bit words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long set =
      static_cast<long long>(blockIdx.x) * kSetsPerBlock + warp;
  if (set >= num_sets) return;   // the whole warp leaves together

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem + warp * set_bytes(k, kWords);
  float4* s_box = reinterpret_cast<float4*>(base);
  unsigned long long* s_row =
      reinterpret_cast<unsigned long long*>(s_box + k);
  unsigned* s_row32 = reinterpret_cast<unsigned*>(s_row);
  float* s_area = reinterpret_cast<float*>(s_row + k * kWords);
  unsigned* s_ballot = reinterpret_cast<unsigned*>(s_area + k);

  // 1. The valid candidates' boxes, every load in flight at once, staged
  // at their own positions, then compacted in place and in order.
  const float* b = boxes + set * k * 4;
  const uint8_t* v = valid + set * k;
  const bool vec4 = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  unsigned mine = 0u;   // bit q: candidate 32 q + lane is valid
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int i = 32 * q + lane;
    if (i < k && v[i] != 0) mine |= 1u << q;
  }
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int i = 32 * q + lane;
    if ((mine >> q) & 1u) {
      s_box[i] = vec4 ? __ldg(reinterpret_cast<const float4*>(b) + i)
                      : make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2],
                                    b[4 * i + 3]);
    }
  }
  __syncwarp();
  int n_v = 0;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const bool ok = (mine >> q) & 1u;
    const unsigned m = __ballot_sync(kFull, ok);
    float4 bx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok) bx = s_box[32 * q + lane];
    __syncwarp();   // every read of the chunk before any write
    if (ok) {
      const int pos = n_v + __popc(m & ((1u << lane) - 1u));
      s_box[pos] = bx;
      s_area[pos] = box_area(bx);
    }
    if (lane == 0) s_ballot[q] = m;
    n_v += __popc(m);
    __syncwarp();
  }
  for (int t = lane; t < n_v * kWords; t += 32) s_row[t] = 0ull;
  __syncwarp();

  // 2. The triangle among valid candidates, one block of 32 columns at a
  // time: lane t holds column j = 32 cb + t's box in registers, and the
  // warp walks the rows i that have a column j > i in the block, kRows
  // rows per step (one broadcast load of each row's box, kRows independent
  // IoUs per lane).  A row's ballot over the block is its 32-bit word cb,
  // stored once by one lane; words no row reaches stay 0.
  const int col_blocks = (n_v + 31) >> 5;
  for (int cb = 0; cb < col_blocks; ++cb) {
    const int col = 32 * cb + lane;
    const int col_c = min(col, n_v - 1);
    const float4 box_c = s_box[col_c];
    const float area_c = s_area[col_c];
    const int rows = min(n_v - 1, 32 * cb + 31);
    for (int i0 = 0; i0 < rows; i0 += kRows) {
      bool hit[kRows], open[kRows];
      float inter[kRows], uni[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, rows - 1);
        screen(s_box[i], s_area[i], box_c, area_c, thr, thr_below, hit[r],
               open[r], inter[r], uni[r]);
        const bool in = i0 + r < rows && col > i0 + r && col < n_v;
        hit[r] = hit[r] && in;
        open[r] = open[r] && in;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (open[r]) hit[r] = __fdiv_rn(inter[r], uni[r]) >= thr;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const unsigned h = __ballot_sync(kFull, hit[r]);
        if (lane == r && i0 + r < rows) s_row32[(i0 + r) * kChunks + cb] = h;
      }
    }
  }
  __syncwarp();

  // 3. The scan over kept boxes.  avail: valid, not removed and above the
  // last kept box; the kept flags go to shared memory (over the areas,
  // which are done with).
  uint8_t* s_kept = reinterpret_cast<uint8_t*>(s_area);
  for (int t = lane; t < n_v; t += 32) s_kept[t] = 0;
  unsigned long long avail[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int left = n_v - 64 * w;
    avail[w] = left >= 64 ? ~0ull : left > 0 ? (1ull << left) - 1ull : 0ull;
  }
  __syncwarp();
  for (;;) {
    int i = -1;
#pragma unroll
    for (int w = kWords - 1; w >= 0; --w) {
      if (avail[w] != 0ull) i = 64 * w + __ffsll(avail[w]) - 1;
    }
    if (i < 0) break;
    if (lane == 0) s_kept[i] = 1;
    const unsigned long long* r = s_row + i * kWords;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int below = i + 1 - 64 * w;   // bits of word w at or below i
      const unsigned long long above =
          below <= 0 ? ~0ull : below >= 64 ? 0ull : ~0ull << below;
      avail[w] &= ~r[w] & above;
    }
  }
  __syncwarp();

  // 4. Map the compacted keep flags back; 0 at every invalid position.
  uint8_t* out = keep + set * k;
  int before = 0;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const unsigned m = s_ballot[q];
    const int i = 32 * q + lane;
    if (i < k) {
      out[i] = ((m >> lane) & 1u)
                   ? s_kept[before + __popc(m & ((1u << lane) - 1u))]
                   : static_cast<uint8_t>(0);
    }
    before += __popc(m);
  }
}

template <int kWords>
cudaError_t launch(const void* boxes, const void* valid, void* keep,
                   long long num_sets, int k, float thr,
                   cudaStream_t stream) {
  const int smem = set_bytes(k, kWords) * kSetsPerBlock;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_warp_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (num_sets + kSetsPerBlock - 1) / kSetsPerBlock;
  nms_warp_kernel<kWords><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), num_sets, k, thr,
      std::nextafter(thr, -INFINITY));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes (num_sets, k, 4) f32, valid / keep (num_sets, k) bool (1 byte),
// all contiguous on the current device.  Launches on `stream` and returns
// the CUDA error code (0 when the launch was accepted).
int ssd_nms_keep(const void* boxes, const void* valid, void* keep,
                 long long num_sets, int k, float thr, void* stream) {
  if (num_sets <= 0 || num_sets > 0x7fffffffLL || k <= 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((k + 63) / 64) {
    case 1: err = launch<1>(boxes, valid, keep, num_sets, k, thr, s); break;
    case 2: err = launch<2>(boxes, valid, keep, num_sets, k, thr, s); break;
    case 3: err = launch<3>(boxes, valid, keep, num_sets, k, thr, s); break;
    default: err = launch<4>(boxes, valid, keep, num_sets, k, thr, s);
  }
  return static_cast<int>(err);
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

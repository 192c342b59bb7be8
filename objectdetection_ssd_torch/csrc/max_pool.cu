// K5: a max pool over channels_last maps, without indices (sm_90a).
//
// Replaces no TPU kernel.  The JAX package pools with `lax.reduce_window`
// (models/layers.py:max_pool), which XLA lowers to one pass over the map,
// and pools an int8 map directly.  On the card `F.max_pool2d` runs
// `max_pool2d_with_indices`, which also writes an int64 index for every
// output value and then drops it, and takes no int8, so the port pooled an
// int8 map through f16 (a cast before, a cast after).  This kernel pools
// bf16, f32 and int8 maps in one read of the input and one write of the
// output, and writes no index (models/layers.py:max_pool, the card's
// inference forward).
//
// What it computes.  x is (N, C, H, W) in channels_last memory (NHWC
// bytes, dense); out is (N, C, Ho, Wo), dense channels_last, with Ho and Wo
// from torch's pooling arithmetic (ceil mode included), which the caller
// gives.  out[n, c, oh, ow] is the max of x[n, c, oh * sh - ph + i,
// ow * sw - pw + j] over the taps 0 <= i < kh, 0 <= j < kw that lie inside
// the map, scanned row-major, starting from the dtype's lowest value, each
// tap taken when `v > m || isnan(v)`: the rule and order of torch's CUDA
// kernel (max_pool_forward_nhwc), so a NaN in the window wins, the first
// of +0.0 and -0.0 stays, and the result equals `F.max_pool2d` bit for bit.
// Taps outside the map are skipped; every window holds a real tap (torch's
// output sizes see to it), so that equals torch's -inf padding and JAX's
// INT8_MIN one.  int8 values compare as signed bytes (`__vmaxs4`): the max
// is exact and commutes with the monotone quantization, so it equals the
// f16 round trip it replaces.
//
// Bound on the H100: bytes.  Each input byte read once and each output
// byte written once, against one compare a value per tap: the five pools
// of a batch-256 bf16 SSD300 forward move 7.12 GB, 2.13 ms at 3.35 TB/s.
//
// Design.
// - One thread per 16-byte vector of channels at one output pixel (8 bf16,
//   4 f32 or 16 int8 values).  Consecutive threads take consecutive
//   vectors of a pixel, then the next pixel of the row, so a warp's loads
//   of one tap are contiguous 16-byte runs along C.
// - The window is compiled in, 2x2 or 3x3 (kWin): every tap's load is
//   issued before the first compare, so 4 or 9 vectors are in flight a
//   thread, and a tap outside the map reads as the dtype's lowest value
//   instead (no branch).
// - 2x2 / s2 windows do not overlap: each input byte is read once, and no
//   shared memory is needed.  3x3 windows reread a small map (19x19x512 or
//   112x112x64 per image) through the read-only cache and L2.
// - blockIdx.y is the image, so the index arithmetic inside an image is
//   32-bit (a 64-bit division is a call).
// - Where C is not a multiple of the vector width, a pointer is not
//   16-byte aligned, or the window is another, a scalar kernel does the
//   same per value over a runtime window.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

// The running max of one 32-bit word of the map: one f32, two bf16 (low
// half first, the lower address) or four int8 values.  The scalar kernel
// puts one value in the word's low bytes and keeps those of the result.
template <int D>
struct WordMax;

template <>
struct WordMax<kF32> {
  static constexpr uint32_t kLowest = 0xff800000u;   // -inf
  float m = -INFINITY;
  __device__ __forceinline__ void take(uint32_t w) {
    const float v = __uint_as_float(w);
    if (v > m || isnan(v)) m = v;
  }
  __device__ __forceinline__ uint32_t bits() const {
    return __float_as_uint(m);
  }
};

// A bf16 widens to f32 exactly by a shift (NaN payloads included) and
// narrows back by one, so the compare runs in f32 and the bits survive.
template <>
struct WordMax<kBF16> {
  static constexpr uint32_t kLowest = 0xff80ff80u;   // -inf, -inf
  float lo = -INFINITY, hi = -INFINITY;
  __device__ __forceinline__ void take(uint32_t w) {
    const float a = __uint_as_float(w << 16);
    const float b = __uint_as_float(w & 0xffff0000u);
    if (a > lo || isnan(a)) lo = a;
    if (b > hi || isnan(b)) hi = b;
  }
  __device__ __forceinline__ uint32_t bits() const {
    return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
  }
};

template <>
struct WordMax<kI8> {
  static constexpr uint32_t kLowest = 0x80808080u;   // -128 in every byte
  uint32_t m = kLowest;
  __device__ __forceinline__ void take(uint32_t w) { m = __vmaxs4(m, w); }
  __device__ __forceinline__ uint32_t bits() const { return m; }
};

// One value of the map, as the scalar kernel loads and stores it.
template <int D>
struct Elem;
template <>
struct Elem<kF32> { using Type = uint32_t; };
template <>
struct Elem<kBF16> { using Type = uint16_t; };
template <>
struct Elem<kI8> { using Type = uint8_t; };

struct Geometry {
  int n, h, w;            // input images, rows, columns
  int cv;                 // items per pixel: 16-byte vectors, or values
  int ho, wo;             // output rows, columns
  int kh, kw, sh, sw, ph, pw;
};

// 16-byte vectors: x and out hold g.cv vectors per pixel; the window is
// kWin x kWin.
template <int D, int kWin>
__global__ void __launch_bounds__(kThreads)
    max_pool_vec(const uint4* __restrict__ x, uint4* __restrict__ out,
                 Geometry g) {
  const int items = g.ho * g.wo * g.cv;         // per image
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int c = i % g.cv;
  const int p = i / g.cv;
  const int ow = p % g.wo;
  const int oh = p / g.wo;
  const int h0 = oh * g.sh - g.ph;
  const int w0 = ow * g.sw - g.pw;
  for (int n = blockIdx.y; n < g.n; n += gridDim.y) {
    const uint4* src = x + (long long)n * g.h * g.w * g.cv + c;
    // A tap outside the map reads as the lowest value, which no take
    // keeps: the same as skipping it.
    constexpr uint32_t low = WordMax<D>::kLowest;
    uint4 v[kWin * kWin];
#pragma unroll
    for (int a = 0; a < kWin; ++a) {
#pragma unroll
      for (int b = 0; b < kWin; ++b) {
        const int ih = h0 + a, iw = w0 + b;
        v[a * kWin + b] = ih >= 0 && ih < g.h && iw >= 0 && iw < g.w
                              ? __ldg(src + (ih * g.w + iw) * g.cv)
                              : make_uint4(low, low, low, low);
      }
    }
    WordMax<D> m[4];
#pragma unroll
    for (int t = 0; t < kWin * kWin; ++t) {
      m[0].take(v[t].x);
      m[1].take(v[t].y);
      m[2].take(v[t].z);
      m[3].take(v[t].w);
    }
    out[(long long)n * items + i] =
        make_uint4(m[0].bits(), m[1].bits(), m[2].bits(), m[3].bits());
  }
}

// One value a thread: x and out hold g.cv = C values per pixel.
template <int D>
__global__ void __launch_bounds__(kThreads)
    max_pool_scalar(const typename Elem<D>::Type* __restrict__ x,
                    typename Elem<D>::Type* __restrict__ out, Geometry g) {
  using E = typename Elem<D>::Type;
  const int items = g.ho * g.wo * g.cv;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int c = i % g.cv;
  const int p = i / g.cv;
  const int ow = p % g.wo;
  const int oh = p / g.wo;
  const int h0 = oh * g.sh - g.ph;
  const int w0 = ow * g.sw - g.pw;
  for (int n = blockIdx.y; n < g.n; n += gridDim.y) {
    const E* src = x + (long long)n * g.h * g.w * g.cv + c;
    WordMax<D> m;
    for (int a = 0; a < g.kh; ++a) {
      const int ih = h0 + a;
      if (ih < 0 || ih >= g.h) continue;
      for (int b = 0; b < g.kw; ++b) {
        const int iw = w0 + b;
        if (iw < 0 || iw >= g.w) continue;
        m.take(static_cast<uint32_t>(src[(ih * g.w + iw) * g.cv]));
      }
    }
    out[(long long)n * items + i] = static_cast<E>(m.bits());
  }
}

template <int D>
int launch(const void* x, void* out, Geometry g, cudaStream_t stream) {
  constexpr int kSize = sizeof(typename Elem<D>::Type);
  constexpr int kVec = 16 / kSize;              // values per vector
  const int c = g.cv;
  const int win = g.kh == g.kw && (g.kh == 2 || g.kh == 3) ? g.kh : 0;
  const bool vec = win && c % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) g.cv = c / kVec;
  // The index arithmetic inside an image is 32-bit.
  if ((long long)g.h * g.w * g.cv > INT_MAX ||
      (long long)g.ho * g.wo * g.cv > INT_MAX - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = g.ho * g.wo * g.cv;
  const dim3 grid((items + kThreads - 1) / kThreads,
                  g.n < kMaxGridY ? g.n : kMaxGridY);
  if (!vec) {
    using E = typename Elem<D>::Type;
    max_pool_scalar<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const E*>(x), static_cast<E*>(out), g);
  } else if (win == 2) {
    max_pool_vec<D, 2><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), g);
  } else {
    max_pool_vec<D, 3><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n, c, h, w) and out: (n, c, ho, wo), both dense channels_last (NHWC)
// in one dtype (0 f32, 1 bf16, 2 int8) on the current device; window
// (kh, kw), stride (sh, sw), padding (ph, pw); ho and wo as torch's
// pooling arithmetic gives them, every window holding a tap of the map.
// Launches on `stream` and returns the CUDA error code (0 when the launch
// was accepted; cudaErrorInvalidValue for arguments it does not take).
int ssd_max_pool(const void* x, void* out, int n, int c, int h, int w,
                 int ho, int wo, int kh, int kw, int sh, int sw, int ph,
                 int pw, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || ho <= 0 || wo <= 0 ||
      kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{n, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<kF32>(x, out, g, s);
    case kBF16: return launch<kBF16>(x, out, g, s);
    case kI8: return launch<kI8>(x, out, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

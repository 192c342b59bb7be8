// K4: a conv's bias add and ReLU in one pass over its output (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves a conv's bias add and
// the ReLU after it to XLA, which fuses both into the conv.  On the card
// `aten::_convolution` runs cuDNN without the bias, adds it as a separate
// `add_` of a (1, C, 1, 1) tensor onto the channels_last output (a
// broadcast operand keeps TensorIterator off its vectorized path), and
// `F.relu` reads and writes the whole map once more.  This kernel does both
// in one read and one write of the map (models/layers.py:TorchConv, the
// inference forward of a plain conv with a bias and a ReLU).
//
// What it computes.  y is the bias-free conv output, (N, C, H, W) in
// channels_last memory (NHWC bytes, dense), in bf16 or f32; bias is
// (C,) in y's dtype.  out[i] = relu(y[i] + bias[i % C]): the add in f32,
// rounded once to y's dtype (round to nearest even, `__float2bfloat16_rn`,
// as c10's conversion on sm_80+), then max(v, 0) unless v is NaN, which
// stays NaN.  That is, bit for bit, what `add_` (opmath f32, one rounding)
// followed by `F.relu` (`clamp_min(v, 0)`: NaN kept, else `::max`) gives.
//
// Bound on the H100: bytes.  One read and one write of the map (2 x 2
// bytes per bf16 value) and the bias once, against 2 operations a value:
// at 3.35 TB/s a batch-256 SSD300 forward's 23 maps (12.9 GB of bf16
// output) take 7.7 ms at the least.
//
// Design.
// - 16-byte loads and stores (8 bf16 or 4 f32 values) in a grid-
//   stride loop, kUnroll vectors in flight per thread, the grid sized to
//   fill every SM (kBlocksPerSm blocks of kThreads).  Consecutive threads
//   take consecutive vectors, so a warp moves 512 contiguous bytes.
// - The channel of a vector is its first value's offset modulo C.  With
//   C a multiple of the vector width a vector never straddles two pixels,
//   so its bias values are one 16-byte read through the read-only cache
//   (C values: a few KB, which stay in L1).  The thread keeps its vector's
//   channel and steps it by the grid stride modulo C: no division in the
//   loop, and none in 64 bits at all (a 64-bit remainder is a call, whose
//   saved registers ptxas reports as spills).
// - Where C is not a multiple of the vector width, or a pointer is not
//   16-byte aligned, a scalar grid-stride loop does the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 of_bits(uint32_t v) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(v));
  }
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
};

// relu(round(y + b)), the rounding to T once; NaN passes through.
template <typename T>
__device__ __forceinline__ T bias_relu1(T y, T b) {
  const T sum = Num<T>::from_float(__fadd_rn(Num<T>::to_float(y),
                                             Num<T>::to_float(b)));
  const float v = Num<T>::to_float(sum);
  return isnan(v) ? sum : Num<T>::from_float(fmaxf(v, 0.0f));
}

// One 32-bit word of y with the matching word of the bias: two bf16
// values (low half first, the lower address), or one f32.  Words, not a
// reinterpreted array, so that the vector stays in registers.
template <typename T>
struct Word {
  static __device__ __forceinline__ uint32_t apply(uint32_t y, uint32_t b) {
    const uint32_t lo = Num<T>::bits(bias_relu1(Num<T>::of_bits(y & 0xffffu),
                                                Num<T>::of_bits(b & 0xffffu)));
    const uint32_t hi = Num<T>::bits(bias_relu1(Num<T>::of_bits(y >> 16),
                                                Num<T>::of_bits(b >> 16)));
    return lo | (hi << 16);
  }
};

template <>
struct Word<float> {
  static __device__ __forceinline__ uint32_t apply(uint32_t y, uint32_t b) {
    return __float_as_uint(bias_relu1(__uint_as_float(y), __uint_as_float(b)));
  }
};

// Values per 16-byte vector.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// One vector of y (raw bytes) with the bias of channels c .. c + kVec - 1.
template <typename T>
__device__ __forceinline__ uint4 apply(uint4 x, const T* __restrict__ bias,
                                       int c) {
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(bias + c));
  x.x = Word<T>::apply(x.x, b.x);
  x.y = Word<T>::apply(x.y, b.y);
  x.z = Word<T>::apply(x.z, b.z);
  x.w = Word<T>::apply(x.w, b.w);
  return x;
}

// n_vec vectors of kVec<T> values; C % kVec<T> == 0, every pointer 16-byte
// aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_relu_vec(const T* __restrict__ y, const T* __restrict__ bias,
                  T* __restrict__ out, long long n_vec, int c) {
  constexpr int kN = kVec<T>;
  const int c_vec = c / kN;                     // vectors per pixel
  // 32-bit arithmetic for the channel (a 64-bit remainder is a call).
  const int start = blockIdx.x * kThreads + threadIdx.x;
  const int step = (gridDim.x * kThreads) % c_vec;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = start;
  int ch = start % c_vec;                       // i's channel vector
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 x[kUnroll];
    int chs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = y4[i + u * stride];
      chs[u] = ch;
      ch += step;
      if (ch >= c_vec) ch -= c_vec;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      out4[i + u * stride] = apply(x[u], bias, chs[u] * kN);
    }
  }
  for (; i < n_vec; i += stride) {
    out4[i] = apply(y4[i], bias, ch * kN);
    ch += step;
    if (ch >= c_vec) ch -= c_vec;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_relu_scalar(const T* __restrict__ y, const T* __restrict__ bias,
                     T* __restrict__ out, long long n, int c) {
  const int start = blockIdx.x * kThreads + threadIdx.x;
  const int step = (gridDim.x * kThreads) % c;
  const long long stride = (long long)gridDim.x * kThreads;
  int ch = start % c;
  for (long long i = start; i < n; i += stride) {
    out[i] = bias_relu1(y[i], __ldg(bias + ch));
    ch += step;
    if (ch >= c) ch -= c;
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return sms;
}

template <typename T>
int launch(const void* y, const void* bias, void* out, long long n, int c,
           cudaStream_t stream) {
  constexpr int kN = kVec<T>;
  static const int max_blocks = sm_count() * kBlocksPerSm;
  const bool vec =
      c % kN == 0 && ((reinterpret_cast<uintptr_t>(y) |
                       reinterpret_cast<uintptr_t>(bias) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long items = vec ? n / kN : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  if (vec)
    bias_relu_vec<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(bias),
        static_cast<T*>(out), items, c);
  else
    bias_relu_scalar<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(bias),
        static_cast<T*>(out), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y / out: n values of (N, C, H, W) in channels_last memory (NHWC, dense),
// bias: (C,) values, all of one dtype (0 f32, 1 bf16) on the current
// device; n > 0 and n % c == 0.  Launches on `stream` and returns the CUDA
// error code (0 when the launch was accepted).
int ssd_bias_relu(const void* y, const void* bias, void* out, long long n,
                  int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(y, bias, out, n, c, s);
    case 1: return launch<__nv_bfloat16>(y, bias, out, n, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Filter gradient dW of a 3x3 / stride-1 / pad-1 NHWC convolution (sm_90a).
//
// Replaces the Pallas TPU kernel objectdetection_ssd_tpu/ops/dw_pallas.py
// `dw_conv3x3p1` (body `_dwt_kernel`), the filter gradient of the custom VJP
// `conv3x3p1`.  Its plain PyTorch version is ops/dw_cuda.py
// `dw_conv3x3p1_plain`.
//
// What it computes.  With x (N, H, W, Cin) and g (N, H, W, Cout), f32 or
// bf16, and zero outside the image:
//   dW[ky, kx, ci, co] = sum_{n,h,w} x[n, h+ky-1, w+kx-1, ci] * g[n, h, w, co]
// in f32, as a (9*Cin) x Cout matrix: row m = (ky*3 + kx)*Cin + ci, which is
// the (3, 3, Cin, Cout) layout.  It is a matrix product A^T B whose
// contraction runs over all N*H*W pixels p: A[p, m] is x at the pixel p
// shifted by (ky-1, kx-1), B[p, co] = g[p].
//
// What bounds it on the H100.  At batch 32 in bf16, conv1_2 (300x300,
// 64 -> 64) is 212 GFLOP against 0.74 GB of x and g: 0.21 ms at 989 TFLOP/s
// of bf16 tensor cores and 0.22 ms at 3.35 TB/s, so it sits at the ridge
// and both bounds matter; conv2_x have half the bytes for the same FLOPs.
// In f32 (the card-vs-CPU check) the FMA units bound it.
//
// Design.  The TPU kernel's grid ran in order and accumulated into one
// output block; here blocks run in any order, so the sum over pixels is
// split deterministically:
//   * pass 1, `dw_partial_kernel`: block (tile, chunk) owns a 64 x 64 tile
//     of the (9*Cin) x Cout output and a contiguous chunk of pixels, and
//     writes its f32 partial sum to its own slot of a scratch buffer that
//     the wrapper allocates;
//   * pass 2, `dw_reduce_kernel`: sums the partials of each output in chunk
//     order, so every run gives the same bits.
// A block steps through its chunk 128 pixels at a time (32 in f32).  It
// gathers the A tile (pixels x 64 tap rows) straight from x with the
// pixel's shift, masking to zero what falls outside the image, and the B
// tile (pixels x 64 channels) from g, into shared memory.  Nothing padded is ever written to device
// memory; a pixel chunk need not start at a row, since every element is
// masked by its own (h, w).  The neighbouring tap tiles of one chunk run
// as neighbouring blocks, so x's 9 shifted reads mostly hit L2.  Ragged
// sizes (Cin = 3 gives 27 tap rows; W = 150 or 300; Cout = 7) are masked;
// 16-byte vector loads are used when Cin and Cout allow them.  Products:
//   * bf16: wmma 16x16x16 bf16 fragments with f32 accumulation, 8 warps
//     each holding two 16x16 accumulators of the 64 x 64 tile;
//   * f32: a 4 x 4 register tile per thread, explicit __fmaf_rn (the file
//     is built with -fmad=false, which leaves explicit FMAs alone).
// 36 KB (bf16) or 17 KB (f32) of static shared memory per block, below the
// 48 KB that would need cudaFuncSetAttribute; tile rows are padded by 16
// bytes so that fragment loads are free of bank conflicts.  This is a first, simple
// kernel: no wgmma, no TMA, no pipelining of the loads across steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;        // tap rows (ky, kx, ci) per tile
constexpr int kBN = 64;        // output channels per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kReduceThreads = 256;

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// VEC contiguous elements of T: 16 bytes when VEC > 1, else one element.
template <typename T, int VEC>
struct Pack {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte packs only");
  __device__ __forceinline__ static void copy(T* dst, const T* src) {
    if constexpr (VEC == 1) {
      *dst = *src;
    } else {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    }
  }
  __device__ __forceinline__ static void zero(T* dst) {
    if constexpr (VEC == 1) {
      *dst = zero_value<T>();
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Pixels per step: 128 for bf16, so that each thread keeps 4 16-byte loads
// of each operand in flight between two barriers; 32 for f32, whose 4-byte
// tiles would not fit the 48 KB of static shared memory at 128.  Chunks are
// whole multiples of kChunkAlign pixels, a multiple of both.
template <typename T>
constexpr int kStepPixels = sizeof(T) == 2 ? 128 : 32;
constexpr int kChunkAlign = 128;

// Pass 1.  grid = (tiles_m * tiles_n, chunks), block = 256 threads.
// partial[chunk][m][co] = sum over the chunk's pixels of A[p, m] * g[p, co].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ partial, int height, int width,
                  int cin, int cout, int pixels, int chunk_pixels,
                  int tiles_n) {
  constexpr bool kTensorCores = sizeof(T) == 2;
  constexpr int kBK = kStepPixels<T>;
  // Tile rows are padded by 16 bytes: at the unpadded 128-byte (bf16) or
  // 256-byte (f32) stride, the rows of a fragment load all fall on the
  // same shared-memory banks.
  constexpr int kLd = kBM + 16 / static_cast<int>(sizeof(T));
  constexpr int kTileBytes = kBK * kLd * static_cast<int>(sizeof(T));
  constexpr int kOutBytes = kTensorCores ? kBM * kBN * 4 : 0;
  constexpr int kSmemBytes =
      2 * kTileBytes > kOutBytes ? 2 * kTileBytes : kOutBytes;
  static_assert(kBM == kBN, "A and B tiles share their column layout");
  // A tile [pixel][tap row] and B tile [pixel][out channel]; after the
  // last step the bf16 path reuses the space for its f32 output tile.
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* a_s = reinterpret_cast<T*>(smem);
  T* b_s = reinterpret_cast<T*>(smem + kTileBytes);

  const int tid = threadIdx.x;
  const int m_rows = 9 * cin;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int chunk = blockIdx.y;
  const int p_begin = chunk * chunk_pixels;
  const int p_end = min(p_begin + chunk_pixels, pixels);
  const int hw = height * width;

  // Each thread loads the same VEC columns of every pixel row it touches:
  // decode their tap (dy, dx), channel and bounds once.
  constexpr int kCols = kBM / VEC;                 // vector groups per row
  constexpr int kRowsPerPass = kThreads / kCols;
  constexpr int kPasses = kBK / kRowsPerPass;
  static_assert(kThreads % kCols == 0 && kBK % kRowsPerPass == 0,
                "the tiles split evenly over the threads");
  const int col = (tid % kCols) * VEC;
  const int row0 = tid / kCols;
  const int m = m0 + col;
  const bool a_live = m < m_rows;
  const int tap = a_live ? m / cin : 0;
  const int a_ci = a_live ? m - tap * cin : 0;
  const int a_dy = tap / 3 - 1;
  const int a_dx = tap % 3 - 1;
  const int nn = n0 + col;
  const bool b_live = nn < cout;

  // Accumulators: two wmma fragments per warp (bf16) or a 4 x 4
  // register tile per thread (f32).
  float acc[4][4];
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      frag_c[2];
  const int warp = tid / 32;
  const int frag_m = (warp % 4) * 16;
  const int frag_n = (warp / 4) * 32;
  if constexpr (kTensorCores) {
    nvcuda::wmma::fill_fragment(frag_c[0], 0.0f);
    nvcuda::wmma::fill_fragment(frag_c[1], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
  }
  const int ty = tid / 16;   // f32 register tile: rows 4*ty, cols 4*tx
  const int tx = tid % 16;

  for (int p0 = p_begin; p0 < p_end; p0 += kBK) {
    // A: x at each pixel shifted by the column's tap, zero outside the
    // image; B: g at each pixel.
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int k = row0 + j * kRowsPerPass;
      const int p = p0 + k;
      const bool pixel_in = p < p_end;
      bool in = a_live && pixel_in;
      int src_pixel = 0;
      if (in) {
        const int rem = p % hw;
        const int h = rem / width + a_dy;
        const int w = rem % width + a_dx;
        in = h >= 0 && h < height && w >= 0 && w < width;
        src_pixel = p + a_dy * width + a_dx;
      }
      T* a_dst = a_s + k * kLd + col;
      if (in) {
        Pack<T, VEC>::copy(a_dst,
                           x + static_cast<int64_t>(src_pixel) * cin + a_ci);
      } else {
        Pack<T, VEC>::zero(a_dst);
      }
      T* b_dst = b_s + k * kLd + col;
      if (b_live && pixel_in) {
        Pack<T, VEC>::copy(b_dst, g + static_cast<int64_t>(p) * cout + nn);
      } else {
        Pack<T, VEC>::zero(b_dst);
      }
    }
    __syncthreads();

    if constexpr (kTensorCores) {
      // (A^T)[m, k] sits at a_s[k * kLd + m]: a col-major matrix_a.
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T,
                               nvcuda::wmma::col_major>
            frag_a;
        nvcuda::wmma::load_matrix_sync(frag_a, a_s + kk * kLd + frag_m, kLd);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T,
                                 nvcuda::wmma::row_major>
              frag_b;
          nvcuda::wmma::load_matrix_sync(
              frag_b, b_s + kk * kLd + frag_n + 16 * f, kLd);
          nvcuda::wmma::mma_sync(frag_c[f], frag_a, frag_b, frag_c[f]);
        }
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 av =
            *reinterpret_cast<const float4*>(&a_s[k * kLd + 4 * ty]);
        const float4 bv =
            *reinterpret_cast<const float4*>(&b_s[k * kLd + 4 * tx]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(chunk) * m_rows * cout;
  if constexpr (kTensorCores) {
    // Stage the 64 x 64 f32 tile through shared memory for the masked
    // store.
    float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      nvcuda::wmma::store_matrix_sync(c_s + frag_m * kBN + frag_n + 16 * f,
                                      frag_c[f], kBN,
                                      nvcuda::wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int row = m0 + i / kBN;
      const int co = n0 + i % kBN;
      if (row < m_rows && co < cout) {
        out[static_cast<int64_t>(row) * cout + co] = c_s[i];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + 4 * tx + j;
        if (row < m_rows && co < cout) {
          out[static_cast<int64_t>(row) * cout + co] = acc[i][j];
        }
      }
    }
  }
}

// Pass 2: out[i] = sum over chunks of partial[chunk][i], in chunk order.
__global__ void __launch_bounds__(kReduceThreads)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int64_t outputs, int chunks) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= outputs) return;
  float sum = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    sum = __fadd_rn(sum, partial[static_cast<int64_t>(c) * outputs + i]);
  }
  out[i] = sum;
}

template <typename T, int VEC>
cudaError_t launch_partial(const void* x, const void* g, float* partial,
                           int height, int width, int cin, int cout,
                           int pixels, int chunk_pixels, int chunks,
                           cudaStream_t stream) {
  const int tiles_m = (9 * cin + kBM - 1) / kBM;
  const int tiles_n = (cout + kBN - 1) / kBN;
  dim3 grid(static_cast<unsigned>(tiles_m * tiles_n),
            static_cast<unsigned>(chunks));
  dw_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, height,
      width, cin, cout, pixels, chunk_pixels, tiles_n);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x (n, h, w, cin) and g (n, h, w, cout), contiguous, both f32 (dtype 0) or
// both bf16 (dtype 1); partial (chunks, 9*cin, cout) f32 scratch; out
// (3, 3, cin, cout) f32.  Chunk c covers pixels [c*chunk_pixels,
// (c+1)*chunk_pixels) of the n*h*w; chunk_pixels is a multiple of 128 and
// the chunks cover every pixel.  Launches both passes on `stream` and
// returns cudaGetLastError() (0 when both launches were accepted).
int ssd_dw_conv3x3(const void* x, const void* g, void* partial, void* out,
                   int dtype, long long n, int h, int w, int cin, int cout,
                   int chunk_pixels, int chunks, void* stream) {
  const long long pixels = n * h * w;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      pixels > 0x7fffffffLL - 2 * kChunkAlign ||
      9LL * cin * cout > 0x7fffffffLL || chunk_pixels <= 0 ||
      chunk_pixels % kChunkAlign != 0 ||
      chunk_pixels >= pixels + kChunkAlign || chunks <= 0 ||
      chunks > 65535 ||
      static_cast<long long>(chunks) * chunk_pixels < pixels ||
      static_cast<long long>(chunks - 1) * chunk_pixels >= pixels ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  const int p = static_cast<int>(pixels);
  const bool aligned = aligned16(x) && aligned16(g);
  cudaError_t err;
  if (dtype == 0) {
    err = (aligned && cin % 4 == 0 && cout % 4 == 0)
              ? launch_partial<float, 4>(x, g, part, h, w, cin, cout, p,
                                         chunk_pixels, chunks, s)
              : launch_partial<float, 1>(x, g, part, h, w, cin, cout, p,
                                         chunk_pixels, chunks, s);
  } else {
    err = (aligned && cin % 8 == 0 && cout % 8 == 0)
              ? launch_partial<__nv_bfloat16, 8>(x, g, part, h, w, cin, cout,
                                                 p, chunk_pixels, chunks, s)
              : launch_partial<__nv_bfloat16, 1>(x, g, part, h, w, cin, cout,
                                                 p, chunk_pixels, chunks, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t outputs = 9LL * cin * cout;
  const unsigned blocks =
      static_cast<unsigned>((outputs + kReduceThreads - 1) / kReduceThreads);
  dw_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      part, static_cast<float*>(out), outputs, chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// conv1_1 (Cin = 3) is 10 GFLOP against 0.39 GB: bytes, almost all of g.
// In f32 (the card-vs-CPU check) the FMA units bound it.
//
// Both passes are deterministic.  Blocks run in any order, so pass 1 writes
// each block's f32 partial sum over its chunk of pixels to its own slot of a
// scratch buffer that the wrapper allocates, and pass 2, `dw_reduce_kernel`,
// sums the partials of each output in chunk order: every run gives the same
// bits.  The wrapper (ops/dw_cuda.py `plan`) picks the pass-1 kernel, its
// instantiation and its tiling from the shapes, the dtype and the
// pointers' alignment, and passes them in; the entry points check them
// and launch exactly that.
//
// Pass 1, bf16 with Cin and Cout multiples of 8 and 16-byte aligned x and
// g: `dw_halo_kernel`.  A block owns 64 input channels, 64 output
// channels, all nine taps, and a run of spatial tiles of TH x TW = 4 x 32
// pixels of one image.  Per tile it loads the x halo, (TH+2) x
// (TW+2) pixels x 64 channels, and the g tile, TH x TW pixels x 64
// channels, once, with 16-byte `cp.async.cg`; what lies outside the image
// (or past Cin / Cout) is zero-filled by the copy itself (source size 0),
// so the product loop has no mask.  g is zero outside the image, so a
// ragged tile column adds nothing.  Two stages: tile t+1 loads while tile
// t multiplies.  Tap (ky, kx) reads the halo from pixel (r+ky, c+kx) on: a
// shift is only another start row in shared memory, nothing is copied, and
// x and g cross L2 once per tile instead of once per tap.  Products are
// `ldmatrix.trans` + `mma.sync.m16n8k16` (bf16 in, f32 accumulate): both
// operands sit pixel-major in shared memory, so both are loaded
// transposed.  ldmatrix needs 16-byte aligned rows, which a one-pixel shift
// of the 144-byte rows (64 bf16 + 16 bytes of padding) keeps; wmma's
// 32-byte alignment would not.  The 144-byte stride also spreads the 8
// rows of each 8x8 ldmatrix over all 32 banks, so the loads are free of
// bank conflicts.  12 warps: warp w owns ci half (w % 2), tap row
// ky = (w / 2) % 3 and co half (w / 6), i.e. three taps x 32 ci x 32 co =
// 96 f32 accumulators a thread; per 16-pixel step it loads its g fragment
// once and reuses it for its three taps (8 ldmatrix.x4 for 24 mma).  One
// block of 384 threads and 94 KB of dynamic shared memory per SM (166
// registers, no spills); 64 output channels per block read each halo once
// for twice the products of 32, which measured faster than two blocks of
// 32.  The ci and co tiles of one chunk have neighbouring block indices,
// so x's second read (Cin > 64) hits L2.  Against the bound: at conv1_2
// the tiles move ~1.6 x 369 + 369 MB through L2 (the halo's overhead is
// the 1.6) instead of 9 x (369 + 369) MB, so the products, at mma.sync's
// rate, are what is left.  Not used yet: wgmma and TMA.  wgmma reads its
// operands through a swizzled shared-memory descriptor, whose pattern a
// one-pixel shift of the halo breaks; the way there is one TMA box per tap
// shift (zero-filled out of bounds) in the swizzled layout, later work.
//
// Pass 1, every other case (conv1_1's Cin = 3, ragged channels, f32):
// `dw_partial_kernel`, the tap-gather kernel.  Block (tile, chunk) owns a
// 64 x 64 tile of the (9*Cin) x Cout output and a contiguous chunk of
// pixels, which it steps through 128 pixels at a time (32 in f32).  It
// gathers the A tile (pixels x 64 tap rows) with the pixel's shift and the
// B tile from g into shared memory; chunks need not start at a row, since
// every element is masked by its own (h, w).  x and g each take 16-byte
// vector loads where the plan says so (where the operand's channel count
// and pointer allow).  When all 9*Cin tap rows fit one tile (Cin <= 7,
// conv1_1), a step first copies the three runs of
// x that it touches (rows h-1, h, h+1 of its pixels) contiguously into
// shared memory and decodes each pixel's (h, w) once into a 9-bit mask of
// its valid taps; the tap rows are expanded from there.  Tile rows past
// 9*Cin are zeroed once and not multiplied.  Products:
//   * bf16: wmma 16x16x16 bf16 fragments with f32 accumulation, 8 warps
//     each holding two 16x16 accumulators of the 64 x 64 tile;
//   * f32: a 4 x 4 register tile per thread, explicit __fmaf_rn (the file
//     is built with -fmad=false, which leaves explicit FMAs alone).
// At most 42 KB of static shared memory; tile rows are padded by 16 bytes
// so that fragment loads are free of bank conflicts.  Its loads are not
// pipelined: prefetching the next step into registers measured slower at
// conv1_1 (fewer blocks per SM) and spilled in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;        // tap rows (ky, kx, ci) per tile
constexpr int kBN = 64;        // output channels per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kReduceThreads = 256;
constexpr int kMaxStagedCin = 7;  // 9 * Cin <= kBM: every tap row in one tile

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

// Pass 1, tap gather.  grid = (tiles_m * tiles_n, chunks), block = 256
// threads.  partial[chunk][m][co] = sum over the chunk's pixels of
// A[p, m] * g[p, co].  VEC_A / VEC_B: elements per load of x / g.
// STAGE_X: Cin <= kMaxStagedCin, x is staged in runs (see the header).
template <typename T, int VEC_A, int VEC_B, bool STAGE_X>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ partial, int height, int width,
                  int cin, int cout, int pixels, int chunk_pixels,
                  int tiles_n) {
  static_assert(!STAGE_X || VEC_A == 1, "staged x is expanded per element");
  constexpr bool kTensorCores = sizeof(T) == 2;
  constexpr int kBK = kStepPixels<T>;
  // Tile rows are padded by 16 bytes: at the unpadded 128-byte (bf16) or
  // 256-byte (f32) stride, the rows of a fragment load all fall on the
  // same shared-memory banks.
  constexpr int kLd = kBM + 16 / static_cast<int>(sizeof(T));
  constexpr int kTileBytes = kBK * kLd * static_cast<int>(sizeof(T));
  constexpr int kOutBytes = kTensorCores ? kBM * kBN * 4 : 0;
  constexpr int kMainBytes =
      2 * kTileBytes > kOutBytes ? 2 * kTileBytes : kOutBytes;
  // Staged x: three runs of kBK + 2 pixels of at most kMaxStagedCin
  // channels, and one 9-bit valid-tap mask per pixel of the step.
  constexpr int kRun = kBK + 2;
  constexpr int kStageBytes =
      STAGE_X ? 3 * kRun * kMaxStagedCin * static_cast<int>(sizeof(T)) : 0;
  constexpr int kMaskOffset = (kMainBytes + kStageBytes + 15) / 16 * 16;
  constexpr int kSmemBytes =
      kMaskOffset + (STAGE_X ? kBK * static_cast<int>(sizeof(uint16_t)) : 0);
  static_assert(kBM == kBN, "A and B tiles share their column layout");
  // A tile [pixel][tap row] and B tile [pixel][out channel]; after the
  // last step the bf16 path reuses the space for its f32 output tile.
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* a_s = reinterpret_cast<T*>(smem);
  T* b_s = reinterpret_cast<T*>(smem + kTileBytes);
  T* x_runs = reinterpret_cast<T*>(smem + kMainBytes);
  uint16_t* tap_mask = reinterpret_cast<uint16_t*>(smem + kMaskOffset);

  const int tid = threadIdx.x;
  const int m_rows = 9 * cin;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int chunk = blockIdx.y;
  const int p_begin = chunk * chunk_pixels;
  const int p_end = min(p_begin + chunk_pixels, pixels);
  const int hw = height * width;

  // Each thread loads the same VEC_A columns of every A row and VEC_B
  // columns of every B row it touches: decode their tap, channel and
  // bounds once.
  constexpr int kColsA = kBM / VEC_A;  // vector groups per row
  constexpr int kRowsPerPassA = kThreads / kColsA;
  constexpr int kPassesA = kBK / kRowsPerPassA;
  constexpr int kColsB = kBN / VEC_B;
  constexpr int kRowsPerPassB = kThreads / kColsB;
  constexpr int kPassesB = kBK / kRowsPerPassB;
  static_assert(kThreads % kColsA == 0 && kBK % kRowsPerPassA == 0 &&
                    kThreads % kColsB == 0 && kBK % kRowsPerPassB == 0,
                "the tiles split evenly over the threads");
  const int col_a = (tid % kColsA) * VEC_A;
  const int row0_a = tid / kColsA;
  const int m = m0 + col_a;
  const bool a_live = m < m_rows;
  const int tap = a_live ? m / cin : 0;
  const int a_ci = a_live ? m - tap * cin : 0;
  const int a_dy = tap / 3 - 1;
  const int a_dx = tap % 3 - 1;
  const int col_b = (tid % kColsB) * VEC_B;
  const int row0_b = tid / kColsB;
  const int nn = n0 + col_b;
  const bool b_live = nn < cout;
  const int64_t x_elems = static_cast<int64_t>(pixels) * cin;
  const int run_elems = kRun * cin;

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

  // Tile rows past 9*Cin (37 of conv1_1's 64) add nothing: their A
  // columns are zeroed once, and a warp whose rows all lie there does not
  // multiply.
  const bool rows_live =
      m0 + (kTensorCores ? frag_m : 4 * ty) < m_rows;
  if (!a_live) {
#pragma unroll 4
    for (int j = 0; j < kPassesA; ++j) {
      Pack<T, VEC_A>::zero(a_s + (row0_a + j * kRowsPerPassA) * kLd + col_a);
    }
  }

  for (int p0 = p_begin; p0 < p_end; p0 += kBK) {
    // B: g at each pixel.
#pragma unroll
    for (int j = 0; j < kPassesB; ++j) {
      const int k = row0_b + j * kRowsPerPassB;
      T* b_dst = b_s + k * kLd + col_b;
      if (b_live && p0 + k < p_end) {
        Pack<T, VEC_B>::copy(b_dst,
                             g + static_cast<int64_t>(p0 + k) * cout + nn);
      } else {
        Pack<T, VEC_B>::zero(b_dst);
      }
    }
    if constexpr (STAGE_X) {
      // Run s holds the flat pixels [p0 + (s-1)*W - 1, p0 + (s-1)*W + kBK
      // + 1): pixel p0 + k shifted by (dy, dx) is run dy+1, entry k+dx+1.
      for (int s = 0; s < 3; ++s) {
        const int64_t e0 =
            static_cast<int64_t>(p0 + (s - 1) * width - 1) * cin;
        for (int i = tid; i < run_elems; i += kThreads) {
          const int64_t e = e0 + i;
          x_runs[s * run_elems + i] =
              e >= 0 && e < x_elems ? x[e] : zero_value<T>();
        }
      }
      if (tid < kBK) {
        const int p = p0 + tid;
        unsigned mask = 0;
        if (p < p_end) {
          const int rem = p % hw;
          const int h = rem / width;
          const int w = rem - h * width;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int hh = h + t / 3 - 1;
            const int ww = w + t % 3 - 1;
            if (hh >= 0 && hh < height && ww >= 0 && ww < width) {
              mask |= 1u << t;
            }
          }
        }
        tap_mask[tid] = static_cast<uint16_t>(mask);
      }
    } else if (a_live) {
      // A: x at each pixel shifted by the column's tap, zero outside the
      // image.  Unrolled by 4: fully, ptxas spills the f32 scalar case.
#pragma unroll 4
      for (int j = 0; j < kPassesA; ++j) {
        const int k = row0_a + j * kRowsPerPassA;
        const int p = p0 + k;
        bool in = p < p_end;
        int src_pixel = 0;
        if (in) {
          const int rem = p % hw;
          const int h = rem / width + a_dy;
          const int w = rem % width + a_dx;
          in = h >= 0 && h < height && w >= 0 && w < width;
          src_pixel = p + a_dy * width + a_dx;
        }
        T* a_dst = a_s + k * kLd + col_a;
        if (in) {
          Pack<T, VEC_A>::copy(
              a_dst, x + static_cast<int64_t>(src_pixel) * cin + a_ci);
        } else {
          Pack<T, VEC_A>::zero(a_dst);
        }
      }
    }
    __syncthreads();

    if constexpr (STAGE_X) {
      // A from the runs: tap (dy, dx) of pixel k, where the mask allows.
      if (a_live) {
        const T* run =
            x_runs + (a_dy + 1) * run_elems + (a_dx + 1) * cin + a_ci;
#pragma unroll 4
        for (int j = 0; j < kPassesA; ++j) {
          const int k = row0_a + j * kRowsPerPassA;
          a_s[k * kLd + col_a] =
              tap_mask[k] >> tap & 1u ? run[k * cin] : zero_value<T>();
        }
      }
      __syncthreads();
    }

    if (rows_live) {
      if constexpr (kTensorCores) {
        // (A^T)[m, k] sits at a_s[k * kLd + m]: a col-major matrix_a.
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T,
                                 nvcuda::wmma::col_major>
              frag_a;
          nvcuda::wmma::load_matrix_sync(frag_a, a_s + kk * kLd + frag_m,
                                         kLd);
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

// ---- Pass 1, halo tiles (bf16, Cin and Cout multiples of 8) ----

constexpr int kHaloCi = 64;  // input channels per block
constexpr int kHaloCo = 64;  // output channels per block
// 12 warps: 2 ci halves x 3 tap rows x 2 co halves, each owning 3 taps x
// 32 ci x 32 co.  One block per SM.
constexpr int kHaloThreads = 6 * kHaloCo;
constexpr int kXLd = kHaloCi + 8;  // halo row: 144 bytes
constexpr int kGLd = kHaloCo + 8;  // g tile row: 144 bytes
// The spatial tile: TH x TW = 128 pixels, a 16-pixel step along one row.
constexpr int kTH = 4;
constexpr int kTW = 32;
static_assert(kTW % 16 == 0, "a 16-pixel step runs along a row");
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPx = (kTH + 2) * kHaloW;
constexpr int kHaloPieces = kHaloPx * kHaloCi / 8;  // 16 bytes each
constexpr int kGPieces = kTH * kTW * kHaloCo / 8;
constexpr int kStageBytes =
    (kHaloPx * kXLd + kTH * kTW * kGLd) *
    static_cast<int>(sizeof(__nv_bfloat16));

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 b16 matrices, each transposed: register j of lane l holds
// elements (2*(l%4), l/4) and (2*(l%4)+1, l/4) of matrix j, whose 8 rows
// lanes 8j..8j+7 address.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid = chunks * ci_tiles * co_tiles blocks, block = kHaloThreads, dynamic
// shared memory 2 * kStageBytes.  Block b owns co tile b % co_tiles, ci
// tile (b / co_tiles) % ci_tiles and chunk b / (ci_tiles * co_tiles):
// spatial tiles [chunk * tiles_per_chunk, ...) of the n * tiles_h *
// tiles_w, image-major, then row-major.
__global__ void __launch_bounds__(kHaloThreads, 1)
dw_halo_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ g,
               float* __restrict__ partial, int height, int width, int cin,
               int cout, int tiles_w, int tiles, int tiles_per_chunk,
               int ci_tiles, int co_tiles) {
  constexpr int TH = kTH;
  constexpr int TW = kTW;
  extern __shared__ __align__(128) unsigned char halo_smem[];
  const int tiles_per_image = (height + TH - 1) / TH * tiles_w;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  int b = blockIdx.x;
  const int co0 = (b % co_tiles) * kHaloCo;
  b /= co_tiles;
  const int ci0 = (b % ci_tiles) * kHaloCi;
  const int chunk = b / ci_tiles;
  const int t_begin = chunk * tiles_per_chunk;
  const int count = max(min(tiles_per_chunk, tiles - t_begin), 0);

  // Every thread copies the same 16-byte piece of each pixel it touches
  // (the thread count is a multiple of the pieces per pixel): whether that
  // piece lies past Cin / Cout is fixed for the whole run.
  const int x_piece = tid % (kHaloCi / 8);
  const bool x_live = ci0 + 8 * x_piece < cin;
  const int g_piece = tid % (kHaloCo / 8);
  const bool g_live = co0 + 8 * g_piece < cout;
  static_assert(kHaloThreads % (kHaloCi / 8) == 0 &&
                    kHaloThreads % (kHaloCo / 8) == 0,
                "pieces stay with their thread");
  const __nv_bfloat16* x_base = x + ci0 + 8 * x_piece;
  const __nv_bfloat16* g_base = g + co0 + 8 * g_piece;

  // Start the copies of spatial tile t into stage s.
  auto load_tile = [&](int t, int s) {
    auto* xs = reinterpret_cast<__nv_bfloat16*>(halo_smem +
                                                s * kStageBytes);
    __nv_bfloat16* gs = xs + kHaloPx * kXLd;
    const int img = t / tiles_per_image;
    const int rem = t - img * tiles_per_image;
    const int tr = rem / tiles_w;
    const int h0 = tr * TH;
    const int w0 = (rem - tr * tiles_w) * TW;
    const int64_t img_px = static_cast<int64_t>(img) * height * width;
#pragma unroll
    for (int i0 = 0; i0 < kHaloPieces; i0 += kHaloThreads) {
      const int i = i0 + tid;
      if (kHaloPieces % kHaloThreads == 0 || i < kHaloPieces) {
        const int px = i / (kHaloCi / 8);
        const int hr = px / kHaloW;
        const int h = h0 + hr - 1;
        const int w = w0 + (px - hr * kHaloW) - 1;
        const bool in = x_live && static_cast<unsigned>(h) <
                                      static_cast<unsigned>(height) &&
                        static_cast<unsigned>(w) < static_cast<unsigned>(width);
        const __nv_bfloat16* src =
            in ? x_base + (img_px + h * width + w) * cin : x;
        cp_async16(xs + px * kXLd + 8 * x_piece, src, in);
      }
    }
#pragma unroll
    for (int i0 = 0; i0 < kGPieces; i0 += kHaloThreads) {
      const int i = i0 + tid;
      if (kGPieces % kHaloThreads == 0 || i < kGPieces) {
        const int px = i / (kHaloCo / 8);
        const int h = h0 + px / TW;
        const int w = w0 + px % TW;
        const bool in = g_live && h < height && w < width;
        const __nv_bfloat16* src =
            in ? g_base + (img_px + h * width + w) * cout : g;
        cp_async16(gs + px * kGLd + 8 * g_piece, src, in);
      }
    }
  };

  // Warp roles and the rows / columns each lane addresses in ldmatrix.
  const int ci_half = warp % 2;       // ci 32*ci_half .. 32*ci_half + 31
  const int ky = (warp / 2) % 3;      // taps (ky, 0..2)
  const int co_half = warp / 6;       // co 32*co_half .. 32*co_half + 31
  // A = x^T (m = ci, k = pixel): matrices (k0-7, m0-7), (k0-7, m8-15),
  // (k8-15, m0-7), (k8-15, m8-15) are the fragment's a0..a3.
  const int a_k = lane % 8 + (lane / 16) * 8;
  const int a_m = ci_half * 32 + ((lane / 8) % 2) * 8;
  // B = g (k = pixel, n = co): matrices (k0-7, n0-7), (k8-15, n0-7),
  // (k0-7, n8-15), (k8-15, n8-15) are b0, b1 of two n8 tiles.
  const int b_k = lane % 8 + ((lane / 8) % 2) * 8;
  const int b_n = co_half * 32 + (lane / 16) * 8;

  float acc[3][2][4][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kx][mt][nt][e] = 0.0f;

  if (count > 0) load_tile(t_begin, 0);
  cp_async_commit();
  for (int i = 0; i < count; ++i) {
    if (i + 1 < count) load_tile(t_begin + i + 1, (i + 1) % 2);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(
        halo_smem + (i % 2) * kStageBytes);
    const __nv_bfloat16* gs = xs + kHaloPx * kXLd;
#pragma unroll 2
    for (int r = 0; r < TH; ++r) {
#pragma unroll
      for (int c0 = 0; c0 < TW; c0 += 16) {
        // 16 pixels (r, c0 .. c0+15): the g fragment of the warp's 32 co.
        uint32_t bf[4][2];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t v[4];
          ldmatrix_x4_trans(
              v, gs + (r * TW + c0 + b_k) * kGLd + nb * 16 + b_n);
          bf[2 * nb][0] = v[0];
          bf[2 * nb][1] = v[1];
          bf[2 * nb + 1][0] = v[2];
          bf[2 * nb + 1][1] = v[3];
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // Tap (ky, kx): the same pixels' x at halo (r + ky, c0 + kx).
          const __nv_bfloat16* a_row =
              xs + ((r + ky) * kHaloW + c0 + kx + a_k) * kXLd + a_m;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, a_row + mt * 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_bf16_16816(acc[kx][mt][nt], a, bf[nt][0], bf[nt][1]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // Accumulator element e of lane l: row (l/4) + 8*(e/2), column
  // 2*(l%4) + e%2 of its 16 x 8 tile.
  float* out = partial + static_cast<int64_t>(chunk) * 9 * cin * cout;
  const int row = lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + co_half * 32 + nt * 8 + col;
        const int ci = ci0 + ci_half * 32 + mt * 16 + row;
        if (co >= cout) continue;
        const float* d = acc[kx][mt][nt];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          if (ci + 8 * hi < cin) {
            const int64_t m = static_cast<int64_t>(ky * 3 + kx) * cin + ci +
                              8 * hi;
            *reinterpret_cast<float2*>(out + m * cout + co) =
                make_float2(d[2 * hi], d[2 * hi + 1]);
          }
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

// The tap-gather kernel's arguments, as its launch functions pass them on.
struct GatherArgs {
  const void* x;
  const void* g;
  float* partial;
  int height, width, cin, cout, pixels, chunk_pixels, chunks;
  cudaStream_t stream;
};

template <typename T, int VEC_A, int VEC_B, bool STAGE_X>
cudaError_t launch_partial(const GatherArgs& a) {
  const int tiles_m = (9 * a.cin + kBM - 1) / kBM;
  const int tiles_n = (a.cout + kBN - 1) / kBN;
  dim3 grid(static_cast<unsigned>(tiles_m * tiles_n),
            static_cast<unsigned>(a.chunks));
  dw_partial_kernel<T, VEC_A, VEC_B, STAGE_X>
      <<<grid, kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.partial,
          a.height, a.width, a.cin, a.cout, a.pixels, a.chunk_pixels,
          tiles_n);
  return cudaGetLastError();
}

// The tap-gather instantiation that the plan names: x and g loaded vec_a /
// vec_b elements at a time (1, or V for 16 bytes), x staged in runs when
// `staged`.  bf16 with 16-byte loads of both is the halo kernel's case and
// has no instantiation here.
template <typename T, int V>
cudaError_t launch_gather(const GatherArgs& a, int vec_a, int vec_b,
                          bool staged) {
  const bool wide_b = vec_b == V;
  if (staged) {
    return wide_b ? launch_partial<T, 1, V, true>(a)
                  : launch_partial<T, 1, 1, true>(a);
  }
  if (vec_a == V) {
    if constexpr (sizeof(T) == 2) {
      return wide_b ? cudaErrorInvalidValue
                    : launch_partial<T, V, 1, false>(a);
    } else {
      return wide_b ? launch_partial<T, V, V, false>(a)
                    : launch_partial<T, V, 1, false>(a);
    }
  }
  return wide_b ? launch_partial<T, 1, V, false>(a)
                : launch_partial<T, 1, 1, false>(a);
}

cudaError_t launch_halo(const void* x, const void* g, float* partial,
                        int height, int width, int cin, int cout, int tiles_w,
                        int tiles, int tiles_per_chunk, int ci_tiles,
                        int co_tiles, int blocks, cudaStream_t stream) {
  constexpr int smem = 2 * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      dw_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dw_halo_kernel<<<blocks, kHaloThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), partial, height, width, cin,
      cout, tiles_w, tiles, tiles_per_chunk, ci_tiles, co_tiles);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* partial, void* out, int cin, int cout,
                          int chunks, cudaStream_t s) {
  const int64_t outputs = 9LL * cin * cout;
  const unsigned blocks =
      static_cast<unsigned>((outputs + kReduceThreads - 1) / kReduceThreads);
  dw_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      partial, static_cast<float*>(out), outputs, chunks);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Tap-gather route.  x (n, h, w, cin) and g (n, h, w, cout), contiguous,
// both f32 (dtype 0) or both bf16 (dtype 1); partial (chunks, 9*cin, cout)
// f32 scratch; out (3, 3, cin, cout) f32.  vec_a / vec_b: elements per
// load of x / g, 1 or 16 bytes' worth (4 f32, 8 bf16), which needs the
// channel count to be a multiple and the pointer 16-byte aligned; staged
// (0 or 1): x staged in runs, for cin <= 7 and vec_a 1.  Chunk c covers
// pixels [c*chunk_pixels, (c+1)*chunk_pixels) of the n*h*w; chunk_pixels
// is a multiple of 128 and the chunks cover every pixel.  Launches both
// passes on `stream` and returns cudaGetLastError() (0 when both launches
// were accepted).
int ssd_dw_conv3x3(const void* x, const void* g, void* partial, void* out,
                   int dtype, long long n, int h, int w, int cin, int cout,
                   int vec_a, int vec_b, int staged, int chunk_pixels,
                   int chunks, void* stream) {
  const long long pixels = n * h * w;
  const int v = dtype == 0 ? 4 : 8;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      pixels > 0x7fffffffLL - 2 * kChunkAlign ||
      9LL * cin * cout > 0x7fffffffLL || chunk_pixels <= 0 ||
      chunk_pixels % kChunkAlign != 0 ||
      chunk_pixels >= pixels + kChunkAlign || chunks <= 0 ||
      chunks > 65535 ||
      static_cast<long long>(chunks) * chunk_pixels < pixels ||
      static_cast<long long>(chunks - 1) * chunk_pixels >= pixels ||
      (dtype != 0 && dtype != 1) ||
      !(vec_a == 1 || (vec_a == v && cin % v == 0 && aligned16(x))) ||
      !(vec_b == 1 || (vec_b == v && cout % v == 0 && aligned16(g))) ||
      !(staged == 0 || (staged == 1 && cin <= kMaxStagedCin && vec_a == 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  const GatherArgs a{x, g, part, h, w, cin, cout, static_cast<int>(pixels),
                     chunk_pixels, chunks, s};
  const cudaError_t err =
      dtype == 0
          ? launch_gather<float, 4>(a, vec_a, vec_b, staged == 1)
          : launch_gather<__nv_bfloat16, 8>(a, vec_a, vec_b, staged == 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, out, cin, cout, chunks, s));
}

// Halo-tile route, bf16 only.  x (n, h, w, cin) and g (n, h, w, cout),
// contiguous and 16-byte aligned, cin and cout multiples of 8; partial
// (chunks, 9*cin, cout) f32 scratch; out (3, 3, cin, cout) f32.  Spatial
// tiles are tile_h x tile_w pixels, which must be the 4 x 32 the kernel is
// built for, image-major then row-major; chunk c covers tiles
// [c*tiles_per_chunk, (c+1)*tiles_per_chunk), and the chunks cover every
// tile.  Launches both passes on `stream` and returns the first CUDA error
// (0 on success).
int ssd_dw_conv3x3_halo(const void* x, const void* g, void* partial,
                        void* out, long long n, int h, int w, int cin,
                        int cout, int tile_h, int tile_w,
                        int tiles_per_chunk, int chunks, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 8 != 0 ||
      cout % 8 != 0 || tile_h != kTH || tile_w != kTW ||
      tiles_per_chunk <= 0 || chunks <= 0 ||
      n * h * w > 0x7fffffffLL || 9LL * cin * cout > 0x7fffffffLL ||
      !aligned16(x) || !aligned16(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_w = (w + kTW - 1) / kTW;
  const long long tiles = n * ((h + kTH - 1) / kTH) * tiles_w;
  const long long ci_tiles = (cin + kHaloCi - 1) / kHaloCi;
  const long long co_tiles = (cout + kHaloCo - 1) / kHaloCo;
  const long long blocks = chunks * ci_tiles * co_tiles;
  if (tiles > 0x7fffffffLL - tiles_per_chunk ||
      static_cast<long long>(chunks) * tiles_per_chunk < tiles ||
      static_cast<long long>(chunks - 1) * tiles_per_chunk >= tiles ||
      blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  const cudaError_t err =
      launch_halo(x, g, part, h, w, cin, cout, static_cast<int>(tiles_w),
                  static_cast<int>(tiles), tiles_per_chunk,
                  static_cast<int>(ci_tiles), static_cast<int>(co_tiles),
                  static_cast<int>(blocks), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, out, cin, cout, chunks, s));
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

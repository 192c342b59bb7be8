// int8 x int8 -> int32 convolution with a fused rescale, bias and
// optional requantize epilogue (sm_90a): kernel K3.
//
// Replaces the int8 path of the JAX package's `Int8Conv`
// (objectdetection_ssd_tpu/models/layers.py:114-138): XLA's
// `conv_general_dilated(x_q, w_q, preferred_element_type=int32)` at
// :124-126, then `y * (s_a * s_w) + bias`, rounded to the model's compute
// dtype, and, on a requant-chained edge, `clip(round(y / s_next))` to int8
// (:131-138).  That code is XLA, not Pallas; PyTorch has no int8
// convolution for the card, so the port computes it here.
//
// What it computes, per output pixel m = (n, oh, ow) and channel c:
//   acc    = sum over (r, s, ci) of x[n, oh*st - p + r*d, ow*st - p + s*d, ci]
//            * w[c, r, s, ci], out-of-bounds taps 0, exact in int32
//            (127^2 * K < 2^31 for K = kh*kw*Cin <= 9216);
//   y      = float(acc) * scale[c]  (+ bias[c]), two rounded f32 operations;
//   mode 0 -> y (f32); mode 1 -> bf16(y);
//   mode 2 / 3 -> q = clip(rint(D(y) / out_scale), -127, 127) as int8, where
//            D rounds through the model's dtype first (f32 or bf16), as the
//            unchained graph materializes y before the next conv quantizes.
// x is int8 NHWC (N, H, W, Cin), w int8 (Cout, kh, kw, Cin), the output
// NHWC (N, Ho, Wo, Cout), all contiguous.  Every step is an _rn intrinsic
// or an IEEE operation (the file is built with -fmad=false), so the result
// is bit-equal to the plain PyTorch version (ops/int8_conv.py); the
// requantize's division is replaced where that provably gives the same
// integer (`requantize`, `requantize_tie`).
//
// Bound on the H100.  An implicit GEMM with M = N*Ho*Wo, N = Cout and
// K = kh*kw*Cin: 2*M*Cout*K int8 operations at 1,979 dense TOPS, against
// the bytes of x and w read once and the output written once at 3.35 TB/s.
// SSD300's quantized convs at batch 32 are bound by operations except
// conv1_1, conv1_2 and the small late maps, which the bytes bound.
//
// Design (`mma.sync` s8; `wgmma`, TMA and a producer warp are later work).
// A block owns a BM x BN tile of the (M x Cout) output; warps of WM x WN
// (64 x 32) hold their sums in registers and issue
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`, 16 per 32 bytes of K,
// from fragments loaded by `ldmatrix.x4`: x rows are K-contiguous (the
// row-major A) and w is (Cout, K) (the column-major B), so neither needs
// `.trans`; 6 loads feed 16 products.  Shared rows are padded by 16 bytes,
// which leaves the eight 16-byte rows of each `ldmatrix` phase in distinct
// banks.  The launch plan (tile, path, shared bytes, and for `rows` the
// output tile and the k -> offset table) is made in Python
// (`ops/int8_conv.py:plan`); `ssd_int8_conv` launches exactly the
// instantiation it names, or returns cudaErrorInvalidValue.
// - `vec` (Cin % 16 == 0, 16-byte aligned x and w): every 16 bytes of K lie
//   in one tap, so each thread copies 16-byte runs with `cp.async.cg`
//   (zero-filled for taps outside the image and past M, Cout or K) into a
//   STAGES-deep ring, BK = 64; one `__syncthreads` per K step, with
//   STAGES - 1 steps in flight.  A thread's chunks share one column of K,
//   so its tap (r, s, ci) advances by additions, without a division.
//   128 x 128 tiles, or 256 x 64 where Cout <= 64 (conv1_2).
// - `rows` (any Cin or alignment; conv1_1 and the ResNet-34 stem): a
//   block owns a tile_h x tile_w patch of one image's output, stages once
//   the input rows it reads (zero-padded, 32-bit coalesced loads
//   realigned with a funnel shift) and builds each 32-byte K step of its A
//   tile from them through the plan's k -> offset table (K padded with
//   zeros to 32); B is gathered bytewise from w (a few KB, cached).
// The epilogue is fused, one copy per output mode and bias: each
// accumulator pair is rescaled, biased and rounded in registers; f32 and
// bf16 go out as one 2-element store (float2, bfloat162), masked on the
// ragged M and Cout edges; int8 goes as a char2 into a BM x BN tile in
// shared memory, written out with 16-byte stores.  The requantize
// multiplies by rn(1 / out_scale) and decides exactly, in f64, only the
// elements next to a half integer, where the two may differ, after the
// unrolled loop: an IEEE division per element, or a branch to the exact
// path in the loop, was slower, most on conv1_1 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowPad = 16;         // bytes of padding per shared row
constexpr int kMaxSmem = 232448;    // dynamic shared bytes a block may use

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;       // nullptr: no bias
  const float* out_scale;  // modes 2, 3
  const int* table;        // rows path: kp offsets into the staged rows
  void* out;
  int h, w_in, cin, cout, kh, kw, stride, pad, dil, ho, wo, k, kp;
  long long m;
  int mode;
  // rows path: the output tile, its count per image, the staged window.
  int tile_h, tile_w, tiles_w, tiles, staged_rows, staged_cols, pitch;
};

template <int BM, int BN, int WM, int WN, int STAGES, bool ROWS>
struct Cfg {
  static constexpr int kBK = ROWS ? 32 : 64;
  static constexpr int kLd = kBK + kRowPad;
  static constexpr int kWarpsM = BM / WM;
  static constexpr int kThreads = kWarpsM * (BN / WN) * 32;
  static constexpr int kStageBytes = (BM + BN) * kLd;
  static constexpr int kRingBytes = STAGES * kStageBytes;
  // The ring, then one long long per tile row (its output pixel or -1),
  // then (rows path) the table and the staged rows.
  static constexpr int kFixedBytes = kRingBytes + BM * 8;
  static_assert(WM == 64 && WN % 16 == 0, "warp tile");
  static_assert(!ROWS || STAGES == 2, "the rows path double-buffers");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Margin of the requantize's shortcut: rint(y * rn(1 / so)) is
// rint(rn(y / so)) unless y * rn(1 / so) lies within this of a half
// integer.  For |y / so| <= 127.5 the two quotients differ by at most
// 127.5 * (2^-23 + 2^-24) < 2.3e-5 (each rounding adds 2^-24 relative);
// a larger quotient clips to +-127 either way.
constexpr float kTieMargin = 1.0f / 16384.0f;

// y = float(acc) * sc (+ bc), rounded through bf16 in mode 3.
template <int MODE, bool BIAS>
__device__ __forceinline__ float rescale(int acc, float sc, float bc) {
  float y = __fmul_rn(__int2float_rn(acc), sc);
  if (BIAS) y = __fadd_rn(y, bc);
  if (MODE == 3) y = __bfloat162float(__float2bfloat16_rn(y));
  return y;
}

// The requantize's shortcut: clip(rint(y * rso), -127, 127) with rso =
// rn(1 / so), which is clip(rint(rn(y / so))) except, possibly, where the
// product lies within kTieMargin of a half integer h with |h| < 127: there
// `near` is set.  (Beyond, both clip to the same end.)
__device__ __forceinline__ float requantize(float y, float rso,
                                           bool& near) {
  const float t = __fmul_rn(y, rso);
  const float q = rintf(t);
  near = fabsf(__fsub_rn(t, q)) > 0.5f - kTieMargin && fabsf(t) < 127.0f;
  return fminf(fmaxf(q, -127.0f), 127.0f);
}

// clip(rint(rn(y / so))) exactly, for a `near` element, without the
// division.  With a = |y| and h the half integer next to a * rso (0.5 <=
// h <= 126.5, so h has at most 8 significant bits and an even last
// mantissa bit), rn(a / so) is h exactly when a / so lies between the
// midpoints b_lo = (pred(h) + h) / 2 and b_hi = (h + succ(h)) / 2, ends
// included (a tie goes to h, the even one); above b_hi it is past h,
// below b_lo short of it.  b * so has 25 + 24 bits, so a > b * so is
// decided exactly in f64.  Then rint: h + 0.5, h - 0.5, or rint(h).
__device__ __forceinline__ float requantize_tie(float y, float so,
                                               float rso) {
  const float t = __fmul_rn(fabsf(y), rso);
  const float qa = rintf(t);
  const float h = t > qa ? __fadd_rn(qa, 0.5f) : __fsub_rn(qa, 0.5f);
  const int hb = __float_as_int(h);
  const double hd = static_cast<double>(h);
  const double b_hi = 0.5 * (hd + __int_as_float(hb + 1));
  const double b_lo = 0.5 * (hd + __int_as_float(hb - 1));
  const double a = static_cast<double>(fabsf(y));
  const double sd = static_cast<double>(so);
  float r = rintf(h);
  if (a > b_hi * sd) r = __fadd_rn(h, 0.5f);
  if (a < b_lo * sd) r = __fsub_rn(h, 0.5f);
  return copysignf(r, y);
}

// Stores y0 (channel c) and, if `two`, y1 (channel c + 1) at element o
// of the f32 (MODE 0) or bf16 (MODE 1) output; `pair`: one 2-element
// store (o even).
template <int MODE>
__device__ __forceinline__ void store2(const Params& p, long long o,
                                       float y0, float y1, bool two,
                                       bool pair) {
  if (MODE == 0) {
    float* out = static_cast<float*>(p.out) + o;
    if (pair) {
      *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
    } else {
      out[0] = y0;
      if (two) out[1] = y1;
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
    const __nv_bfloat16 b0 = __float2bfloat16_rn(y0);
    const __nv_bfloat16 b1 = __float2bfloat16_rn(y1);
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(out) = __halves2bfloat162(b0, b1);
    } else {
      out[0] = b0;
      if (two) out[1] = b1;
    }
  }
}

// Copies the block's int8 output tile (BM rows of BN bytes, row pitch
// BN + 16, in shared memory) to its rows of the output: 16-byte stores
// where every row's run is whole 16-byte chunks, else bytewise.
template <int BM, int BN, int NT>
__device__ __forceinline__ void store_int8_tile(const Params& p,
                                                const int8_t* tile,
                                                const long long* row_m,
                                                int n0) {
  constexpr int kLdo = BN + 16;
  int8_t* out = static_cast<int8_t*>(p.out);
  const int cols = min(BN, p.cout - n0);
  if (cols == BN && p.cout % 16 == 0) {
    constexpr int kChunks = BN / 16;
    for (int q = threadIdx.x; q < BM * kChunks; q += NT) {
      const int r = q / kChunks;
      const int c = (q - r * kChunks) * 16;
      const long long m = row_m[r];
      if (m >= 0) {
        *reinterpret_cast<uint4*>(out + m * p.cout + n0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * kLdo + c);
      }
    }
  } else {
    for (int q = threadIdx.x; q < BM * BN; q += NT) {
      const int r = q / BN;
      const int c = q - r * BN;
      const long long m = row_m[r];
      if (m >= 0 && c < cols) out[m * p.cout + n0 + c] = tile[r * kLdo + c];
    }
  }
}

// Elements near a tie a thread notes for `requantize_tie`; with more, it
// redoes its tile by division.
constexpr int kFixSlots = 4;

// The epilogue of one warp tile: accumulator j of tile (mi, ni) is row g
// (+8 for j >= 2), channel 2 * t4 + (j & 1) of that m16n8 tile.  f32 and
// bf16 go out from registers, the two channels in one store where Cout is
// even (the pair's element offset is then even), rows whose `row_m` is -1
// masked; int8 goes, as a char2, into the block's tile in shared memory
// (`store_int8_tile` writes it out), requantized by the shortcut.  An
// element near a tie (common in mode 3, where y keeps only bf16's 8
// significant bits) is noted, y and tile offset, in the thread's slots in
// shared memory (column-major over the block's threads) and rewritten
// after the unrolled loop by `requantize_tie`: a branch to the exact path
// inside the loop would serialize it.  A thread with more than
// kFixSlots such elements redoes its whole tile with EXACT (the IEEE
// division).
template <int MODE, bool BIAS, bool EXACT, int BN, int NT, int kMI, int kNI>
__device__ __forceinline__ void epilogue(const Params& p,
                                         const int (&acc)[kMI][kNI][4],
                                         const long long* row_m, int n0,
                                         int wm, int wn, int lane,
                                         int8_t* tile, float* fix_y,
                                         int* fix_o) {
  int nfix = 0;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float so = MODE >= 2 ? *p.out_scale : 1.0f;
  const float rso = __frcp_rn(so);
  const bool even = (p.cout & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int c = n0 + wn + ni * 8 + t4 * 2;
    if (c >= p.cout) continue;
    const bool two = c + 1 < p.cout;
    const float sc[2] = {p.scale[c], two ? p.scale[c + 1] : 0.0f};
    const float bc[2] = {BIAS ? p.bias[c] : 0.0f,
                         BIAS && two ? p.bias[c + 1] : 0.0f};
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int jr = 0; jr < 2; ++jr) {
        const int row = wm + mi * 16 + g + jr * 8;
        float y[2];
#pragma unroll
        for (int jc = 0; jc < 2; ++jc) {
          y[jc] = rescale<MODE, BIAS>(acc[mi][ni][jr * 2 + jc], sc[jc],
                                      bc[jc]);
          if (MODE >= 2) {
            if (EXACT) {
              y[jc] = fminf(fmaxf(rintf(__fdiv_rn(y[jc], so)), -127.0f),
                            127.0f);
            } else {
              bool near;
              const float yr = y[jc];
              y[jc] = requantize(yr, rso, near);
              if (near) {
                if (nfix < kFixSlots) {
                  fix_y[nfix * NT + threadIdx.x] = yr;
                  fix_o[nfix * NT + threadIdx.x] =
                      row * (BN + 16) + (c - n0) + jc;
                }
                ++nfix;
              }
            }
          }
        }
        if (MODE >= 2) {
          *reinterpret_cast<char2*>(tile + row * (BN + 16) + (c - n0)) =
              make_char2(static_cast<signed char>(__float2int_rn(y[0])),
                         static_cast<signed char>(__float2int_rn(y[1])));
        } else {
          const long long m = row_m[row];
          if (m >= 0) {
            store2<MODE>(p, m * p.cout + c, y[0], y[1], two, two && even);
          }
        }
      }
    }
  }
  if (MODE >= 2 && !EXACT && nfix > 0) {
    if (nfix <= kFixSlots) {  // a rolled loop keeps the code small
#pragma unroll 1
      for (int i = 0; i < nfix; ++i) {
        tile[fix_o[i * NT + threadIdx.x]] = static_cast<int8_t>(
            __float2int_rn(requantize_tie(fix_y[i * NT + threadIdx.x], so,
                                          rso)));
      }
    } else {
      epilogue<MODE, BIAS, true, BN, NT>(p, acc, row_m, n0, wm, wn, lane,
                                         tile, fix_y, fix_o);
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, bool ROWS>
__global__ void __launch_bounds__(
    (Cfg<BM, BN, WM, WN, STAGES, ROWS>::kThreads))
    int8_conv_kernel(const Params p) {
  using C = Cfg<BM, BN, WM, WN, STAGES, ROWS>;
  constexpr int kBK = C::kBK;
  constexpr int kLd = C::kLd;
  constexpr int kNT = C::kThreads;
  constexpr int kMI = WM / 16;
  constexpr int kNI = WN / 8;
  extern __shared__ __align__(16) int8_t smem[];
  long long* row_m = reinterpret_cast<long long*>(smem + C::kRingBytes);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int num_k_tiles = (p.k + kBK - 1) / kBK;

  // The block's output pixels: a run of M (vec), or a tile_h x tile_w
  // patch of image `img` at (oh0, ow0) (rows).
  long long m0 = 0;
  int img = 0, oh0 = 0, ow0 = 0;
  if constexpr (ROWS) {
    img = blockIdx.x / p.tiles;
    const int t = blockIdx.x - img * p.tiles;
    const int th = t / p.tiles_w;
    oh0 = th * p.tile_h;
    ow0 = (t - th * p.tiles_w) * p.tile_w;
  } else {
    m0 = static_cast<long long>(blockIdx.x) * BM;
  }
  for (int r = tid; r < BM; r += kNT) {
    long long m = -1;
    if constexpr (ROWS) {
      const int th = r / p.tile_w;
      const int oh = oh0 + th;
      const int ow = ow0 + r - th * p.tile_w;
      if (th < p.tile_h && oh < p.ho && ow < p.wo) {
        m = (static_cast<long long>(img) * p.ho + oh) * p.wo + ow;
      }
    } else if (m0 + r < p.m) {
      m = m0 + r;
    }
    row_m[r] = m;
  }

  // Warp tile WM x WN at (wm, wn): kMI x kNI tiles of m16n8.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp % C::kWarpsM) * WM;
  const int wn = (warp / C::kWarpsM) * WN;
  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  // ldmatrix.x4 addresses.  A: matrices (rows 0-7 | 8-15) x (bytes 0-15 |
  // 16-31) give a0..a3; lane l points at row l % 16, byte 16 * (l / 16).
  // B: matrices (n 0-7, bytes 0-15 | 16-31), then n 8-15, give b0, b1 of
  // two n8 tiles; lane l points at n 8 * (l / 16) + l % 8, byte
  // 16 * ((l / 8) % 2).
  const int a_lane = (wm + (lane & 15)) * kLd + (lane >> 4) * 16;
  const int b_lane = (BM + wn + ((lane >> 4) << 3) + (lane & 7)) * kLd +
                     ((lane >> 3) & 1) * 16;
  auto compute = [&](const int8_t* stage) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMI][4], b[kNI / 2][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        ldmatrix_x4(a[mi], stage + a_lane + mi * 16 * kLd + kk);
      }
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        ldmatrix_x4(b[nj], stage + b_lane + nj * 16 * kLd + kk);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni / 2][(ni & 1) * 2],
                 b[ni / 2][(ni & 1) * 2 + 1]);
    }
  };

  if constexpr (!ROWS) {
    // Loader: 16-byte chunks, kBK / 16 per row; a thread owns chunk
    // column kc of rows lrow + i * kRowStep of the A and of the B tile.
    constexpr int kCPR = kBK / 16;
    constexpr int kRowStep = kNT / kCPR;
    constexpr int kAR = BM / kRowStep;
    constexpr int kBR = BN / kRowStep;
    static_assert(BM % kRowStep == 0 && BN % kRowStep == 0, "loader");
    const int kc = tid % kCPR;
    const int lrow = tid / kCPR;
    long long a_off[kAR];  // x offset of the pixel's (h0, w0) corner
    int a_h0[kAR], a_w0[kAR];
    const long long hw = static_cast<long long>(p.ho) * p.wo;
#pragma unroll
    for (int i = 0; i < kAR; ++i) {
      const long long m = m0 + lrow + i * kRowStep;
      a_off[i] = 0;
      a_h0[i] = -(1 << 29);  // past M: every tap fails the bounds test
      a_w0[i] = 0;
      if (m < p.m) {
        const long long n = m / hw;
        const int rem = static_cast<int>(m - n * hw);
        const int oh = rem / p.wo;
        a_h0[i] = oh * p.stride - p.pad;
        a_w0[i] = (rem - oh * p.wo) * p.stride - p.pad;
        a_off[i] = ((n * p.h + a_h0[i]) * p.w_in + a_w0[i]) *
                   static_cast<long long>(p.cin);
      }
    }
    // The thread's column of K and its tap, advanced by kBK per load.
    int k = kc * 16;
    int ci = k % p.cin;
    int r = (k / p.cin) / p.kw;
    int s = (k / p.cin) - r * p.kw;

    auto load = [&](int stage) {
      int8_t* a_s = smem + stage * C::kStageBytes;
      int8_t* b_s = a_s + BM * kLd;
      const bool k_ok = r < p.kh;
      const int rd = r * p.dil;
      const int sd = s * p.dil;
      const int tap = (rd * p.w_in + sd) * p.cin + ci;
#pragma unroll
      for (int i = 0; i < kAR; ++i) {
        const bool ok = k_ok &&
                        static_cast<unsigned>(a_h0[i] + rd) <
                            static_cast<unsigned>(p.h) &&
                        static_cast<unsigned>(a_w0[i] + sd) <
                            static_cast<unsigned>(p.w_in);
        cp_async16(a_s + (lrow + i * kRowStep) * kLd + kc * 16,
                   ok ? p.x + a_off[i] + tap : p.x, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < kBR; ++i) {
        const int co = n0 + lrow + i * kRowStep;
        const bool ok = k_ok && co < p.cout;
        cp_async16(b_s + (lrow + i * kRowStep) * kLd + kc * 16,
                   ok ? p.w + static_cast<long long>(co) * p.k + k : p.w,
                   ok ? 16 : 0);
      }
      k += kBK;
      ci += kBK;
      while (ci >= p.cin) {
        ci -= p.cin;
        if (++s == p.kw) {
          s = 0;
          ++r;
        }
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < num_k_tiles) load(st);
      cp_async_commit();
    }
    for (int kt = 0; kt < num_k_tiles; ++kt) {
      cp_async_wait<STAGES - 2>();  // step kt's group has landed
      __syncthreads();              // ... for every thread; and step
                                    // kt - 1's stage is free again
      const int pre = kt + STAGES - 1;
      if (pre < num_k_tiles) load(pre % STAGES);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      compute(smem + (kt % STAGES) * C::kStageBytes);
    }
    cp_async_wait<0>();
  } else {
    // Stage the rows: staged_rows input rows from hs, staged_cols pixels
    // from ws, each row `pitch` bytes; bytes outside the image (or past
    // the window) are 0.  A 32-bit word of a staged row is read as the
    // aligned global word(s) it spans, realigned by a funnel shift.
    int* table = reinterpret_cast<int*>(smem + C::kFixedBytes);
    int8_t* staged = reinterpret_cast<int8_t*>(table + p.kp);
    for (int i = tid; i < p.kp; i += kNT) table[i] = p.table[i];
    const int hs = oh0 * p.stride - p.pad;
    const int ws = ow0 * p.stride - p.pad;
    const int lo_col = max(ws, 0);
    const int hi_col = min(ws + p.staged_cols, p.w_in);
    const int words = p.pitch / 4;
    const uintptr_t xa = reinterpret_cast<uintptr_t>(p.x);
    for (int idx = tid; idx < p.staged_rows * words; idx += kNT) {
      const int rr = idx / words;
      const int j = idx - rr * words;
      const int hi = hs + rr;
      uint32_t v = 0u;
      if (static_cast<unsigned>(hi) < static_cast<unsigned>(p.h) &&
          lo_col < hi_col) {
        const long long row = (static_cast<long long>(img) * p.h + hi) *
                              p.w_in;
        const long long g = (row + ws) * p.cin + 4 * j;
        const long long ga = (row + lo_col) * p.cin;
        const long long gb = (row + hi_col) * p.cin;
        if (g < gb && g + 4 > ga) {
          const uintptr_t addr = xa + static_cast<uintptr_t>(g);
          const int d = static_cast<int>(addr & 3);
          const uintptr_t w0 = addr - d;
          const uintptr_t va = xa + static_cast<uintptr_t>(ga);
          const uintptr_t vb = xa + static_cast<uintptr_t>(gb);
          const uint32_t lo =
              (w0 < vb && w0 + 4 > va)
                  ? __ldg(reinterpret_cast<const unsigned*>(w0))
                  : 0u;
          const uint32_t up =
              (d != 0 && w0 + 4 < vb && w0 + 8 > va)
                  ? __ldg(reinterpret_cast<const unsigned*>(w0 + 4))
                  : 0u;
          v = __funnelshift_r(lo, up, 8 * d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (g + e < ga || g + e >= gb) v &= ~(0xffu << (8 * e));
          }
        }
      }
      *reinterpret_cast<uint32_t*>(staged + rr * p.pitch + 4 * j) = v;
    }

    // The A tile, in 16-byte chunks (kBK / 16 per row): the pixel's offset in
    // the staged rows plus the table's offset of each k.
    constexpr int kAC = BM * (kBK / 16) / kNT;
    static_assert(BM * (kBK / 16) % kNT == 0, "A tile chunks");
    int pix[kAC];
#pragma unroll
    for (int i = 0; i < kAC; ++i) {
      const int row = (tid + i * kNT) / (kBK / 16);
      const int th = row / p.tile_w;
      const int tw = row - th * p.tile_w;
      pix[i] = th < p.tile_h
                   ? th * p.stride * p.pitch + tw * p.stride * p.cin
                   : 0;
    }
    __syncthreads();

    auto build = [&](int kt, int8_t* a_s) {
#pragma unroll
      for (int i = 0; i < kAC; ++i) {
        const int q = tid + i * kNT;
        const int row = q / (kBK / 16);
        const int c16 = q % (kBK / 16);
        const int k0 = kt * kBK + c16 * 16;
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int o = table[k0 + e];
          const uint32_t v =
              o >= 0 ? static_cast<uint8_t>(staged[pix[i] + o]) : 0u;
          wd[e / 4] |= v << (8 * (e % 4));
        }
        *reinterpret_cast<uint4*>(a_s + row * kLd + c16 * 16) =
            make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
      // B: 8-byte chunks of w rows, bytewise (rows of K bytes need not be
      // aligned).
      int8_t* b_s = a_s + BM * kLd;
      for (int q = tid; q < BN * (kBK / 8); q += kNT) {
        const int row = q / (kBK / 8);
        const int c8 = q % (kBK / 8);
        const int co = n0 + row;
        const int k0 = kt * kBK + c8 * 8;
        uint32_t wd[2] = {0u, 0u};
        if (co < p.cout) {
          const int8_t* src = p.w + static_cast<long long>(co) * p.k;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (k0 + e < p.k) {
              wd[e / 4] |= static_cast<uint32_t>(
                               static_cast<uint8_t>(src[k0 + e]))
                           << (8 * (e % 4));
            }
          }
        }
        *reinterpret_cast<uint2*>(b_s + row * kLd + c8 * 8) =
            make_uint2(wd[0], wd[1]);
      }
    };

    // Two buffers, one barrier per step: step kt + 2 rebuilds buffer
    // kt % 2 only after every thread passed step kt + 1's barrier, which
    // follows its products of step kt.
    for (int kt = 0; kt < num_k_tiles; ++kt) {
      int8_t* stage = smem + (kt & 1) * C::kStageBytes;
      build(kt, stage);
      __syncthreads();
      compute(stage);
    }
  }

  // The fused epilogue, one copy per output mode and bias.  The int8
  // tile and the tie slots reuse the ring once every warp is done with it.
  static_assert(BM * (BN + 16) + kFixSlots * kNT * 8 <= C::kRingBytes,
                "int8 output tile");
  int8_t* tile = smem;
  float* fix_y = reinterpret_cast<float*>(smem + BM * (BN + 16));
  int* fix_o = reinterpret_cast<int*>(fix_y + kFixSlots * kNT);
  if (p.mode >= 2) __syncthreads();
  switch (p.mode * 2 + (p.bias != nullptr ? 1 : 0)) {
#define K3_EPILOGUE(MODE, BIAS)                                          \
  case 2 * MODE + BIAS:                                                  \
    epilogue<MODE, BIAS, false, BN, kNT>(p, acc, row_m, n0, wm, wn, lane, \
                                         tile, fix_y, fix_o);             \
    break;
    K3_EPILOGUE(0, false)
    K3_EPILOGUE(0, true)
    K3_EPILOGUE(1, false)
    K3_EPILOGUE(1, true)
    K3_EPILOGUE(2, false)
    K3_EPILOGUE(2, true)
    K3_EPILOGUE(3, false)
    K3_EPILOGUE(3, true)
#undef K3_EPILOGUE
  }
  if (p.mode >= 2) {
    __syncthreads();
    store_int8_tile<BM, BN, kNT>(p, tile, row_m, n0);
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, bool ROWS>
cudaError_t launch(const Params& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  using C = Cfg<BM, BN, WM, WN, STAGES, ROWS>;
  auto kernel = int8_conv_kernel<BM, BN, WM, WN, STAGES, ROWS>;
  // Opt in to more than 48 KB of dynamic shared memory, once per device.
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  kernel<<<grid, C::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instantiations: path (0 vec, 1 rows), BM, BN, WM, WN, STAGES.  The
// plan in ops/int8_conv.py (TILES) names one of these.
#define K3_TILES(X)            \
  X(0, 128, 128, 64, 32, 4)    \
  X(0, 256, 64, 64, 32, 4)     \
  X(1, 256, 64, 64, 32, 2)

}  // namespace

extern "C" {

// x int8 (n, h, w, cin), w int8 (cout, kh, kw, cin), scale f32 (cout),
// bias f32 (cout) or null, out_scale f32 scalar (modes 2, 3) or null,
// table int32 (kp) (rows path) or null, out (n, ho, wo, cout): f32 (mode
// 0), bf16 (mode 1), int8 (modes 2: y in f32, 3: y rounded through bf16).
// The plan: path (0 vec: cin % 16 == 0 and 16-byte aligned x and w; 1
// rows), the block tile bm x bn of warps wm x wn, stages, the rows path's
// output tile tile_h x tile_w, and the dynamic shared bytes, which must be
// what this instantiation needs.  All contiguous on the current device;
// launches on `stream` and returns the CUDA error code.
int ssd_int8_conv(const void* x, const void* w, const void* scale,
                  const void* bias, const void* out_scale, const void* table,
                  void* out, int n, int h, int w_in, int cin, int cout, int kh,
                  int kw, int stride, int pad, int dil, int ho, int wo,
                  int mode, int path, int bm, int bn, int wm, int wn,
                  int stages, int tile_h, int tile_w, int smem,
                  void* stream) {
  const long long k = static_cast<long long>(kh) * kw * cin;
  const long long m = static_cast<long long>(n) * ho * wo;
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || cout <= 0 || ho <= 0 ||
      wo <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 || dil <= 0 ||
      k * 127 * 127 > 0x7fffffffLL || mode < 0 || mode > 3 ||
      (mode >= 2 && out_scale == nullptr) || bm <= 0 || bn <= 0 ||
      (cout + bn - 1) / bn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out_scale = static_cast<const float*>(out_scale);
  p.table = static_cast<const int*>(table);
  p.out = out;
  p.h = h;
  p.w_in = w_in;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.dil = dil;
  p.ho = ho;
  p.wo = wo;
  p.k = static_cast<int>(k);
  p.m = m;
  p.mode = mode;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  long long blocks = 0;
  int want = 0;
  if (path == 0) {
    if (cin % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 || tile_h != 0 ||
        tile_w != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.kp = static_cast<int>((k + 63) / 64 * 64);
    p.tiles_w = p.tiles = p.staged_rows = p.staged_cols = p.pitch = 0;
    blocks = (m + bm - 1) / bm;
    want = stages * (bm + bn) * (64 + kRowPad) + bm * 8;
  } else if (path == 1) {
    if (table == nullptr || tile_h <= 0 || tile_w <= 0 ||
        static_cast<long long>(tile_h) * tile_w > bm) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.kp = static_cast<int>((k + 31) / 32 * 32);
    p.tiles_w = (wo + tile_w - 1) / tile_w;
    p.tiles = (ho + tile_h - 1) / tile_h * p.tiles_w;
    p.staged_rows = (tile_h - 1) * stride + (kh - 1) * dil + 1;
    p.staged_cols = (tile_w - 1) * stride + (kw - 1) * dil + 1;
    const long long pitch = (static_cast<long long>(p.staged_cols) * cin +
                             3) / 4 * 4;
    if (pitch * p.staged_rows > kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.pitch = static_cast<int>(pitch);
    blocks = static_cast<long long>(n) * p.tiles;
    want = stages * (bm + bn) * (32 + kRowPad) + bm * 8 + p.kp * 4 +
           p.staged_rows * p.pitch;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem != want || want > kMaxSmem || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((cout + bn - 1) / bn));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_DISPATCH(P, BM, BN, WM, WN, ST)                                 \
  if (path == P && bm == BM && bn == BN && wm == WM && wn == WN &&          \
      stages == ST) {                                                       \
    return static_cast<int>(launch<BM, BN, WM, WN, ST, P == 1>(p, grid,    \
                                                               smem, s));  \
  }
  K3_TILES(K3_DISPATCH)
#undef K3_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// is bit-equal to the plain PyTorch version (ops/int8_conv.py).
//
// Bound on the H100.  An implicit GEMM with M = N*Ho*Wo, N = Cout and
// K = kh*kw*Cin: 2*M*Cout*K int8 operations at 1,979 dense TOPS, against
// the bytes of x and w read once and the output written once at 3.35 TB/s.
// SSD300's quantized convs at batch 32 are bound by operations (conv1_2:
// 1.9 TOP, ~1 ms) except the small late maps and the 1x1 convs, which the
// bytes bound.
//
// Design (the first one: simple and right; `wgmma` s8, TMA and a
// persistent schedule are later work).  A block owns a 128 x 64 tile of
// the (M x Cout) output, 8 warps of 32 x 32 each, and walks K in steps of
// kBK bytes.  Each step stages the x tile (gathered through the conv
// geometry) and the w tile in shared memory, rows padded by 16 bytes so
// that the fragment loads are free of bank conflicts, then issues
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (8 per warp per 32
// bytes of K) into int32 accumulators held in registers.
// - Vector path (Cin % 16 == 0, 16-byte aligned tensors): every 16 bytes
//   of K lie in one tap, so each thread copies 16-byte runs with
//   `cp.async` (zero-filled when the tap falls outside the image or past
//   M, Cout or K), double-buffered so the next step's loads overlap this
//   step's products.  kBK = 64.
// - Gather path (any other Cin, e.g. 3 for conv1_1 and the ResNet stem):
//   bytes are gathered one by one into registers and stored as words;
//   K is padded with zeros in shared memory, not in a copy of the input.
//   kBK = 32 (K = 27 for conv1_1).
// The epilogue is fused: each accumulator is rescaled, biased, rounded and
// stored from registers, masked on the ragged M and Cout edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along Cout
constexpr int kRowPad = 16;    // bytes of padding per shared-memory row

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;       // nullptr: no bias
  const float* out_scale;  // modes 2, 3
  void* out;
  int h, w_in, cin, cout, kh, kw, stride, pad, dil, ho, wo, k;
  long long m;
  int mode;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output pixel's place in the input: image offset and the top-left
// corner of its receptive field (before dilation).
struct Pixel {
  long long base;  // n * H * W * Cin
  int h0, w0;
  bool valid;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, long long m) {
  Pixel px;
  px.valid = m < p.m;
  if (!px.valid) m = 0;
  const long long hw = static_cast<long long>(p.ho) * p.wo;
  const long long n = m / hw;
  const int rem = static_cast<int>(m - n * hw);
  const int oh = rem / p.wo;
  const int ow = rem - oh * p.wo;
  px.base = n * p.h * p.w_in * static_cast<long long>(p.cin);
  px.h0 = oh * p.stride - p.pad;
  px.w0 = ow * p.stride - p.pad;
  return px;
}

// Offset of x[pixel, tap of k, ci of k] in bytes, or -1 outside the image.
__device__ __forceinline__ long long x_offset(const Params& p,
                                              const Pixel& px, int k) {
  const int tap = k / p.cin;
  const int ci = k - tap * p.cin;
  const int r = tap / p.kw;
  const int s = tap - r * p.kw;
  const int hi = px.h0 + r * p.dil;
  const int wi = px.w0 + s * p.dil;
  if (hi < 0 || hi >= p.h || wi < 0 || wi >= p.w_in) return -1;
  return px.base + (static_cast<long long>(hi) * p.w_in + wi) * p.cin + ci;
}

template <int kBK, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Params p) {
  constexpr int kLd = kBK + kRowPad;
  constexpr int kStages = kVec ? 2 : 1;
  __shared__ __align__(16) int8_t a_s[kStages][kBM][kLd];
  __shared__ __align__(16) int8_t b_s[kStages][kBN][kLd];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int num_k_tiles = (p.k + kBK - 1) / kBK;

  // Loader roles.  Vector path: 16-byte chunks, kBK / 16 = 4 per row; a
  // thread owns chunk column kc of rows a_row and a_row + 64 (x) and of
  // row a_row (w).  Gather path: a thread owns 16 bytes of one x row and
  // 8 bytes of one w row.
  constexpr int kChunksPerRow = kBK / 16;
  static_assert(!kVec || kThreads / kChunksPerRow * 2 == kBM, "x tile");
  static_assert(!kVec || kThreads / kChunksPerRow == kBN, "w tile");
  static_assert(kVec || (kBK == 32 && kThreads == 2 * kBM &&
                         kThreads == 4 * kBN), "gather tiles");
  const int kc = tid % kChunksPerRow;
  const int a_row = tid / kChunksPerRow;
  Pixel px[2];
  if constexpr (kVec) {
    px[0] = pixel_of(p, m0 + a_row);
    px[1] = pixel_of(p, m0 + a_row + kThreads / kChunksPerRow);
  } else {
    px[0] = pixel_of(p, m0 + tid / 2);
  }

  auto load_vec = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = kt * kBK + kc * 16;
      const int row = a_row + i * (kThreads / kChunksPerRow);
      long long off = -1;
      if (px[i].valid && k < p.k) off = x_offset(p, px[i], k);
      cp_async16(&a_s[stage][row][kc * 16], off >= 0 ? p.x + off : p.x,
                 off >= 0 ? 16 : 0);
    }
    {
      const int k = kt * kBK + kc * 16;
      const int co = n0 + a_row;
      const bool ok = co < p.cout && k < p.k;
      cp_async16(&b_s[stage][a_row][kc * 16],
                 ok ? p.w + static_cast<long long>(co) * p.k + k : p.w,
                 ok ? 16 : 0);
    }
  };

  auto load_gather = [&](int kt) {
    {
      const int row = tid / 2;
      const int k0 = kt * kBK + (tid % 2) * 16;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + e;
        if (px[0].valid && k < p.k) {
          const long long off = x_offset(p, px[0], k);
          if (off >= 0) {
            const uint32_t v = static_cast<uint8_t>(p.x[off]);
            words[e / 4] |= v << (8 * (e % 4));
          }
        }
      }
      *reinterpret_cast<uint4*>(&a_s[0][row][(tid % 2) * 16]) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
    {
      const int row = tid / 4;
      const int k0 = kt * kBK + (tid % 4) * 8;
      const int co = n0 + row;
      uint32_t words[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e;
        if (co < p.cout && k < p.k) {
          const uint32_t v = static_cast<uint8_t>(
              p.w[static_cast<long long>(co) * p.k + k]);
          words[e / 4] |= v << (8 * (e % 4));
        }
      }
      *reinterpret_cast<uint2*>(&b_s[0][row][(tid % 4) * 8]) =
          make_uint2(words[0], words[1]);
    }
  };

  // Warp tile: 32 output pixels x 32 channels = 2 x 4 m16n8 tiles.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  auto compute = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = &a_s[stage][wm + mi * 16 + g][kk + t4 * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = &b_s[stage][wn + ni * 8 + g][kk + t4 * 4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  };

  if constexpr (kVec) {
    load_vec(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < num_k_tiles; ++kt) {
      if (kt + 1 < num_k_tiles) load_vec(kt + 1, (kt + 1) & 1);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait_1();  // this step's group has landed
      __syncthreads();
      compute(kt & 1);
      __syncthreads();
    }
  } else {
    for (int kt = 0; kt < num_k_tiles; ++kt) {
      load_gather(kt);
      __syncthreads();
      compute(0);
      __syncthreads();
    }
  }

  // Epilogue: accumulator j of tile (mi, ni) is row g (+8 for j >= 2),
  // column 2*t4 + (j & 1) of that m16n8 tile.
  const float so = p.mode >= 2 ? *p.out_scale : 1.0f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int jc = 0; jc < 2; ++jc) {
      const int c = n0 + wn + ni * 8 + t4 * 2 + jc;
      if (c >= p.cout) continue;
      const float sc = p.scale[c];
      const float bc = p.bias != nullptr ? p.bias[c] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          const long long m = m0 + wm + mi * 16 + g + jr * 8;
          if (m >= p.m) continue;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][jr * 2 + jc]), sc);
          if (p.bias != nullptr) y = __fadd_rn(y, bc);
          const long long o = m * p.cout + c;
          if (p.mode == 0) {
            static_cast<float*>(p.out)[o] = y;
          } else if (p.mode == 1) {
            static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
          } else {
            if (p.mode == 3) y = __bfloat162float(__float2bfloat16_rn(y));
            float q = rintf(__fdiv_rn(y, so));
            q = fminf(fmaxf(q, -127.0f), 127.0f);
            static_cast<int8_t*>(p.out)[o] =
                static_cast<int8_t>(__float2int_rn(q));
          }
        }
      }
    }
  }
}

template <int kBK, bool kVec>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long blocks_m = (p.m + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>(blocks_m),
                  static_cast<unsigned>((p.cout + kBN - 1) / kBN));
  int8_conv_kernel<kBK, kVec><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x int8 (n, h, w, cin), w int8 (cout, kh, kw, cin), scale f32 (cout),
// bias f32 (cout) or null, out_scale f32 scalar (modes 2, 3) or null, out
// (n, ho, wo, cout): f32 (mode 0), bf16 (mode 1), int8 (modes 2: y in f32,
// 3: y rounded through bf16).  vec = 1 takes the cp.async path and needs
// cin % 16 == 0 and 16-byte aligned x and w.  All contiguous on the
// current device; launches on `stream` and returns the CUDA error code.
int ssd_int8_conv(const void* x, const void* w, const void* scale,
                  const void* bias, const void* out_scale, void* out, int n,
                  int h, int w_in, int cin, int cout, int kh, int kw,
                  int stride, int pad, int dil, int ho, int wo, int mode,
                  int vec, void* stream) {
  const long long k = static_cast<long long>(kh) * kw * cin;
  const long long m = static_cast<long long>(n) * ho * wo;
  const long long blocks_m = (m + kBM - 1) / kBM;
  if (n <= 0 || cin <= 0 || cout <= 0 || ho <= 0 || wo <= 0 || k <= 0 ||
      k * 127 * 127 > 0x7fffffffLL || blocks_m > 0x7fffffffLL ||
      (cout + kBN - 1) / kBN > 65535 || mode < 0 || mode > 3 ||
      (mode >= 2 && out_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && (cin % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(w) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out_scale = static_cast<const float*>(out_scale);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch<64, true>(p, s) : launch<32, false>(p, s);
  return static_cast<int>(err);
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

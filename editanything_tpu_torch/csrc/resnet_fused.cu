// The SD resnet block for Hopper (sm_90a), forward only (kernel E):
//   out = conv2(SiLU(GN2(conv1(SiLU(GN1(x))) + b1 + trow))) + b2 + shortcut(x)
// with shortcut a 1x1 conv (+ its bias) or the identity.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/kernels.py
// (_resnet_kernel, :604; _resnet_pallas, :680; resnet_fused, :801), which
// holds one whole image in VMEM. Rounding points are the Pallas kernel's
// (:645-675): the normalised activations xn and hn are rounded to the storage
// dtype before each conv; the conv sums, h, GN2's statistics and the output
// sum stay fp32 until one final rounding; the shortcut product takes the raw
// x in the storage dtype with fp32 sums.
//
// What bounds it on this card: at the UNet's 64x64 blocks (batch 4, 320
// channels) it does 60 GFLOP against ~21 MB of activations and weights, and
// at the VAE's 512x512 blocks 300-500 GFLOP: the tensor cores bound it (989
// TFLOP/s dense bf16), ~60 us and ~0.3-0.5 ms. Only the 8x8 blocks (2560 ->
// 1280) are bound by reading their 95 MB of weights. A Hopper block has 227
// KB of shared memory, one image of a 64x64x320 block is 2.6 MB, and
// GroupNorm needs whole-image statistics twice (of x, then of conv1's
// output), so E cannot be one pass over an image as on the TPU.
//
// Design: six launches on the caller's stream (eight where conv2 is split
// over K).
//   1. stats_kernel: per (image, group) slab of NCHW (contiguous), chunk
//      means and centred sums of squares (fp32);
//   2. finalize_kernel: merges a slab's chunks (Chan's formula, no
//      E[x^2] - E[x]^2 cancellation) into per-(image, channel) scale and
//      shift of the GroupNorm affine;
//   3. conv_kernel, conv1 as an implicit GEMM: M = an 8 x 16 tile of output
//      pixels, N = 128 output channels, K = 9 Cin in the torch weight layout
//      (Cout, Cin, 3, 3) as it is (k = cin * 9 + tap). A stage takes 16 input
//      channels: their 10 x 18 halo tile, read from NCHW x, normalised with
//      GN1's scale/shift, SiLU'd and rounded to the storage dtype once per
//      element (0 outside the image: the reference pads the normalised
//      activation), and the 144 weight columns of those channels, which are
//      contiguous in the torch layout and arrive by cp.async. The mma.sync
//      A fragments (bf16 in, fp32 sums) are read from the halo tile through a
//      table of (channel, tap) offsets, so each input element is normalised
//      once instead of once per tap. Stages are double-buffered: the next
//      stage's loads are in flight while this one's products run. Epilogue:
//      + b1 + trow[image], h written in fp32. Where the output tiles are
//      too few for the card (the 8x8 blocks: 40 tiles for 132 SMs), K is
//      split over blocks that add their sums into a zeroed fp32 buffer;
//   4-5. the same statistics and scale/shift of h (GN2);
//   6. conv2 the same way from h with GN2 + SiLU in the prologue; the 1x1
//      shortcut is one more K segment of the same GEMM (16 channels of raw x
//      against conv_shortcut per stage), or the identity add of x in the
//      epilogue, which adds b2 and the shortcut bias and rounds once (a split
//      conv2 rounds in one more launch).
// 8 warps, each 2 tile rows (32 pixels) x 64 channels. fp32 (the tests'
// path) uses the same code with exact FMAs. Later work: wgmma with TMA-fed
// operands and GN2's statistics in conv1's epilogue (this design reads h
// once more for them).
//
// Plain C interface for ctypes: ea_resnet_fused returns the first
// cudaGetLastError() that is not 0, or 0 on success.

#include <algorithm>

#include "common.cuh"

namespace {

using namespace ea;

constexpr int kTH = 8, kTW = 16;   // output tile: 8 rows x 16 columns = 128 pixels
constexpr int kBN = 128;           // output channels per tile
constexpr int kCC = 16;            // input channels per stage
constexpr int kHW = kTW + 2;       // halo tile: 10 rows x 18 columns
constexpr int kHalo = (kTH + 2) * kHW;
constexpr int kLDH = 184;          // halo row stride of a channel (>= kHalo)
constexpr int kK3 = kCC * 9;       // K per 3x3 stage (torch order: c * 9 + tap)
constexpr int kThreads = 256;      // 8 warps: 4 along M (2 tile rows each) x 2 along N
constexpr int kInPer = (kCC * kHalo + kThreads - 1) / kThreads;   // staged per thread
constexpr int kChunk = 16384;      // statistics: elements per block

template <typename T>
struct ConvSmem {
  static constexpr int LDB = kK3 + pad_of<T>();
  static constexpr size_t b = 0;                                         // 2 x (kBN, LDB)
  static constexpr size_t in = align128(b + 2 * kBN * LDB * sizeof(T));  // 2 x (kCC, kLDH)
  static constexpr size_t koff = align128(in + 2 * kCC * kLDH * sizeof(T));  // kK3 + kCC
  static constexpr size_t halo = align128(koff + (kK3 + kCC) * sizeof(int));  // kHalo
  static constexpr size_t total = align128(halo + kHalo * sizeof(int));   // + (cin, 2) fp32
};

// sum of v over the block (blockDim.x == kThreads); every thread gets it
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// grid (chunks, slabs): the mean and centred sum of squares of one chunk of
// one (image, group) slab, written to part[(slab * chunks + chunk) * 2 + {0,1}]
template <typename TS>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const TS* src, float* part, long long slab, int chunks) {
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  const long long start = static_cast<long long>(c) * kChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kChunk), slab - start));
  const TS* base = src + s * slab + start;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < len; i += kThreads) sum += to_f(base[i]);
  const float mean = block_sum(sum, red) / len;
  float m2 = 0.0f;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float d = to_f(base[i]) - mean;
    m2 += d * d;
  }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) {
    part[(s * chunks + c) * 2] = mean;
    part[(s * chunks + c) * 2 + 1] = m2;
  }
}

// grid (images): per channel, merge its group's chunk statistics and write
// the GroupNorm affine as ss[(image * C + c) * 2 + {0: scale, 1: shift}]:
// scale = gamma * rstd, shift = beta - mean * scale
template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* part, const T* gamma, const T* beta, float* ss,
                int C, int G, long long slab, int chunks, float eps) {
  const int n = blockIdx.x, cpg = C / G;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float* p = part + (static_cast<long long>(n) * G + c / cpg) * chunks * 2;
    const float total = static_cast<float>(slab);
    float mean = 0.0f;
    for (int i = 0; i < chunks; ++i) {
      const float cnt = static_cast<float>(min(static_cast<long long>(kChunk),
                                               slab - static_cast<long long>(i) * kChunk));
      mean += p[2 * i] * cnt;
    }
    mean /= total;
    float m2 = 0.0f;
    for (int i = 0; i < chunks; ++i) {
      const float cnt = static_cast<float>(min(static_cast<long long>(kChunk),
                                               slab - static_cast<long long>(i) * kChunk));
      const float d = p[2 * i] - mean;
      m2 += p[2 * i + 1] + d * d * cnt;
    }
    const float rstd = 1.0f / sqrtf(m2 / total + eps);
    const float scale = to_f(gamma[c]) * rstd;
    ss[(static_cast<long long>(n) * C + c) * 2] = scale;
    ss[(static_cast<long long>(n) * C + c) * 2 + 1] = to_f(beta[c]) - mean * scale;
  }
}

struct ConvArgs {
  const void* src;     // (N, cin, H, W): x (storage dtype) or h (fp32)
  const float* ss;     // (N, cin, 2) GroupNorm scale and shift
  const void* w;       // (cout, cin, 3, 3)
  const void* bias;    // (cout)
  const void* trow;    // (N, cout) or null
  const void* xsc;     // (N, cx, H, W) raw x for the shortcut, or null
  const void* wsc;     // (cout, cx): 1x1 shortcut; null with xsc: identity
  const void* bsc;     // (cout) or null
  void* out;           // (N, cout, H, W): h (fp32) or the output
  float* acc;          // split over K: zeroed fp32 (N, cout, H, W) sums, else null
  int cin, cout, cx, height, width, splits;
};

template <typename T>
__device__ __forceinline__ float silu_of(float v);
template <>
__device__ __forceinline__ float silu_of<float>(float v) {   // exact: the tests' path
  return v / (1.0f + expf(-v));
}
template <>
__device__ __forceinline__ float silu_of<__nv_bfloat16>(float v) {
  // rounded to bf16 next, so the fast exponential and division suffice
  return v < -80.0f ? 0.0f : __fdividef(v, 1.0f + __expf(-v));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// acc += A (the warp's 2 x 16 pixels, K columns kb .. kb + 16 ksteps) x
// B^T (its 64 channels); A(pixel, k) = in[hb[t] + (g or g + 8) + koff[k]],
// B row-major (channel, k) with stride ldb
template <int KSTEPS>
__device__ __forceinline__ void tile_mma(float (&acc)[2][8][4], const __nv_bfloat16* in,
                                         const int (&hb)[2], const int* koff,
                                         const __nv_bfloat16* B, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll 3
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int k0 = kk * 16 + tig * 2;
    const int o0 = koff[k0], o1 = koff[k0 + 1], o2 = koff[k0 + 8], o3 = koff[k0 + 9];
    uint32_t b[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* w = B + (n * 8 + g) * ldb + k0;
      b[n][0] = lds32(w);
      b[n][1] = lds32(w + 8);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const __nv_bfloat16* p = in + hb[t] + g;
      uint32_t a[4];
      a[0] = pack2(p[o0], p[o1]);
      a[1] = pack2(p[o0 + 8], p[o1 + 8]);
      a[2] = pack2(p[o2], p[o3]);
      a[3] = pack2(p[o2 + 8], p[o3 + 8]);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma_bf16(acc[t][n], a, b[n][0], b[n][1]);
    }
  }
}

// the same product in exact fp32 FMAs, in the same fragment layout: the
// tests' path
template <int KSTEPS>
__device__ __forceinline__ void tile_mma(float (&acc)[2][8][4], const float* in,
                                         const int (&hb)[2], const int* koff,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  for (int k = 0; k < KSTEPS * 16; ++k) {
    const int o = koff[k];
    float w[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      w[n][0] = B[(n * 8 + tig * 2) * ldb + k];
      w[n][1] = B[(n * 8 + tig * 2 + 1) * ldb + k];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float a0 = in[hb[t] + g + o], a1 = in[hb[t] + g + 8 + o];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[t][n][0] = fmaf(a0, w[n][0], acc[t][n][0]);
        acc[t][n][1] = fmaf(a0, w[n][1], acc[t][n][1]);
        acc[t][n][2] = fmaf(a1, w[n][0], acc[t][n][2]);
        acc[t][n][3] = fmaf(a1, w[n][1], acc[t][n][3]);
      }
    }
  }
}

// 3x3 conv (padding 1) of SiLU(src * scale + shift) as an implicit GEMM over
// one 8 x 16 tile of output pixels and 128 output channels; T the storage
// dtype, TS the source's element type, TO the output's. Block x is the tile,
// y the channel tile, z (image, split over K). A stage takes kCC input
// channels: their 10 x 18 halo tile, normalised once per element (0 outside
// the image), and the weights of all 9 taps (kK3 contiguous columns of the
// torch layout).
template <typename T, typename TS, typename TO>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(ConvArgs a) {
  using S = ConvSmem<T>;
  constexpr int LDB = S::LDB;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sB = reinterpret_cast<T*>(smem + S::b);
  T* sIn = reinterpret_cast<T*>(smem + S::in);
  int* sK = reinterpret_cast<int*>(smem + S::koff);     // 3x3 stage, then 1x1
  int* sHalo = reinterpret_cast<int*>(smem + S::halo);  // pixel offset or -1
  float* sSS = reinterpret_cast<float*>(smem + S::total);   // (cin, 2)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int split = blockIdx.z % a.splits, n = blockIdx.z / a.splits;
  const int tiles_x = (a.width + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_x) * kTH, x0 = (blockIdx.x % tiles_x) * kTW;
  const int co0 = blockIdx.y * kBN;
  const int hw = a.height * a.width;
  const int steps0 = (a.cin + kCC - 1) / kCC;
  const int steps = steps0 + (a.wsc ? (a.cx + kCC - 1) / kCC : 0);
  const int per = (steps + a.splits - 1) / a.splits;
  const int s_begin = split * per, s_end = min(steps, s_begin + per);

  for (int i = tid; i < 2 * a.cin; i += kThreads) {
    sSS[i] = a.ss[static_cast<long long>(n) * a.cin * 2 + i];
  }
  for (int k = tid; k < kK3 + kCC; k += kThreads) {
    if (k < kK3) {
      const int c = k / 9, tap = k - c * 9;
      sK[k] = c * kLDH + (tap / 3 - 1) * kHW + tap % 3 - 1;
    } else {
      sK[k] = (k - kK3) * kLDH;
    }
  }
  for (int i = tid; i < kHalo; i += kThreads) {
    const int y = y0 - 1 + i / kHW, x = x0 - 1 + i % kHW;
    sHalo[i] = (y >= 0 && y < a.height && x >= 0 && x < a.width) ? y * a.width + x : -1;
  }
  __syncthreads();

  const TS* src = static_cast<const TS*>(a.src) + static_cast<long long>(n) * a.cin * hw;
  const T* xsc = a.xsc ? static_cast<const T*>(a.xsc) + static_cast<long long>(n) * a.cx * hw
                       : nullptr;
  // halo element i = tid + kThreads j of a stage: channel i / kHalo, pixel i % kHalo
  float raw[kInPer];
  auto load_in = [&](int step) {
    const bool conv = step < steps0;
    const int c0 = conv ? step * kCC : (step - steps0) * kCC;
    const int cn = conv ? a.cin : a.cx;
#pragma unroll
    for (int j = 0; j < kInPer; ++j) {
      const int i = tid + kThreads * j;
      const int c = i / kHalo, off = i < kCC * kHalo ? sHalo[i - c * kHalo] : -1;
      raw[j] = 0.0f;
      if (off >= 0 && c0 + c < cn) {
        const long long at = static_cast<long long>(c0 + c) * hw + off;
        raw[j] = conv ? to_f(src[at]) : to_f(xsc[at]);
      }
    }
  };
  auto store_in = [&](int step, T* dst) {
    const bool conv = step < steps0;
    const int c0 = conv ? step * kCC : (step - steps0) * kCC;
    const int cn = conv ? a.cin : a.cx;
#pragma unroll
    for (int j = 0; j < kInPer; ++j) {
      const int i = tid + kThreads * j;
      if (i >= kCC * kHalo) break;
      const int c = i / kHalo, hp = i - c * kHalo;
      float v = raw[j];
      if (conv && sHalo[hp] >= 0 && c0 + c < cn) {
        v = silu_of<T>(v * sSS[2 * (c0 + c)] + sSS[2 * (c0 + c) + 1]);
      }
      dst[c * kLDH + hp] = from_f<T>(v);
    }
  };
  auto load_b = [&](int step, T* dst) {
    const bool conv = step < steps0;
    const T* wsrc = static_cast<const T*>(conv ? a.w : a.wsc);
    const int klen = conv ? a.cin * 9 : a.cx;
    const int kw = conv ? kK3 : kCC;                 // columns of this stage
    const int kb = conv ? step * kK3 : (step - steps0) * kCC;
    constexpr int V = 16 / sizeof(T);
    const int chunks = kw / V;
    const bool vec = klen % V == 0 && reinterpret_cast<uintptr_t>(wsrc) % 16 == 0;
    for (int i = tid; i < kBN * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * V;
      const int co = co0 + r, k = kb + c;
      T* d = dst + r * LDB + c;
      const T* s = wsrc + static_cast<long long>(co) * klen + k;
      if (vec && co < a.cout && k + V <= klen) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          d[e] = (co < a.cout && k + e < klen) ? s[e] : from_f<T>(0.0f);
        }
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.0f;
  // halo index of pixel (tile row 2 wm + t, column 0) of this warp
  const int hb[2] = {(2 * wm + 1) * kHW + 1, (2 * wm + 2) * kHW + 1};

  if (s_begin < s_end) {
    load_b(s_begin, sB);
    cp_async_commit();
    load_in(s_begin);
    store_in(s_begin, sIn);
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int buf = (s - s_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();   // stage buf complete; stage buf ^ 1 no longer read
    const bool more = s + 1 < s_end;
    if (more) {
      load_b(s + 1, sB + (buf ^ 1) * kBN * LDB);
      cp_async_commit();
      load_in(s + 1);
    }
    const T* in = sIn + buf * kCC * kLDH;
    const T* B = sB + buf * kBN * LDB + wn * 64 * LDB;
    if (s < steps0) {
      tile_mma<kK3 / 16>(acc, in, hb, sK, B, LDB);
    } else {
      tile_mma<kCC / 16>(acc, in, hb, sK + kK3, B, LDB);
    }
    if (more) store_in(s + 1, sIn + (buf ^ 1) * kCC * kLDH);
  }

  // epilogue: row g (+8) of m-tile t is pixel (y0 + 2 wm + t, x0 + g (+8)),
  // columns channels; the first split adds the biases, trow and the
  // identity shortcut
  const int g = lane / 4, tig = lane % 4;
  const bool first = split == 0;
  const T* bias = static_cast<const T*>(a.bias);
  const T* trow = a.trow ? static_cast<const T*>(a.trow) + static_cast<long long>(n) * a.cout
                         : nullptr;
  const T* bsc = static_cast<const T*>(a.bsc);
  const long long obase = static_cast<long long>(n) * a.cout * hw;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int y = y0 + 2 * wm + m, x = x0 + g + 8 * rr;
      if (y >= a.height || x >= a.width) continue;
      const int p = y * a.width + x;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + wn * 64 + t * 8 + tig * 2 + e;
          if (co >= a.cout) continue;
          float v = acc[m][t][2 * rr + e];
          if (first) {
            if (trow) {
              v += to_f(trow[co]) + to_f(bias[co]);
            } else {
              v += to_f(bias[co]);
            }
            if (a.wsc) {
              v += to_f(bsc[co]);
            } else if (xsc) {
              v += to_f(xsc[static_cast<long long>(co) * hw + p]);
            }
          }
          const long long o = obase + static_cast<long long>(co) * hw + p;
          if (a.acc) {
            atomicAdd(a.acc + o, v);
          } else {
            static_cast<TO*>(a.out)[o] = from_f<TO>(v);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) store_kernel(const float* acc, T* out,
                                                         long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    out[i] = from_f<T>(acc[i]);
  }
}

int sm_count() {   // of the current device
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 132;
  }
  return sms;
}

// splits over K for a conv of `steps` K stages: enough blocks for about two
// per SM where the output tiles alone are too few (the 8x8 blocks), each
// split keeping at least 16 stages
int pixel_tiles(int height, int width) {
  return ((height + kTH - 1) / kTH) * ((width + kTW - 1) / kTW);
}

int split_k(int batch, int cout, int height, int width, int steps) {
  const int tiles = pixel_tiles(height, width) * ((cout + kBN - 1) / kBN) * batch;
  const int want = (2 * sm_count() + tiles - 1) / tiles;
  const int most = std::max(1, steps / 4);
  return std::max(1, std::min({want, most, 65535 / batch}));
}

int conv_steps(int cin, int cx, bool shortcut) {
  return (cin + kCC - 1) / kCC + (shortcut ? (cx + kCC - 1) / kCC : 0);
}

template <typename T, typename TS, typename TO>
cudaError_t launch_conv(const ConvArgs& a, int batch, cudaStream_t stream) {
  using S = ConvSmem<T>;
  static_assert(S::total <= static_cast<size_t>(kMaxSmem), "tile too big");
  const size_t smem = S::total + 2 * sizeof(float) * a.cin;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, conv_kernel<T, TS, TO>, kMaxSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(pixel_tiles(a.height, a.width), (a.cout + kBN - 1) / kBN, batch * a.splits);
  conv_kernel<T, TS, TO><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// GroupNorm statistics of src (N, C, hw) folded into ss with gamma/beta
template <typename T, typename TS>
cudaError_t launch_norm(const TS* src, const T* gamma, const T* beta, float* part,
                        float* ss, int batch, int C, int G, int hw, float eps,
                        cudaStream_t stream) {
  const long long slab = static_cast<long long>(C / G) * hw;
  const int chunks = static_cast<int>((slab + kChunk - 1) / kChunk);
  stats_kernel<TS><<<dim3(chunks, batch * G), kThreads, 0, stream>>>(src, part, slab, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finalize_kernel<T><<<batch, kThreads, 0, stream>>>(part, gamma, beta, ss, C, G, slab,
                                                      chunks, eps);
  return cudaGetLastError();
}

struct BlockArgs {
  const void *x, *gn1_w, *gn1_b, *w1, *b1, *trow, *gn2_w, *gn2_b, *w2, *b2, *wsc, *bsc;
  void* out;
  float *h, *scratch;
  int batch, cin, cout, height, width, groups;
  float eps;
};

// the fp32 scratch: ss1 (N, cin, 2) | ss2 (N, cout, 2) | chunk statistics |
// conv2's split-K sums (N, cout, H, W) where conv2 is split
struct Scratch {
  long long ss1, ss2, part, acc, total;
  int split1, split2;
  Scratch(int batch, int cin, int cout, int height, int width, int groups, bool shortcut) {
    const int hw = height * width;
    split1 = split_k(batch, cout, height, width, conv_steps(cin, cin, false));
    split2 = split_k(batch, cout, height, width, conv_steps(cout, cin, shortcut));
    const long long slab = static_cast<long long>(std::max(cin, cout)) / groups * hw;
    ss1 = 0;
    ss2 = ss1 + 2LL * batch * cin;
    part = ss2 + 2LL * batch * cout;
    acc = part + 2LL * batch * groups * ((slab + kChunk - 1) / kChunk);
    total = acc + (split2 > 1 ? static_cast<long long>(batch) * cout * hw : 0);
  }
};

template <typename T>
cudaError_t run(const BlockArgs& b, cudaStream_t stream) {
  const int hw = b.height * b.width;
  const Scratch sc(b.batch, b.cin, b.cout, b.height, b.width, b.groups, b.wsc != nullptr);
  float* ss1 = b.scratch + sc.ss1;
  float* ss2 = b.scratch + sc.ss2;
  float* part = b.scratch + sc.part;
  const long long outs = static_cast<long long>(b.batch) * b.cout * hw;
  cudaError_t e = launch_norm<T, T>(static_cast<const T*>(b.x), static_cast<const T*>(b.gn1_w),
                                    static_cast<const T*>(b.gn1_b), part, ss1, b.batch,
                                    b.cin, b.groups, hw, b.eps, stream);
  if (e != cudaSuccess) return e;
  ConvArgs c1{};
  c1.src = b.x; c1.ss = ss1; c1.w = b.w1; c1.bias = b.b1; c1.trow = b.trow;
  c1.out = b.h; c1.cin = b.cin; c1.cout = b.cout; c1.cx = b.cin;
  c1.height = b.height; c1.width = b.width; c1.splits = sc.split1;
  if (sc.split1 > 1) {
    c1.acc = b.h;
    e = cudaMemsetAsync(b.h, 0, outs * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  e = launch_conv<T, T, float>(c1, b.batch, stream);
  if (e != cudaSuccess) return e;
  e = launch_norm<T, float>(b.h, static_cast<const T*>(b.gn2_w), static_cast<const T*>(b.gn2_b),
                            part, ss2, b.batch, b.cout, b.groups, hw, b.eps, stream);
  if (e != cudaSuccess) return e;
  ConvArgs c2{};
  c2.src = b.h; c2.ss = ss2; c2.w = b.w2; c2.bias = b.b2;
  c2.xsc = b.x; c2.wsc = b.wsc; c2.bsc = b.bsc;
  c2.out = b.out; c2.cin = b.cout; c2.cout = b.cout; c2.cx = b.cin;
  c2.height = b.height; c2.width = b.width; c2.splits = sc.split2;
  if (sc.split2 > 1) {
    c2.acc = b.scratch + sc.acc;
    e = cudaMemsetAsync(c2.acc, 0, outs * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  e = launch_conv<T, float, T>(c2, b.batch, stream);
  if (e != cudaSuccess || sc.split2 == 1) return e;
  const int blocks = static_cast<int>(std::min((outs + kThreads - 1) / kThreads, 65535LL));
  store_kernel<T><<<blocks, kThreads, 0, stream>>>(c2.acc, static_cast<T*>(b.out), outs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the fp32 scratch buffer that ea_resnet_fused needs for these
// shapes (shortcut: 1 with a 1x1 shortcut conv).
long long ea_resnet_scratch_floats(int batch, int cin, int cout, int height, int width,
                                   int groups, int shortcut) {
  return Scratch(batch, cin, cout, height, width, groups, shortcut != 0).total;
}

// x (N, cin, H, W), out (N, cout, H, W) in the storage dtype (0 = float32,
// 1 = bfloat16), as are every weight, bias and GroupNorm affine and trow
// (N, cout); trow null: no time embedding; wsc (cout, cin) and bsc null: the
// identity shortcut (cin == cout). Scratch: h (N, cout, H, W) fp32 and
// `scratch` of ea_resnet_scratch_floats fp32. Returns a cudaError_t (0 =
// success).
int ea_resnet_fused(const void* x, const void* gn1_w, const void* gn1_b, const void* w1,
                    const void* b1, const void* trow, const void* gn2_w, const void* gn2_b,
                    const void* w2, const void* b2, const void* wsc, const void* bsc,
                    void* out, float* h, float* scratch, int batch, int cin, int cout,
                    int height, int width, int groups, float eps, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || cin < 1 || cout < 1 || groups < 1 || cin % groups ||
      cout % groups || height < 1 || width < 1 || (!wsc && cin != cout) ||
      (wsc && !bsc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockArgs b{x, gn1_w, gn1_b, w1, b1, trow, gn2_w, gn2_b, w2, b2, wsc, bsc,
              out, h, scratch, batch, cin, cout, height, width, groups, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(run<__nv_bfloat16>(b, s));
  if (dtype == 0) return static_cast<int>(run<float>(b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

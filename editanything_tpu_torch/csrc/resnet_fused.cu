// The SD resnet block for Hopper (sm_90a), forward only (kernel E):
//   out = conv2(SiLU(GN2(conv1(SiLU(GN1(x))) + b1 + trow))) + b2 + shortcut(x)
// with shortcut a 1x1 conv (+ its bias) or the identity.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/kernels.py
// (_resnet_kernel, :604; _resnet_pallas, :680; resnet_fused, :801), which
// holds one whole image in VMEM and runs each conv as 9 roll + mask +
// matmul taps. Rounding points are the Pallas kernel's (:645-675): the
// normalised activations xn and hn are rounded to the storage dtype before
// each conv; the conv sums, h, GN2's statistics and the output sum stay
// fp32 until one final rounding; the shortcut product takes the raw x in the
// storage dtype with fp32 sums; zero padding comes after the normalisation.
//
// What bounds it on this card: at the UNet's 64x64 blocks (batch 4, 320
// channels) it does 60 GFLOP against ~21 MB of activations and weights, and
// at the VAE's 512x512 blocks 300-500 GFLOP: the tensor cores bound it (989
// TFLOP/s dense bf16). Only the 8x8 blocks (2560 -> 1280) are bound by
// reading their 95 MB of weights. A block has 227 KB of shared memory, one
// image of a 64x64x320 block is 2.6 MB, and GroupNorm needs whole-image
// statistics twice, so E cannot be one pass over an image as on the TPU.
//
// Design: each conv is an implicit GEMM over channels-last (NHWC)
// activations on mma.sync, and the normalisations are passes that write
// those activations. Six launches on the caller's stream:
//   1. stats_x: GN1's (count, mean, M2) per chunk of each NCHW (image,
//      group) slab (one pass: per-thread shifted sums, merged by Chan's
//      formula; at most 16 chunks a slab);
//   2. norm_x: merges a channel block's GN1 chunks (Chan's formula), then
//      reads x (NCHW) once in 64-channel x 64-pixel tiles and writes
//      xn = SiLU(GN1(x)) rounded to the storage dtype as NHWC, through a
//      shared-memory transpose (16-byte reads along pixels, 16-byte writes
//      along channels); with a 1x1 shortcut also raw x as NHWC (the
//      shortcut's K segment). Channels are padded to a multiple of 8
//      (zeros), so every pixel's channel run is whole 16-byte vectors;
//   3. conv: conv1 as an implicit GEMM. M = the N*H*W output pixels (the
//      batch folded in, so small images share one pass over the weights),
//      tiles of 128; N = output channels, tiles of 64, 128 or 160 chosen by
//      the caller so that no tile is more than half empty; K tap-major
//      (k = tap * Cin + c), 64 channels of one tap a stage. A rows are
//      16-byte channel vectors of the shifted pixel, fetched by cp.async
//      (zero-filled outside the image: zero padding after the
//      normalisation); B are the weights packed once by the caller to
//      (Cout, 3, 3, Cin). Both sit in a 3-stage cp.async ring (one stage's
//      wait a step behind, one barrier a step) whose 16-byte chunks are
//      XOR-swizzled by row, read by ldmatrix.x4 without bank conflicts into
//      mma.sync.m16n8k16 (bf16 in, fp32 sums). 8 warps: 4 along M (32
//      pixels each) x 2 along N, two CTAs per SM (128 registers, 96-108 KB
//      of shared memory each). The epilogue adds b1 and trow[image], stages
//      the fp32 tile in shared memory, writes h (NHWC fp32) with 16-byte
//      stores and reduces the tile to GN2 partials (count, mean, M2) per
//      (image, group) segment, two passes over the staged tile, one warp a
//      segment, written without atomics (groups may straddle a channel tile
//      and tiles may straddle images: each partial carries its count);
//   4. fin2: one block per (image, group) merges its partials by Chan's
//      formula into GN2's per-channel scale and shift (a launch of its own:
//      at the VAE's 512^2 one image has 2048 M tiles of partials per group,
//      which every CTA of the next pass would otherwise merge again);
//   5. norm_h: hn = SiLU(GN2(h)) rounded, NHWC, 16-byte accesses;
//   6. conv: conv2 the same way, the 1x1 shortcut one more K segment over
//      raw x (or the identity add of x in the epilogue), + b2 and the
//      shortcut bias, rounded once and stored to NCHW from the staged tile
//      (each warp a run of 32 pixels of one channel).
// Where the output tiles are fewer than the SMs (the 8x8 and 16x16
// blocks), K is split over CTAs that add into zeroed fp32 sums: a split
// conv1 takes GN2's partials in a pass of its own over h (tile_stats), a
// split conv2 rounds in one more (store_out); two more launches each.
// fp32 (the tests' path) uses the same tiling and ring with exact FMAs, one
// CTA per SM. The convs run mma.sync at about 250 TFLOP/s at the UNet's
// 64x64 blocks (NVIDIA H100 80GB HBM3 at 700 W, PERF.md); later work: wgmma
// with TMA-fed operands and a producer warp.
//
// Plain C interface for ctypes: ea_resnet_fused returns the first
// cudaGetLastError() that is not 0, or 0 on success. The launch plan (the
// channel tile, the splits, the partials' layout, the padded channel
// strides) and every scratch buffer come from the caller
// (editanything_tpu_torch/core/kernels.py::resnet_plan).

#include <algorithm>

#include "common.cuh"

namespace {

using namespace ea;

constexpr int kThreads = 256;   // 8 warps (the passes other than the convs)
constexpr int kBM = 128;        // output pixels (GEMM rows) per conv tile
constexpr int kWarpsM = 4;      // conv warps along M (x 2 along N)
constexpr int kConvThreads = 64 * kWarpsM;
constexpr int kMT = kBM / (16 * kWarpsM);   // a conv warp's m16 tiles
constexpr int kBK = 64;         // K elements per stage: 64 channels of one tap
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kChunk = 16384;   // GN1 statistics: least elements per block,
constexpr int kMaxChunks = 16;  // and at most this many blocks per slab
constexpr int kNC = 64;         // normalise pass: channels per CTA
constexpr int kNP = 64;         // normalise pass: pixels per tile
constexpr int kNormPix = 128;   // normalise pass: pixels per CTA
constexpr int kLDT = kNP + 2;   // its transpose tile's row stride

struct Stat {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2) partials
__device__ __forceinline__ Stat chan(Stat a, Stat b) {
  const float n = a.n + b.n;
  if (n == 0.0f) return a;
  const float d = b.mean - a.mean, f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// the merge over the warp; lane 0's result on every lane
__device__ __forceinline__ Stat warp_chan(Stat s) {
  for (int o = 16; o > 0; o >>= 1) {
    const Stat t{__shfl_xor_sync(0xffffffffu, s.n, o),
                 __shfl_xor_sync(0xffffffffu, s.mean, o),
                 __shfl_xor_sync(0xffffffffu, s.m2, o)};
    s = chan(s, t);
  }
  return {__shfl_sync(0xffffffffu, s.n, 0), __shfl_sync(0xffffffffu, s.mean, 0),
          __shfl_sync(0xffffffffu, s.m2, 0)};
}

__device__ __forceinline__ Stat load_stat(const float* p) { return {p[0], p[1], p[2]}; }

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

// 1. grid (chunks, slabs): (count, mean, M2) of one chunk of one NCHW
// (image, group) slab, at part[(slab * chunks + chunk) * 3]
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_x_kernel(const T* src, float* part, long long slab, int chunk, int chunks) {
  __shared__ Stat red[kThreads / 32];
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  const long long start = static_cast<long long>(c) * chunk;
  const int len = static_cast<int>(min(static_cast<long long>(chunk), slab - start));
  const T* base = src + s * slab + start;
  // one pass: per thread, sums shifted by the first element it reads (no
  // cancellation while the shift is near the mean), then Chan's merge over
  // the block; 16-byte loads where the chunk is whole aligned vectors
  constexpr int V = 16 / sizeof(T);
  const bool vec = len % V == 0 && (s * slab) % V == 0;
  float shift = 0.0f, s1 = 0.0f, s2 = 0.0f;
  int cnt = 0;
  if (vec) {
    if (threadIdx.x < len / V) shift = to_f(base[threadIdx.x * V]);
#pragma unroll 4
    for (int i = threadIdx.x; i < len / V; i += kThreads) {
      alignas(16) T v[V];
      *reinterpret_cast<uint4*>(v) = reinterpret_cast<const uint4*>(base)[i];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = to_f(v[e]) - shift;
        s1 += d;
        s2 += d * d;
      }
      cnt += V;
    }
  } else {
    if (threadIdx.x < len) shift = to_f(base[threadIdx.x]);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float d = to_f(base[i]) - shift;
      s1 += d;
      s2 += d * d;
      ++cnt;
    }
  }
  const float fc = static_cast<float>(cnt);
  Stat st = cnt ? Stat{fc, shift + s1 / fc, fmaxf(s2 - s1 * s1 / fc, 0.0f)}
                : Stat{0.0f, 0.0f, 0.0f};
  st = warp_chan(st);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = st;
  __syncthreads();
  st = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) st = chan(st, red[w]);
  const float mean = st.mean, m2 = st.m2;
  if (threadIdx.x == 0) {
    float* p = part + (s * chunks + c) * 3;
    p[0] = static_cast<float>(len);
    p[1] = mean;
    p[2] = m2;
  }
}

struct NormXArgs {
  const void *x, *gamma, *beta;   // x (N, C, HW); gamma, beta (C)
  const float* part;              // GN1 chunk partials
  void* xn;                       // (N, HW, cp) SiLU(GN1(x)), rounded
  void* xs;                       // (N, HW, cp) raw x, or null
  int C, cp, G, hw, chunks;
  float eps;
};

// 2. grid (pixel ranges of kNormPix, channel blocks of kNC, images)
template <typename T>
__global__ void __launch_bounds__(kThreads) norm_x_kernel(NormXArgs a) {
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte vector
  __shared__ float s_mean[kNC + 1], s_rstd[kNC + 1], s_scale[kNC], s_shift[kNC];
  __shared__ __align__(16) unsigned char tile_bytes[2 * kNC * kLDT * sizeof(T)];
  T* tile = reinterpret_cast<T*>(tile_bytes);   // normalised
  T* raw = tile + kNC * kLDT;                   // as read
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.z, c0 = blockIdx.y * kNC;
  const int cpg = a.C / a.G;
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(n) * a.C * a.hw;
  // this block's groups: merge their chunks, one warp per group
  const int c_last = min(c0 + kNC, a.C) - 1;
  const int g_first = c0 < a.C ? c0 / cpg : 0;
  const int groups = c0 < a.C ? c_last / cpg - g_first + 1 : 0;
  for (int gl = warp; gl < groups; gl += kThreads / 32) {
    const float* p = a.part + (static_cast<long long>(n) * a.G + g_first + gl) * a.chunks * 3;
    Stat s{0.0f, 0.0f, 0.0f};
    for (int i = lane; i < a.chunks; i += 32) s = chan(s, load_stat(p + 3 * i));
    s = warp_chan(s);
    if (lane == 0) {
      s_mean[gl] = s.mean;
      s_rstd[gl] = 1.0f / sqrtf(s.m2 / s.n + a.eps);
    }
  }
  __syncthreads();
  if (tid < kNC) {
    const int c = c0 + tid;
    float scale = 0.0f, shift = 0.0f;
    if (c < a.C) {
      const int gl = c / cpg - g_first;
      scale = to_f(static_cast<const T*>(a.gamma)[c]) * s_rstd[gl];
      shift = to_f(static_cast<const T*>(a.beta)[c]) - s_mean[gl] * scale;
    }
    s_scale[tid] = scale;
    s_shift[tid] = shift;
  }
  __syncthreads();
  const bool vec = a.hw % V == 0;
  const int p_end = min(a.hw, (blockIdx.x + 1) * kNormPix);
  for (int p0 = blockIdx.x * kNormPix; p0 < p_end; p0 += kNP) {
    // load kNC channels x kNP pixels, normalise, round
    for (int i = tid; i < kNC * (kNP / V); i += kThreads) {
      const int cl = i / (kNP / V), pl = (i % (kNP / V)) * V;
      const int c = c0 + cl, p = p0 + pl;
      alignas(16) T v[V];
      if (c < a.C && vec && p < a.hw) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(x + static_cast<long long>(c) * a.hw + p);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          v[e] = (c < a.C && p + e < a.hw) ? x[static_cast<long long>(c) * a.hw + p + e]
                                          : from_f<T>(0.0f);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = c < a.C ? silu_of<T>(to_f(v[e]) * s_scale[cl] + s_shift[cl]) : 0.0f;
        tile[cl * kLDT + pl + e] = from_f<T>(f);
        raw[cl * kLDT + pl + e] = v[e];
      }
    }
    __syncthreads();
    // store each pixel's channel run: 16-byte vectors along channels
    for (int i = tid; i < kNP * (kNC / V); i += kThreads) {
      const int pl = i / (kNC / V), cl = (i % (kNC / V)) * V;
      const int p = p0 + pl, c = c0 + cl;
      if (p >= a.hw || c >= a.cp) continue;
      alignas(16) T v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = tile[(cl + e) * kLDT + pl];
      const long long o = (static_cast<long long>(n) * a.hw + p) * a.cp + c;
      *reinterpret_cast<uint4*>(static_cast<T*>(a.xn) + o) = *reinterpret_cast<uint4*>(v);
      if (a.xs) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = raw[(cl + e) * kLDT + pl];
        *reinterpret_cast<uint4*>(static_cast<T*>(a.xs) + o) = *reinterpret_cast<uint4*>(v);
      }
    }
    __syncthreads();
  }
}

struct ConvArgs {
  const void* a;      // NHWC (M, cpa): xn or hn, storage dtype
  const void* w;      // (cout, 9, cpa) packed weights
  const void* asc;    // NHWC (M, cpx) raw x of a 1x1 shortcut, or null
  const void* wsc;    // (cout, cpx) packed 1x1 shortcut, or null
  const void* bias;   // (cout)
  const void* trow;   // (N, cout) or null
  const void* bsc;    // (cout) or null
  const void* xid;    // identity shortcut: NCHW x (N, cout, HW), or null
  float* h;           // conv1: NHWC (M, cph) fp32 h (zeroed sums where split)
  float* part;        // conv1 unsplit: GN2 partials, else null
  void* out;          // conv2: NCHW (N, cout, HW) in the storage dtype
  float* acc;         // conv2 split: zeroed NCHW fp32 sums, else null
  int cpa, cpx, cout, cph, height, width, batch, splits, slots, segs, cpg;
};

// the ring's layout: per stage an A tile (kBM rows) and a B tile (BN rows)
// of kBK elements, each row's 16-byte chunks XOR-swizzled by row; the
// epilogue's fp32 tile reuses the same memory
template <typename T, int BN>
struct ConvSmem {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));   // elements a chunk
  static constexpr int CPR = kBK / V;                          // chunks a row
  static constexpr int RPP = kConvThreads / CPR;               // rows a copy pass
  static constexpr size_t a_bytes = static_cast<size_t>(kBM) * kBK * sizeof(T);
  static constexpr size_t stage = static_cast<size_t>(kBM + BN) * kBK * sizeof(T);
  static constexpr size_t ring = kStages * stage;
  static constexpr int LDE = BN + 4;                           // epilogue row stride
  static constexpr size_t epi = static_cast<size_t>(kBM) * LDE * sizeof(float);
  static constexpr size_t total = ring > epi ? ring : epi;
};

// element offset of (row, chunk) in a swizzled tile
template <typename T>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  static_assert(kBK / V >= 8, "rows of at least 8 chunks");
  return row * kBK + ((chunk ^ (row & 7)) * V);
}

// mma.sync m16n8k16 (bf16 in, fp32 sums) without the volatile of
// common.cuh's mma_bf16: a pure register operation, so the compiler may
// issue it between the (volatile, ordered) ldmatrix loads of the next k-step
__device__ __forceinline__ void mma_sched(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one stage's products: the warp's 16 kMT rows x BN/2 columns, K = kBK;
// each k-step's fragments are all loaded before its products
template <int BN>
__device__ __forceinline__ void stage_mma(float (&acc)[kMT][BN / 16][4], const __nv_bfloat16* sA,
                                          const __nv_bfloat16* sB, int wm, int wn) {
  constexpr int NT = BN / 16;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t af[kMT][4], bf[NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = wm * (16 * kMT) + mt * 16 + lane % 16;
      ldsm_x4(af[mt], sA + swz<__nv_bfloat16>(row, kk * 2 + lane / 16));
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int row = wn * (BN / 2) + np * 16 + (lane / 16) * 8 + lane % 8;
      ldsm_x4(bf[np], sB + swz<__nv_bfloat16>(row, kk * 2 + (lane / 8) % 2));
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_sched(acc[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
        mma_sched(acc[mt][2 * np + 1], af[mt], bf[np][2], bf[np][3]);
      }
    }
  }
}

// the same products in exact fp32 FMAs, same fragment layout: the tests' path
template <int BN>
__device__ __forceinline__ void stage_mma(float (&acc)[kMT][BN / 16][4], const float* sA,
                                          const float* sB, int wm, int wn) {
  constexpr int NT = BN / 16;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  for (int k = 0; k < kBK; ++k) {
    float av[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * (16 * kMT) + mt * 16 + g + 8 * h;
        av[mt][h] = sA[swz<float>(row, k / 4) + k % 4];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = wn * (BN / 2) + nt * 8 + tig * 2 + e;
        bv[e] = sB[swz<float>(row, k / 4) + k % 4];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        acc[mt][nt][0] = fmaf(av[mt][0], bv[0], acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(av[mt][0], bv[1], acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(av[mt][1], bv[0], acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(av[mt][1], bv[1], acc[mt][nt][3]);
      }
    }
  }
}

// GN2 partials of the staged fp32 tile E (kBM rows from pixel m0, BN
// columns from channel n0; row stride lde): one (count, mean, M2) per
// (image, group) segment the tile holds, one warp per segment, two passes
// over the tile. Written at part[(((mt * slots + image slot) * ntiles + nt)
// * segs + group segment) * 3].
__device__ void tile_stats(const float* E, int lde, int bn, int m0, int n0, int M, int hw,
                           int cout, int cpg, int mt, int nt, int ntiles, int slots, int segs,
                           float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_end = min(m0 + kBM, M), c_end = min(n0 + bn, cout);
  const int n_first = m0 / hw, n_last = (m_end - 1) / hw;
  const int g_first = n0 / cpg, g_last = (c_end - 1) / cpg;
  const int ng = g_last - g_first + 1;
  const int pairs = (n_last - n_first + 1) * ng;
  for (int pi = warp; pi < pairs; pi += blockDim.x / 32) {
    const int img = n_first + pi / ng, gi = g_first + pi % ng;
    const int r0 = max(m0, img * hw) - m0, r1 = min(m_end, (img + 1) * hw) - m0;
    const int cb = max(n0, gi * cpg) - n0, ce = min(c_end, (gi + 1) * cpg) - n0;
    const int cw = ce - cb, cnt = (r1 - r0) * cw;
    // lanes cover q rows of the segment at a time (cw <= 32), or its
    // columns 32 at a time: no division per element; four rows in flight
    const int q = cw <= 32 ? 32 / cw : 1;
    const int lr = cw <= 32 ? lane / cw : 0, lc = cw <= 32 ? lane % cw : lane;
    const int rows = lr < q ? r1 - r0 - lr : 0;     // rows from r0 + lr
    const float* e0 = E + (r0 + lr) * lde;
    auto sum_rows = [&](auto f) {
      float acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int i = 0;
      for (; i + 3 * q < rows; i += 4 * q) {
        for (int c = cb + lc; c < ce; c += 32) {
#pragma unroll
          for (int u = 0; u < 4; ++u) acc4[u] += f(e0[(i + u * q) * lde + c]);
        }
      }
      for (; i < rows; i += q) {
        for (int c = cb + lc; c < ce; c += 32) acc4[0] += f(e0[i * lde + c]);
      }
      return (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]);
    };
    const float mean = warp_sum(sum_rows([](float v) { return v; })) / cnt;
    float m2 = sum_rows([mean](float v) { return (v - mean) * (v - mean); });
    m2 = warp_sum(m2);
    if (lane == 0) {
      float* p = part + ((static_cast<long long>(mt * slots + img - n_first) * ntiles + nt) * segs +
                         gi - g_first) * 3;
      p[0] = static_cast<float>(cnt);
      p[1] = mean;
      p[2] = m2;
    }
  }
}

// 3 and 6. grid (M tiles, channel tiles, splits over K). CONV1: h and GN2's
// partials; else the block's output with the shortcut.
template <typename T, int BN, bool CONV1>
__global__ void __launch_bounds__(kConvThreads, sizeof(T) == 2 ? 2 : 1) conv_kernel(ConvArgs a) {
  using S = ConvSmem<T, BN>;
  constexpr int NT = BN / 16, V = S::V, CPR = S::CPR, RPP = S::RPP;
  constexpr int APASS = kBM / RPP, BPASS = BN / RPP;
  static_assert(kBM % RPP == 0 && BN % RPP == 0, "whole copy passes");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int hw = a.height * a.width, M = a.batch * hw;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int kc = (a.cpa + kBK - 1) / kBK, kcx = a.asc ? (a.cpx + kBK - 1) / kBK : 0;
  const int steps = 9 * kc + kcx;
  const int per = (steps + a.splits - 1) / a.splits;
  const int s_begin = split * per, s_end = min(steps, s_begin + per);
  const int nsteps = max(0, s_end - s_begin);

  // this thread's copy slots: chunk `col` of rows row0 + j * RPP, the
  // pixel of each (-1 past the end) and its (y, x) as y << 16 | x
  const int col = tid % CPR, row0 = tid / CPR;
  int pm[APASS], pyx[APASS];
#pragma unroll
  for (int j = 0; j < APASS; ++j) {
    const int m = m0 + row0 + j * RPP;
    pm[j] = m < M ? m : -1;
    const int r = m % hw;
    pyx[j] = (r / a.width) << 16 | (r % a.width);
  }
  const T* A = static_cast<const T*>(a.a);
  const T* W = static_cast<const T*>(a.w);
  const T* ASC = static_cast<const T*>(a.asc);
  const T* WSC = static_cast<const T*>(a.wsc);
  auto load = [&](int s, int slot) {
    T* sA = reinterpret_cast<T*>(smem + slot * S::stage);
    T* sB = reinterpret_cast<T*>(smem + slot * S::stage + S::a_bytes);
    if (s < 9 * kc) {
      const int tap = s / kc, ch = (s % kc) * kBK + col * V;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool cv = ch < a.cpa;
#pragma unroll
      for (int j = 0; j < APASS; ++j) {
        const int y = (pyx[j] >> 16) + dy, x = (pyx[j] & 0xffff) + dx;
        const bool ok = cv && pm[j] >= 0 && y >= 0 && y < a.height && x >= 0 && x < a.width;
        const T* src = ok ? A + static_cast<long long>(pm[j] + dy * a.width + dx) * a.cpa + ch : A;
        cp_async16_zfill(sA + swz<T>(row0 + j * RPP, col), src, ok);
      }
#pragma unroll
      for (int j = 0; j < BPASS; ++j) {
        const int co = n0 + row0 + j * RPP;
        const bool ok = cv && co < a.cout;
        const T* src = ok ? W + (static_cast<long long>(co) * 9 + tap) * a.cpa + ch : W;
        cp_async16_zfill(sB + swz<T>(row0 + j * RPP, col), src, ok);
      }
    } else {   // the 1x1 shortcut's K segment over raw x
      const int ch = (s - 9 * kc) * kBK + col * V;
      const bool cv = ch < a.cpx;
#pragma unroll
      for (int j = 0; j < APASS; ++j) {
        const bool ok = cv && pm[j] >= 0;
        const T* src = ok ? ASC + static_cast<long long>(pm[j]) * a.cpx + ch : ASC;
        cp_async16_zfill(sA + swz<T>(row0 + j * RPP, col), src, ok);
      }
#pragma unroll
      for (int j = 0; j < BPASS; ++j) {
        const int co = n0 + row0 + j * RPP;
        const bool ok = cv && co < a.cout;
        const T* src = ok ? WSC + static_cast<long long>(co) * a.cpx + ch : WSC;
        cp_async16_zfill(sB + swz<T>(row0 + j * RPP, col), src, ok);
      }
    }
  };

  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.0f;

  // the ring: stage i + kStages - 1 is requested while stage i is multiplied
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nsteps) load(s_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage i landed for all; the slot of stage i - 1 is free
    const int next = i + kStages - 1;
    if (next < nsteps) load(s_begin + next, next % kStages);
    cp_async_commit();
    const int slot = i % kStages;
    stage_mma<BN>(acc, reinterpret_cast<const T*>(smem + slot * S::stage),
                  reinterpret_cast<const T*>(smem + slot * S::stage + S::a_bytes), wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the fp32 tile, biases added by the first split, staged in
  // shared memory; row g (+8) of m-tile mt is pixel m0 + 16 (kMT wm + mt) + g
  // row stride: 16-byte rows for conv1's NHWC stores, odd for conv2's
  // reads down a channel
  float* E = reinterpret_cast<float*>(smem);
  constexpr int LDE = CONV1 ? S::LDE : BN + 1;
  const int g = lane / 4, tig = lane % 4;
  const bool first = split == 0;
  const T* bias = static_cast<const T*>(a.bias);
  const T* trow = static_cast<const T*>(a.trow);
  const T* bsc = static_cast<const T*>(a.bsc);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * (16 * kMT) + mt * 16 + g + 8 * hh;
      const int img = min(m0 + r, M - 1) / hw;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * (BN / 2) + t * 8 + tig * 2 + e, co = n0 + c;
          float v = acc[mt][t][2 * hh + e];
          if (first && co < a.cout) {
            v += to_f(bias[co]);
            if (trow) v += to_f(trow[static_cast<long long>(img) * a.cout + co]);
            if (bsc) v += to_f(bsc[co]);
          }
          E[r * LDE + c] = v;
        }
      }
    }
  }
  __syncthreads();
  if constexpr (CONV1) {
    // h, NHWC fp32: 16-byte stores along channels (sums where split)
    for (int i = tid; i < kBM * (BN / 4); i += kConvThreads) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int m = m0 + r, co = n0 + c;
      if (m >= M || co >= a.cout) continue;
      float* dst = a.h + static_cast<long long>(m) * a.cph + co;
      const float4 v = *reinterpret_cast<const float4*>(E + r * LDE + c);
      if (a.splits > 1) {
        atomicAdd(dst, v.x);
        if (co + 1 < a.cout) atomicAdd(dst + 1, v.y);
        if (co + 2 < a.cout) atomicAdd(dst + 2, v.z);
        if (co + 3 < a.cout) atomicAdd(dst + 3, v.w);
      } else {
        *reinterpret_cast<float4*>(dst) = v;
      }
    }
    if (a.part) {
      tile_stats(E, LDE, BN, m0, n0, M, hw, a.cout, a.cpg, blockIdx.x, blockIdx.y, gridDim.y,
                 a.slots, a.segs, a.part);
    }
  } else {
    // the output, NCHW: thread t owns row (pixel) t % kBM of the tile and
    // every (kConvThreads / kBM)-th channel, so each warp stores a run of
    // 32 pixels of one channel at a time
    constexpr int CSTEP = kConvThreads / kBM;
    static_assert(kConvThreads % kBM == 0, "whole tile rows a thread");
    const T* xid = static_cast<const T*>(a.xid);
    const int r = tid % kBM, m = m0 + r;
    if (m < M) {
      const int img = m / hw;
      const int cn = min(BN, a.cout - n0);
      long long o = (static_cast<long long>(img) * a.cout + n0 + tid / kBM) * hw + (m - img * hw);
      // 8 channels at a time, so that their loads of x are in flight together
      for (int c0 = tid / kBM; c0 < cn; c0 += 8 * CSTEP, o += 8 * CSTEP * hw) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + j * CSTEP;
          v[j] = c < cn ? E[r * LDE + c] : 0.0f;
          if (first && xid && c < cn) v[j] += to_f(xid[o + j * CSTEP * hw]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c0 + j * CSTEP >= cn) break;
          if (a.acc) {
            atomicAdd(a.acc + o + j * CSTEP * hw, v[j]);
          } else {
            static_cast<T*>(a.out)[o + j * CSTEP * hw] = from_f<T>(v[j]);
          }
        }
      }
    }
  }
}

// a split conv1's GN2 partials: grid (M tiles, channel tiles), h staged
// tile by tile as conv1's epilogue stages it
template <int BN>
__global__ void __launch_bounds__(kConvThreads)
    tile_stats_kernel(const float* h, float* part, int M, int hw, int cout, int cph, int cpg,
                      int slots, int segs) {
  constexpr int LDE = BN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* E = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < kBM * (BN / 4); i += kConvThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int m = m0 + r, co = n0 + c;
    if (m < M && co < cout) {
      *reinterpret_cast<float4*>(E + r * LDE + c) =
          *reinterpret_cast<const float4*>(h + static_cast<long long>(m) * cph + co);
    }
  }
  __syncthreads();
  tile_stats(E, LDE, BN, m0, n0, M, hw, cout, cpg, blockIdx.x, blockIdx.y, gridDim.y, slots,
             segs, part);
}

// 4. one block per (image, group): merge its GN2 partials (each thread a
// strided share, then the warps, then the block), write the per-channel
// scale and shift ss[(image * cout + c) * 2 + {0, 1}]
template <typename T>
__global__ void __launch_bounds__(kThreads)
fin2_kernel(const float* part, const T* gamma, const T* beta, float* ss, int hw, int cout,
            int G, int bn, int ntiles, int slots, int segs, float eps) {
  __shared__ Stat red[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x / G, gi = blockIdx.x % G, cpg = cout / G;
  const int mt0 = n * hw / kBM, mt1 = ((n + 1) * hw - 1) / kBM;
  const int nt0 = gi * cpg / bn, nt1 = ((gi + 1) * cpg - 1) / bn;
  const int nnt = nt1 - nt0 + 1, count = (mt1 - mt0 + 1) * nnt;
  Stat s{0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int mt = mt0 + i / nnt, nt = nt0 + i % nnt;
    const int slot = n - mt * kBM / hw, seg = gi - nt * bn / cpg;
    s = chan(s, load_stat(part + ((static_cast<long long>(mt * slots + slot) * ntiles + nt) *
                                  segs + seg) * 3));
  }
  s = warp_chan(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) s = chan(s, red[w]);
  const float rstd = 1.0f / sqrtf(s.m2 / s.n + eps);
  for (int c = gi * cpg + threadIdx.x; c < (gi + 1) * cpg; c += kThreads) {
    const float scale = to_f(gamma[c]) * rstd;
    ss[(static_cast<long long>(n) * cout + c) * 2] = scale;
    ss[(static_cast<long long>(n) * cout + c) * 2 + 1] = to_f(beta[c]) - s.mean * scale;
  }
}

// 5. hn = SiLU(h * scale + shift) rounded, NHWC with stride cph (channels
// from cout on written 0), 8 channels a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_h_kernel(const float* h, const float* ss, T* hn, int M, int hw, int cout, int cph) {
  const int vecs = cph / 8, total = M * vecs;   // < 2^31 (checked by the caller)
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    const int m = i / vecs, c = (i - m * vecs) * 8, n = m / hw;
    const float* src = h + static_cast<long long>(m) * cph + c;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float2* t = reinterpret_cast<const float2*>(ss) + n * cout + c;
    alignas(16) T o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = 0.0f;
      if (c + e < cout) {
        const float2 st = t[e];
        y = silu_of<T>(v[e] * st.x + st.y);
      }
      o[e] = from_f<T>(y);
    }
    uint4* dst = reinterpret_cast<uint4*>(hn + static_cast<long long>(m) * cph + c);
#pragma unroll
    for (int q = 0; q < static_cast<int>(sizeof(T)) / 2; ++q) {
      dst[q] = reinterpret_cast<const uint4*>(o)[q];
    }
  }
}

// a split conv2's sums, rounded once
template <typename T>
__global__ void __launch_bounds__(kThreads) store_out_kernel(const float* acc, T* out,
                                                             long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    out[i] = from_f<T>(acc[i]);
  }
}

int grid_of(long long items) {
  return static_cast<int>(std::min((items + kThreads - 1) / kThreads, 8LL * 65535));
}

template <typename T, int BN, bool CONV1>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  using S = ConvSmem<T, BN>;
  static_assert(S::total <= static_cast<size_t>(kMaxSmem), "tile too big");
  auto* kernel = conv_kernel<T, BN, CONV1>;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, kernel, S::total, true);
  if (e != cudaSuccess) return e;
  const int M = a.batch * a.height * a.width;
  const dim3 grid((M + kBM - 1) / kBM, (a.cout + BN - 1) / BN, a.splits);
  kernel<<<grid, kConvThreads, S::total, stream>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_tile_stats(const float* h, float* part, int M, int hw, int cout, int cph,
                              int cpg, int slots, int segs, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBM) * (BN + 4) * sizeof(float);
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, tile_stats_kernel<BN>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kBM - 1) / kBM, (cout + BN - 1) / BN);
  tile_stats_kernel<BN><<<grid, kConvThreads, smem, stream>>>(h, part, M, hw, cout, cph, cpg, slots,
                                                          segs);
  return cudaGetLastError();
}

struct BlockArgs {
  const void *x, *gn1_w, *gn1_b, *w1, *b1, *trow, *gn2_w, *gn2_b, *w2, *b2, *wsc, *bsc;
  void *out, *xn, *xs, *hn;
  float *h, *part1, *part2, *ss2, *acc;
  int batch, cin, cout, height, width, groups, cp1, cp2, bn, split1, split2, slots, segs;
  float eps;
};

// GN1's chunk of a slab: at least kChunk elements, at most kMaxChunks
// chunks a slab, a multiple of 8 (core/kernels.py::resnet_plan mirrors it)
int gn1_chunk(long long slab) {
  const long long per = ((slab + kMaxChunks - 1) / kMaxChunks + 7) / 8 * 8;
  return static_cast<int>(std::max(static_cast<long long>(kChunk), per));
}

template <typename T, int BN>
cudaError_t run(const BlockArgs& b, cudaStream_t stream) {
  const int hw = b.height * b.width, M = b.batch * hw;
  const long long slab = static_cast<long long>(b.cin / b.groups) * hw;
  const int chunk = gn1_chunk(slab);
  const int chunks = static_cast<int>((slab + chunk - 1) / chunk);
  stats_x_kernel<T><<<dim3(chunks, b.batch * b.groups), kThreads, 0, stream>>>(
      static_cast<const T*>(b.x), b.part1, slab, chunk, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  NormXArgs nx{b.x, b.gn1_w, b.gn1_b, b.part1, b.xn, b.wsc ? b.xs : nullptr,
               b.cin, b.cp1, b.groups, hw, chunks, b.eps};
  norm_x_kernel<T><<<dim3((hw + kNormPix - 1) / kNormPix, (b.cp1 + kNC - 1) / kNC, b.batch),
                      kThreads, 0, stream>>>(nx);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  ConvArgs c1{};
  c1.a = b.xn; c1.w = b.w1; c1.bias = b.b1; c1.trow = b.trow;
  c1.h = b.h; c1.part = b.split1 > 1 ? nullptr : b.part2;
  c1.cpa = b.cp1; c1.cout = b.cout; c1.cph = b.cp2;
  c1.height = b.height; c1.width = b.width; c1.batch = b.batch; c1.splits = b.split1;
  c1.slots = b.slots; c1.segs = b.segs; c1.cpg = b.cout / b.groups;
  if (b.split1 > 1) {
    e = cudaMemsetAsync(b.h, 0, static_cast<size_t>(M) * b.cp2 * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  e = launch_conv<T, BN, true>(c1, stream);
  if (e != cudaSuccess) return e;
  if (b.split1 > 1) {
    e = launch_tile_stats<BN>(b.h, b.part2, M, hw, b.cout, b.cp2, c1.cpg, b.slots, b.segs,
                              stream);
    if (e != cudaSuccess) return e;
  }
  const int ntiles = (b.cout + BN - 1) / BN;
  fin2_kernel<T><<<b.batch * b.groups, kThreads, 0, stream>>>(
      b.part2, static_cast<const T*>(b.gn2_w), static_cast<const T*>(b.gn2_b), b.ss2, hw, b.cout,
      b.groups, BN, ntiles, b.slots, b.segs, b.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norm_h_kernel<T><<<grid_of(static_cast<long long>(M) * (b.cp2 / 8)), kThreads, 0, stream>>>(
      b.h, b.ss2, static_cast<T*>(b.hn), M, hw, b.cout, b.cp2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  ConvArgs c2{};
  c2.a = b.hn; c2.w = b.w2; c2.bias = b.b2;
  c2.asc = b.wsc ? b.xs : nullptr; c2.wsc = b.wsc; c2.bsc = b.bsc;
  c2.xid = b.wsc ? nullptr : b.x;
  c2.out = b.out;
  c2.cpa = b.cp2; c2.cpx = b.cp1; c2.cout = b.cout;
  c2.height = b.height; c2.width = b.width; c2.batch = b.batch; c2.splits = b.split2;
  const long long outs = static_cast<long long>(M) * b.cout;
  if (b.split2 > 1) {
    c2.acc = b.acc;
    e = cudaMemsetAsync(b.acc, 0, outs * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  e = launch_conv<T, BN, false>(c2, stream);
  if (e != cudaSuccess || b.split2 == 1) return e;
  store_out_kernel<T><<<grid_of(outs), kThreads, 0, stream>>>(b.acc, static_cast<T*>(b.out),
                                                              outs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bn(const BlockArgs& b, cudaStream_t stream) {
  switch (b.bn) {
    case 64: return run<T, 64>(b, stream);
    case 128: return run<T, 128>(b, stream);
    case 160: return run<T, 160>(b, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int BN>
cudaError_t occupancy(int* out) {
  using S = ConvSmem<T, BN>;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, conv_kernel<T, BN, true>, S::total, true);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], conv_kernel<T, BN, true>, kConvThreads,
                                                    S::total);
  out[1] = static_cast<int>(S::total);
  return e;
}

}  // namespace

extern "C" {

// x (N, cin, H, W), out (N, cout, H, W) in the storage dtype (0 = float32,
// 1 = bfloat16), as are every bias, GroupNorm affine and trow (N, cout);
// trow null: no time embedding; wsc and bsc null: the identity shortcut
// (cin == cout). w1 (cout, 3, 3, cp1), w2 (cout, 3, 3, cp2) and wsc (cout,
// cp1) packed, channels zero-padded to cp1 = cin and cp2 = cout rounded up
// to a multiple of 8. Scratch: xn, xs (xs only with wsc) (N, H, W, cp1) and
// hn (N, H, W, cp2) in the storage dtype; h (N, H, W, cp2), part1 (N *
// groups * ceil(cin / groups * H * W / 16384) * 3), part2 (mtiles * slots
// * ntiles * segs * 3), ss2 (N, cout, 2) and, where split2 > 1, acc (N,
// cout, H, W), all fp32. bn (64, 128 or 160), the splits over K, slots and
// segs are the plan's. Returns a cudaError_t (0 = success).
int ea_resnet_fused(const void* x, const void* gn1_w, const void* gn1_b, const void* w1,
                    const void* b1, const void* trow, const void* gn2_w, const void* gn2_b,
                    const void* w2, const void* b2, const void* wsc, const void* bsc, void* out,
                    void* xn, void* xs, float* h, void* hn, float* part1, float* part2,
                    float* ss2, float* acc, int batch, int cin, int cout, int height, int width,
                    int groups, int cp1, int cp2, int bn, int split1, int split2, int slots,
                    int segs, float eps, int dtype, void* stream) {
  if (batch < 1 || cin < 1 || cout < 1 || groups < 1 || cin % groups || cout % groups ||
      height < 1 || width < 1 || (!wsc && cin != cout) || (wsc && (!bsc || !xs)) ||
      cp1 < cin || cp1 % 8 || cp2 < cout || cp2 % 8 || split1 < 1 || split2 < 1 ||
      (split2 > 1 && !acc) || slots < 1 || segs < 1 ||
      static_cast<long long>(batch) * height * width * std::max(cp1, cp2) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockArgs b{x, gn1_w, gn1_b, w1, b1, trow, gn2_w, gn2_b, w2, b2, wsc, bsc,
              out, xn, xs, hn, h, part1, part2, ss2, acc,
              batch, cin, cout, height, width, groups, cp1, cp2, bn, split1, split2, slots, segs,
              eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(run_bn<__nv_bfloat16>(b, s));
  if (dtype == 0) return static_cast<int>(run_bn<float>(b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// conv1's blocks per SM on the current device and its dynamic shared
// memory in bytes, out[0] and out[1], for channel tile bn and dtype
int ea_resnet_occupancy(int bn, int dtype, int* out) {
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (bn == 64) e = occupancy<__nv_bfloat16, 64>(out);
    if (bn == 128) e = occupancy<__nv_bfloat16, 128>(out);
    if (bn == 160) e = occupancy<__nv_bfloat16, 160>(out);
  } else if (dtype == 0) {
    if (bn == 64) e = occupancy<float, 64>(out);
    if (bn == 128) e = occupancy<float, 128>(out);
    if (bn == 160) e = occupancy<float, 160>(out);
  }
  return static_cast<int>(e);
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

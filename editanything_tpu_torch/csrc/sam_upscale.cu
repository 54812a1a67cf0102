// SAM's mask-decoder output path for Hopper (sm_90a), forward only
// (kernel C): upscale + hypernetwork products.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/kernels.py
// (_sam_upscale_kernel, :209; _sam_upscale_pallas, :254; sam_upscale_hyper,
// :280). Per prompt b and input pixel i of the (e x e, 256) keys: for each
// tap (di, dj) of the first 2x2/s2 ConvTranspose, y = x_i W1[di,dj] + b1
// (256 -> 64), LayerNorm2d (eps 1e-6), GELU; for each tap (di2, dj2) of the
// second, z = y W2[di2,dj2] + b2 (64 -> 32), GELU; then the products with
// the 4 hypernetwork vectors, written to
// mask[b, t, 4i_y + 2di + di2, 4i_x + 2dj + dj2]. Torch ConvTranspose taps,
// no flip. Products of storage-dtype values with fp32 sums, as the Pallas
// kernel (y and z rounded to the storage dtype before the next product).
//
// What bounds it on this card: per 256-prompt AMG batch (e = 64) it does
// ~210 GFLOP on the tensor cores (4 taps x (256x64 + 64x128) MACs per input
// pixel plus the hypernetwork products), 0.21 ms at the bf16 peak, and
// moves 512 MiB of keys in and 128 MiB of logits out, 0.20 ms of device
// memory; and it takes ~805 M GELUs (768 per input pixel) on the CUDA cores
// and the special-function unit, which no tensor core helps.
//
// Design (bf16): a persistent grid, one 8-warp block per SM (SMs x blocks
// per SM, at most the work items), each block walking (prompt, 64-pixel
// tile) items. The block loads all four taps of W1 (132 KB with padding)
// and W2 (18 KB) into shared memory once, not once per tile, and keeps them
// resident; source tiles come through a two-stage cp.async ring, the next
// item's tile loading while the current one is multiplied. Warp w takes
// tap w / 2 for 32 of the tile's pixels (two m16 tiles sharing each weight
// fragment): the 256 -> 64 product on mma.sync from ldmatrix fragments,
// bias, LayerNorm2d by quad shuffles and GELU in registers, and the bf16 y
// goes from the accumulators straight into the A fragments of the
// 64 -> 128 product (as flash attention passes P), so y is never staged.
// GELU uses erf from Abramowitz & Stegun 7.1.26 (|error| <= 1.5e-7, one
// exponential and one reciprocal; the JAX kernel's own form, :191-206)
// instead of erff. The hypernetwork products run on mma.sync too: per
// second-conv tap the 32 channels of z against hyper^T (32 x 4, padded to
// 8 columns) from registers, the selection matrix of the TPU kernel
// (4 nm x 128, block diagonal) without its zero blocks. The tile's
// 64 x 4 x 16 outputs collect in shared memory (8 KB) and leave as 16-byte
// streaming stores, two input pixels' 4 columns each, so the pixel shuffle
// of the JAX wrapper (:341-344) is index arithmetic here. Shared memory:
// 132 + 18 + 2 x 33 (ring) + 8 (outputs) + 1.25 (vectors) KB = 225.25 KB,
// so one block per SM; taps split over a cluster of two were not needed.
// fp32 (the tests' path) keeps the first design: one block of 4 warps per
// 64 input pixels of a prompt, each tap's W1 staged in turn, exact FMAs
// and erff.
//
// Plain C interface for ctypes: ea_sam_upscale returns cudaGetLastError(),
// 0 on success.

#include "common.cuh"

namespace {

using namespace ea;

constexpr int kC = 256;        // key channels (every SAM variant)
constexpr int kC1 = 64;        // after the first ConvTranspose
constexpr int kC2 = 128;       // 4 taps x 32 channels of the second
constexpr int kNm = 4;         // hypernetwork vectors (mask tokens)
constexpr int kWarps = 4;
constexpr int kR = kWarps * 16;   // pixels per block

struct Params {
  const void* src;     // (B, M, 256)
  const void* w1;      // (4 taps, 64 out, 256 in)
  const float* b1;     // (64)
  const float* ln_w;   // (64)
  const float* ln_b;   // (64)
  const void* w2;      // (128 = tap * 32 + out, 64 in)
  const float* b2;     // (128), b2 tiled over the taps
  const void* hyper;   // (B, 4, 32)
  void* out;           // (B, 4, 4e, 4e)
  int M, e;
  float eps;
};

template <typename T>
struct UpSmem {
  static constexpr int LDX = kC + pad_of<T>();
  static constexpr int LDY = kC1 + pad_of<T>();
  static constexpr size_t x = 0;
  static constexpr size_t w1 = align128(x + kR * LDX * sizeof(T));
  static constexpr size_t w2 = align128(w1 + kC1 * LDX * sizeof(T));
  static constexpr size_t y = align128(w2 + kC2 * LDY * sizeof(T));
  static constexpr size_t h = align128(y + kR * LDY * sizeof(T));
  static constexpr size_t out = align128(h + kNm * 32 * sizeof(float));
  static constexpr size_t total = align128(out + kNm * 16 * kR * sizeof(float));
};

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) upscale_kernel(Params p) {
  using S = UpSmem<T>;
  constexpr int LDX = S::LDX, LDY = S::LDY;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem + S::x);
  T* sW1 = reinterpret_cast<T*>(smem + S::w1);
  T* sW2 = reinterpret_cast<T*>(smem + S::w2);
  T* sY = reinterpret_cast<T*>(smem + S::y);
  float* sH = reinterpret_cast<float*>(smem + S::h);
  float* sOut = reinterpret_cast<float*>(smem + S::out);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int b = blockIdx.y, pix0 = blockIdx.x * kR;
  const int rows = min(kR, p.M - pix0);
  const T* src = static_cast<const T*>(p.src) +
                 (static_cast<long long>(b) * p.M + pix0) * kC;
  copy_tile(sX, LDX, src, kC, rows, kC);
  for (int i = tid; i < (kR - rows) * kC; i += blockDim.x) {
    sX[(rows + i / kC) * LDX + i % kC] = from_f<T>(0.0f);
  }
  copy_tile(sW2, LDY, static_cast<const T*>(p.w2), kC1, kC2, kC1);
  const T* hyper = static_cast<const T*>(p.hyper) +
                   static_cast<long long>(b) * kNm * 32;
  for (int i = tid; i < kNm * 32; i += blockDim.x) sH[i] = to_f(hyper[i]);

  for (int k = 0; k < 4; ++k) {
    const int di = k >> 1, dj = k & 1;
    __syncthreads();   // sW1 and sY are free
    copy_tile(sW1, LDX, static_cast<const T*>(p.w1) + k * kC1 * kC, kC, kC1, kC);
    __syncthreads();
    float c[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.0f;
    warp_mm<8>(c, sX + warp * 16 * LDX, LDX, sW1, LDX, kC);
    // + b1, LayerNorm2d over the 64 channels of rows g and g + 8, GELU
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          c[t][2 * rr + e] += p.b1[t * 8 + tig * 2 + e];
          sum += c[t][2 * rr + e];
        }
      }
      const float mean = quad_sum(sum) / kC1;
      float var = 0.0f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = c[t][2 * rr + e] - mean;
          var += d * d;
        }
      }
      const float rstd = rsqrtf(quad_sum(var) / kC1 + p.eps);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t * 8 + tig * 2 + e;
          const float yv = (c[t][2 * rr + e] - mean) * rstd * p.ln_w[col] +
                           p.ln_b[col];
          sY[(warp * 16 + g + 8 * rr) * LDY + col] = from_f<T>(gelu(yv));
        }
      }
    }
    __syncwarp();
    float z[16][4];
#pragma unroll
    for (int t = 0; t < 16; ++t) z[t][0] = z[t][1] = z[t][2] = z[t][3] = 0.0f;
    warp_mm<16>(z, sY + warp * 16 * LDY, LDY, sW2, LDY, kC1);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[t][e] = round_to<T>(gelu(z[t][e] + p.b2[t * 8 + tig * 2 + (e & 1)]));
      }
    }
    // hypernetwork products: tap2 owns columns [32 tap2, 32 tap2 + 32),
    // i.e. fragment tiles 4 tap2 .. 4 tap2 + 3
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int pix = warp * 16 + g + 8 * rr;
#pragma unroll
      for (int tap2 = 0; tap2 < 4; ++tap2) {
        const int sr = 2 * di + (tap2 >> 1), sc = 2 * dj + (tap2 & 1);
#pragma unroll
        for (int t = 0; t < kNm; ++t) {
          float s = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int o = q * 8 + tig * 2 + e;
              s = fmaf(z[tap2 * 4 + q][2 * rr + e], sH[t * 32 + o], s);
            }
          }
          s = quad_sum(s);
          if (tig == t) sOut[((t * 4 + sr) * kR + pix) * 4 + sc] = s;
        }
      }
    }
  }
  __syncthreads();
  const int w4 = 4 * p.e;
  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < kNm * 4 * kR; i += blockDim.x) {
    const int pix = i % kR, sr = (i / kR) % 4, t = i / (4 * kR);
    const int gp = pix0 + pix;
    if (gp >= p.M) continue;
    const int iy = gp / p.e, ix = gp - (gp / p.e) * p.e;
    T* dst = out + ((static_cast<long long>(b) * kNm + t) * w4 + 4 * iy + sr) * w4 +
             4 * ix;
    store4(dst, sOut + ((t * 4 + sr) * kR + pix) * 4);
  }
}

// ---------------------------------------------------------------------------
// bf16: the persistent kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;             // input pixels per work item
constexpr int kMT = 2;                // m16 tiles (16 pixels each) per warp
constexpr int kPWarps = 4 * (kTile / (16 * kMT));   // taps x pixel groups
constexpr int kPThreads = kPWarps * 32;
constexpr int kStages = 2;            // source tiles in the cp.async ring

struct PSmem {
  static constexpr int LDX = kC + 8;     // 264: rows 16-byte aligned, banks spread
  static constexpr int LDY = kC1 + 8;    // 72
  static constexpr size_t w1 = 0;
  static constexpr size_t w2 = align128(w1 + 4 * kC1 * LDX * sizeof(bf16));
  static constexpr size_t x = align128(w2 + kC2 * LDY * sizeof(bf16));
  static constexpr size_t out = align128(x + kStages * kTile * LDX * sizeof(bf16));
  static constexpr size_t vec = align128(out + kNm * 16 * kTile * sizeof(bf16));
  static constexpr size_t total = align128(vec + (3 * kC1 + kC2) * sizeof(float));
};
static_assert(PSmem::total <= static_cast<size_t>(kMaxSmem), "kernel C's shared memory");

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// exact GELU through erf from Abramowitz & Stegun 7.1.26 (|error| <= 1.5e-7):
// with a = |x| / sqrt(2), 1 - erf(a) = poly(t) exp(-a^2), t = 1 / (1 + p a),
// one reciprocal and one exponential on the special-function unit; then
// GELU(x) = x - x (1 - erf(a)) / 2 for x >= 0 and x (1 - erf(a)) / 2 below
__device__ __forceinline__ float gelu_as(float x) {
  const float a = fabsf(x) * 0.70710678118654752f;
  const float t = rcp_approx(fmaf(0.3275911f, a, 1.0f));
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float h = 0.5f * x * (poly * ex2_approx(a * (a * -1.4426950408889634f)));
  return x >= 0.0f ? x - h : h;
}

__global__ void __launch_bounds__(kPThreads, 1)
    upscale_persistent_kernel(Params p, int batch) {
  using S = PSmem;
  constexpr int LDX = S::LDX, LDY = S::LDY;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW1 = reinterpret_cast<bf16*>(smem + S::w1);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + S::w2);
  bf16* sX = reinterpret_cast<bf16*>(smem + S::x);
  bf16* sOut = reinterpret_cast<bf16*>(smem + S::out);
  float* sB1 = reinterpret_cast<float*>(smem + S::vec);
  float* sLnW = sB1 + kC1;
  float* sLnB = sLnW + kC1;
  float* sB2 = sLnB + kC1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int tiles = (p.M + kTile - 1) / kTile;
  const int items = batch * tiles;
  const bf16* src_all = static_cast<const bf16*>(p.src);

  // every tap of W1 and all of W2, once per block
  copy_tile_async(sW1, LDX, static_cast<const bf16*>(p.w1), kC, 4 * kC1, kC);
  copy_tile_async(sW2, LDY, static_cast<const bf16*>(p.w2), kC1, kC2, kC1);
  for (int i = tid; i < kC1; i += kPThreads) {
    sB1[i] = p.b1[i];
    sLnW[i] = p.ln_w[i];
    sLnB[i] = p.ln_b[i];
  }
  for (int i = tid; i < kC2; i += kPThreads) sB2[i] = p.b2[i];

  // item -> its 64 x 256 source tile in ring stage `stage`, rows past the
  // image zero-filled
  auto load_tile = [&](int item, int stage) {
    const int b = item / tiles, pix0 = (item - b * tiles) * kTile;
    const int rows = min(kTile, p.M - pix0);
    const bf16* src = src_all + (static_cast<long long>(b) * p.M + pix0) * kC;
    bf16* dst = sX + stage * kTile * LDX;
    for (int i = tid; i < kTile * (kC / 8); i += kPThreads) {
      const int r = i / (kC / 8), c = (i % (kC / 8)) * 8;
      const bool valid = r < rows;
      cp_async16_zfill(dst + r * LDX + c, src + (valid ? r * kC + c : 0), valid);
    }
  };

  int item = blockIdx.x;
  if (item < items) load_tile(item, 0);
  cp_async_commit();

  constexpr int kGroups = kPWarps / 4;     // pixel groups of a tile
  const int tap = warp / kGroups, di = tap >> 1, dj = tap & 1;
  const int prow = (warp % kGroups) * 16 * kMT;   // this warp's pixels
  const int w4 = 4 * p.e;
  bf16* out_all = static_cast<bf16*>(p.out);

  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int stage = it % kStages;
    const int next = item + gridDim.x;
    if (next < items) load_tile(next, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();     // this item's tile (and, first, the weights)
    __syncthreads();

    const int b = item / tiles, pix0 = (item - b * tiles) * kTile;
    // hyper^T as B fragments (k = channel, n = mask token, columns 4-7 zero)
    uint32_t hb[2][2];
    {
      const bf16* hyper = static_cast<const bf16*>(p.hyper) +
                          (static_cast<long long>(b) * kNm + (g & 3)) * 32;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        hb[s][0] = g < kNm ? lds32(hyper + s * 16 + 2 * tig) : 0u;
        hb[s][1] = g < kNm ? lds32(hyper + s * 16 + 8 + 2 * tig) : 0u;
      }
    }

    // y = x W1[tap]^T for the warp's two m16 tiles
    float acc[kMT][8][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.0f;
    const bf16* X = sX + stage * kTile * LDX + prow * LDX;
    const bf16* W = sW1 + tap * kC1 * LDX;
#pragma unroll 4
    for (int kk = 0; kk < kC / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        ldsm_x4(a[m], X + (m * 16 + (lane & 15)) * LDX + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int tp = 0; tp < 4; ++tp) {
        uint32_t bq[4];
        ldsm_x4(bq, W + (tp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDX +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          mma_bf16(acc[m][2 * tp], a[m], bq[0], bq[1]);
          mma_bf16(acc[m][2 * tp + 1], a[m], bq[2], bq[3]);
        }
      }
    }

    // + b1, LayerNorm2d over the 64 channels of each row, GELU, rounded to
    // bf16 straight into the A fragments of the 64 -> 128 product
    uint32_t ya[kMT][4][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float sum = 0.0f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 bias = *reinterpret_cast<const float2*>(sB1 + t * 8 + tig * 2);
          acc[m][t][2 * rr] += bias.x;
          acc[m][t][2 * rr + 1] += bias.y;
          sum += acc[m][t][2 * rr] + acc[m][t][2 * rr + 1];
        }
        const float mean = quad_sum(sum) * (1.0f / kC1);
        float var = 0.0f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = acc[m][t][2 * rr + e] - mean;
            var += d * d;
          }
        }
        const float rstd = rsqrtf(quad_sum(var) * (1.0f / kC1) + p.eps);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 lw = *reinterpret_cast<const float2*>(sLnW + t * 8 + tig * 2);
          const float2 lb = *reinterpret_cast<const float2*>(sLnB + t * 8 + tig * 2);
          acc[m][t][2 * rr] = gelu_as(fmaf((acc[m][t][2 * rr] - mean) * rstd, lw.x, lb.x));
          acc[m][t][2 * rr + 1] =
              gelu_as(fmaf((acc[m][t][2 * rr + 1] - mean) * rstd, lw.y, lb.y));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ya[m][j][0] = pack_bf16(acc[m][2 * j][0], acc[m][2 * j][1]);
        ya[m][j][1] = pack_bf16(acc[m][2 * j][2], acc[m][2 * j][3]);
        ya[m][j][2] = pack_bf16(acc[m][2 * j + 1][0], acc[m][2 * j + 1][1]);
        ya[m][j][3] = pack_bf16(acc[m][2 * j + 1][2], acc[m][2 * j + 1][3]);
      }
    }

    // z = y W2^T, one half of its 128 columns (second-conv taps 2h, 2h + 1)
    // at a time, then GELU and the hypernetwork products per tap
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float z[kMT][8][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int t = 0; t < 8; ++t) z[m][t][0] = z[m][t][1] = z[m][t][2] = z[m][t][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < kC1 / 16; ++j) {
#pragma unroll
        for (int tp = 0; tp < 4; ++tp) {
          uint32_t bq[4];
          ldsm_x4(bq, sW2 + (h * 64 + tp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDY +
                          j * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_bf16(z[m][2 * tp], ya[m][j], bq[0], bq[1]);
            mma_bf16(z[m][2 * tp + 1], ya[m][j], bq[2], bq[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {          // second-conv tap 2h + q
          uint32_t za[2][4];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = 4 * q + 2 * s + half;
              const float2 bias =
                  *reinterpret_cast<const float2*>(sB2 + h * 64 + t * 8 + tig * 2);
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] = gelu_as(z[m][t][e] + (e & 1 ? bias.y : bias.x));
              za[s][2 * half] = pack_bf16(v[0], v[1]);
              za[s][2 * half + 1] = pack_bf16(v[2], v[3]);
            }
          }
          float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(o, za[0], hb[0][0], hb[0][1]);
          mma_bf16(o, za[1], hb[1][0], hb[1][1]);
          if (tig < 2) {    // columns 2 tig, 2 tig + 1 are mask tokens 0-3
            const int sr = 2 * di + h, sc = 2 * dj + q;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int pix = prow + m * 16 + g + 8 * rr;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int tok = 2 * tig + e;
                sOut[((tok * 4 + sr) * kTile + pix) * 4 + sc] = __float2bfloat16(o[2 * rr + e]);
              }
            }
          }
        }
      }
    }
    __syncthreads();

    // the tile's logits: per (token, output row) the 4 columns of each
    // input pixel, two pixels (16 bytes) per store where e is even
    if (p.e % 2 == 0) {
      for (int i = tid; i < kNm * 4 * (kTile / 2); i += kPThreads) {
        const int pix = 2 * (i % (kTile / 2)), sr = (i / (kTile / 2)) % 4;
        const int tok = i / (4 * (kTile / 2));
        const int gp = pix0 + pix;
        if (gp >= p.M) continue;
        const int iy = gp / p.e, ix = gp - iy * p.e;
        bf16* dst = out_all + ((static_cast<long long>(b) * kNm + tok) * w4 + 4 * iy + sr) * w4 + 4 * ix;
        __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(
            sOut + ((tok * 4 + sr) * kTile + pix) * 4));
      }
    } else {
      for (int i = tid; i < kNm * 4 * kTile; i += kPThreads) {
        const int pix = i % kTile, sr = (i / kTile) % 4, tok = i / (4 * kTile);
        const int gp = pix0 + pix;
        if (gp >= p.M) continue;
        const int iy = gp / p.e, ix = gp - iy * p.e;
        bf16* dst = out_all + ((static_cast<long long>(b) * kNm + tok) * w4 + 4 * iy + sr) * w4 + 4 * ix;
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(
            sOut + ((tok * 4 + sr) * kTile + pix) * 4);
      }
    }
  }
  cp_async_wait<0>();
}

// SMs and blocks per SM of the persistent kernel, per device
struct Persist {
  int grid[kMaxDevices] = {};
};

cudaError_t persistent_grid(int* grid) {
  static Persist cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < kMaxDevices && cache.grid[dev] > 0) {
    *grid = cache.grid[dev];
    return cudaSuccess;
  }
  static SmemGrant grant;
  if ((e = grant_smem(grant, upscale_persistent_kernel, PSmem::total)) != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, upscale_persistent_kernel, kPThreads, PSmem::total)) != cudaSuccess) {
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (dev >= 0 && dev < kMaxDevices) cache.grid[dev] = *grid;
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const Params& p, int batch, cudaStream_t stream);

template <>
cudaError_t run<float>(const Params& p, int batch, cudaStream_t stream) {
  using S = UpSmem<float>;
  static_assert(S::total <= static_cast<size_t>(kMaxSmem), "tile too big");
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, upscale_kernel<float>, S::total);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + kR - 1) / kR, batch);
  upscale_kernel<float><<<grid, kWarps * 32, S::total, stream>>>(p);
  return cudaGetLastError();
}

template <>
cudaError_t run<bf16>(const Params& p, int batch, cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = persistent_grid(&grid);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(batch) * ((p.M + kTile - 1) / kTile);
  grid = static_cast<int>(items < grid ? items : grid);
  upscale_persistent_kernel<<<grid, kPThreads, PSmem::total, stream>>>(p, batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; M = e * e input pixels per prompt.
// Returns a cudaError_t (0 = success).
int ea_sam_upscale(const void* src, const void* w1, const float* b1,
                   const float* ln_w, const float* ln_b, const void* w2,
                   const float* b2, const void* hyper, void* out, int batch,
                   int M, int e, float eps, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || e < 1 || M != e * e) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.src = src; p.w1 = w1; p.b1 = b1; p.ln_w = ln_w; p.ln_b = ln_b;
  p.w2 = w2; p.b2 = b2; p.hyper = hyper; p.out = out;
  p.M = M; p.e = e; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(run<__nv_bfloat16>(p, batch, s));
  if (dtype == 0) return static_cast<int>(run<float>(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// bf16 persistent kernel and of the fp32 kernel, into out[0], out[1].
int ea_sam_upscale_occupancy(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static SmemGrant grant_p, grant_f;
  if ((e = grant_smem(grant_p, upscale_persistent_kernel, PSmem::total)) != cudaSuccess) return e;
  if ((e = grant_smem(grant_f, upscale_kernel<float>, UpSmem<float>::total)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[0], upscale_persistent_kernel, kPThreads, PSmem::total)) != cudaSuccess) {
    return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], upscale_kernel<float>, kWarps * 32, UpSmem<float>::total);
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

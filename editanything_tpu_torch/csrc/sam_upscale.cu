// SAM's mask-decoder output path for Hopper (sm_90a), forward only
// (kernel C): upscale + hypernetwork products.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/kernels.py
// (_sam_upscale_kernel, :209; _sam_upscale_pallas, :254; sam_upscale_hyper,
// :280). Per prompt b and input pixel i of the (e x e, 256) keys: for each
// tap (di, dj) of the first 2x2/s2 ConvTranspose, y = x_i W1[di,dj] + b1
// (256 -> 64), LayerNorm2d (eps 1e-6), exact GELU; for each tap (di2, dj2)
// of the second, z = y W2[di2,dj2] + b2 (64 -> 32), GELU; then the products
// with the 4 hypernetwork vectors, written to
// mask[b, t, 4i_y + 2di + di2, 4i_x + 2dj + dj2]. Torch ConvTranspose taps,
// no flip. Products of storage-dtype values with fp32 sums, as the Pallas
// kernel (y and z rounded to the storage dtype before the next product).
//
// What bounds it on this card: per 256-prompt AMG batch it reads 512 MiB of
// keys and writes 128 MiB of logits (bf16), ~0.2 ms of device memory, and
// does ~70 GFLOP (4 taps x (256x64 + 64x128) MACs per pixel, plus the
// hypernetwork products), ~0.1 ms at the tensor cores' peak: both small;
// the XLA form it replaces materialises ~0.6 GB of intermediates per batch.
//
// Design: every input pixel emits its own 4x4 output block independently,
// so one block of 4 warps takes 64 consecutive pixels of one prompt, each
// warp 16 of them. Per tap, W1[di,dj] (64 x 256) is staged in shared
// memory and multiplied on mma.sync (warp_mm); bias, LayerNorm over the 64
// channels (quad shuffles on the fragment layout) and GELU in registers;
// y goes to shared memory as the A operand of the 64 -> 128 product with
// all four taps of W2 (resident); GELU, then the hypernetwork products
// reduced across each quad. The block's 64 x 4 x 16 outputs collect in
// shared memory and are written as rows of 4 consecutive values, so the
// pixel shuffle of the JAX wrapper (:341-344) is index arithmetic here.
// fp32 (the tests' path) uses the same code with exact FMAs.
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
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
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

template <typename T>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  using S = UpSmem<T>;
  static_assert(S::total <= static_cast<size_t>(kMaxSmem), "tile too big");
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, upscale_kernel<T>, S::total);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + kR - 1) / kR, batch);
  upscale_kernel<T><<<grid, kWarps * 32, S::total, stream>>>(p);
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

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

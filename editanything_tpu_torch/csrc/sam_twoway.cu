// SAM's two-way transformer for Hopper (sm_90a), forward only (kernel D).
//
// Replaces the Pallas TPU kernel editanything_tpu/core/kernels.py
// (_twoway_kernel, :347; _twoway_pallas, :511; sam_twoway, :550). It
// computes what that kernel computes for B prompts sharing one image input
// src1 (M rows of width 256): per layer, token self-attention (layer 0
// replaces the queries), token->image attention at inner width 128, a ReLU
// MLP of width 2048, image->token attention with the update of every image
// row; then a final token->image attention. 8 heads; LayerNorm eps 1e-5.
// Cast points are the Pallas kernel's: projections take storage-dtype
// inputs with fp32 sums, probabilities are rounded to the storage dtype
// before the product with v, the tokens stay fp32, the keys are stored in
// the storage dtype between layers.
//
// What bounds it on this card: the Pallas kernel keeps one prompt's keys
// (4096 x 256), pe and ~5-8 MB of packed weights resident in 128 MiB of
// VMEM for the whole depth; a Hopper block has 227 KB. The work is the
// per-row projections (about 8.4 MFLOP per 64 image rows per layer, on the
// tensor cores) and one read and write of the keys per layer (2 MiB per
// prompt in bf16); at the AMG's 256 prompts that is ~275 GFLOP and ~1 GiB
// per layer, so the tensor cores and the weight traffic into shared memory
// bound it, not device memory.
//
// Design: the dependency structure splits the transformer into two kinds of
// launch that alternate (7 launches for SAM's 2 layers):
//   twoway_tokens, one block per prompt: everything on the <= 24 tokens
//     (self-attention, MLP, LayerNorms, the merge of the token->image
//     attention partials, the token-side projections for the next image
//     pass), scalar fp32 FMAs over storage-dtype values, each warp 4
//     output columns at a time with one 16-byte weight load per lane and
//     column in flight together (tok_linear);
//   twoway_rows, one block per (tile of 64 image rows, prompt): image->token
//     attention for its rows (each row attends over the tokens; out
//     projection, residual, LayerNorm 4), writing the new keys tile once,
//     then the next token->image attention's K and V for the same rows and
//     its split-K partials (the tile's max, sum of exponentials and output
//     per token and head, flash-decoding style; the exponentials rounded to
//     the storage dtype before the product with v, as the twin rounds them),
//     merged by the next token launch. Projections
//     run on mma.sync m16n8k16 (warp_mm) with weights staged 64 output rows
//     at a time. The first pass reads src1 for every prompt (batch stride 0)
//     and recomputes layer 0's K/V of the shared rows per prompt.
// fp32 (the tests' path) uses the same code with exact FMAs (warp_mm's fp32
// twin) and 32-row tiles to fit shared memory.
//
// Plain C interface for ctypes: ea_sam_twoway returns cudaGetLastError() of
// its launches, 0 on success.

#include "common.cuh"

namespace {

using namespace ea;

constexpr int kD = 256;          // width
constexpr int kC = 128;          // cross-attention inner width
constexpr int kF = 2048;         // MLP width
constexpr int kHeads = 8;
constexpr int kHdC = kC / kHeads;   // 16
constexpr int kHdS = kD / kHeads;   // 32
constexpr int kMaxT = 24;
constexpr int kMaxLayers = 4;
constexpr int kMats = 14, kVecs = 22;  // per layer, in core/kernels.py order
constexpr int kPart = 2 + kHdC;        // max, sum, output
constexpr int kTokThreads = 256;
constexpr int kLdt = kD + 4;           // fp32 token rows in shared memory

// a layer's matrices (and their biases at the same vector index)
enum { SQ, SK, SV, SO, TQ, TK, TV, TO, M1, M2, IQ, IK, IV, IO };
// a layer's LayerNorm affines: norm j (1..4) weight at kNorm + 2 (j - 1)
constexpr int kNorm = 14;

struct Params {
  const void* src;
  long long src_sb;      // batch stride of src (0: one input for all)
  const float* pe;       // (M, 256)
  const float* tokens;   // (B, T, 256)
  const void* w;         // matrices, storage dtype, (out, in) row-major
  const float* v;        // biases and LayerNorm affines
  long long wo[kMaxLayers * kMats + 4];
  long long vo[kMaxLayers * kVecs + 6];
  int n_layers;
  void* keys;            // (B, M, 256) storage dtype
  void* q_out;           // (B, T, 256) storage dtype
  float* q;              // (B, T, 256) token state between launches
  void* tokkv;           // (B, 2, T, 128) image->token K and V of the tokens
  void* tq;              // (B, T, 128) queries of the next token->image pass
  float* part;           // (B, tiles, T, 8, kPart)
  int B, M, T, tiles;
};

// token->image attention a (a layer, or n_layers: the final one); j = 0..3
// for q, k, v, out
__device__ __forceinline__ long long t2i_w(const Params& p, int a, int j) {
  return a < p.n_layers ? p.wo[a * kMats + TQ + j] : p.wo[p.n_layers * kMats + j];
}
__device__ __forceinline__ long long t2i_v(const Params& p, int a, int j) {
  return a < p.n_layers ? p.vo[a * kVecs + TQ + j] : p.vo[p.n_layers * kVecs + j];
}

// ---------------------------------------------------------------------------
// row tiles
// ---------------------------------------------------------------------------

template <typename T, int WARPS>
struct RowSmem {
  static constexpr int R = WARPS * 16;
  static constexpr int LDX = kD + pad_of<T>();
  static constexpr int LDF = kD + 4;
  static constexpr int LDC = kC + pad_of<T>();
  // weight rows staged at a time, double-buffered
  static constexpr int NC = sizeof(T) == 2 ? 64 : 32;
  static constexpr size_t xs = R * LDX * sizeof(T);
  static constexpr size_t fs = R * LDF * 4 > xs ? R * LDF * 4 : xs;
  static constexpr size_t cs = R * LDC * sizeof(T);
  static constexpr size_t ts = kMaxT * LDC * sizeof(T);
  static constexpr size_t x = 0;                       // keys tile
  static constexpr size_t f = align128(x + xs);        // keys+pe, or fp32 sums
  static constexpr size_t w = align128(f + fs);        // staged weights
  static constexpr size_t q = align128(w + 2 * NC * LDX * sizeof(T));
  static constexpr size_t v2 = align128(q + cs);
  static constexpr size_t tk = align128(v2 + cs);
  static constexpr size_t tv = align128(tk + ts);
  static constexpr size_t tq = align128(tv + ts);
  static constexpr size_t total = align128(tq + ts);
};

// epi(r, n, sum_k A[r][k] W[n][k]) for the block's rows and N outputs; W
// (N x K, row stride K) is staged NC rows at a time into two buffers at sW,
// the next chunk's copy (cp.async) in flight while the current one is used
template <typename T, int WARPS, typename Epi>
__device__ void rows_linear(const T* A, int lda, const T* W, int N, int K,
                            T* sW, Epi epi) {
  using S = RowSmem<T, WARPS>;
  constexpr int NC = S::NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int ldw = K + pad_of<T>();
  T* buf[2] = {sW, sW + NC * S::LDX};
  __syncthreads();   // A is complete and both buffers are free
  copy_tile_async(buf[0], ldw, W, K, NC, K);
  cp_async_commit();
  for (int c = 0; c * NC < N; ++c) {
    const int n0 = c * NC;
    if (n0 + NC < N) {
      copy_tile_async(buf[(c + 1) & 1], ldw,
                      W + static_cast<long long>(n0 + NC) * K, K, NC, K);
    }
    cp_async_commit();
    cp_async_wait<1>();   // chunk c has landed
    __syncthreads();
    float acc[NC / 8][4];
#pragma unroll
    for (int t = 0; t < NC / 8; ++t) {
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    }
    warp_mm<NC / 8>(acc, A + warp * 16 * lda, lda, buf[c & 1], ldw, K);
#pragma unroll
    for (int t = 0; t < NC / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        epi(warp * 16 + g + (e / 2) * 8, n0 + t * 8 + tig * 2 + (e & 1),
            acc[t][e]);
      }
    }
    __syncthreads();   // buf[c & 1] is free for chunk c + 2
  }
}

// keys + pe of the tile, rounded to the storage dtype, four columns a step
template <typename T, int WARPS>
__device__ void keys_plus_pe(T* dst, const T* x, const float* pe) {
  using S = RowSmem<T, WARPS>;
#pragma unroll 4
  for (int i = threadIdx.x; i < S::R * kD / 4; i += WARPS * 32) {
    const int r = i / (kD / 4), c = (i - r * (kD / 4)) * 4;
    const float4 pv = *reinterpret_cast<const float4*>(pe + r * kD + c);
    const T* xr = x + r * S::LDX + c;
    T* dr = dst + r * S::LDX + c;
    dr[0] = from_f<T>(to_f(xr[0]) + pv.x);
    dr[1] = from_f<T>(to_f(xr[1]) + pv.y);
    dr[2] = from_f<T>(to_f(xr[2]) + pv.z);
    dr[3] = from_f<T>(to_f(xr[3]) + pv.w);
  }
}

// upd >= 0: layer upd's image->token update of this tile first; nxt: the
// token->image attention whose partials this tile then adds
template <typename T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) twoway_rows(Params p, int upd,
                                                          int nxt) {
  using S = RowSmem<T, WARPS>;
  constexpr int R = S::R, LDX = S::LDX, LDF = S::LDF, LDC = S::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem + S::x);
  T* sXP = reinterpret_cast<T*>(smem + S::f);
  float* sF = reinterpret_cast<float*>(smem + S::f);
  T* sW = reinterpret_cast<T*>(smem + S::w);
  T* sQ = reinterpret_cast<T*>(smem + S::q);
  T* sV2 = reinterpret_cast<T*>(smem + S::v2);
  T* sTK = reinterpret_cast<T*>(smem + S::tk);
  T* sTV = reinterpret_cast<T*>(smem + S::tv);
  T* sTQ = reinterpret_cast<T*>(smem + S::tq);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, tile = blockIdx.x, r0 = tile * R;
  const int nt = p.T;
  const T* W = static_cast<const T*>(p.w);
  const float* pe = p.pe + static_cast<long long>(r0) * kD;
  const T* kin = upd <= 0
      ? static_cast<const T*>(p.src) + b * p.src_sb
      : static_cast<const T*>(p.keys) + static_cast<long long>(b) * p.M * kD;
  kin += static_cast<long long>(r0) * kD;

  copy_tile(sX, LDX, kin, kD, R, kD);
  __syncthreads();
  keys_plus_pe<T, WARPS>(sXP, sX, pe);

  if (upd >= 0) {
    const long long* wo = p.wo + upd * kMats;
    const long long* vo = p.vo + upd * kVecs;
    const T* kv = static_cast<const T*>(p.tokkv) +
                  static_cast<long long>(b) * 2 * nt * kC;
    copy_tile(sTK, LDC, kv, kC, nt, kC);
    copy_tile(sTV, LDC, kv + nt * kC, kC, nt, kC);
    // image->token queries of this tile
    const float* bq = p.v + vo[IQ];
    rows_linear<T, WARPS>(sXP, LDX, W + wo[IQ], kC, kD, sW,
                          [&](int r, int n, float s) {
                            sQ[r * LDC + n] = from_f<T>(s + bq[n]);
                          });
    __syncthreads();
    // each (row, head) attends over the tokens; the output replaces q
    for (int pr = tid; pr < R * kHeads; pr += nthreads) {
      const int r = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
      T* qrow = sQ + r * LDC + h * kHdC;
      float qv[kHdC];
#pragma unroll
      for (int d = 0; d < kHdC; ++d) qv[d] = to_f(qrow[d]);
      float s[kMaxT];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < nt) {
          float a = 0.0f;
#pragma unroll
          for (int d = 0; d < kHdC; ++d) {
            a = fmaf(qv[d], to_f(sTK[t * LDC + h * kHdC + d]), a);
          }
          s[t] = a * 0.25f;
          mx = fmaxf(mx, s[t]);
        }
      }
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < nt) {
          s[t] = expf(s[t] - mx);
          sum += s[t];
        }
      }
      const float inv = 1.0f / sum;
      float o[kHdC];
#pragma unroll
      for (int d = 0; d < kHdC; ++d) o[d] = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < nt) {
          const float pt = round_to<T>(s[t] * inv);
#pragma unroll
          for (int d = 0; d < kHdC; ++d) {
            o[d] = fmaf(pt, to_f(sTV[t * LDC + h * kHdC + d]), o[d]);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < kHdC; ++d) qrow[d] = from_f<T>(o[d]);
    }
    // out projection + residual, fp32 (over the dead keys+pe)
    const float* bo = p.v + vo[IO];
    rows_linear<T, WARPS>(sQ, LDC, W + wo[IO], kD, kC, sW,
                          [&](int r, int n, float s) {
                            sF[r * LDF + n] =
                                to_f(sX[r * LDX + n]) + s + bo[n];
                          });
    __syncthreads();
    // LayerNorm 4, one warp per row: the new keys
    const float* nw = p.v + vo[kNorm + 6];
    const float* nb = p.v + vo[kNorm + 7];
    T* kout = static_cast<T*>(p.keys) +
              (static_cast<long long>(b) * p.M + r0) * kD;
    for (int r = warp; r < R; r += WARPS) {
      float x[kD / 32];
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        x[j] = sF[r * LDF + lane + 32 * j];
        sum += x[j];
      }
      const float mean = warp_sum(sum) / kD;
      float var = 0.0f;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) var += (x[j] - mean) * (x[j] - mean);
      const float rstd = rsqrtf(warp_sum(var) / kD + 1e-5f);
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int c = lane + 32 * j;
        const T y = from_f<T>((x[j] - mean) * rstd * nw[c] + nb[c]);
        sX[r * LDX + c] = y;
        kout[r * kD + c] = y;
      }
    }
    __syncthreads();
    keys_plus_pe<T, WARPS>(sXP, sX, pe);
  }

  // the next token->image attention: K and V of this tile, then partials
  copy_tile(sTQ, LDC,
            static_cast<const T*>(p.tq) + static_cast<long long>(b) * nt * kC,
            kC, nt, kC);
  T* sK2 = sQ;
  const float* bk = p.v + t2i_v(p, nxt, 1);
  const float* bv = p.v + t2i_v(p, nxt, 2);
  rows_linear<T, WARPS>(sXP, LDX, W + t2i_w(p, nxt, 1), kC, kD, sW,
                        [&](int r, int n, float s) {
                          sK2[r * LDC + n] = from_f<T>(s + bk[n]);
                        });
  rows_linear<T, WARPS>(sX, LDX, W + t2i_w(p, nxt, 2), kC, kD, sW,
                        [&](int r, int n, float s) {
                          sV2[r * LDC + n] = from_f<T>(s + bv[n]);
                        });
  __syncthreads();
  for (int pr = tid; pr < nt * kHeads; pr += nthreads) {
    const int t = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
    float qv[kHdC], acc[kHdC];
#pragma unroll
    for (int d = 0; d < kHdC; ++d) {
      qv[d] = to_f(sTQ[t * LDC + h * kHdC + d]);
      acc[d] = 0.0f;
    }
    // the tile's maximum first, then exponentials against it, each rounded
    // to the storage dtype before the product with v (the twin's order)
    float m = -INFINITY;
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kHdC; ++d) {
        s = fmaf(qv[d], to_f(sK2[r * LDC + h * kHdC + d]), s);
      }
      m = fmaxf(m, s * 0.25f);
    }
    float l = 0.0f;
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kHdC; ++d) {
        s = fmaf(qv[d], to_f(sK2[r * LDC + h * kHdC + d]), s);
      }
      const float e = expf(s * 0.25f - m);
      l += e;
      const float er = round_to<T>(e);
#pragma unroll
      for (int d = 0; d < kHdC; ++d) {
        acc[d] = fmaf(er, to_f(sV2[r * LDC + h * kHdC + d]), acc[d]);
      }
    }
    float* out = p.part +
        (((static_cast<long long>(b) * p.tiles + tile) * nt + t) * kHeads + h) *
            kPart;
    out[0] = m;
    out[1] = l;
#pragma unroll
    for (int d = 0; d < kHdC; ++d) out[2 + d] = acc[d];
  }
}

// ---------------------------------------------------------------------------
// tokens
// ---------------------------------------------------------------------------

constexpr size_t kTokSmem = 6 * kMaxT * kLdt * sizeof(float);

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// epi(t, n, sum_k in[t][k] W[n * ldw + k]) for t < nt, n < N: each warp
// takes kCols output columns at a time, its lanes 8 consecutive k each (one
// 16-byte load per column), so every weight load of the step is in flight
// together. N is a multiple of 8 * kCols, K and ldw of 8.
constexpr int kCols = 4;
template <typename T, typename Epi>
__device__ void tok_linear(const float* in, const T* W, long long ldw, int N,
                           int K, int nt, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (int n = warp * kCols; n < N; n += warps * kCols) {
    float acc[kCols][kMaxT];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) acc[j][t] = 0.0f;
    }
    for (int k0 = lane * 8; k0 < K; k0 += 32 * 8) {
      float w[kCols][8];
#pragma unroll
      for (int j = 0; j < kCols; ++j) load8(W + (n + j) * ldw + k0, w[j]);
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < nt) {
          const float4 x0 = *reinterpret_cast<const float4*>(in + t * kLdt + k0);
          const float4 x1 = *reinterpret_cast<const float4*>(in + t * kLdt + k0 + 4);
          const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][t] = fmaf(x[i], w[j][i], acc[j][t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < nt) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float s = warp_sum(acc[j][t]);
          if (lane == 0) epi(t, n + j, s);
        }
      }
    }
  }
}

// LayerNorm (eps 1e-5) of rows t < nt of x in place, one warp per row
__device__ void tok_layer_norm(float* x, const float* w, const float* bias,
                               int nt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (int t = warp; t < nt; t += warps) {
    float v[kD / 32];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      v[j] = x[t * kLdt + lane + 32 * j];
      sum += v[j];
    }
    const float mean = warp_sum(sum) / kD;
    float var = 0.0f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) var += (v[j] - mean) * (v[j] - mean);
    const float rstd = rsqrtf(warp_sum(var) / kD + 1e-5f);
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const int c = lane + 32 * j;
      x[t * kLdt + c] = (v[j] - mean) * rstd * w[c] + bias[c];
    }
  }
}

// merge >= 0: finish token->image attention `merge` (merge its partials, out
// projection, residual, LayerNorm; for a layer also the MLP and the
// image->token K/V of the tokens; for the final attention the output).
// self_layer >= 0: then layer self_layer's self-attention (a layer) and the
// queries of its token->image attention (a layer, or the final one).
template <typename T>
__global__ void __launch_bounds__(kTokThreads) twoway_tokens(Params p,
                                                             int merge,
                                                             int self_layer) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sT0 = sQ + kMaxT * kLdt;
  float* sIn = sT0 + kMaxT * kLdt;
  float* sA = sIn + kMaxT * kLdt;
  float* sB = sA + kMaxT * kLdt;
  float* sC = sB + kMaxT * kLdt;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blockIdx.x, nt = p.T;
  const T* W = static_cast<const T*>(p.w);
  float* qg = p.q + static_cast<long long>(b) * nt * kD;
  const float* tok = p.tokens + static_cast<long long>(b) * nt * kD;
  const float* qsrc = (merge < 0 && self_layer == 0) ? tok : qg;
  for (int i = tid; i < nt * kD; i += nthreads) {
    const int t = i / kD, c = i - t * kD;
    sT0[t * kLdt + c] = tok[i];
    sQ[t * kLdt + c] = qsrc[i];
  }
  __syncthreads();

  if (merge >= 0) {
    const int a = merge;
    for (int pr = tid; pr < nt * kHeads; pr += nthreads) {
      const int t = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
      const float* part = p.part +
          ((static_cast<long long>(b) * p.tiles * nt + t) * kHeads + h) * kPart;
      const long long stride = static_cast<long long>(nt) * kHeads * kPart;
      float mx = -INFINITY;
      for (int j = 0; j < p.tiles; ++j) mx = fmaxf(mx, part[j * stride]);
      float l = 0.0f, acc[kHdC];
#pragma unroll
      for (int d = 0; d < kHdC; ++d) acc[d] = 0.0f;
      for (int j = 0; j < p.tiles; ++j) {
        const float* pj = part + j * stride;
        const float sc = expf(pj[0] - mx);
        l = fmaf(pj[1], sc, l);
#pragma unroll
        for (int d = 0; d < kHdC; ++d) acc[d] = fmaf(pj[2 + d], sc, acc[d]);
      }
#pragma unroll
      for (int d = 0; d < kHdC; ++d) {
        sIn[t * kLdt + h * kHdC + d] = round_to<T>(acc[d] / l);
      }
    }
    __syncthreads();
    const float* bo = p.v + t2i_v(p, a, 3);
    tok_linear<T>(sIn, W + t2i_w(p, a, 3), kC, kD, kC, nt,
                  [&](int t, int n, float s) { sQ[t * kLdt + n] += s + bo[n]; });
    __syncthreads();
    if (a == p.n_layers) {
      const long long* vf = p.vo + p.n_layers * kVecs;
      tok_layer_norm(sQ, p.v + vf[4], p.v + vf[5], nt);
      __syncthreads();
      T* out = static_cast<T*>(p.q_out) + static_cast<long long>(b) * nt * kD;
      for (int i = tid; i < nt * kD; i += nthreads) {
        out[i] = from_f<T>(sQ[(i / kD) * kLdt + i % kD]);
      }
      return;
    }
    const long long* wo = p.wo + a * kMats;
    const long long* vo = p.vo + a * kVecs;
    tok_layer_norm(sQ, p.v + vo[kNorm + 2], p.v + vo[kNorm + 3], nt);
    __syncthreads();
    // MLP, in chunks of 256 hidden units summed into sC
    for (int i = tid; i < nt * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sIn[t * kLdt + c] = round_to<T>(sQ[t * kLdt + c]);
      sC[t * kLdt + c] = 0.0f;
    }
    const float* b1 = p.v + vo[M1];
    const float* b2 = p.v + vo[M2];
    for (int f0 = 0; f0 < kF; f0 += kD) {
      __syncthreads();
      tok_linear<T>(sIn, W + wo[M1] + static_cast<long long>(f0) * kD, kD, kD,
                    kD, nt, [&](int t, int n, float s) {
                      sA[t * kLdt + n] = round_to<T>(fmaxf(s + b1[f0 + n], 0.0f));
                    });
      __syncthreads();
      tok_linear<T>(sA, W + wo[M2] + f0, kF, kD, kD, nt,
                    [&](int t, int n, float s) { sC[t * kLdt + n] += s; });
    }
    __syncthreads();
    for (int i = tid; i < nt * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sQ[t * kLdt + c] += sC[t * kLdt + c] + b2[c];
    }
    __syncthreads();
    tok_layer_norm(sQ, p.v + vo[kNorm + 4], p.v + vo[kNorm + 5], nt);
    __syncthreads();
    // image->token keys (from q + pe) and values (from q) of the tokens
    for (int i = tid; i < nt * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sIn[t * kLdt + c] = round_to<T>(sQ[t * kLdt + c] + sT0[t * kLdt + c]);
      sA[t * kLdt + c] = round_to<T>(sQ[t * kLdt + c]);
    }
    __syncthreads();
    T* kv = static_cast<T*>(p.tokkv) + static_cast<long long>(b) * 2 * nt * kC;
    const float* bk = p.v + vo[IK];
    const float* bv = p.v + vo[IV];
    tok_linear<T>(sIn, W + wo[IK], kD, kC, kD, nt, [&](int t, int n, float s) {
      kv[t * kC + n] = from_f<T>(s + bk[n]);
    });
    tok_linear<T>(sA, W + wo[IV], kD, kC, kD, nt, [&](int t, int n, float s) {
      kv[(nt + t) * kC + n] = from_f<T>(s + bv[n]);
    });
    __syncthreads();
  }

  if (self_layer >= 0) {
    const int l = self_layer;
    if (l < p.n_layers) {
      const long long* wo = p.wo + l * kMats;
      const long long* vo = p.vo + l * kVecs;
      // q and k from q + pe (layer 0: from the tokens, no pe), v from q
      for (int i = tid; i < nt * kD; i += nthreads) {
        const int t = i / kD, c = i - t * kD;
        const float pe = l == 0 ? 0.0f : sT0[t * kLdt + c];
        sIn[t * kLdt + c] = round_to<T>(sQ[t * kLdt + c] + pe);
      }
      __syncthreads();
      const float* bq = p.v + vo[SQ];
      const float* bk = p.v + vo[SK];
      const float* bv = p.v + vo[SV];
      tok_linear<T>(sIn, W + wo[SQ], kD, kD, kD, nt, [&](int t, int n, float s) {
        sA[t * kLdt + n] = round_to<T>(s + bq[n]);
      });
      tok_linear<T>(sIn, W + wo[SK], kD, kD, kD, nt, [&](int t, int n, float s) {
        sB[t * kLdt + n] = round_to<T>(s + bk[n]);
      });
      __syncthreads();
      if (l > 0) {
        for (int i = tid; i < nt * kD; i += nthreads) {
          const int t = i / kD, c = i - t * kD;
          sIn[t * kLdt + c] = round_to<T>(sQ[t * kLdt + c]);
        }
        __syncthreads();
      }
      tok_linear<T>(sIn, W + wo[SV], kD, kD, kD, nt, [&](int t, int n, float s) {
        sC[t * kLdt + n] = round_to<T>(s + bv[n]);
      });
      __syncthreads();
      // self-attention per (token, head), head dim 32; output -> sIn
      const float scale = 0.17677669529663687f;   // 1 / sqrt(32)
      for (int pr = tid; pr < nt * kHeads; pr += nthreads) {
        const int t = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
        float s[kMaxT];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < kMaxT; ++u) {
          if (u < nt) {
            float a = 0.0f;
            for (int d = 0; d < kHdS; ++d) {
              a = fmaf(sA[t * kLdt + h * kHdS + d], sB[u * kLdt + h * kHdS + d], a);
            }
            s[u] = a * scale;
            mx = fmaxf(mx, s[u]);
          }
        }
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < kMaxT; ++u) {
          if (u < nt) {
            s[u] = expf(s[u] - mx);
            sum += s[u];
          }
        }
        const float inv = 1.0f / sum;
#pragma unroll
        for (int u = 0; u < kMaxT; ++u) {
          if (u < nt) s[u] = round_to<T>(s[u] * inv);
        }
        for (int d = 0; d < kHdS; ++d) {
          float o = 0.0f;
#pragma unroll
          for (int u = 0; u < kMaxT; ++u) {
            if (u < nt) o = fmaf(s[u], sC[u * kLdt + h * kHdS + d], o);
          }
          sIn[t * kLdt + h * kHdS + d] = round_to<T>(o);
        }
      }
      __syncthreads();
      const float* bo = p.v + vo[SO];
      tok_linear<T>(sIn, W + wo[SO], kD, kD, kD, nt, [&](int t, int n, float s) {
        const float y = s + bo[n];
        sQ[t * kLdt + n] = l == 0 ? y : sQ[t * kLdt + n] + y;
      });
      __syncthreads();
      tok_layer_norm(sQ, p.v + vo[kNorm], p.v + vo[kNorm + 1], nt);
      __syncthreads();
    }
    // queries of the next token->image attention, from q + pe
    for (int i = tid; i < nt * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sIn[t * kLdt + c] = round_to<T>(sQ[t * kLdt + c] + sT0[t * kLdt + c]);
    }
    __syncthreads();
    T* tq = static_cast<T*>(p.tq) + static_cast<long long>(b) * nt * kC;
    const float* bq = p.v + t2i_v(p, l, 0);
    tok_linear<T>(sIn, W + t2i_w(p, l, 0), kD, kC, kD, nt,
                  [&](int t, int n, float s) { tq[t * kC + n] = from_f<T>(s + bq[n]); });
  }
  __syncthreads();
  for (int i = tid; i < nt * kD; i += nthreads) {
    qg[i] = sQ[(i / kD) * kLdt + i % kD];
  }
}

template <typename T>
cudaError_t run(Params& p, cudaStream_t stream) {
  constexpr int kWarps = sizeof(T) == 2 ? 4 : 2;
  using S = RowSmem<T, kWarps>;
  static_assert(S::total <= static_cast<size_t>(kMaxSmem), "row tile too big");
  static bool attrs = false;
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(
        twoway_rows<T, kWarps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::total));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(twoway_tokens<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTokSmem));
    if (e != cudaSuccess) return e;
    attrs = true;
  }
  if (p.M % S::R != 0) return cudaErrorInvalidValue;
  p.tiles = p.M / S::R;
  const dim3 rgrid(p.tiles, p.B);
  cudaError_t e;
  auto tokens = [&](int merge, int self_layer) {
    twoway_tokens<T><<<p.B, kTokThreads, kTokSmem, stream>>>(p, merge, self_layer);
    return cudaGetLastError();
  };
  auto rows = [&](int upd, int nxt) {
    twoway_rows<T, kWarps><<<rgrid, kWarps * 32, S::total, stream>>>(p, upd, nxt);
    return cudaGetLastError();
  };
  if ((e = tokens(-1, 0)) != cudaSuccess) return e;
  if ((e = rows(-1, 0)) != cudaSuccess) return e;
  for (int l = 0; l < p.n_layers; ++l) {
    if ((e = tokens(l, l + 1)) != cudaSuccess) return e;
    if ((e = rows(l, l + 1)) != cudaSuccess) return e;
  }
  return tokens(p.n_layers, -1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. w_off / v_off: element offsets of the
// packed matrices and vectors, n_layers * 14 + 4 and n_layers * 22 + 6 of
// them, in the order of core/kernels.py _twoway_names. Returns a cudaError_t
// (0 = success).
int ea_sam_twoway(const void* src, long long src_sb, const float* pe,
                  const float* tokens, const void* w, const float* v,
                  const long long* w_off, int n_w, const long long* v_off,
                  int n_v, int n_layers, void* keys, void* q_out,
                  float* q_state, void* tokkv, void* tq, float* part, int B,
                  int M, int T, int dtype, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_w != n_layers * kMats + 4 ||
      n_v != n_layers * kVecs + 6 || T < 1 || T > kMaxT || B < 1 ||
      B > 65535 || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.src = src; p.src_sb = src_sb; p.pe = pe; p.tokens = tokens;
  p.w = w; p.v = v;
  for (int i = 0; i < n_w; ++i) p.wo[i] = w_off[i];
  for (int i = 0; i < n_v; ++i) p.vo[i] = v_off[i];
  p.n_layers = n_layers;
  p.keys = keys; p.q_out = q_out; p.q = q_state; p.tokkv = tokkv; p.tq = tq;
  p.part = part; p.B = B; p.M = M; p.T = T; p.tiles = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(run<__nv_bfloat16>(p, s));
  if (dtype == 0) return static_cast<int>(run<float>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

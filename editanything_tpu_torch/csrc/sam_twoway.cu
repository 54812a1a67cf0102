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
// per-row projections: four 256x128 products per image row and layer for
// each prompt (at the AMG's 256 prompts x 4096 rows about 550 GFLOP a
// call), on the tensor cores, and one read and write of the keys per layer
// (2 MiB per prompt in bf16, ~1.5 GB a call). So the tensor cores bound it
// at best, not device memory; what holds it back in practice is each
// block's restaging of 256 KB of weights from L2 per layer and the memory
// latency of the phases between its projections (PERF.md).
//
// Design: the dependency structure splits the transformer into launches
// that alternate (8 for SAM's 2 layers):
//   twoway_shared_kv, once per call, one block per tile of image rows:
//     layer 0's token->image K (from src + pe) and V (from src). They depend
//     on the shared image input alone, so they are computed once and not
//     per prompt; kept in the first prompt's slice of the keys output
//     (written there by no other launch before the first row pass);
//   twoway_shared_partials, one block per (row tile, group of prompts):
//     loads that tile's K/V once and adds, for each prompt of the group, the
//     first token->image attention's split-K partials (the tile's max, sum
//     of exponentials and output per token and head, flash-decoding style),
//     the next prompt's queries loading while the current one runs;
//   twoway_rows, one block per (row tile, prompt): image->token attention
//     of its rows (queries projected, attention over the tokens, out
//     projection, residual, LayerNorm 4), the new keys tile written once,
//     then the next token->image attention's K and V for the same rows and
//     its partials;
//   twoway_tokens, one block per group of whole prompts flattened to at
//     most 32 token rows (5 prompts at the AMG's 6 tokens, 1 at the
//     click's 21): everything on the tokens (merge of the partials, out
//     projection, MLP, LayerNorms, self-attention per prompt, the
//     token-side projections for the next row pass).
// Every projection runs on mma.sync m16n8k16. In the row kernels each warp
// owns 16 image rows, its A fragments in registers (ldmatrix.x4), and the
// block streams all the weights it needs, in the order of use, through one
// cp.async ring in shared memory (so the next projection's first chunks
// load while an attention or LayerNorm runs); a projection's sums stay in
// registers, the out projection's in two halves of 128 columns, the first
// parked in fp32 over the dead keys + pe, so that LayerNorm 4 runs on quad
// shuffles without an fp32 tile. Both attentions run on mma.sync too:
// image->token with the rows as M and the tokens (padded to 8, 16 or 32,
// pad keys masked) as N, two heads interleaved, then P (normalised,
// rounded) times V with the tokens as K; token->image with the tokens
// (padded to 16 or 32) as M and the tile's rows as N, the exponentials
// against the tile's max rounded before the product with V. Row blocks
// take 128 rows (8 warps, 219.5 KB of shared memory, one per SM, a ring of
// 4 x 32 weight rows) where B x M / 128 fills the SMs, else 64 rows (4
// warps, 112.25 KB, two per SM, 3 x 16); the biases and LayerNorm 4's affine
// wait in shared memory, and pe is read in batches of loads in flight.
// The token kernel reads its weights straight from L2, 16 bytes a lane,
// each fragment feeding all 32 token rows of the block.
// fp32 (the tests' path) runs the same launches with exact FMAs: warp_mm's
// fp32 twin for the projections, scalar loops for the attentions, and
// 2-warp row blocks of 32 rows.
//
// Plain C interface for ctypes: ea_sam_twoway returns cudaGetLastError() of
// its launches, 0 on success.

#include "common.cuh"

namespace {

using namespace ea;
using bf16 = __nv_bfloat16;

constexpr int kD = 256;          // width
constexpr int kC = 128;          // cross-attention inner width
constexpr int kF = 2048;         // MLP width
constexpr int kHeads = 8;
constexpr int kHdC = kC / kHeads;   // 16
constexpr int kHdS = kD / kHeads;   // 32
constexpr int kMaxT = 24;
constexpr int kTokPad = 32;         // token rows held in shared memory
constexpr int kMaxLayers = 4;
constexpr int kMats = 14, kVecs = 22;  // per layer, in core/kernels.py order
constexpr int kPart = 2 + kHdC;        // max, sum, output
constexpr int kPromptsPerBlock = 8;    // prompts of a shared-partials block

// a layer's matrices (and their biases at the same vector index)
enum { SQ, SK, SV, SO, TQ, TK, TV, TO, M1, M2, IQ, IK, IV, IO };
// a layer's LayerNorm affines: norm j (1..4) weight at kNorm + 2 (j - 1)
constexpr int kNorm = 14;

struct Params {
  const void* src;       // (M, 256) storage dtype, shared by every prompt
  const float* pe;       // (M, 256)
  const float* tokens;   // (B, T, 256)
  const void* w;         // matrices, storage dtype, (out, in) row-major
  const float* v;        // biases and LayerNorm affines
  long long wo[kMaxLayers * kMats + 4];
  long long vo[kMaxLayers * kVecs + 6];
  int n_layers;
  void* keys;            // (B, M, 256) storage dtype; keys[0] first holds
                         // layer 0's shared token->image [K | V] (M, 256)
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
// bf16 fragments (mma.sync m16n8k16, common.cuh's layout)
// ---------------------------------------------------------------------------

// Lane offsets (row, column) of ldmatrix.x4 for a 16 x 16 tile at row
// stride ld: as an A operand (rows = M, columns = K), and as V for a
// transposed load (rows = K, columns = N) the same; as a B operand stored
// N-major (rows = N, columns = K, e.g. a weight (out, in) or keys).
__device__ __forceinline__ int frag_a_off(int ld) {
  const int lane = threadIdx.x % 32;
  return (lane % 16) * ld + (lane / 16) * 8;
}
__device__ __forceinline__ int frag_b_off(int ld) {
  const int lane = threadIdx.x % 32;
  return ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
}

// the A fragments of a 16 x 16 block held as the C fragments of two n-tiles
// (c0: columns 0-7, c1: columns 8-15), rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// two adjacent storage-dtype values from fp32
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// row tiles: shared memory, the weight ring, projections
// ---------------------------------------------------------------------------

// a row block's vectors in shared memory: the image->token q bias, its out
// bias, LayerNorm 4's weight and bias, the next token->image k and v biases
enum { VQ = 0, VO = kC, VW = VO + kD, VB = VW + kD, VK = VB + kD, VV = VK + kC,
       kVecFloats = VV + kC };

template <typename T, int WARPS>
struct RowSmem {
  static constexpr int R = WARPS * 16;
  static constexpr int LDX = kD + pad_of<T>();
  static constexpr int LDC = kC + pad_of<T>();
  // weight ring: stages, and weight rows per stage. The 128-row bf16 block
  // (one per SM) streams 4 x 32 rows, so that three chunks load while one
  // is used; the 64-row block 3 x 16, which lets two blocks share an SM.
  static constexpr bool kWide = sizeof(T) == 2 && WARPS == 8;
  static constexpr int kStages = kWide ? 4 : 3;
  static constexpr int kChunk = kWide ? 32 : 16;
  static constexpr bool kScalarQ = sizeof(T) == 4;
  // keys tile; after the update, the next attention's V (columns < 128)
  static constexpr size_t x = 0;
  // keys + pe (the out projection parks its first half's fp32 sums over a
  // warp's dead rows); after the update, the next attention's K (columns
  // < 128)
  static constexpr size_t xp = align128(x + R * LDX * sizeof(T));
  static constexpr size_t ring = align128(xp + R * LDX * sizeof(T));
  // the tokens' K and V (image->token), later the token->image queries
  static constexpr size_t tok = align128(ring + kStages * kChunk * LDX * sizeof(T));
  // fp32 only: the image->token queries and the attention's output
  static constexpr size_t q = align128(tok + 2 * kTokPad * LDC * sizeof(T));
  // the block's biases and LayerNorm 4's affine, fp32 (kVecFloats)
  static constexpr size_t vec = align128(q + (kScalarQ ? R * LDC * sizeof(T) : 0));
  static constexpr size_t total = align128(vec + kVecFloats * sizeof(float));
};

// The weights a row block streams through its ring, in the order its
// projections use them: each projection has 128 outputs, so kProjChunks
// chunks of kChunk weight rows (of K columns). One stream for the whole
// block, so that the first chunks of a projection load while the attention
// or LayerNorm before it runs.
constexpr int kMaxProj = 5;

template <typename T, int WARPS>
struct WeightRing {
  using S = RowSmem<T, WARPS>;
  static constexpr int kProjChunks = kC / S::kChunk;
  T* slots;
  const T* w[kMaxProj];
  int k[kMaxProj];
  int chunks;

  // start the copy of chunk i into slot i % kStages (one commit group per
  // chunk, empty past the end)
  __device__ __forceinline__ void stage(int i) {
    if (i < chunks) {
      const int j = i / kProjChunks, c = i - j * kProjChunks;
      copy_tile_async(slots + (i % S::kStages) * S::kChunk * S::LDX, S::LDX,
                      w[j] + static_cast<long long>(c) * S::kChunk * k[j], k[j],
                      S::kChunk, k[j]);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int s = 0; s < S::kStages - 1; ++s) stage(s);
  }
  // wait for chunk i, start chunk i + kStages - 1 into the slot that chunk
  // i - 1 used (free: every warp has passed the barrier), return i's slot
  __device__ __forceinline__ const T* next(int i) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();
    stage(i + S::kStages - 1);
    return slots + (i % S::kStages) * S::kChunk * S::LDX;
  }
};

// A fragments of the warp's 16 rows x K columns at row stride lda
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[K / 16][4], const bf16* A,
                                       int lda) {
  const bf16* base = A + frag_a_off(lda);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) ldsm_x4(a[kk], base + kk * 16);
}

// acc = (the warp's 16 rows) x W^T for projection j of the ring's stream
// (128 x K), block-wide: bf16 with A's fragments in registers
template <int WARPS, int K>
__device__ __forceinline__ void proj(float (&acc)[kC / 8][4],
                                     const uint32_t (&a)[K / 16][4],
                                     WeightRing<bf16, WARPS>& ring, int j) {
  using S = RowSmem<bf16, WARPS>;
  constexpr int PC = WeightRing<bf16, WARPS>::kProjChunks, NT = S::kChunk / 8;
#pragma unroll
  for (int t = 0; t < kC / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < PC; ++c) {
    const bf16* slot = ring.next(j * PC + c) + frag_b_off(S::LDX);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        uint32_t b[4];
        ldsm_x4(b, slot + pr * 16 * S::LDX + kk * 16);
        mma_bf16(acc[c * NT + 2 * pr], a[kk], b[0], b[1]);
        mma_bf16(acc[c * NT + 2 * pr + 1], a[kk], b[2], b[3]);
      }
    }
  }
}

// the same in exact fp32, A (the warp's 16 rows) read from shared memory
template <int WARPS, int K>
__device__ __forceinline__ void proj(float (&acc)[kC / 8][4], const float* A,
                                     int lda, WeightRing<float, WARPS>& ring,
                                     int j) {
  using S = RowSmem<float, WARPS>;
  constexpr int PC = WeightRing<float, WARPS>::kProjChunks, NT = S::kChunk / 8;
#pragma unroll
  for (int t = 0; t < kC / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < PC; ++c) {
    const float* slot = ring.next(j * PC + c);
    warp_mm<NT>(*reinterpret_cast<float(*)[NT][4]>(&acc[c * NT][0]), A, lda, slot,
                S::LDX, K);
  }
}

// the warp's 16 rows x N outputs + bias, rounded, into dst (row stride ld)
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* dst, int ld,
                                           const float (&acc)[N / 8][4],
                                           const float* bias) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int t = 0; t < N / 8; ++t) {
    const int c = t * 8 + tig * 2;
    store2(dst + g * ld + c, acc[t][0] + bias[c], acc[t][1] + bias[c + 1]);
    store2(dst + (g + 8) * ld + c, acc[t][2] + bias[c], acc[t][3] + bias[c + 1]);
  }
}

// pe of a tile's rows, four columns a step: element j of a thread's share is
// i = first + j * step of the tile's rows x 64 float4 (every load issued
// before any is used, so they are in flight together)
constexpr int kPeLoads = 32;   // R * 64 / threads for every row block
template <int N>
__device__ __forceinline__ void load_pe(float4 (&pv)[N], const float* pe,
                                        int first, int step) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = first + j * step, r = i / (kD / 4), c = (i - r * (kD / 4)) * 4;
    pv[j] = __ldg(reinterpret_cast<const float4*>(pe + r * kD + c));
  }
}

// dst = x + pe at the same elements, rounded to the storage dtype
template <typename T, int LDX, int N>
__device__ __forceinline__ void add_pe(T* dst, const T* x, const float4 (&pv)[N],
                                       int first, int step) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = first + j * step, r = i / (kD / 4), c = (i - r * (kD / 4)) * 4;
    const T* xr = x + r * LDX + c;
    store2(dst + r * LDX + c, to_f(xr[0]) + pv[j].x, to_f(xr[1]) + pv[j].y);
    store2(dst + r * LDX + c + 2, to_f(xr[2]) + pv[j].z, to_f(xr[3]) + pv[j].w);
  }
}

// token->image attention a's K (from keys + pe, projection j of the ring's
// stream) and V (from keys, projection j + 1) of the warp's 16 rows,
// rounded, over the dead inputs: K into sXP's and V into sX's first 128
// columns (the warp's rows of both are complete)
template <typename T, int WARPS>
__device__ __forceinline__ void next_kv(const float* bk, const float* bv, T* sX,
                                        T* sXP, WeightRing<T, WARPS>& ring, int j) {
  using S = RowSmem<T, WARPS>;
  const int r0 = (threadIdx.x / 32) * 16;
  T* xp = sXP + r0 * S::LDX;
  T* x = sX + r0 * S::LDX;
  float acc[kC / 8][4];
  if constexpr (sizeof(T) == 2) {
    uint32_t fa[kD / 16][4];
    load_a<kD>(fa, xp, S::LDX);
    proj<WARPS, kD>(acc, fa, ring, j);
    store_rows<T, kC>(xp, S::LDX, acc, bk);
    __syncwarp();
    load_a<kD>(fa, x, S::LDX);
    proj<WARPS, kD>(acc, fa, ring, j + 1);
  } else {
    proj<WARPS, kD>(acc, xp, S::LDX, ring, j);
    store_rows<T, kC>(xp, S::LDX, acc, bk);
    __syncwarp();
    proj<WARPS, kD>(acc, x, S::LDX, ring, j + 1);
  }
  store_rows<T, kC>(x, S::LDX, acc, bv);
}


// ---------------------------------------------------------------------------
// the attentions of the row kernels
// ---------------------------------------------------------------------------

// Token->image partials of one R-row tile for the nt queries q (rows of
// ldq = LDC, zero past nt): for each token t and head h, out[(t * 8 + h) *
// kPart] = (m, l, o[16]): the tile's max of the scaled logits, the sum of
// the exponentials against it, and their product (each rounded to the
// storage dtype) with V. K and V of the tile: rows of sK (ldk), sV (ldv).
template <int R>
__device__ __forceinline__ void tile_partials(const bf16* sK, int ldk, const bf16* sV, int ldv,
                              const bf16* sQ, int ldq, int nt, float* out,
                              int warps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mts = (nt + 15) / 16;
  for (int item = warp; item < kHeads * mts; item += warps) {
    const int h = item % kHeads, mt = item / kHeads;
    uint32_t qa[4];
    ldsm_x4(qa, sQ + mt * 16 * ldq + h * kHdC + frag_a_off(ldq));
    float s[R / 8][4];
    const bf16* kb = sK + h * kHdC + frag_b_off(ldk);
#pragma unroll
    for (int j = 0; j < R / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(b, kb + j * 16 * ldk);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.0f;
      mma_bf16(s[2 * j], qa, b[0], b[1]);
      mma_bf16(s[2 * j + 1], qa, b[2], b[3]);
    }
    // rows g (e = 0, 1) and g + 8 (e = 2, 3): the tile's max, then the
    // exponentials against it
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= 0.25f;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - mx[e / 2]);
        l[e / 2] += s[j][e];
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    float o[2][4] = {};
    const bf16* vb = sV + h * kHdC + frag_a_off(ldv);
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t pa[4], b[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      ldsm_x4_trans(b, vb + kk * 16 * ldv);
      mma_bf16(o[0], pa, b[0], b[1]);
      mma_bf16(o[1], pa, b[2], b[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = mt * 16 + g + 8 * r;
      if (t < nt) {
        float* po = out + (t * kHeads + h) * kPart;
        if (tig == 0) {
          po[0] = mx[r];
          po[1] = l[r];
        }
        po[2 + 2 * tig] = o[0][2 * r];
        po[3 + 2 * tig] = o[0][2 * r + 1];
        po[10 + 2 * tig] = o[1][2 * r];
        po[11 + 2 * tig] = o[1][2 * r + 1];
      }
    }
  }
}

// the same in exact fp32, one thread per (token, head)
template <int R>
__device__ __forceinline__ void tile_partials(const float* sK, int ldk, const float* sV,
                              int ldv, const float* sQ, int ldq, int nt,
                              float* out, int /*warps*/) {
  for (int pr = threadIdx.x; pr < nt * kHeads; pr += blockDim.x) {
    const int t = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
    float qv[kHdC], acc[kHdC];
#pragma unroll
    for (int d = 0; d < kHdC; ++d) {
      qv[d] = sQ[t * ldq + h * kHdC + d];
      acc[d] = 0.0f;
    }
    float m = -INFINITY;
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kHdC; ++d) s = fmaf(qv[d], sK[r * ldk + h * kHdC + d], s);
      m = fmaxf(m, s * 0.25f);
    }
    float l = 0.0f;
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kHdC; ++d) s = fmaf(qv[d], sK[r * ldk + h * kHdC + d], s);
      const float e = expf(s * 0.25f - m);
      l += e;
#pragma unroll
      for (int d = 0; d < kHdC; ++d) acc[d] = fmaf(e, sV[r * ldv + h * kHdC + d], acc[d]);
    }
    float* po = out + (t * kHeads + h) * kPart;
    po[0] = m;
    po[1] = l;
#pragma unroll
    for (int d = 0; d < kHdC; ++d) po[2 + d] = acc[d];
  }
}

// Image->token attention of heads h0 .. h0 + NH - 1 for the warp's 16 rows
// (bf16), the heads interleaved so that their chains of dependent steps
// overlap: q the A fragments of the rows' queries, the tokens' K and V in
// rows of sTK, sTV (ld LDC, zero past nt <= NTOK). Returns the outputs' A
// fragments (rounded). NTOK (8, 16 or 32) bounds the tokens' n-tiles of S
// and k steps of P V.
template <int LDC, int NH, int NTOK>
__device__ __forceinline__ void i2t_heads(uint32_t (&o)[NH][4],
                                          const uint32_t (&q)[NH][4],
                                          const bf16* sTK, const bf16* sTV,
                                          int h0, int nt) {
  constexpr int NT = NTOK / 8, KS = (NTOK + 15) / 16;
  const int lane = threadIdx.x % 32, tig = lane % 4;
  float s[NH][2 * KS][4] = {};   // n-tiles past NT stay 0: P = 0 there
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    const bf16* kb = sTK + (h0 + hh) * kHdC + frag_b_off(LDC);
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      uint32_t b[4];
      ldsm_x4(b, kb + j * 16 * LDC);
      mma_bf16(s[hh][2 * j], q[hh], b[0], b[1]);
      if (2 * j + 1 < NT) mma_bf16(s[hh][2 * j + 1], q[hh], b[2], b[3]);
    }
  }
  float mx[NH][2], sum[NH][2];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    mx[hh][0] = mx[hh][1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[hh][j][e] = j * 8 + tig * 2 + (e & 1) < nt ? s[hh][j][e] * 0.25f : -INFINITY;
        mx[hh][e / 2] = fmaxf(mx[hh][e / 2], s[hh][j][e]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    mx[hh][0] = quad_max(mx[hh][0]);
    mx[hh][1] = quad_max(mx[hh][1]);
    sum[hh][0] = sum[hh][1] = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[hh][j][e] = __expf(s[hh][j][e] - mx[hh][e / 2]);
        sum[hh][e / 2] += s[hh][j][e];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    const float inv[2] = {1.0f / quad_sum(sum[hh][0]), 1.0f / quad_sum(sum[hh][1])};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[hh][j][e] *= inv[e / 2];
    }
  }
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    float acc[2][4] = {};
    const bf16* vb = sTV + (h0 + hh) * kHdC + frag_a_off(LDC);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t pa[4], b[4];
      c_to_a(pa, s[hh][2 * kk], s[hh][2 * kk + 1]);
      ldsm_x4_trans(b, vb + kk * 16 * LDC);
      mma_bf16(acc[0], pa, b[0], b[1]);
      mma_bf16(acc[1], pa, b[2], b[3]);
    }
    c_to_a(o[hh], acc[0], acc[1]);
  }
}

// all heads for the warp's rows: q the queries' sums (C fragments, before
// the bias bq), o the outputs' A fragments
template <int LDC, int NTOK>
__device__ __forceinline__ void i2t_rows(uint32_t (&o)[kHeads][4],
                                         const float (&q)[kC / 8][4],
                                         const float* bq, const bf16* sTK,
                                         const bf16* sTV, int nt) {
  constexpr int NH = 2;   // heads interleaved
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int h0 = 0; h0 < kHeads; h0 += NH) {
    uint32_t qa[NH][4];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int h = h0 + hh;
      float q0[4], q1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q0[e] = q[2 * h][e] + bq[h * kHdC + tig * 2 + (e & 1)];
        q1[e] = q[2 * h + 1][e] + bq[h * kHdC + 8 + tig * 2 + (e & 1)];
      }
      c_to_a(qa[hh], q0, q1);
    }
    i2t_heads<LDC, NH, NTOK>(*reinterpret_cast<uint32_t(*)[NH][4]>(&o[h0][0]),
                             qa, sTK, sTV, h0, nt);
  }
}

// the same in exact fp32 for the warp's 16 rows of sQ (ld LDC), every head,
// the output over the queries
template <int LDC>
__device__ __forceinline__ void i2t_rows_f32(float* sQ, const float* sTK, const float* sTV,
                             int nt) {
  const int lane = threadIdx.x % 32;
  for (int pr = lane; pr < 16 * kHeads; pr += 32) {
    const int r = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
    float* qrow = sQ + r * LDC + h * kHdC;
    float qv[kHdC];
#pragma unroll
    for (int d = 0; d < kHdC; ++d) qv[d] = qrow[d];
    float s[kMaxT];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < nt) {
        float a = 0.0f;
#pragma unroll
        for (int d = 0; d < kHdC; ++d) a = fmaf(qv[d], sTK[t * LDC + h * kHdC + d], a);
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
        const float pt = s[t] * inv;
#pragma unroll
        for (int d = 0; d < kHdC; ++d) o[d] = fmaf(pt, sTV[t * LDC + h * kHdC + d], o[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < kHdC; ++d) qrow[d] = o[d];
  }
}

// ---------------------------------------------------------------------------
// row kernels
// ---------------------------------------------------------------------------

// copy the warp's 16 rows of `cols` columns from shared (ld) to global
// (row stride kD), 16 bytes a lane
template <typename T>
__device__ __forceinline__ void store_warp_rows(T* dst, const T* src, int ld,
                                                int cols) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int i = threadIdx.x % 32; i < 16 * per_row; i += 32) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    *reinterpret_cast<uint4*>(dst + r * kD + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// layer 0's token->image K and V of one tile of the shared image rows, into
// keys[0] as [K | V] rows of 256
template <typename T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) twoway_shared_kv(Params p) {
  using S = RowSmem<T, WARPS>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem + S::x);
  T* sXP = reinterpret_cast<T*>(smem + S::xp);
  const T* W = static_cast<const T*>(p.w);
  WeightRing<T, WARPS> ring{reinterpret_cast<T*>(smem + S::ring),
                            {W + t2i_w(p, 0, 1), W + t2i_w(p, 0, 2)},
                            {kD, kD}, 2 * WeightRing<T, WARPS>::kProjChunks};
  const int r0 = blockIdx.x * S::R, w0 = (threadIdx.x / 32) * 16;
  copy_tile_async(sX, S::LDX,
                  static_cast<const T*>(p.src) + static_cast<long long>(r0) * kD,
                  kD, S::R, kD);
  cp_async_commit();
  ring.begin();
  float4 pv[kPeLoads];
  load_pe(pv, p.pe + static_cast<long long>(r0) * kD, threadIdx.x, blockDim.x);
  cp_async_wait<S::kStages - 1>();   // the tile (the weights may still load)
  __syncthreads();
  add_pe<T, S::LDX>(sXP, sX, pv, threadIdx.x, blockDim.x);
  __syncthreads();
  next_kv<T, WARPS>(p.v + t2i_v(p, 0, 1), p.v + t2i_v(p, 0, 2), sX, sXP, ring, 0);
  __syncwarp();
  T* kv = static_cast<T*>(p.keys) + static_cast<long long>(r0 + w0) * kD;
  store_warp_rows(kv, sXP + w0 * S::LDX, S::LDX, kC);
  store_warp_rows(kv + kC, sX + w0 * S::LDX, S::LDX, kC);
}

template <typename T, int WARPS>
struct PartSmem {
  static constexpr int R = WARPS * 16;
  static constexpr int LDC = kC + pad_of<T>();
  static constexpr size_t k = 0;
  static constexpr size_t v = align128(k + R * LDC * sizeof(T));
  static constexpr size_t q = align128(v + R * LDC * sizeof(T));   // 2 buffers
  static constexpr size_t total = align128(q + 2 * kTokPad * LDC * sizeof(T));
};

// the first token->image attention's partials: one tile of layer 0's shared
// K/V, loaded once, for kPromptsPerBlock prompts in turn (the next one's
// queries loading while the current one's run)
template <typename T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) twoway_shared_partials(Params p) {
  using S = PartSmem<T, WARPS>;
  constexpr int LDC = S::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + S::k);
  T* sV = reinterpret_cast<T*>(smem + S::v);
  T* sQ = reinterpret_cast<T*>(smem + S::q);
  const int tile = blockIdx.x, r0 = tile * S::R, nt = p.T;
  const int b0 = blockIdx.y * kPromptsPerBlock;
  const int b1 = min(p.B, b0 + kPromptsPerBlock);
  const T* kv = static_cast<const T*>(p.keys) + static_cast<long long>(r0) * kD;
  const T* tq = static_cast<const T*>(p.tq);
  copy_tile_async(sK, LDC, kv, kD, S::R, kC);
  copy_tile_async(sV, LDC, kv + kC, kD, S::R, kC);
  copy_tile_async(sQ, LDC, tq + static_cast<long long>(b0) * nt * kC, kC, nt, kC);
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * (kTokPad - nt) * LDC; i += blockDim.x) {
    const int buf = i / ((kTokPad - nt) * LDC);
    sQ[buf * kTokPad * LDC + nt * LDC + i % ((kTokPad - nt) * LDC)] = from_f<T>(0.0f);
  }
  for (int b = b0; b < b1; ++b) {
    const int i = b - b0;
    if (b + 1 < b1) {
      copy_tile_async(sQ + ((i + 1) & 1) * kTokPad * LDC, LDC,
                      tq + static_cast<long long>(b + 1) * nt * kC, kC, nt, kC);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile_partials<S::R>(sK, LDC, sV, LDC, sQ + (i & 1) * kTokPad * LDC, LDC, nt,
                        p.part + (static_cast<long long>(b) * p.tiles + tile) * nt *
                                     kHeads * kPart,
                        WARPS);
    __syncthreads();   // this buffer is free for prompt b + 2
  }
}

// one (row tile, prompt): layer `layer`'s image->token update of the tile,
// then token->image attention layer + 1's K, V and partials
template <typename T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) twoway_rows(Params p, int layer) {
  using S = RowSmem<T, WARPS>;
  constexpr int LDX = S::LDX, LDC = S::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem + S::x);
  T* sXP = reinterpret_cast<T*>(smem + S::xp);
  T* sTK = reinterpret_cast<T*>(smem + S::tok);
  T* sTV = sTK + kTokPad * LDC;
  float* sVec = reinterpret_cast<float*>(smem + S::vec);
  T* sTQ = sTK;   // after the update
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4, w0 = warp * 16;
  const int b = blockIdx.y, tile = blockIdx.x, r0 = tile * S::R, nt = p.T;
  const T* W = static_cast<const T*>(p.w);
  const long long* wo = p.wo + layer * kMats;
  const long long* vo = p.vo + layer * kVecs;
  const float* pe = p.pe + static_cast<long long>(r0) * kD;
  T* keys_b = static_cast<T*>(p.keys) + (static_cast<long long>(b) * p.M + r0) * kD;
  const T* kin = layer == 0 ? static_cast<const T*>(p.src) + static_cast<long long>(r0) * kD
                            : keys_b;
  const T* tkv = static_cast<const T*>(p.tokkv) + static_cast<long long>(b) * 2 * nt * kC;
  // the block's weights in the order it uses them: image->token q, the two
  // halves of its out projection, the next token->image attention's k, v
  const T* wout = W + wo[IO];
  WeightRing<T, WARPS> ring{reinterpret_cast<T*>(smem + S::ring),
                            {W + wo[IQ], wout, wout + kC * kC,
                             W + t2i_w(p, layer + 1, 1), W + t2i_w(p, layer + 1, 2)},
                            {kD, kC, kC, kD, kD}, 5 * WeightRing<T, WARPS>::kProjChunks};

  copy_tile_async(sX, LDX, kin, kD, S::R, kD);
  copy_tile_async(sTK, LDC, tkv, kC, nt, kC);
  copy_tile_async(sTV, LDC, tkv + nt * kC, kC, nt, kC);
  cp_async_commit();
  ring.begin();
  {
    float4 pv[kPeLoads / 2];   // pe in two halves: fewer registers live
    load_pe(pv, pe, threadIdx.x, blockDim.x);
    for (int i = threadIdx.x; i < 2 * (kTokPad - nt) * LDC; i += blockDim.x) {
      const int buf = i / ((kTokPad - nt) * LDC);
      sTK[buf * kTokPad * LDC + nt * LDC + i % ((kTokPad - nt) * LDC)] = from_f<T>(0.0f);
    }
    const float* vsrc[6] = {p.v + vo[IQ], p.v + vo[IO], p.v + vo[kNorm + 6],
                            p.v + vo[kNorm + 7], p.v + t2i_v(p, layer + 1, 1),
                            p.v + t2i_v(p, layer + 1, 2)};
    const int vfirst[7] = {VQ, VO, VW, VB, VK, VV, kVecFloats};
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      for (int i = threadIdx.x; i < vfirst[v + 1] - vfirst[v]; i += blockDim.x) {
        sVec[vfirst[v] + i] = vsrc[v][i];
      }
    }
    cp_async_wait<S::kStages - 1>();   // the tiles (the weights may still load)
    __syncthreads();
    add_pe<T, LDX>(sXP, sX, pv, threadIdx.x, blockDim.x);
    load_pe(pv, pe, threadIdx.x + 16 * blockDim.x, blockDim.x);
    add_pe<T, LDX>(sXP, sX, pv, threadIdx.x + 16 * blockDim.x, blockDim.x);
  }
  __syncthreads();

  // image->token queries of the warp's rows and their attention over the
  // tokens: bf16 keeps the output as the out projection's A fragments in
  // registers, fp32 in the warp's rows of sQ
  uint32_t o[kHeads][4];
  float* sQ = reinterpret_cast<float*>(smem + S::q) + w0 * LDC;
  {
    float q[kC / 8][4];
    const float* bq = sVec + VQ;
    if constexpr (sizeof(T) == 2) {
      uint32_t fa[kD / 16][4];
      load_a<kD>(fa, sXP + w0 * LDX, LDX);
      proj<WARPS, kD>(q, fa, ring, 0);
      if (nt <= 8) {
        i2t_rows<LDC, 8>(o, q, bq, sTK, sTV, nt);
      } else if (nt <= 16) {
        i2t_rows<LDC, 16>(o, q, bq, sTK, sTV, nt);
      } else {
        i2t_rows<LDC, 32>(o, q, bq, sTK, sTV, nt);
      }
    } else {
      proj<WARPS, kD>(q, sXP + w0 * LDX, LDX, ring, 0);
      store_rows<T, kC>(sQ, LDC, q, bq);
      __syncwarp();
      i2t_rows_f32<LDC>(sQ, sTK, sTV, nt);
      __syncwarp();
    }
  }

  // out projection, residual and LayerNorm 4 of rows g and g + 8 by quad
  // shuffles, in two halves of 128 columns: the first half's fp32 sums
  // parked in the warp's rows of sXP (dead since the queries), the second
  // kept in registers. The new keys go to sX and to global memory, keys +
  // pe for the next attention to sXP.
  {
    const float* bo = sVec + VO;
    const float* nw = sVec + VW;
    const float* nb = sVec + VB;
    T* x = sX + w0 * LDX;
    T* xp = sXP + w0 * LDX;
    float* park = reinterpret_cast<float*>(xp);
    constexpr int LDP = LDX * sizeof(T) / 4;
    float acc[kC / 8][4];
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (sizeof(T) == 2) {
        proj<WARPS, kC>(acc, o, ring, 1 + half);
      } else {
        proj<WARPS, kC>(acc, sQ, LDC, ring, 1 + half);
      }
#pragma unroll
      for (int t = 0; t < kC / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e / 2) * 8, c = t * 8 + tig * 2 + (e & 1);
          acc[t][e] += to_f(x[r * LDX + half * kC + c]) + bo[half * kC + c];
          sum[e / 2] += acc[t][e];
        }
        if (half == 0) {
          store2(park + g * LDP + t * 8 + tig * 2, acc[t][0], acc[t][1]);
          store2(park + (g + 8) * LDP + t * 8 + tig * 2, acc[t][2], acc[t][3]);
        }
      }
    }
    const float mean[2] = {quad_sum(sum[0]) / kD, quad_sum(sum[1]) / kD};
    float var[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < kC / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e / 2) * 8, c = t * 8 + tig * 2 + (e & 1);
        const float d0 = park[r * LDP + c] - mean[e / 2];
        const float d1 = acc[t][e] - mean[e / 2];
        var[e / 2] += d0 * d0 + d1 * d1;
      }
    }
    const float rstd[2] = {rsqrtf(quad_sum(var[0]) / kD + 1e-5f),
                           rsqrtf(quad_sum(var[1]) / kD + 1e-5f)};
#pragma unroll
    for (int t = 0; t < kC / 8; ++t) {
      const int c = t * 8 + tig * 2;
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int r = g + r2 * 8;
        const float m = mean[r2], rs = rstd[r2];
        const float* pk = park + r * LDP + c;
        store2(x + r * LDX + c, (pk[0] - m) * rs * nw[c] + nb[c],
               (pk[1] - m) * rs * nw[c + 1] + nb[c + 1]);
        store2(x + r * LDX + kC + c,
               (acc[t][2 * r2] - m) * rs * nw[kC + c] + nb[kC + c],
               (acc[t][2 * r2 + 1] - m) * rs * nw[kC + c + 1] + nb[kC + c + 1]);
      }
    }
    __syncwarp();   // every lane is done with the parked sums
#pragma unroll
    for (int r8 = 0; r8 < 16; r8 += 8) {   // eight rows of pe at a time
      float4 pv[kPeLoads / 2];
      load_pe(pv, pe + (w0 + r8) * kD, lane, 32);
      add_pe<T, LDX>(xp + r8 * LDX, x + r8 * LDX, pv, lane, 32);
    }
    store_warp_rows(keys_b + static_cast<long long>(w0) * kD, x, LDX, kD);
  }

  // the tokens' K/V are dead once every warp is here: load the queries of
  // the next token->image attention over them (rows past nt stay zero)
  __syncthreads();
  copy_tile_async(sTQ, LDC,
                  static_cast<const T*>(p.tq) + static_cast<long long>(b) * nt * kC,
                  kC, nt, kC);
  cp_async_commit();
  next_kv<T, WARPS>(sVec + VK, sVec + VV, sX, sXP, ring, 3);
  cp_async_wait<0>();
  __syncthreads();
  tile_partials<S::R>(sXP, LDX, sX, LDX, sTQ, LDC, nt,
                      p.part + (static_cast<long long>(b) * p.tiles + tile) * nt *
                                   kHeads * kPart,
                      WARPS);
}

// ---------------------------------------------------------------------------
// tokens
// ---------------------------------------------------------------------------

constexpr int kTokWarps = 8;
constexpr int kTokMT = kTokPad / 16;   // m16 tiles of a token block
constexpr int kTokThreads = kTokWarps * 32;
constexpr int kLdt = kD + 4;           // fp32 token rows in shared memory

template <typename T>
struct TokSmem {
  static constexpr int LDI = kD + pad_of<T>();   // storage-dtype rows
  static constexpr size_t q = 0;                                     // fp32 state
  static constexpr size_t t0 = align128(q + kTokPad * kLdt * 4);     // fp32 tokens
  static constexpr size_t in = align128(t0 + kTokPad * kLdt * 4);    // 4 buffers
  static constexpr size_t total = align128(in + 4 * kTokPad * LDI * sizeof(T));
};

// acc[m][j] += A (rows 16 m .. 16 m + 15, shared, row stride lda) x W^T for
// W's rows 8 j .. 8 j + 7 (global, row stride ldw), K deep (a multiple of
// 64): bf16, each weight fragment read once from L2 and used for every row
// tile. The products over k may pair A and W in any order as long as both
// use the same one: within each 64 columns, lane tig takes columns 16 tig ..
// 16 tig + 15 of W's row (two 16-byte loads) and presents columns 4 s ..
// 4 s + 3 of them to mma step s as its k pairs (2 tig, 2 tig + 1) and
// (8 + 2 tig, 9 + 2 tig); A's fragments take the same columns (8-byte loads).
template <int MT, int NJ>
__device__ __forceinline__ void tok_mm(float (&acc)[MT][NJ][4], const bf16* A,
                                       int lda, const bf16* W, long long ldw,
                                       int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const bf16* a0 = A + g * lda + tig * 16;
  const bf16* w0 = W + g * ldw + tig * 16;
#pragma unroll 2
  for (int k = 0; k < K; k += 64) {
    uint4 w[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint4* src = reinterpret_cast<const uint4*>(w0 + j * 8 * ldw + k);
      w[j][0] = __ldg(src);
      w[j][1] = __ldg(src + 1);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint2 lo = *reinterpret_cast<const uint2*>(a0 + m * 16 * lda + k + 4 * st);
        const uint2 hi = *reinterpret_cast<const uint2*>(a0 + (m * 16 + 8) * lda + k + 4 * st);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint4& wv = w[j][st / 2];
          const uint32_t b0 = st % 2 ? wv.z : wv.x;
          const uint32_t b1 = st % 2 ? wv.w : wv.y;
          mma_bf16(acc[m][j], a, b0, b1);
        }
      }
    }
  }
}

// the same in exact fp32 FMAs, in the same layout
template <int MT, int NJ>
__device__ __forceinline__ void tok_mm(float (&acc)[MT][NJ][4], const float* A,
                                       int lda, const float* W, long long ldw,
                                       int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float a0 = A[(m * 16 + g) * lda + k];
      const float a1 = A[(m * 16 + g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w0 = __ldg(W + (j * 8 + tig * 2) * ldw + k);
        const float w1 = __ldg(W + (j * 8 + tig * 2 + 1) * ldw + k);
        acc[m][j][0] = fmaf(a0, w0, acc[m][j][0]);
        acc[m][j][1] = fmaf(a0, w1, acc[m][j][1]);
        acc[m][j][2] = fmaf(a1, w0, acc[m][j][2]);
        acc[m][j][3] = fmaf(a1, w1, acc[m][j][3]);
      }
    }
  }
}

// epi(t, c, sum_k A[t][k] W[c][k]) for the block's rows t < n and N
// columns c: each warp takes 16 columns at a time
template <typename T, typename Epi>
__device__ __forceinline__ void tok_linear(const T* A, const T* W, long long ldw, int N, int K,
                           int n, Epi epi) {
  constexpr int MT = kTokMT;
  constexpr int NJ = 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  for (int n0 = warp * 8 * NJ; n0 < N; n0 += kTokWarps * 8 * NJ) {
    float acc[MT][NJ][4] = {};
    tok_mm<MT, NJ>(acc, A, TokSmem<T>::LDI, W + n0 * ldw, ldw, K);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m * 16 + g + (e / 2) * 8;
          if (t < n) epi(t, n0 + j * 8 + tig * 2 + (e & 1), acc[m][j][e]);
        }
      }
    }
  }
}

// LayerNorm (eps 1e-5) of rows t < n of x in place, one warp per row
__device__ __forceinline__ void tok_layer_norm(float* x, const float* w, const float* bias,
                               int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < n; t += kTokWarps) {
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

// One block per group of 32 / T whole prompts, their n <= 32 token rows
// flattened. merge >= 0: finish token->image attention `merge` (merge its
// partials, out projection, residual, LayerNorm; for a layer also the MLP
// and the image->token K/V of the tokens; for the final attention the
// output). self_layer >= 0: then layer self_layer's self-attention (a
// layer), each prompt over its own tokens, and the queries of its
// token->image attention (a layer, or the final one).
template <typename T>
__global__ void __launch_bounds__(kTokThreads, 1) twoway_tokens(Params p,
                                                             int merge,
                                                             int self_layer) {
  using S = TokSmem<T>;
  constexpr int LDI = S::LDI;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + S::q);
  float* sT0 = reinterpret_cast<float*>(smem + S::t0);
  T* sIn = reinterpret_cast<T*>(smem + S::in);
  T* sA = sIn + kTokPad * LDI;
  T* sB = sA + kTokPad * LDI;
  T* sC = sB + kTokPad * LDI;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int nt = p.T, group = kTokPad / nt;
  const int b0 = blockIdx.x * group;
  const int n = min(group, p.B - b0) * nt;
  const long long row0 = static_cast<long long>(b0) * nt;   // of (B * T)
  const T* W = static_cast<const T*>(p.w);
  float* qg = p.q + row0 * kD;
  const float* tok = p.tokens + row0 * kD;
  const float* qsrc = (merge < 0 && self_layer == 0) ? tok : qg;
  for (int i = tid; i < n * kD; i += nthreads) {
    const int t = i / kD, c = i - t * kD;
    sT0[t * kLdt + c] = tok[i];
    sQ[t * kLdt + c] = qsrc[i];
  }
  for (int i = tid; i < 4 * kTokPad * LDI; i += nthreads) sIn[i] = from_f<T>(0.0f);
  __syncthreads();

  if (merge >= 0) {
    const int a = merge;
    // a quad of lanes per (token, head): each lane merges every fourth
    // tile with a running max, then the quad merges its four
    const long long stride = static_cast<long long>(nt) * kHeads * kPart;
    const int quads = nthreads / 4, qi = tid % 4;
    const int span = (n * kHeads + quads - 1) / quads * quads;
    for (int it = tid / 4; it < span; it += quads) {
      const bool valid = it < n * kHeads;
      const int t = valid ? it / kHeads : 0, h = it % kHeads;
      const int b = b0 + t / nt, tt = t % nt;
      const float* part = p.part +
          ((static_cast<long long>(b) * p.tiles * nt + tt) * kHeads + h) * kPart;
      float mx = -INFINITY, l = 0.0f, acc[kHdC];
#pragma unroll
      for (int d = 0; d < kHdC; ++d) acc[d] = 0.0f;
      if (valid) {
#pragma unroll 4
        for (int j = qi; j < p.tiles; j += 4) {
          const float* pj = part + j * stride;
          const float m = fmaxf(mx, pj[0]);
          const float old = expf(mx - m), sc = expf(pj[0] - m);
          mx = m;
          l = fmaf(pj[1], sc, l * old);
#pragma unroll
          for (int d = 0; d < kHdC; ++d) acc[d] = fmaf(pj[2 + d], sc, acc[d] * old);
        }
      }
      const float m4 = quad_max(mx);
      const float sc = mx > -INFINITY ? expf(mx - m4) : 0.0f;
      l = quad_sum(l * sc);
#pragma unroll
      for (int d = 0; d < kHdC; ++d) acc[d] = quad_sum(acc[d] * sc);
      if (valid && qi == 0) {
#pragma unroll
        for (int d = 0; d < kHdC; ++d) sIn[t * LDI + h * kHdC + d] = from_f<T>(acc[d] / l);
      }
    }
    __syncthreads();
    const float* bo = p.v + t2i_v(p, a, 3);
    tok_linear<T>(sIn, W + t2i_w(p, a, 3), kC, kD, kC, n,
                      [&](int t, int c, float s) { sQ[t * kLdt + c] += s + bo[c]; });
    __syncthreads();
    if (a == p.n_layers) {
      const long long* vf = p.vo + p.n_layers * kVecs;
      tok_layer_norm(sQ, p.v + vf[4], p.v + vf[5], n);
      __syncthreads();
      T* out = static_cast<T*>(p.q_out) + row0 * kD;
      for (int i = tid; i < n * kD; i += nthreads) {
        out[i] = from_f<T>(sQ[(i / kD) * kLdt + i % kD]);
      }
      return;
    }
    const long long* wo = p.wo + a * kMats;
    const long long* vo = p.vo + a * kVecs;
    tok_layer_norm(sQ, p.v + vo[kNorm + 2], p.v + vo[kNorm + 3], n);
    __syncthreads();
    // MLP, 256 hidden units at a time; each warp keeps the sums of its 32
    // output columns in registers over the chunks
    for (int i = tid; i < n * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sIn[t * LDI + c] = from_f<T>(sQ[t * kLdt + c]);
    }
    const float* b1 = p.v + vo[M1];
    const float* b2 = p.v + vo[M2];
    float acc2[kTokMT][4][4] = {};
    for (int f0 = 0; f0 < kF; f0 += kD) {
      __syncthreads();   // sIn complete; sA free
      tok_linear<T>(sIn, W + wo[M1] + static_cast<long long>(f0) * kD, kD,
                        kD, kD, n, [&](int t, int c, float s) {
                          sA[t * LDI + c] = from_f<T>(fmaxf(s + b1[f0 + c], 0.0f));
                        });
      __syncthreads();
      tok_mm<kTokMT, 4>(acc2, sA, LDI,
                    W + wo[M2] + static_cast<long long>(warp * 32) * kF + f0, kF, kD);
    }
#pragma unroll
    for (int m = 0; m < kTokMT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m * 16 + g + (e / 2) * 8;
          const int c = warp * 32 + j * 8 + tig * 2 + (e & 1);
          if (t < n) sQ[t * kLdt + c] += acc2[m][j][e] + b2[c];
        }
      }
    }
    __syncthreads();
    tok_layer_norm(sQ, p.v + vo[kNorm + 4], p.v + vo[kNorm + 5], n);
    __syncthreads();
    // image->token keys (from q + pe) and values (from q) of the tokens
    for (int i = tid; i < n * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sIn[t * LDI + c] = from_f<T>(sQ[t * kLdt + c] + sT0[t * kLdt + c]);
      sA[t * LDI + c] = from_f<T>(sQ[t * kLdt + c]);
    }
    __syncthreads();
    T* kv = static_cast<T*>(p.tokkv);
    const float* bk = p.v + vo[IK];
    const float* bv = p.v + vo[IV];
    tok_linear<T>(sIn, W + wo[IK], kD, kC, kD, n, [&](int t, int c, float s) {
      const long long b = b0 + t / nt;
      kv[(b * 2 * nt + t % nt) * kC + c] = from_f<T>(s + bk[c]);
    });
    tok_linear<T>(sA, W + wo[IV], kD, kC, kD, n, [&](int t, int c, float s) {
      const long long b = b0 + t / nt;
      kv[(b * 2 * nt + nt + t % nt) * kC + c] = from_f<T>(s + bv[c]);
    });
    __syncthreads();
  }

  if (self_layer >= 0) {
    const int l = self_layer;
    if (l < p.n_layers) {
      const long long* wo = p.wo + l * kMats;
      const long long* vo = p.vo + l * kVecs;
      // q and k from q + pe (layer 0: from the tokens, no pe), v from q
      for (int i = tid; i < n * kD; i += nthreads) {
        const int t = i / kD, c = i - t * kD;
        const float pe = l == 0 ? 0.0f : sT0[t * kLdt + c];
        sIn[t * LDI + c] = from_f<T>(sQ[t * kLdt + c] + pe);
      }
      __syncthreads();
      const float* bq = p.v + vo[SQ];
      const float* bk = p.v + vo[SK];
      const float* bv = p.v + vo[SV];
      tok_linear<T>(sIn, W + wo[SQ], kD, kD, kD, n, [&](int t, int c, float s) {
        sA[t * LDI + c] = from_f<T>(s + bq[c]);
      });
      tok_linear<T>(sIn, W + wo[SK], kD, kD, kD, n, [&](int t, int c, float s) {
        sB[t * LDI + c] = from_f<T>(s + bk[c]);
      });
      __syncthreads();
      if (l > 0) {
        for (int i = tid; i < n * kD; i += nthreads) {
          const int t = i / kD, c = i - t * kD;
          sIn[t * LDI + c] = from_f<T>(sQ[t * kLdt + c]);
        }
        __syncthreads();
      }
      tok_linear<T>(sIn, W + wo[SV], kD, kD, kD, n, [&](int t, int c, float s) {
        sC[t * LDI + c] = from_f<T>(s + bv[c]);
      });
      __syncthreads();
      // self-attention per (token, head) over the tokens of its own prompt,
      // head dim 32; output -> sIn
      const float scale = 0.17677669529663687f;   // 1 / sqrt(32)
      for (int pr = tid; pr < n * kHeads; pr += nthreads) {
        const int t = pr / kHeads, h = pr - (pr / kHeads) * kHeads;
        const int base = (t / nt) * nt;
        const T* qa = sA + t * LDI + h * kHdS;
        float s[kMaxT];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < kMaxT; ++u) {
          if (u < nt) {
            const T* ka = sB + (base + u) * LDI + h * kHdS;
            float acc = 0.0f;
            for (int d = 0; d < kHdS; ++d) acc = fmaf(to_f(qa[d]), to_f(ka[d]), acc);
            s[u] = acc * scale;
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
            if (u < nt) o = fmaf(s[u], to_f(sC[(base + u) * LDI + h * kHdS + d]), o);
          }
          sIn[t * LDI + h * kHdS + d] = from_f<T>(o);
        }
      }
      __syncthreads();
      const float* bo = p.v + vo[SO];
      tok_linear<T>(sIn, W + wo[SO], kD, kD, kD, n, [&](int t, int c, float s) {
        const float y = s + bo[c];
        sQ[t * kLdt + c] = l == 0 ? y : sQ[t * kLdt + c] + y;
      });
      __syncthreads();
      tok_layer_norm(sQ, p.v + vo[kNorm], p.v + vo[kNorm + 1], n);
      __syncthreads();
    }
    // queries of the next token->image attention, from q + pe
    for (int i = tid; i < n * kD; i += nthreads) {
      const int t = i / kD, c = i - t * kD;
      sIn[t * LDI + c] = from_f<T>(sQ[t * kLdt + c] + sT0[t * kLdt + c]);
    }
    __syncthreads();
    T* tq = static_cast<T*>(p.tq) + row0 * kC;
    const float* bq = p.v + t2i_v(p, l, 0);
    tok_linear<T>(sIn, W + t2i_w(p, l, 0), kD, kC, kD, n,
                      [&](int t, int c, float s) { tq[t * kC + c] = from_f<T>(s + bq[c]); });
  }
  __syncthreads();
  for (int i = tid; i < n * kD; i += nthreads) {
    qg[i] = sQ[(i / kD) * kLdt + i % kD];
  }
}

template <typename T>
cudaError_t launch_tokens(const Params& p, int merge, int self_layer,
                          cudaStream_t stream) {
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, twoway_tokens<T>, TokSmem<T>::total, true);
  if (e != cudaSuccess) return e;
  const int group = kTokPad / p.T;
  twoway_tokens<T><<<(p.B + group - 1) / group, kTokThreads, TokSmem<T>::total,
                     stream>>>(p, merge, self_layer);
  return cudaGetLastError();
}

// Rows per row block: bf16 takes 128 (8 warps) where the image rows split
// into 128-row tiles that give each of an H100's 132 SMs a block, else 64
// (4 warps; the click's single prompt, small images); fp32 takes 32 (2
// warps). core/kernels.py twoway_row_tile follows the same rule.
constexpr int kFillBlocks = 132;

int row_tile(const Params& p, bool bf16) {
  if (!bf16) return 32;
  return p.M % 128 == 0 && static_cast<long long>(p.B) * (p.M / 128) >= kFillBlocks
             ? 128 : 64;
}

template <typename T, int WARPS>
cudaError_t run_tiles(Params& p, cudaStream_t stream) {
  using S = RowSmem<T, WARPS>;
  using P0 = PartSmem<T, WARPS>;
  static_assert(S::total <= static_cast<size_t>(kMaxSmem), "row tile too big");
  static_assert(TokSmem<T>::total <= static_cast<size_t>(kMaxSmem), "token tile too big");
  static SmemGrant kv_grant, part_grant, rows_grant;
  if (p.M % S::R != 0) return cudaErrorInvalidValue;
  p.tiles = p.M / S::R;
  cudaError_t e;
  if ((e = grant_smem(kv_grant, twoway_shared_kv<T, WARPS>, S::total, true)) != cudaSuccess ||
      (e = grant_smem(part_grant, twoway_shared_partials<T, WARPS>, P0::total, true)) != cudaSuccess ||
      (e = grant_smem(rows_grant, twoway_rows<T, WARPS>, S::total, true)) != cudaSuccess) {
    return e;
  }
  auto tokens = [&](int merge, int self_layer) {
    return launch_tokens<T>(p, merge, self_layer, stream);
  };
  twoway_shared_kv<T, WARPS><<<p.tiles, WARPS * 32, S::total, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = tokens(-1, 0)) != cudaSuccess) return e;
  const dim3 pgrid(p.tiles, (p.B + kPromptsPerBlock - 1) / kPromptsPerBlock);
  twoway_shared_partials<T, WARPS><<<pgrid, WARPS * 32, P0::total, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 rgrid(p.tiles, p.B);
  for (int l = 0; l < p.n_layers; ++l) {
    if ((e = tokens(l, l + 1)) != cudaSuccess) return e;
    twoway_rows<T, WARPS><<<rgrid, WARPS * 32, S::total, stream>>>(p, l);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return tokens(p.n_layers, -1);
}

template <typename T>
cudaError_t run(Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return row_tile(p, true) == 128 ? run_tiles<T, 8>(p, stream)
                                    : run_tiles<T, 4>(p, stream);
  } else {
    return run_tiles<T, 2>(p, stream);
  }
}

// blocks of each kernel an SM holds at once: shared K/V, first partials,
// rows, tokens (after the opt-in, on the current device)
template <typename T, int WARPS>
cudaError_t occupancy(int* blocks) {
  using S = RowSmem<T, WARPS>;
  using P0 = PartSmem<T, WARPS>;
  cudaError_t e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks[0], twoway_shared_kv<T, WARPS>, WARPS * 32, S::total)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks[1], twoway_shared_partials<T, WARPS>, WARPS * 32, P0::total)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks[2], twoway_rows<T, WARPS>, WARPS * 32, S::total)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks[3], twoway_tokens<T>, kTokThreads, TokSmem<T>::total)) != cudaSuccess) {
    return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks per SM of the four kernels (shared K/V, first partials, rows,
// tokens) for dtype 0 = float32, 1 = bfloat16 at `rows` image rows per row
// block (128 or 64 in bf16, 32 in fp32), into blocks[0..3]; valid after an
// ea_sam_twoway call at that tile on the current device (the shared memory
// opt-in). Returns a cudaError_t.
int ea_sam_twoway_occupancy(int dtype, int rows, int* blocks) {
  if (dtype == 1 && rows == 128) return static_cast<int>(occupancy<__nv_bfloat16, 8>(blocks));
  if (dtype == 1 && rows == 64) return static_cast<int>(occupancy<__nv_bfloat16, 4>(blocks));
  if (dtype == 0 && rows == 32) return static_cast<int>(occupancy<float, 2>(blocks));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16. w_off / v_off: element offsets of the
// packed matrices and vectors, n_layers * 14 + 4 and n_layers * 22 + 6 of
// them, in the order of core/kernels.py _twoway_names. src_sb, the batch
// stride of src, must be 0: every prompt shares src. keys (B, M, 256)
// doubles as the scratch of layer 0's shared K/V. Returns a cudaError_t
// (0 = success).
int ea_sam_twoway(const void* src, long long src_sb, const float* pe,
                  const float* tokens, const void* w, const float* v,
                  const long long* w_off, int n_w, const long long* v_off,
                  int n_v, int n_layers, void* keys, void* q_out,
                  float* q_state, void* tokkv, void* tq, float* part, int B,
                  int M, int T, int dtype, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_w != n_layers * kMats + 4 ||
      n_v != n_layers * kVecs + 6 || T < 1 || T > kMaxT || B < 1 ||
      B > 65535 || M < 1 || src_sb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.src = src; p.pe = pe; p.tokens = tokens;
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

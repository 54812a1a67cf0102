// Flash attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/flash_attention.py
// (_flash_kernel, :64; called through flash_attention, :114). It computes
// what that kernel computes: unmasked softmax(scale * q k^T) v over
// (B, H, N, Dqk) x (B, H, M, Dqk) x (B, H, M, Dv), with q/k allowed deeper
// than v, keys past M masked, products in the storage dtype (bf16 on the
// main path), P rounded to bf16 before P V, and the running max, sum and
// output accumulator in fp32.
//
// What bounds it on this card. Attention does 2 (Dqk + Dv) flops per
// (query, key) pair against a few bytes, so no shape of the main path is
// bound by device memory. At D <= 208 (UNet/ControlNet D = 40/80/160, SAM's
// 208/80 and 112/80) a warp of mma.sync is bound by issue slots and the
// special-function unit: per (query, key) pair it spends one exp2 (16 per
// clock per SM, against 4096 bf16 tensor flops per clock) and ~5 ALU
// instructions on the online softmax beside 2 (Dqk + Dv) tensor flops, so
// every shared-memory fragment load and every instruction around the mma
// counts. At the VAE's single 512-deep head the work per pair is 2048
// flops, the output accumulator is 512 fp32 per query row, and what bounds
// it is reading K and V (8 MB per 32 query rows) from L2 into shared memory.
//
// bf16, Dv <= 160 (flash_bf16_kernel, FlashAttention-2 style). A block of
// 8 warps owns 256 query rows (32 per warp, two m16 tiles; 128 rows, one
// tile per warp, at Dv = 144/160, where two tiles' accumulators would not
// fit the registers), so each K/V tile staged in shared memory serves 256
// queries; warps whose rows all lie past N skip the arithmetic. K and V
// tiles of 64 keys (32 where two m16 tiles per warp meet Dqk > 128, SAM's
// 208, which keeps S's registers and the ring's shared memory down) stream
// through a ring of 2-3 shared-memory stages filled by cp.async: tile
// j + stages - 1 is in flight while tile j computes, with one
// __syncthreads per tile. Rows past M and the depth padding (D = 40 -> 48)
// are zero-filled by the src-size form of cp.async; layouts that rule out
// 16-byte rows (Dqk = 36, SAM's unpadded 108) take a synchronous element
// copy into the same ring. Per tile a warp forms S = Q K^T with mma.sync
// m16n8k16 (fp32 accumulate) in registers: Q's A fragments stay in
// registers for the whole key loop where Dqk and Dv <= 64 (else one
// ldmatrix.x4 per 16-deep step from shared memory), K's B fragments come
// two n-tiles per ldmatrix.x4, and each feeds both m16 tiles. Only the
// last, ragged key tile is masked. The online softmax runs on the registers (row max
// and sum across the 4 threads of a row, the max taken on the raw logits
// and the scale folded into one FFMA before each exp2); P, rounded to
// bf16, is the A operand of O += P V, with V's B fragments two n-tiles per
// ldmatrix.x4.trans.
//
// bf16, Dv > 160 (flash_bf16_wide_kernel: the VAE's D = 512 head). A block
// of 8 warps owns 32 query rows; keys come 32 at a time. Each warp forms
// one 16 x 8 tile of S over the whole depth, so S is formed once per
// (query tile, key tile); the tile goes through shared memory to a pass
// that runs the online softmax (8 threads per row) and writes P (bf16) and
// each row's rescale factor back to shared memory, from which every warp
// forms O += P V for its own 64 of the output columns (a 2 x 8 tile
// accumulator, 64 fp32 registers a thread). Q, one K tile and one V tile
// share 105 KB, so two blocks (16 warps) fit an SM; V_j loads while S_j
// forms, K_{j+1} while the softmax and P_j V_j run. The grid is one block
// per 32 query rows: 128 blocks at batch 1, 256 at batch 2.
//
// Not here yet: wgmma (asynchronous warpgroup products from shared
// memory), TMA loads and warp specialisation, which would take the
// fragment loads and the copies off the issue slots; the backward.
//
// fp32 (flash_f32_kernel) is the tests' path, not the main path's: the
// tensor cores have no exact fp32 mode (TF32 only), so it uses exact fp32
// FMAs on the CUDA cores with S, P and the output accumulator in shared
// memory. It agrees with the plain PyTorch version to ~1e-6.
//
// Tensors are read through their (batch, head, row) strides, so the
// (B, N, H, D) projections need no transposed copy. Plain C interface for
// ctypes (no PyTorch headers): ea_flash_attention returns the launch's
// cudaGetLastError(), 0 on success.

#include "common.cuh"

namespace {

using namespace ea;

constexpr int kRows = 16;          // query rows per warp (fp32 path)
constexpr int kWarps = 8;          // warps per block (bf16, Dv <= 160)
constexpr int kWideWarps = 8;      // warps per block (bf16, Dv > 160)
constexpr int kWideRows = 32;      // query rows per block (Dv > 160)
constexpr int kWideKeys = 32;      // keys per tile (Dv > 160)
constexpr int kWideCols = 64;      // output columns per warp (Dv > 160)
constexpr int kWideMaxDv = kWideWarps * kWideCols;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  int heads, n, m, dqk, dv;
  int dqk_pad, dv_pad;   // depths rounded up to 16
  int vec;               // 1: rows may be read as 16-byte vectors
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 (common.cuh) with ldmatrix fragment loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

// Start copying a rows x cols_pad tile, global (row stride src_ld) ->
// shared (row stride dst_ld), by the whole block, zero past rows_valid /
// cols_valid. vec: 16-byte cp.async, zero-filled by its src-size operand
// (cols_valid, src_ld and src are multiples of 8 elements); else a
// synchronous element copy.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int dst_ld,
                                          const __nv_bfloat16* src,
                                          long long src_ld, int rows,
                                          int rows_valid, int cols_pad,
                                          int cols_valid, bool vec) {
  if (vec) {
    const int chunks = cols_pad / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async16_zfill(dst + r * dst_ld + c, valid ? src + r * src_ld + c : src,
                       valid);
    }
  } else {   // 8 loads in flight per thread, then 8 stores
    constexpr int kBatch = 8;
    const int total = rows * cols_pad;
    for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
      __nv_bfloat16 val[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * blockDim.x;
        const int r = idx / cols_pad, c = idx - r * cols_pad;
        val[u] = idx < total && r < rows_valid && c < cols_valid
                     ? __ldg(src + r * src_ld + c) : __float2bfloat16(0.0f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * blockDim.x;
        const int r = idx / cols_pad, c = idx - r * cols_pad;
        if (idx < total) dst[r * dst_ld + c] = val[u];
      }
    }
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int width,
                                           float x0, float x1, bool pairs) {
  if (pairs && c + 1 < width) {
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(x0, x1);
  } else {
    if (c < width) row[c] = __float2bfloat16(x0);
    if (c + 1 < width) row[c + 1] = __float2bfloat16(x1);
  }
}

// Shared-memory carve-up of flash_bf16_kernel: Q, then the ring's stages
// (K tile, V tile each).
template <int MT, int DVT, int KB, int STAGES>
struct Bf16Layout {
  static constexpr int kBlockN = kWarps * 16 * MT;
  static constexpr int kLdv = DVT * 8 + 8;   // +8: spreads rows over banks
  __host__ __device__ static size_t q_bytes(int ldq) {
    return align128(static_cast<size_t>(kBlockN) * ldq * 2);
  }
  __host__ __device__ static size_t k_bytes(int ldq) {
    return align128(static_cast<size_t>(KB) * ldq * 2);
  }
  __host__ __device__ static size_t stage_bytes(int ldq) {
    return k_bytes(ldq) + align128(static_cast<size_t>(KB) * kLdv * 2);
  }
  __host__ __device__ static size_t total(int ldq) {
    return q_bytes(ldq) + STAGES * stage_bytes(ldq);
  }
};

// MT m16 tiles (16 query rows each) per warp, DVT * 8 output columns, KB
// keys per tile, STAGES ring stages, QREG: Q's fragments held in registers
// (dqk_pad <= 64).
template <int MT, int DVT, int KB, int STAGES, bool QREG>
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(Params p) {
  using L = Bf16Layout<MT, DVT, KB, STAGES>;
  constexpr int kLdv = L::kLdv;
  constexpr int NT = KB / 8;      // n8 tiles of S per m16 tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = p.dqk_pad + 8;  // +8: spreads rows over banks
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + L::q_bytes(ldq);
  const size_t stage_bytes = L::stage_bytes(ldq), k_bytes = L::k_bytes(ldq);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment row / column pair
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int row0 = blockIdx.x * L::kBlockN;
  const bool vec = p.vec != 0;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* o =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int ntiles = (p.m + KB - 1) / KB;
  auto issue = [&](int tile) {   // K and V of one key tile into its stage
    unsigned char* st = ring + (tile % STAGES) * stage_bytes;
    const int kv0 = tile * KB;
    load_tile(reinterpret_cast<__nv_bfloat16*>(st), ldq, k + kv0 * p.k_sn,
              p.k_sn, KB, p.m - kv0, p.dqk_pad, p.dqk, vec);
    load_tile(reinterpret_cast<__nv_bfloat16*>(st + k_bytes), kLdv,
              v + kv0 * p.v_sn, p.v_sn, KB, p.m - kv0, DVT * 8, p.dv, vec);
  };
  load_tile(sQ, ldq, q + row0 * p.q_sn, p.q_sn, L::kBlockN, p.n - row0,
            p.dqk_pad, p.dqk, vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  float acc[MT][DVT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < DVT; ++t)
      acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.0f;
  float m_run[MT][2], l_run[MT][2];   // rows g and g + 8, log2 domain
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.0f;   // this thread's partial sums
  }
  const float scale_log2 = p.scale * kLog2e;
  const bool raw_max = scale_log2 > 0.0f;
  const float factor = raw_max ? scale_log2 : 1.0f;
  const __nv_bfloat16* qw = sQ + warp * 16 * MT * ldq;
  // lane addresses of ldmatrix: A (Q) rows lane % 16, column half lane / 16;
  // B (K) rows (lane / 16) * 8 + lane % 8, column half (lane / 8) % 2;
  // B (V, transposed) rows lane % 16, n-tile lane / 16
  const int a_off = (lane & 15) * ldq + (lane >> 4) * 8;
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * ldq + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * kLdv + (lane >> 4) * 8;
  const int qsteps = p.dqk_pad / 16;
  uint32_t qf[MT][QREG ? 4 : 1][4];
  const bool active = row0 + warp * 16 * MT < p.n;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread
    __syncthreads();              // ... for all; tile j - 1 no longer read
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* sK =
        reinterpret_cast<const __nv_bfloat16*>(ring + (j % STAGES) * stage_bytes);
    const __nv_bfloat16* sV = reinterpret_cast<const __nv_bfloat16*>(
        ring + (j % STAGES) * stage_bytes + k_bytes);
    if (!active) continue;   // no row of this warp lies below N
    if (QREG && j == 0) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? 4 : 1); ++ks)
        if (ks < qsteps)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(qf[mt][ks], qw + mt * 16 * ldq + a_off + ks * 16);
    }

    // S = Q K^T: MT x 16 rows x KB keys per warp
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        s[mt][t][0] = s[mt][t][1] = s[mt][t][2] = s[mt][t][3] = 0.0f;
    if (QREG) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? 4 : 1); ++ks) {
        if (ks < qsteps) {
#pragma unroll
          for (int tp = 0; tp < NT / 2; ++tp) {
            uint32_t kf[4];
            ldsm_x4(kf, sK + tp * 16 * ldq + k_off + ks * 16);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(s[mt][2 * tp], qf[mt][ks], kf[0], kf[1]);
              mma_bf16(s[mt][2 * tp + 1], qf[mt][ks], kf[2], kf[3]);
            }
          }
        }
      }
    } else {
      for (int kk = 0; kk < p.dqk_pad; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], qw + mt * 16 * ldq + a_off + kk);
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
          uint32_t kf[4];
          ldsm_x4(kf, sK + tp * 16 * ldq + k_off + kk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * tp], a[mt], kf[0], kf[1]);
            mma_bf16(s[mt][2 * tp + 1], a[mt], kf[2], kf[3]);
          }
        }
      }
    }

    // thread holds rows g (s[.][.][0..1]) and g + 8 (s[.][.][2..3]),
    // columns t * 8 + tig * 2 + {0, 1}. The running max is kept in the log2
    // domain; with a positive scale it is the scale times the max of the
    // raw logits, so each element costs one FFMA before its exp2 (any other
    // scale is applied first, and the factor becomes 1). Only the last tile
    // can be ragged.
    if (!raw_max) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][t][e] *= scale_log2;
    }
    const int kv0 = j * KB;
    if (kv0 + KB > p.m) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + t * 8 + tig * 2 + (e & 1) >= p.m) s[mt][t][e] = -INFINITY;
    }

    // online softmax on the registers
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[mt][t][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[mt][r], mx[r] * factor);
        alpha[r] = fast_exp2(m_run[mt][r] - m_new);
        m_run[mt][r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fast_exp2(fmaf(s[mt][t][e], factor, -m_run[mt][e / 2]));
          s[mt][t][e] = pe;
          sum[e / 2] += pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[mt][r] = l_run[mt][r] * alpha[r] + sum[r];
#pragma unroll
      for (int t = 0; t < DVT; ++t) {
        acc[mt][t][0] *= alpha[0];
        acc[mt][t][1] *= alpha[0];
        acc[mt][t][2] *= alpha[1];
        acc[mt][t][3] *= alpha[1];
      }
    }

    // O += P V; P's C fragments are the A fragments of the next product
#pragma unroll
    for (int kc = 0; kc < KB / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int tp = 0; tp < DVT / 2; ++tp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, sV + kc * 16 * kLdv + v_off + tp * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * tp], a[mt], vf[0], vf[1]);
          mma_bf16(acc[mt][2 * tp + 1], a[mt], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy may outlive the block

  const bool pairs = (p.dv & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int gr = row0 + warp * 16 * MT + mt * 16 + g + r * 8;
      if (gr >= p.n) continue;
      const float inv = 1.0f / l;
      __nv_bfloat16* orow = o + gr * p.o_sn;
#pragma unroll
      for (int t = 0; t < DVT; ++t)
        store_pair(orow, t * 8 + tig * 2, p.dv, acc[mt][t][2 * r] * inv,
                   acc[mt][t][2 * r + 1] * inv, pairs);
    }
  }
}

template <int MT, int DVT, int KB, int STAGES, bool QREG>
cudaError_t launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  using L = Bf16Layout<MT, DVT, KB, STAGES>;
  static SmemGrant grant;  // largest dynamic shared memory granted, per device
  const size_t smem = L::total(p.dqk_pad + 8);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t e =
      grant_smem(grant, flash_bf16_kernel<MT, DVT, KB, STAGES, QREG>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + L::kBlockN - 1) / L::kBlockN, batch * p.heads);
  flash_bf16_kernel<MT, DVT, KB, STAGES, QREG>
      <<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// key tile and ring by depth: Q in registers and three stages where
// Dqk <= 64 (and Dv <= 64); 64-key tiles in two stages, but 32-key tiles
// where two m16 tiles per warp meet Dqk > 128 (SAM's 208)
template <int MT, int DVT>
cudaError_t by_depth(const Params& p, int batch, cudaStream_t s) {
  if constexpr (DVT <= 8) {
    if (p.dqk_pad <= 64) return launch_bf16<MT, DVT, 64, 3, true>(p, batch, s);
  }
  if constexpr (MT == 1) {
    return launch_bf16<MT, DVT, 64, 2, false>(p, batch, s);
  } else {
    if (p.dqk_pad <= 128) return launch_bf16<MT, DVT, 64, 2, false>(p, batch, s);
    return launch_bf16<MT, DVT, 32, 2, false>(p, batch, s);
  }
}

// ---------------------------------------------------------------------------
// bf16, Dv > 160: S formed once per (32-row query tile, 32-key tile) and P
// shared through shared memory by 8 warps of 64 output columns each
// ---------------------------------------------------------------------------

struct WideLayout {
  static constexpr int kLdS = kWideKeys + 8;   // fp32 S row stride
  static constexpr int kLdP = kWideKeys + 8;   // bf16 P row stride
  int ldq, ldv;
  size_t q, k, v, s, pp, stats, total;
};

__host__ __device__ inline WideLayout wide_layout(int dqk_pad, int dv_pad) {
  WideLayout L;
  L.ldq = dqk_pad + 8;
  L.ldv = dv_pad + 8;
  size_t off = 0;
  L.q = off; off = align128(off + static_cast<size_t>(kWideRows) * L.ldq * 2);
  L.k = off; off = align128(off + static_cast<size_t>(kWideKeys) * L.ldq * 2);
  L.v = off; off = align128(off + static_cast<size_t>(kWideKeys) * L.ldv * 2);
  L.s = off; off = align128(off + static_cast<size_t>(kWideRows) * WideLayout::kLdS * 4);
  L.pp = off; off = align128(off + static_cast<size_t>(kWideRows) * WideLayout::kLdP * 2);
  L.stats = off; off = align128(off + static_cast<size_t>(kWideRows) * 2 * 4);
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(kWideWarps * 32, 2)
flash_bf16_wide_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WideLayout L = wide_layout(p.dqk_pad, p.dv_pad);
  constexpr int kLdS = WideLayout::kLdS, kLdP = WideLayout::kLdP;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L.pp);
  float* sAlpha = reinterpret_cast<float*>(smem + L.stats);
  float* sL = sAlpha + kWideRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int row0 = blockIdx.x * kWideRows;
  const bool vec = p.vec != 0;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* o =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile(sQ, L.ldq, q + row0 * p.q_sn, p.q_sn, kWideRows, p.n - row0,
            p.dqk_pad, p.dqk, vec);
  load_tile(sK, L.ldq, k, p.k_sn, kWideKeys, p.m, p.dqk_pad, p.dqk, vec);
  cp_async_commit();

  // this warp's tile of S: rows smt * 16.., keys snt * 8..
  const int smt = warp & 1, snt = warp >> 1;
  const __nv_bfloat16* qa = sQ + (smt * 16 + (lane & 15)) * L.ldq + (lane >> 4) * 8;
  const __nv_bfloat16* kb = sK + (snt * 8 + (lane & 7)) * L.ldq + ((lane >> 3) & 1) * 8;
  // the softmax pass: 8 threads per row, 4 keys each
  const int sr = tid >> 3, sc = (tid & 7) * 4;
  float m_run = -INFINITY, l_run = 0.0f;   // of row sr, log2 domain
  const float scale_log2 = p.scale * kLog2e;
  // this warp's output columns and its P V fragments
  const int col0 = warp * kWideCols;
  const __nv_bfloat16* pa = sP + (lane & 15) * kLdP + (lane >> 4) * 8;
  const __nv_bfloat16* vb = sV + (lane & 15) * L.ldv + col0 + (lane >> 4) * 8;
  float acc[2][kWideCols / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < kWideCols / 8; ++t)
      acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.0f;

  const int ntiles = (p.m + kWideKeys - 1) / kWideKeys;
  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * kWideKeys;
    cp_async_wait<0>();   // K_j (and Q) landed for this thread
    __syncthreads();      // ... for all; P_{j-1} V_{j-1} done, sV free
    load_tile(sV, L.ldv, v + kv0 * p.v_sn, p.v_sn, kWideKeys, p.m - kv0,
              p.dv_pad, p.dv, vec);
    cp_async_commit();

    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < p.dqk_pad; kk += 16) {
      uint32_t a[4], b0, b1;
      ldsm_x4(a, qa + kk);
      ldsm_x2(b0, b1, kb + kk);
      mma_bf16(s, a, b0, b1);
    }
    float* srow = sS + (smt * 16 + g) * kLdS + snt * 8 + tig * 2;
    *reinterpret_cast<float2*>(srow) = make_float2(s[0], s[1]);
    *reinterpret_cast<float2*>(srow + 8 * kLdS) = make_float2(s[2], s[3]);
    __syncthreads();      // S visible; K_j no longer read
    if (j + 1 < ntiles) {
      load_tile(sK, L.ldq, k + (kv0 + kWideKeys) * p.k_sn, p.k_sn, kWideKeys,
                p.m - kv0 - kWideKeys, p.dqk_pad, p.dqk, vec);
    }
    cp_async_commit();

    // online softmax of row sr, keys sc..sc + 3
    float x[4];
    const float4 s4 = *reinterpret_cast<const float4*>(sS + sr * kLdS + sc);
    x[0] = s4.x * scale_log2; x[1] = s4.y * scale_log2;
    x[2] = s4.z * scale_log2; x[3] = s4.w * scale_log2;
    if (kv0 + kWideKeys > p.m) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + sc + e >= p.m) x[e] = -INFINITY;
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = fast_exp2(m_run - m_new);
    m_run = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = fast_exp2(x[e] - m_new);
      sum += x[e];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l_run = l_run * alpha + sum;
    *reinterpret_cast<uint2*>(sP + sr * kLdP + sc) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
    if ((tid & 7) == 0) sAlpha[sr] = alpha;
    cp_async_wait<1>();   // V_j landed (K_{j+1} may still be in flight)
    __syncthreads();      // P, the rescale factors and V_j visible

    if (col0 < p.dv_pad) {
      float al[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        al[mt][0] = sAlpha[mt * 16 + g];
        al[mt][1] = sAlpha[mt * 16 + g + 8];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < kWideCols / 8; ++t) {
          acc[mt][t][0] *= al[mt][0];
          acc[mt][t][1] *= al[mt][0];
          acc[mt][t][2] *= al[mt][1];
          acc[mt][t][3] *= al[mt][1];
        }
#pragma unroll
      for (int kc = 0; kc < kWideKeys / 16; ++kc) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], pa + mt * 16 * kLdP + kc * 16);
#pragma unroll
        for (int tp = 0; tp < kWideCols / 16; ++tp) {
          if (col0 + tp * 16 >= p.dv_pad) break;
          uint32_t vf[4];
          ldsm_x4_trans(vf, vb + kc * 16 * L.ldv + tp * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * tp], a[mt], vf[0], vf[1]);
            mma_bf16(acc[mt][2 * tp + 1], a[mt], vf[2], vf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if ((tid & 7) == 0) sL[sr] = l_run;
  __syncthreads();

  if (col0 >= p.dv_pad) return;
  const bool pairs = (p.dv & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = mt * 16 + g + r * 8, gr = row0 + lr;
      if (gr >= p.n) continue;
      const float inv = 1.0f / sL[lr];
      __nv_bfloat16* orow = o + gr * p.o_sn;
#pragma unroll
      for (int t = 0; t < kWideCols / 8; ++t)
        store_pair(orow, col0 + t * 8 + tig * 2, p.dv, acc[mt][t][2 * r] * inv,
                   acc[mt][t][2 * r + 1] * inv, pairs);
    }
  }
}

cudaError_t launch_bf16_wide(const Params& p, int batch, cudaStream_t stream) {
  static SmemGrant grant;
  if (p.dv_pad > kWideMaxDv) return cudaErrorInvalidValue;
  const size_t smem = wide_layout(p.dqk_pad, p.dv_pad).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t e = grant_smem(grant, flash_bf16_wide_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + kWideRows - 1) / kWideRows, batch * p.heads);
  flash_bf16_wide_kernel<<<grid, kWideWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& p, int batch, cudaStream_t s) {
  // output width per block: the smallest instantiated one that holds dv;
  // two m16 tiles per warp up to 128 columns, one at 144/160; wider Dv
  // (the VAE's 512) takes the wide kernel
  switch (p.dv_pad) {
    case 16:
    case 32: return by_depth<2, 4>(p, batch, s);
    case 48: return by_depth<2, 6>(p, batch, s);
    case 64: return by_depth<2, 8>(p, batch, s);
    case 80: return by_depth<2, 10>(p, batch, s);
    case 96:
    case 112:
    case 128: return by_depth<2, 16>(p, batch, s);
    case 144:
    case 160: return by_depth<1, 20>(p, batch, s);
    default: return launch_bf16_wide(p, batch, s);
  }
}

// ---------------------------------------------------------------------------
// fp32: exact FMAs on the CUDA cores, S/P/O in shared memory
// ---------------------------------------------------------------------------

// Shared-memory carve-up, used by the host (sizing) and the kernel (offsets).
// Odd row strides keep the lanes of a warp on distinct banks.
struct F32Layout {
  int ldq, ldv, lds, ldo;
  size_t q, k, v, s, o, stats, total;
};

__host__ __device__ inline F32Layout f32_layout(int bn, int bm, int dqk_pad,
                                                int dv_pad) {
  F32Layout L;
  L.ldq = dqk_pad + 1;
  L.ldv = dv_pad + 1;
  L.lds = bm + 1;
  L.ldo = dv_pad + 1;
  size_t off = 0;
  L.q = off; off = align128(off + static_cast<size_t>(bn) * L.ldq * 4);
  L.k = off; off = align128(off + static_cast<size_t>(bm) * L.ldq * 4);
  L.v = off; off = align128(off + static_cast<size_t>(bm) * L.ldv * 4);
  L.s = off; off = align128(off + static_cast<size_t>(bn) * L.lds * 4);
  L.o = off; off = align128(off + static_cast<size_t>(bn) * L.ldo * 4);
  L.stats = off; off = align128(off + static_cast<size_t>(bn) * 3 * 4);
  L.total = off;
  return L;
}

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void flash_f32_kernel(Params p, int bm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int bn = warps * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const F32Layout L = f32_layout(bn, bm, p.dqk_pad, p.dv_pad);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sK = reinterpret_cast<float*>(smem + L.k);
  float* sV = reinterpret_cast<float*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.stats);
  float* sL = sM + bn;
  float* sA = sL + bn;

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int row0 = blockIdx.x * bn;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = threadIdx.x; idx < bn * p.dqk_pad; idx += blockDim.x) {
    const int r = idx / p.dqk_pad, d = idx - r * p.dqk_pad;
    const int gr = row0 + r;
    sQ[r * L.ldq + d] = (gr < p.n && d < p.dqk) ? q[gr * p.q_sn + d] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < bn * p.dv_pad; idx += blockDim.x) {
    const int r = idx / p.dv_pad, d = idx - r * p.dv_pad;
    sO[r * L.ldo + d] = 0.0f;
  }
  for (int r = threadIdx.x; r < bn; r += blockDim.x) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }

  const float* sQw = sQ + warp * kRows * L.ldq;
  float* sSw = sS + warp * kRows * L.lds;
  float* sOw = sO + warp * kRows * L.ldo;

  for (int kv0 = 0; kv0 < p.m; kv0 += bm) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < bm * p.dqk_pad; idx += blockDim.x) {
      const int r = idx / p.dqk_pad, d = idx - r * p.dqk_pad;
      const int gr = kv0 + r;
      sK[r * L.ldq + d] = (gr < p.m && d < p.dqk) ? k[gr * p.k_sn + d] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < bm * p.dv_pad; idx += blockDim.x) {
      const int r = idx / p.dv_pad, d = idx - r * p.dv_pad;
      const int gr = kv0 + r;
      sV[r * L.ldv + d] = (gr < p.m && d < p.dv) ? v[gr * p.v_sn + d] : 0.0f;
    }
    __syncthreads();

    for (int idx = lane; idx < kRows * bm; idx += 32) {
      const int r = idx / bm, c = idx - r * bm;
      const float* qr = sQw + r * L.ldq;
      const float* kr = sK + c * L.ldq;
      float dot = 0.0f;
      for (int d = 0; d < p.dqk_pad; ++d) dot = fmaf(qr[d], kr[d], dot);
      sSw[r * L.lds + c] = dot;
    }
    __syncwarp();

    // online softmax, one row at a time across the warp
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      float* srow = sSw + r * L.lds;
      float mx = -INFINITY;
      for (int c = lane; c < bm; c += 32) {
        const float x = (kv0 + c < p.m) ? srow[c] * p.scale : -INFINITY;
        srow[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = sM[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < bm; c += 32) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[rr] = alpha;
        sL[rr] = sL[rr] * alpha + sum;
        sM[rr] = m_new;
      }
    }
    __syncwarp();

    for (int idx = lane; idx < kRows * p.dv_pad; idx += 32) {
      const int r = idx / p.dv_pad, c = idx - r * p.dv_pad;
      const float* pr = sSw + r * L.lds;
      float out = sOw[r * L.ldo + c] * sA[warp * kRows + r];
      for (int j = 0; j < bm; ++j) out = fmaf(pr[j], sV[j * L.ldv + c], out);
      sOw[r * L.ldo + c] = out;
    }
    __syncwarp();
  }

  for (int idx = lane; idx < kRows * p.dv; idx += 32) {
    const int r = idx / p.dv, d = idx - r * p.dv;
    const int gr = row0 + warp * kRows + r;
    if (gr < p.n) o[gr * p.o_sn + d] = sOw[r * L.ldo + d] / sL[warp * kRows + r];
  }
}

cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  // (warps per block, keys per tile), widest first; the first that fits wins
  static const int configs[][2] = {{4, 64}, {4, 32}, {2, 32}, {1, 32}, {1, 16}};
  static SmemGrant grant;
  int warps = 0, bm = 0;
  size_t smem = 0;
  for (const auto& c : configs) {
    const F32Layout L = f32_layout(c[0] * kRows, c[1], p.dqk_pad, p.dv_pad);
    if (L.total <= static_cast<size_t>(kMaxSmem)) {
      warps = c[0];
      bm = c[1];
      smem = L.total;
      break;
    }
  }
  if (warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = grant_smem(grant, flash_f32_kernel, smem);
  if (e != cudaSuccess) return e;
  const int bn = warps * kRows;
  const dim3 grid((p.n + bn - 1) / bn, batch * p.heads);
  flash_f32_kernel<<<grid, warps * 32, smem, stream>>>(p, bm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last axis
// of every tensor must be contiguous. Returns a cudaError_t (0 = success).
int ea_flash_attention(const void* q, const void* k, const void* v, void* o,
                       long long q_sb, long long q_sh, long long q_sn,
                       long long k_sb, long long k_sh, long long k_sn,
                       long long v_sb, long long v_sh, long long v_sn,
                       long long o_sb, long long o_sh, long long o_sn,
                       int batch, int heads, int n, int m, int dqk, int dv,
                       float scale, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || m <= 0 || dqk <= 0 || dv <= 0 ||
      batch * heads > 65535) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.heads = heads; p.n = n; p.m = m; p.dqk = dqk; p.dv = dv;
  p.dqk_pad = (dqk + 15) / 16 * 16;
  p.dv_pad = (dv + 15) / 16 * 16;
  p.scale = scale;
  // 16-byte row loads need every row start 16-byte aligned
  const long long strides[] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                               v_sb, v_sh, v_sn};
  bool vec = dqk % 8 == 0 && dv % 8 == 0 &&
             reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (long long s : strides) vec = vec && s % 8 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(dispatch_bf16(p, batch, s));
  if (dtype == 0) return static_cast<int>(launch_f32(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

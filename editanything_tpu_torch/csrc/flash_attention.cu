// Flash attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/flash_attention.py
// (_flash_kernel, :64; called through flash_attention, :114). It computes
// what that kernel computes: unmasked softmax(scale * q k^T) v over
// (B, H, N, Dqk) x (B, H, M, Dqk) x (B, H, M, Dv), with q/k allowed deeper
// than v, keys past M masked, products in the storage dtype (bf16 on the
// main path, P rounded to bf16 before P V; fp32 to within ~2^-21 of fp32
// products on the tensor cores), and the running max, sum and output
// accumulator in fp32.
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
// fp32 (every trainer's path: ControlNet, textual inversion and
// DreamBooth run fp32 with TF32 off, and their preprocessors' VAE encode
// takes the wide kernel). The tensor cores have no fp32 mode, so each
// product runs in 3xTF32: every operand is split at its fragment load into
// hi = cvt.rna.tf32(x) and lo = x - hi, and mma.sync m16n8k8 (fp32 sums)
// forms lo * hi + hi * lo + hi * hi, within ~2^-21 of each fp32 product.
// The tensor cores truncate their fp32 sums, so the narrow kernel sums
// each k8 step of S = Q K^T from zero and adds it to S in fp32 (rounded):
// at SAM's global attention (scale 1, |S| ~ 50) one running sum kept B
// 7.4-9.3e-5 from an fp64 reference, the step sums 2.1-2.6e-5, for 21 %
// more time at the training's 64x64 self-attention (PERF.md).
// Three tf32 passes make the tensor cores' bound 495 / 3 = 165 TFLOP/s;
// each operand's split costs two instructions at its load, so the issue
// slots bound it below that. Both products use one fragment pairing (see
// "The fragment layout" below): K and Q rows load their k8 pairs as one
// 8-byte load, and S's accumulator is P's A operand without a shuffle.
// Row strides of 8 (mod 16) floats for Q and K and 4 (mod 8) for V keep
// the fragment loads off bank conflicts.
//   Dv <= 160 (flash_f32_narrow_kernel): flash_bf16_kernel's structure, S,
// P and O in registers, K/V tiles through a cp.async ring, blocks of 1-4
// warps of 16 or 32 query rows each.
//   Dv > 160 (flash_f32_wide_kernel, the VAE's 512): S formed once per
// (64-row, 16-key) tile by 8 warps over quarters of the depth, P through
// shared memory, each warp 64 output columns (see the kernel's note).
//   Both take their launch plan from core/flash_attention.py
// (flash_f32_plan): where the (row tile, batch, head) blocks are fewer
// than the SMs, the keys are split into chunks over blockIdx.z, and the
// last block of each row tile to finish folds the chunks' partial (max,
// sum, O) into the output, inside the same launch.
//
// Not here yet: wgmma (asynchronous warpgroup products from shared
// memory), TMA loads and warp specialisation, which would take the
// fragment loads and the copies off the issue slots; the backward.
//
// Tensors are read through their (batch, head, row) strides, so the
// (B, N, H, D) projections need no transposed copy. Plain C interface for
// ctypes (no PyTorch headers): ea_flash_attention (bf16) and
// ea_flash_attention_f32 return the launch's cudaGetLastError(), 0 on
// success.

#include "common.cuh"

namespace {

using namespace ea;

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
// (cols_valid, src_ld and src are multiples of 16 bytes); else a
// synchronous element copy.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_ld, const T* src,
                                          long long src_ld, int rows,
                                          int rows_valid, int cols_pad,
                                          int cols_valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int chunks = cols_pad / V;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = idx / chunks, c = (idx - r * chunks) * V;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async16_zfill(dst + r * dst_ld + c, valid ? src + r * src_ld + c : src,
                       valid);
    }
  } else {   // 8 loads in flight per thread, then 8 stores
    constexpr int kBatch = 8;
    const int total = rows * cols_pad;
    for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
      T val[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * blockDim.x;
        const int r = idx / cols_pad, c = idx - r * cols_pad;
        val[u] = idx < total && r < rows_valid && c < cols_valid
                     ? __ldg(src + r * src_ld + c) : from_f<T>(0.0f);
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

// row[c], row[c + 1] = x0, x1 in T, both as one store where pairs (an even
// width: c is even, so the pair is aligned)
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int width, float x0,
                                           float x1, bool pairs) {
  if (pairs && c + 1 < width) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(x0, x1);
    } else {
      *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
    }
  } else {
    if (c < width) row[c] = from_f<T>(x0);
    if (c + 1 < width) row[c + 1] = from_f<T>(x1);
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
// fp32: 3xTF32 on the tensor cores, mma.sync m16n8k8 with fp32 sums
// ---------------------------------------------------------------------------

constexpr int kF32MaxSplits = 16;  // key chunks of one row tile (the plan's cap)
constexpr int kF32WideRows = 64;   // query rows per block (wide)
constexpr int kF32WideKeys = 16;   // keys per tile (wide)
constexpr int kF32WideWarps = 8;
constexpr int kF32WideCols = 64;   // output columns per warp (wide)
constexpr int kF32LdS = 24;        // row stride of S and P in shared memory (wide)

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  int heads, n, m, dqk, dv;
  int dqk8, dv8;     // depths rounded up to 8 (one k8 step)
  int ldq;           // row stride of the Q and K tiles, 8 (mod 16)
  int vec;           // 1: rows may be read as 16-byte vectors
  float scale;
  int chunk, splits; // keys per chunk, chunks (blockIdx.z)
  float* part;       // (splits, B*H, N, dv8): each chunk's unnormalised O
  float* stats;      // (splits, B*H, N, 2): its running max (log2) and sum
  int* counter;      // (B*H, row tiles): chunks of each row tile finished
};

// Row stride of a Q or K tile of depth d8 (a multiple of 8): 8 (mod 16)
// floats, so the 8-byte fragment loads of a half-warp (rows g = 0..3,
// pairs t = 0..3) fall on 16 distinct bank pairs.
__host__ __device__ inline int f32_ld(int d8) { return (d8 / 8) % 2 ? d8 : d8 + 8; }

// One fp32 operand as tf32 hi (rounded to nearest) and the remainder lo =
// x - hi (exact in fp32), passed whole: the tensor core reads its tf32 bits
// and ignores the low 13 (truncation), as CUTLASS's fast fp32 products let
// it. hi * hi + hi * lo + lo * hi misses only lo * lo and lo's truncation,
// each under 2^-22 of the product. (Rounding lo with a second cvt.rna cost
// 9-12 % of the kernel's time on an H100 and left its error against the
// plain twin where it was.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16n8k8 operand pair in 3xTF32: A's four registers, B's two, each as
// hi and lo.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a b in 3xTF32, the small products first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// c += a b in 3xTF32, the step's three products summed from zero and added
// to c in fp32
__device__ __forceinline__ void mma_3xtf32_add(float (&c)[4], const FragA& a,
                                               const FragB& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_3xtf32(t, a, b);
  c[0] += t[0];
  c[1] += t[1];
  c[2] += t[2];
  c[3] += t[3];
}

// The fragment layout. m16n8k8 tf32 gives lane (g = lane / 4, t = lane % 4)
// A's rows g and g + 8 at columns t and t + 4, B's columns (n) g at rows
// (k) t and t + 4, and C's rows g and g + 8 at columns 2t and 2t + 1. A
// product sums over k in any order, so every k8 step here pairs its
// logical k = t with element 2t and k = t + 4 with element 2t + 1 of its 8
// (depth or keys), on both operands alike. Then each row of A and of a K
// tile gives its pair in one 8-byte load, and S's accumulator (row g, keys
// 2t and 2t + 1) is already P's A fragment for O += P V: no shuffle.

// A from a row-major tile; p = tile + g * ld + k0 + 2t
__device__ __forceinline__ void load_a(FragA& a, const float* p, int ld) {
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  split_tf32(r0.x, a.hi[0], a.lo[0]);
  split_tf32(r1.x, a.hi[1], a.lo[1]);
  split_tf32(r0.y, a.hi[2], a.lo[2]);
  split_tf32(r1.y, a.hi[3], a.lo[3]);
}

// A from S's accumulator of one n8 tile (P, row g and g + 8, keys 2t, 2t + 1)
__device__ __forceinline__ void split_p(FragA& a, const float (&s)[4]) {
  split_tf32(s[0], a.hi[0], a.lo[0]);
  split_tf32(s[2], a.hi[1], a.lo[1]);
  split_tf32(s[1], a.hi[2], a.lo[2]);
  split_tf32(s[3], a.hi[3], a.lo[3]);
}

// B = K^T from a row-major K tile; p = tile + (n0 + g) * ld + k0 + 2t
__device__ __forceinline__ void load_b_rows(FragB& b, const float* p) {
  const float2 r = *reinterpret_cast<const float2*>(p);
  split_tf32(r.x, b.hi[0], b.lo[0]);
  split_tf32(r.y, b.hi[1], b.lo[1]);
}

// B = V from a row-major V tile (keys are rows); p = tile + (k0 + 2t) * ld
// + n0 + g. ld = 4 (mod 8) keeps the lanes on 32 distinct banks.
__device__ __forceinline__ void load_b_cols(FragB& b, const float* p, int ld) {
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[ld], b.hi[1], b.lo[1]);
}

// Where the keys are split over blockIdx.z: each block has written its
// chunk's unnormalised O and (max, sum) per row; the last block of the row
// tile to finish returns true (the others false), after which every
// chunk's partial is visible to it.
__device__ bool last_chunk(const F32Params& p, int tile) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.counter + tile, 1) == p.splits - 1;
  __syncthreads();
  if (last) __threadfence();
  return last != 0;
}

// Fold every chunk's partial of rows row0 .. row0 + rows - 1 (rows <= 128)
// into the output: O = sum_s 2^(m_s - m) O_s / sum_s 2^(m_s - m) l_s,
// m = max_s m_s. First a thread per row turns the chunks' (max, sum) into
// weights in shared memory (sw: (splits + 1) x rows floats, free by now),
// then each thread takes 4 columns of a row at a time, kCombineUnroll
// groups in flight, every chunk's partial read from L2 (__ldcg), never from
// L1's copy: the loads of a group do not wait on each other.
constexpr int kCombineUnroll = 4;

__device__ void combine_chunks(const F32Params& p, int bh, int row0, int rows,
                               float* o, float* sw) {
  const long long plane = static_cast<long long>(gridDim.y) * p.n;
  const long long first = static_cast<long long>(bh) * p.n + row0;
  const int nrows = min(rows, p.n - row0);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    float w[kF32MaxSplits], l[kF32MaxSplits];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kF32MaxSplits; ++s) {
      if (s < p.splits) {
        const float2 st = __ldcg(reinterpret_cast<const float2*>(
            p.stats + (s * plane + first + r) * 2));
        w[s] = st.x;
        l[s] = st.y;
        mx = fmaxf(mx, st.x);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kF32MaxSplits; ++s) {
      if (s < p.splits) {
        w[s] = fast_exp2(w[s] - mx);
        sum += w[s] * l[s];
      }
    }
    const float inv = 1.0f / sum;
#pragma unroll
    for (int s = 0; s < kF32MaxSplits; ++s)
      if (s < p.splits) sw[s * rows + r] = w[s] * inv;
  }
  __syncthreads();
  const int groups = (p.dv + 3) / 4;   // partial rows hold round8(dv) floats
  const int items = nrows * groups;
  const bool vec4 = p.dv % 4 == 0 && p.o_sn % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0;
  for (int base = threadIdx.x; base < items;
       base += kCombineUnroll * blockDim.x) {
    float4 x[kCombineUnroll];
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kF32MaxSplits; ++s) {
      if (s >= p.splits) break;
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        const int i = base + u * blockDim.x;
        if (i < items) {
          const int r = i / groups, c = (i - r * groups) * 4;
          const float wt = sw[s * rows + r];
          const float4 y = __ldcg(reinterpret_cast<const float4*>(
              p.part + (s * plane + first + r) * p.dv8 + c));
          x[u].x += wt * y.x;
          x[u].y += wt * y.y;
          x[u].z += wt * y.z;
          x[u].w += wt * y.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i >= items) continue;
      const int r = i / groups, c = (i - r * groups) * 4;
      float* orow = o + (row0 + r) * p.o_sn + c;
      if (vec4) {
        *reinterpret_cast<float4*>(orow) = x[u];
      } else {
        const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k < p.dv) orow[k] = e[k];
      }
    }
  }
}

// ---- narrow: Dv <= 160, S, P and O in registers --------------------------

// Shared memory of flash_f32_narrow_kernel: Q (rows x ldq), then the
// ring's stages (K tile, V tile each); used by the host (sizing) and the
// kernel (offsets).
template <int MT, int DVT, int KB, int STAGES>
struct F32Narrow {
  static constexpr int kLdv = DVT * 8 + 4;   // 4 (mod 8): see load_b_cols
  __host__ __device__ static size_t q_bytes(int warps, int ldq) {
    return align128(static_cast<size_t>(warps) * 16 * MT * ldq * 4);
  }
  __host__ __device__ static size_t k_bytes(int ldq) {
    return align128(static_cast<size_t>(KB) * ldq * 4);
  }
  __host__ __device__ static size_t stage_bytes(int ldq) {
    return k_bytes(ldq) + align128(static_cast<size_t>(KB) * kLdv * 4);
  }
  __host__ __device__ static size_t total(int warps, int ldq) {
    return q_bytes(warps, ldq) + STAGES * stage_bytes(ldq);
  }
};

// A block of blockDim.x / 32 warps (1, 2 or 4) owns warps * 16 * MT query
// rows of one (batch, head) and the key chunk blockIdx.z; K and V tiles of
// KB keys stream through a ring of STAGES cp.async stages. Per tile a warp
// forms S = Q K^T for its MT m16 tiles (Q's fragments from shared memory,
// each K fragment serving every m16 tile), runs the online softmax on the
// registers and adds P V into its DVT n8 tiles of O.
template <int MT, int DVT, int KB, int STAGES>
__global__ void __launch_bounds__(128)
flash_f32_narrow_kernel(F32Params p) {
  using L = F32Narrow<MT, DVT, KB, STAGES>;
  constexpr int kLdv = L::kLdv;
  constexpr int NT = KB / 8;      // n8 tiles of S per m16 tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int ldq = p.ldq;
  float* sQ = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + L::q_bytes(warps, ldq);
  const size_t stage_bytes = L::stage_bytes(ldq), k_bytes = L::k_bytes(ldq);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int rows = warps * 16 * MT;
  const int row0 = blockIdx.x * rows;
  const int k_begin = blockIdx.z * p.chunk;
  const int k_end = min(p.m, k_begin + p.chunk);
  const bool vec = p.vec != 0;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  const int ntiles = (k_end - k_begin + KB - 1) / KB;
  auto issue = [&](int tile) {   // K and V of one key tile into its stage
    unsigned char* st = ring + (tile % STAGES) * stage_bytes;
    const int kv0 = k_begin + tile * KB;
    load_tile(reinterpret_cast<float*>(st), ldq, k + kv0 * p.k_sn, p.k_sn, KB,
              k_end - kv0, p.dqk8, p.dqk, vec);
    load_tile(reinterpret_cast<float*>(st + k_bytes), kLdv, v + kv0 * p.v_sn,
              p.v_sn, KB, k_end - kv0, DVT * 8, p.dv, vec);
  };
  load_tile(sQ, ldq, q + row0 * p.q_sn, p.q_sn, rows, p.n - row0, p.dqk8,
            p.dqk, vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  float acc[MT][DVT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < DVT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
  float m_run[MT][2], l_run[MT][2];   // rows g and g + 8, log2 domain
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.0f;   // this thread's partial sums
  }
  const float scale_log2 = p.scale * kLog2e;
  const bool raw_max = scale_log2 > 0.0f;
  const float factor = raw_max ? scale_log2 : 1.0f;
  const float* qw = sQ + (warp * 16 * MT + g) * ldq + 2 * t;
  const int ksteps = p.dqk8 / 8;
  const bool active = row0 + warp * 16 * MT < p.n;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread
    __syncthreads();              // ... for all; tile j - 1 no longer read
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_async_commit();
    const float* sK =
        reinterpret_cast<const float*>(ring + (j % STAGES) * stage_bytes);
    const float* sV = reinterpret_cast<const float*>(
        ring + (j % STAGES) * stage_bytes + k_bytes);
    if (!active) continue;   // no row of this warp lies below N

    // S = Q K^T: MT x 16 rows x KB keys per warp
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
    const float* kp = sK + g * ldq + 2 * t;
    for (int ks = 0; ks < ksteps; ++ks) {
      FragA a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a(a[mt], qw + mt * 16 * ldq + ks * 8, ldq);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragB kb;
        load_b_rows(kb, kp + nt * 8 * ldq + ks * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32_add(s[mt][nt], a[mt], kb);
      }
    }

    // the online softmax on the registers, as flash_bf16_kernel's: the max
    // on the raw logits and the scale folded into one FFMA before each
    // exp2; only a chunk's last tile can be ragged
    if (!raw_max) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] *= scale_log2;
    }
    const int kv0 = k_begin + j * KB;
    if (kv0 + KB > k_end) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + nt * 8 + 2 * t + (e & 1) >= k_end) s[mt][nt][e] = -INFINITY;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[mt][nt][e]);
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
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fast_exp2(fmaf(s[mt][nt][e], factor, -m_run[mt][e / 2]));
          s[mt][nt][e] = pe;
          sum[e / 2] += pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[mt][r] = l_run[mt][r] * alpha[r] + sum[r];
#pragma unroll
      for (int nt = 0; nt < DVT; ++nt) {
        acc[mt][nt][0] *= alpha[0];
        acc[mt][nt][1] *= alpha[0];
        acc[mt][nt][2] *= alpha[1];
        acc[mt][nt][3] *= alpha[1];
      }
    }

    // O += P V, P's accumulator as the A operand (see the fragment layout)
    const float* vp = sV + 2 * t * kLdv + g;
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      FragA a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) split_p(a[mt], s[mt][kc]);
#pragma unroll
      for (int nt = 0; nt < DVT; ++nt) {
        FragB vb;
        load_b_cols(vb, vp + kc * 8 * kLdv + nt * 8, kLdv);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][nt], a[mt], vb);
      }
    }
  }
  cp_async_wait<0>();   // no copy may outlive the block

  const bool pairs = (p.dv & 1) == 0;
  const long long part_row0 =
      (static_cast<long long>(blockIdx.z) * gridDim.y + bh) * p.n;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[mt][r]);
      const int gr = row0 + warp * 16 * MT + mt * 16 + g + r * 8;
      if (gr >= p.n) continue;
      if (p.splits == 1) {
        const float inv = 1.0f / l;
        float* orow = o + gr * p.o_sn;
#pragma unroll
        for (int nt = 0; nt < DVT; ++nt)
          store_pair(orow, nt * 8 + 2 * t, p.dv, acc[mt][nt][2 * r] * inv,
                         acc[mt][nt][2 * r + 1] * inv, pairs);
      } else {
        float* prow = p.part + (part_row0 + gr) * p.dv8;
#pragma unroll
        for (int nt = 0; nt < DVT; ++nt)
          if (nt * 8 < p.dv8)
            *reinterpret_cast<float2*>(prow + nt * 8 + 2 * t) =
                make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        if (t == 0)
          *reinterpret_cast<float2*>(p.stats + (part_row0 + gr) * 2) =
              make_float2(m_run[mt][r], l);
      }
    }
  }
  if (p.splits > 1 && last_chunk(p, bh * gridDim.x + blockIdx.x))
    combine_chunks(p, bh, row0, rows, o, reinterpret_cast<float*>(ring));
}

// ---- wide: Dv > 160 (the VAE's 512), S formed once per tile ----------------

struct F32WideLayout {
  int ldv;
  size_t q, k, v, s, stats, total;
};

__host__ __device__ inline F32WideLayout f32_wide_layout(int ldq, int dv8) {
  F32WideLayout L;
  L.ldv = dv8 + 4;   // 4 (mod 8): see load_b_cols
  size_t off = 0;
  L.q = off; off = align128(off + static_cast<size_t>(kF32WideRows) * ldq * 4);
  L.k = off; off = align128(off + static_cast<size_t>(kF32WideKeys) * ldq * 4);
  L.v = off; off = align128(off + static_cast<size_t>(kF32WideKeys) * L.ldv * 4);
  L.s = off; off = align128(off + static_cast<size_t>(4) * kF32WideRows * kF32LdS * 4);
  L.stats = off; off = align128(off + static_cast<size_t>(kF32WideRows) * 3 * 4);
  L.total = off;
  return L;
}

// A block of 8 warps owns 64 query rows of one (batch, head) and the key
// chunk blockIdx.z, 16 keys a tile. S of a tile is formed once: warp w
// takes rows (w % 2) * 32 .. + 31 (two m16 tiles) over a quarter (w / 2)
// of the depth, so each Q and K fragment serves two products, and the four
// quarters are summed by the softmax pass (4 threads a row, 4 keys each),
// which writes P over the first quarter. Every warp then adds P V into its
// own 64 of the output columns (4 x 8 n8 tiles, 128 fp32 registers a
// thread). Q (133 KB at D = 512), one K tile and one V tile (33 KB each)
// fill the SM: V_j loads while S_j forms, K_{j+1} while the softmax and
// P_j V_j run.
__global__ void __launch_bounds__(kF32WideWarps * 32, 1)
flash_f32_wide_kernel(F32Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = p.ldq;
  const F32WideLayout L = f32_wide_layout(ldq, p.dv8);
  const int ldv = L.ldv;
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sK = reinterpret_cast<float*>(smem + L.k);
  float* sV = reinterpret_cast<float*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sAlpha = reinterpret_cast<float*>(smem + L.stats);
  float* sM = sAlpha + kF32WideRows;
  float* sL = sM + kF32WideRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int row0 = blockIdx.x * kF32WideRows;
  const int k_begin = blockIdx.z * p.chunk;
  const int k_end = min(p.m, k_begin + p.chunk);
  const bool vec = p.vec != 0;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  load_tile(sQ, ldq, q + row0 * p.q_sn, p.q_sn, kF32WideRows, p.n - row0,
            p.dqk8, p.dqk, vec);
  load_tile(sK, ldq, k + k_begin * p.k_sn, p.k_sn, kF32WideKeys,
            k_end - k_begin, p.dqk8, p.dqk, vec);
  cp_async_commit();

  // S: this warp's rows and depth quarter, and where its sums go
  const int rh = warp & 1, dq = warp >> 1;
  const int ksteps = p.dqk8 / 8;
  const int ks0 = dq * ksteps / 4, ks1 = (dq + 1) * ksteps / 4;
  const float* qa = sQ + (rh * 32 + g) * ldq + 2 * t;
  const float* kb = sK + g * ldq + 2 * t;
  float* sw = sS + (dq * kF32WideRows + rh * 32 + g) * kF32LdS + 2 * t;
  // the softmax pass: row sr, keys sc .. sc + 3
  const int sr = tid >> 2, sc = (tid & 3) * 4;
  float m_run = -INFINITY, l_run = 0.0f;   // of row sr, log2 domain
  const float scale_log2 = p.scale * kLog2e;
  // P V: this warp's output columns
  const int col0 = warp * kF32WideCols;
  const float* pa = sS + g * kF32LdS + 2 * t;
  const float* vb = sV + 2 * t * ldv + col0 + g;
  float acc[4][kF32WideCols / 8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kF32WideCols / 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

  const int ntiles = (k_end - k_begin + kF32WideKeys - 1) / kF32WideKeys;
  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = k_begin + j * kF32WideKeys;
    cp_async_wait<0>();   // K_j (and Q) landed for this thread
    __syncthreads();      // ... for all; P_{j-1} V_{j-1} done: sV, sS free
    load_tile(sV, ldv, v + kv0 * p.v_sn, p.v_sn, kF32WideKeys, k_end - kv0,
              p.dv8, p.dv, vec);
    cp_async_commit();

    // two accumulators per tile: hi * hi apart from the small products
    float big[2][2][4], small[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[mt][nt][e] = small[mt][nt][e] = 0.0f;
#pragma unroll 4
    for (int ks = ks0; ks < ks1; ++ks) {
      FragA a[2];
      FragB kf[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a(a[mt], qa + mt * 16 * ldq + ks * 8, ldq);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) load_b_rows(kf[nt], kb + nt * 8 * ldq + ks * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_tf32(small[mt][nt], a[mt].lo, kf[nt].hi[0], kf[nt].hi[1]);
          mma_tf32(small[mt][nt], a[mt].hi, kf[nt].lo[0], kf[nt].lo[1]);
          mma_tf32(big[mt][nt], a[mt].hi, kf[nt].hi[0], kf[nt].hi[1]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* d = sw + mt * 16 * kF32LdS + nt * 8;
        *reinterpret_cast<float2*>(d) =
            make_float2(big[mt][nt][0] + small[mt][nt][0],
                        big[mt][nt][1] + small[mt][nt][1]);
        *reinterpret_cast<float2*>(d + 8 * kF32LdS) =
            make_float2(big[mt][nt][2] + small[mt][nt][2],
                        big[mt][nt][3] + small[mt][nt][3]);
      }
    __syncthreads();      // S's quarters visible; K_j no longer read
    if (j + 1 < ntiles) {
      load_tile(sK, ldq, k + (kv0 + kF32WideKeys) * p.k_sn, p.k_sn,
                kF32WideKeys, k_end - kv0 - kF32WideKeys, p.dqk8, p.dqk, vec);
    }
    cp_async_commit();

    // online softmax of row sr, keys sc .. sc + 3: the four quarters summed
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          sS + (qd * kF32WideRows + sr) * kF32LdS + sc);
      x[0] += s4.x; x[1] += s4.y; x[2] += s4.z; x[3] += s4.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = kv0 + sc + e < k_end ? x[e] * scale_log2 : -INFINITY;
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
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
    l_run = l_run * alpha + sum;
    // P over the first quarter: only this thread read these four
    *reinterpret_cast<float4*>(sS + sr * kF32LdS + sc) =
        make_float4(x[0], x[1], x[2], x[3]);
    if ((tid & 3) == 0) sAlpha[sr] = alpha;
    cp_async_wait<1>();   // V_j landed (K_{j+1} may still be in flight)
    __syncthreads();      // P, the rescale factors and V_j visible

    if (col0 < p.dv8) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float a0 = sAlpha[mt * 16 + g], a1 = sAlpha[mt * 16 + g + 8];
#pragma unroll
        for (int nt = 0; nt < kF32WideCols / 8; ++nt) {
          acc[mt][nt][0] *= a0;
          acc[mt][nt][1] *= a0;
          acc[mt][nt][2] *= a1;
          acc[mt][nt][3] *= a1;
        }
      }
#pragma unroll
      for (int kc = 0; kc < kF32WideKeys / 8; ++kc) {
        FragA a[4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          load_a(a[mt], pa + mt * 16 * kF32LdS + kc * 8, kF32LdS);
#pragma unroll
        for (int nt = 0; nt < kF32WideCols / 8; ++nt) {
          if (col0 + nt * 8 < p.dv8) {
            FragB vf;
            load_b_cols(vf, vb + kc * 8 * ldv + nt * 8, ldv);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma_3xtf32(acc[mt][nt], a[mt], vf);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if ((tid & 3) == 0) {
    sM[sr] = m_run;
    sL[sr] = l_run;
  }
  __syncthreads();

  const bool pairs = (p.dv & 1) == 0;
  const long long part_row0 =
      (static_cast<long long>(blockIdx.z) * gridDim.y + bh) * p.n;
  if (col0 < p.dv8) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = mt * 16 + g + r * 8, gr = row0 + lr;
        if (gr >= p.n) continue;
        if (p.splits == 1) {
          const float inv = 1.0f / sL[lr];
          float* orow = o + gr * p.o_sn;
#pragma unroll
          for (int nt = 0; nt < kF32WideCols / 8; ++nt)
            store_pair(orow, col0 + nt * 8 + 2 * t, p.dv,
                           acc[mt][nt][2 * r] * inv, acc[mt][nt][2 * r + 1] * inv,
                           pairs);
        } else {
          float* prow = p.part + (part_row0 + gr) * p.dv8;
#pragma unroll
          for (int nt = 0; nt < kF32WideCols / 8; ++nt)
            if (col0 + nt * 8 < p.dv8)
              *reinterpret_cast<float2*>(prow + col0 + nt * 8 + 2 * t) =
                  make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        }
      }
    }
  }
  if (p.splits == 1) return;
  if (tid < kF32WideRows && row0 + tid < p.n)
    *reinterpret_cast<float2*>(p.stats + (part_row0 + row0 + tid) * 2) =
        make_float2(sM[tid], sL[tid]);
  if (last_chunk(p, bh * gridDim.x + blockIdx.x))
    combine_chunks(p, bh, row0, kF32WideRows, o, sS);
}

// ---- the plan's checks and launch ------------------------------------------

// What core/flash_attention.py::flash_f32_plan chose. The kernels run only
// the configurations instantiated below; any other plan is refused with
// cudaErrorInvalidValue, never run some other way.
struct F32Plan {
  int wide, mt, dvt, kb, stages, warps, smem;
};

template <int MT, int DVT, int KB, int STAGES>
cudaError_t launch_f32_narrow(const F32Params& p, const F32Plan& plan,
                              dim3 grid, cudaStream_t stream) {
  using L = F32Narrow<MT, DVT, KB, STAGES>;
  static SmemGrant grant;
  if (plan.mt != MT || plan.kb != KB || plan.stages != STAGES ||
      (plan.warps != 1 && plan.warps != 2 && plan.warps != 4) ||
      static_cast<size_t>(plan.smem) != L::total(plan.warps, p.ldq)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = grant_smem(
      grant, flash_f32_narrow_kernel<MT, DVT, KB, STAGES>, plan.smem, true);
  if (e != cudaSuccess) return e;
  flash_f32_narrow_kernel<MT, DVT, KB, STAGES>
      <<<grid, plan.warps * 32, plan.smem, stream>>>(p);
  return cudaGetLastError();
}

// (MT, KB, STAGES) by the n8 tiles of O: two m16 tiles a warp up to 96
// output columns, one above; 64-key tiles but 32 where two m16 tiles meet
// 80-96 columns (the registers of S and O); three stages up to 48 columns
cudaError_t dispatch_f32_narrow(const F32Params& p, const F32Plan& plan,
                                dim3 grid, cudaStream_t s) {
  switch (plan.dvt) {
    case 4: return launch_f32_narrow<2, 4, 64, 3>(p, plan, grid, s);
    case 5: return launch_f32_narrow<2, 5, 64, 3>(p, plan, grid, s);
    case 6: return launch_f32_narrow<2, 6, 64, 3>(p, plan, grid, s);
    case 8: return launch_f32_narrow<2, 8, 64, 2>(p, plan, grid, s);
    case 10: return launch_f32_narrow<2, 10, 32, 2>(p, plan, grid, s);
    case 12: return launch_f32_narrow<2, 12, 32, 2>(p, plan, grid, s);
    case 16: return launch_f32_narrow<1, 16, 64, 2>(p, plan, grid, s);
    case 20: return launch_f32_narrow<1, 20, 64, 2>(p, plan, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_f32_wide(const F32Params& p, const F32Plan& plan, dim3 grid,
                            cudaStream_t stream) {
  static SmemGrant grant;
  if (plan.mt != kF32WideRows / 16 || plan.kb != kF32WideKeys ||
      plan.stages != 1 || plan.warps != kF32WideWarps ||
      plan.dvt * 8 != p.dv8 ||
      static_cast<size_t>(plan.smem) != f32_wide_layout(p.ldq, p.dv8).total) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = grant_smem(grant, flash_f32_wide_kernel, plan.smem, true);
  if (e != cudaSuccess) return e;
  flash_f32_wide_kernel<<<grid, kF32WideWarps * 32, plan.smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 (dtype 1; fp32 takes ea_flash_attention_f32 and its plan).
// Strides are in elements; the last axis of every tensor must be
// contiguous. Returns a cudaError_t (0 = success).
int ea_flash_attention(const void* q, const void* k, const void* v, void* o,
                       long long q_sb, long long q_sh, long long q_sn,
                       long long k_sb, long long k_sh, long long k_sn,
                       long long v_sb, long long v_sh, long long v_sn,
                       long long o_sb, long long o_sh, long long o_sn,
                       int batch, int heads, int n, int m, int dqk, int dv,
                       float scale, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || m <= 0 || dqk <= 0 || dv <= 0 ||
      batch * heads > 65535 || dtype != 1) {
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
  return static_cast<int>(dispatch_bf16(p, batch, static_cast<cudaStream_t>(stream)));
}

// float32 through the plan of core/flash_attention.py::flash_f32_plan:
// wide (0 narrow, 1 wide), m16 tiles a warp (4 = 64 rows a block when
// wide), n8 tiles of O, keys a tile, ring stages, warps a block, keys a
// chunk, chunks, dynamic shared memory. With chunks > 1, part (splits *
// B*H * N * round8(dv) floats), stats (splits * B*H * N * 2 floats) and a
// zeroed counter (B*H * row tiles ints) are the kernel's scratch. Returns a
// cudaError_t: cudaErrorInvalidValue for a plan the kernels do not run.
int ea_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                           long long q_sb, long long q_sh, long long q_sn,
                           long long k_sb, long long k_sh, long long k_sn,
                           long long v_sb, long long v_sh, long long v_sn,
                           long long o_sb, long long o_sh, long long o_sn,
                           int batch, int heads, int n, int m, int dqk, int dv,
                           float scale, int wide, int mt, int dvt, int kb,
                           int stages, int warps, int chunk, int splits,
                           int smem, void* part, void* stats, void* counter,
                           void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || m <= 0 || dqk <= 0 || dv <= 0 ||
      dqk > 512 || dv > 512 || batch * heads > 65535 || splits < 1 ||
      splits > kF32MaxSplits || chunk < 1 ||
      static_cast<long long>(chunk) * (splits - 1) >= m ||
      static_cast<long long>(chunk) * splits < m || mt < 1 || warps < 1 ||
      smem <= 0 || smem > kMaxSmem ||
      (splits > 1 && (part == nullptr || stats == nullptr || counter == nullptr))) {
    return cudaErrorInvalidValue;
  }
  F32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.heads = heads; p.n = n; p.m = m; p.dqk = dqk; p.dv = dv;
  p.dqk8 = (dqk + 7) / 8 * 8;
  p.dv8 = (dv + 7) / 8 * 8;
  p.ldq = f32_ld(p.dqk8);
  p.scale = scale;
  p.chunk = chunk; p.splits = splits;
  p.part = static_cast<float*>(part);
  p.stats = static_cast<float*>(stats);
  p.counter = static_cast<int*>(counter);
  const long long strides[] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                               v_sb, v_sh, v_sn};
  bool vec = dqk % 4 == 0 && dv % 4 == 0 &&
             reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (long long s : strides) vec = vec && s % 4 == 0;
  p.vec = vec ? 1 : 0;
  const F32Plan plan{wide, mt, dvt, kb, stages, warps, smem};
  const int rows = wide ? kF32WideRows : warps * 16 * mt;
  const dim3 grid((n + rows - 1) / rows, batch * heads, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return static_cast<int>(launch_f32_wide(p, plan, grid, s));
  if (dvt * 8 < p.dv8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_f32_narrow(p, plan, grid, s));
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

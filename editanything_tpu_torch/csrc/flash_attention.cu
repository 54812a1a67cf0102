// Flash attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel editanything_tpu/core/flash_attention.py
// (_flash_kernel, :64; called through flash_attention, :114). It computes
// what that kernel computes: unmasked softmax(scale * q k^T) v over
// (B, H, N, Dqk) x (B, H, M, Dqk) x (B, H, M, Dv), with q/k allowed deeper
// than v, keys past M masked, products in the storage dtype (bf16 on the
// main path) and the running max, sum and output accumulator in fp32.
//
// What bounds it on this card: at the UNet's 64x64 latents (N = M = 4096,
// D = 40..160) attention does about 2 (Dqk + Dv) flops per (query, key)
// pair against a few bytes, so it is bound by the tensor cores and by the
// instructions around them (softmax, fragment traffic), not by memory.
//
// bf16 design (flash_bf16_kernel, FlashAttention-2 style). One block of 4
// warps per (64 query rows, b*h, chunk of output columns); each warp owns
// 16 query rows. The block loops over 64-key tiles of K and V staged in
// shared memory (16-byte loads where the layout allows). Per tile, a warp
// forms S = Q K^T with mma.sync m16n8k16 (fp32 accumulate) in registers,
// runs the online softmax on its registers (row max and sum across the 4
// threads that share a row, exp2 with the scale folded in), rescales its
// fp32 output accumulator, and feeds P (rounded to bf16, as the TPU kernel
// does) straight back as the A operand of O += P V, with V's B fragments
// read by ldmatrix.trans. The output accumulator stays in registers, so its
// width is a template parameter: Dv <= 160 runs in one chunk, wider Dv (the
// VAE's single 512-deep head) is split over gridDim.z in 128-column chunks
// that each recompute S. Depths are zero-padded to 16 in shared memory
// (D = 40 -> 48); rows and keys past N and M are zero-filled and masked.
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

constexpr int kRows = 16;          // query rows per warp
constexpr int kWarps = 4;          // warps per block
constexpr int kBlockN = kRows * kWarps;
constexpr int kBlockM = 64;        // keys per tile
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
// bf16: mma.sync m16n8k16 (common.cuh), everything but the K/V/Q tiles in
// registers
// ---------------------------------------------------------------------------

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x cols tile from global (row stride src_ld) into shared (row stride
// dst_ld), zero-filled past rows_valid / cols_valid up to cols_pad.
__device__ inline void load_tile(__nv_bfloat16* dst, int dst_ld,
                                 const __nv_bfloat16* src, long long src_ld,
                                 int rows, int rows_valid, int cols_pad,
                                 int cols_valid, bool vec) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  if (vec) {  // cols_valid, src_ld and src are multiples of 8 elements
    const int chunks = cols_pad / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows_valid && c < cols_valid) {
        val = *reinterpret_cast<const uint4*>(src + r * src_ld + c);
      }
      *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols_pad; idx += blockDim.x) {
      const int r = idx / cols_pad, c = idx - r * cols_pad;
      dst[r * dst_ld + c] =
          (r < rows_valid && c < cols_valid) ? src[r * src_ld + c] : zero;
    }
  }
}

template <int DVT>  // output columns per block = DVT * 8
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = p.dqk_pad + 8;          // +8: spreads rows over banks
  constexpr int kLdv = DVT * 8 + 8;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(
      smem + align128(static_cast<size_t>(kBlockN) * ldq * 2));
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(sK) +
      align128(static_cast<size_t>(kBlockM) * ldq * 2));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment row / column pair
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int row0 = blockIdx.x * kBlockN;
  const int dv0 = blockIdx.z * DVT * 8;
  const int dv_here = min(DVT * 8, p.dv - dv0);
  const bool vec = p.vec != 0;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh + dv0;
  __nv_bfloat16* o =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + dv0;

  load_tile(sQ, ldq, q + row0 * p.q_sn, p.q_sn, kBlockN, p.n - row0,
            p.dqk_pad, p.dqk, vec);

  float acc[DVT][4];
#pragma unroll
  for (int t = 0; t < DVT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.0f, 0.0f};            // this thread's partial sums
  const float scale_log2 = p.scale * kLog2e;
  const __nv_bfloat16* qw = sQ + warp * kRows * ldq;

  for (int kv0 = 0; kv0 < p.m; kv0 += kBlockM) {
    __syncthreads();  // the previous tile is no longer read
    load_tile(sK, ldq, k + kv0 * p.k_sn, p.k_sn, kBlockM, p.m - kv0,
              p.dqk_pad, p.dqk, vec);
    load_tile(sV, kLdv, v + kv0 * p.v_sn, p.v_sn, kBlockM, p.m - kv0,
              DVT * 8, dv_here, vec);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[kBlockM / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockM / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
    for (int kk = 0; kk < p.dqk_pad; kk += 16) {
      uint32_t a[4];
      a[0] = lds32(qw + g * ldq + kk + tig * 2);
      a[1] = lds32(qw + (g + 8) * ldq + kk + tig * 2);
      a[2] = lds32(qw + g * ldq + kk + 8 + tig * 2);
      a[3] = lds32(qw + (g + 8) * ldq + kk + 8 + tig * 2);
#pragma unroll
      for (int t = 0; t < kBlockM / 8; ++t) {
        const __nv_bfloat16* kr = sK + (t * 8 + g) * ldq + kk + tig * 2;
        mma_bf16(s[t], a, lds32(kr), lds32(kr + 8));
      }
    }

    // online softmax on the registers; thread holds rows g (s[.][0..1]) and
    // g + 8 (s[.][2..3]), columns t * 8 + tig * 2 + {0, 1}
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < kBlockM / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + t * 8 + tig * 2 + (e & 1);
        const float x = col < p.m ? s[t][e] * scale_log2 : -INFINITY;
        s[t][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < kBlockM / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[t][e] - m_run[e / 2]);
        s[t][e] = pe;
        sum[e / 2] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int t = 0; t < DVT; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    // O += P V; P's C fragments are the A fragments of the next product
#pragma unroll
    for (int kc = 0; kc < kBlockM / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vrow = sV + (kc * 16 + (lane & 15)) * kLdv;
#pragma unroll
      for (int t = 0; t < DVT; ++t) {
        uint32_t b0, b1;
        const uint32_t addr =
            static_cast<uint32_t>(__cvta_generic_to_shared(vrow + t * 8));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b0), "=r"(b1) : "r"(addr));
        mma_bf16(acc[t], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + warp * kRows + g + r * 8;
    if (gr >= p.n) continue;
    const float inv = 1.0f / l_run[r];
    __nv_bfloat16* orow = o + gr * p.o_sn;
#pragma unroll
    for (int t = 0; t < DVT; ++t) {
      const int c = t * 8 + tig * 2;
      if (c < dv_here) orow[c] = __float2bfloat16(acc[t][2 * r] * inv);
      if (c + 1 < dv_here) orow[c + 1] = __float2bfloat16(acc[t][2 * r + 1] * inv);
    }
  }
}

size_t bf16_smem(int dqk_pad, int dvt) {
  return align128(static_cast<size_t>(kBlockN) * (dqk_pad + 8) * 2) +
         align128(static_cast<size_t>(kBlockM) * (dqk_pad + 8) * 2) +
         align128(static_cast<size_t>(kBlockM) * (dvt * 8 + 8) * 2);
}

template <int DVT>
cudaError_t launch_bf16(const Params& p, int batch, int chunks,
                        cudaStream_t stream) {
  static int smem_attr = 0;  // largest dynamic shared memory granted so far
  const size_t smem = bf16_smem(p.dqk_pad, DVT);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (static_cast<int>(smem) > smem_attr) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_attr = static_cast<int>(smem);
  }
  const dim3 grid((p.n + kBlockN - 1) / kBlockN, batch * p.heads, chunks);
  flash_bf16_kernel<DVT><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& p, int batch, cudaStream_t s) {
  // output width per block: the smallest instantiated one that holds dv,
  // else chunks of 128 columns
  switch (p.dv_pad) {
    case 16: return launch_bf16<2>(p, batch, 1, s);
    case 32: return launch_bf16<4>(p, batch, 1, s);
    case 48: return launch_bf16<6>(p, batch, 1, s);
    case 64: return launch_bf16<8>(p, batch, 1, s);
    case 80: return launch_bf16<10>(p, batch, 1, s);
    case 96: return launch_bf16<12>(p, batch, 1, s);
    case 112:
    case 128: return launch_bf16<16>(p, batch, 1, s);
    case 144:
    case 160: return launch_bf16<20>(p, batch, 1, s);
    default: return launch_bf16<16>(p, batch, (p.dv_pad + 127) / 128, s);
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
  static int smem_attr = 0;
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
  if (static_cast<int>(smem) > smem_attr) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_attr = static_cast<int>(smem);
  }
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

// GroupNorm(+SiLU) for Hopper (sm_90a), forward only (kernel A).
//
// Replaces the Pallas TPU kernel editanything_tpu/core/kernels.py
// (_gn_silu_kernel, :37; _gn_silu_pallas, :121; group_norm_silu, :825):
// over NCHW, fp32 statistics per (image, group), then the per-channel
// affine and an optional SiLU, stored once in the input dtype. The TPU
// kernel keeps a whole image in VMEM and reads device memory once.
//
// What bounds it on this card: a few operations per element and no tensor
// cores, so device memory: one read and one write of the activation at
// 3.35 TB/s. The SD edit makes 3500 calls a request, and 1800 of them move
// under 5 MB (8x8, 16x16 and 32x32 UNet levels), where the time is launch
// latency; the largest (the VAE decoder at 512^2) moves 512 MiB.
//
// Design: one launch per call, the activation read from device memory once
// (all of it at every UNet/ControlNet shape). In NCHW each (image, group)
// slab is contiguous; a thread-block cluster of k CTAs owns it, each CTA a
// contiguous share of whole 16-byte vectors. Each CTA copies its share
// into shared memory with cp.async, in four groups, and forms fp32 (count,
// mean, M2) of each group as it lands (per-thread shifted sums, merged by
// Chan's formula across the block); the k CTAs merge their statistics over
// distributed shared memory (map_shared_rank, cluster.sync), every CTA in
// the same order, then normalise, apply the affine and SiLU from shared
// memory and store with 16-byte streaming stores. The (scale, bias) of the
// channels a share touches are loaded into a small table while the data
// is in flight. Clusters cost ~1.3 us a rank on an H100 (launch and
// barrier), so k is as small as the shapes allow: where one CTA per slab
// already gives ~one CTA per SM (every UNet/ControlNet call, 128 slabs),
// the smallest k whose share fits in 200 KB ("single" everywhere but the
// 240 KB slabs of 64x64x960, a cluster of 2); on the VAE's 32 or 64 slabs
// the smallest k that gives 128 CTAs and shares of at most 64 KB, up to
// the non-portable 16 (the 1 MB and 2 MB slabs: 64 and 128 KB shares),
// which pays for its clusters with more CTAs per SM. A slab
// that 16 CTAs cannot hold (the VAE decoder's (2, 256, 512, 512) bf16, 4 MB
// slabs, 256 KB shares, and the fp32 VAE shapes) is "streamed": each CTA
// holds the first 200 KB of its share on chip as above and streams the
// rest twice in the same launch, for the statistics (while its cp.async
// copies are in flight) and to apply them, the second read from L2: the
// co-resident CTAs' tails (one CTA per SM, 56 KB each in bf16) stay far
// inside the 50 MB L2.
// The plan (path, k, CTAs, bytes held) is computed by the caller
// (editanything_tpu_torch/core/kernels.py::group_norm_plan) and checked
// here. Vectors are 16 bytes where H*W is a multiple of the vector and the
// pointers are aligned; otherwise single elements (ragged shapes such as
// 7x9), with the same plan. Scale and bias may be fp32, bf16 or fp16.
//
// NHWC (channels-last, the half-precision SD models' layout, so that
// cuDNN's NHWC conv kernels need no transposes): a group is then a run of
// C / groups channels in every pixel, C apart, 20 bytes at the UNet's
// 320 channels. Two paths, both one launch, reading once where the data
// fits on chip and writing once. gn_nhwc_kernel keeps the (image, group)
// slab of the NCHW kernel, read as runs of 8-byte (or 4-byte) packs, one
// CTA or a cluster of 2 a slab: at the UNet's 8x8-32x32 levels within
// 0.94-1.55x of the NCHW kernel (PERF.md). Where the runs are too short or
// the activation too large for that (64x64 at 320 channels, every VAE
// shape of 16 MB or more), gn_grid_kernel takes each image's pixels in
// ranges across all channels, contiguous memory, one co-resident CTA per
// SM, and merges the groups' statistics through device memory at a
// grid-wide sync. A thread of either keeps the same pack of channels in
// every pixel it visits, so its (scale, bias) are loaded once, while the
// data is in flight, and applied with no channel arithmetic.
//
// Plain C interface for ctypes: ea_group_norm_silu (NCHW),
// ea_group_norm_silu_nhwc and ea_group_norm_silu_nhwc_grid return
// cudaGetLastError(), 0 on success.

#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_fp16.h>

namespace cg = cooperative_groups;

namespace {

using namespace ea;

constexpr int kThreads = 512;     // the most; 256 where a CTA holds < 64 KB
constexpr int kMaxTable = 4096;   // channels a table may hold
constexpr int kChunks = 4;        // cp.async groups of a share
constexpr int kUnroll = 4;        // 16-byte loads in flight per thread, streamed
constexpr int kMaxCluster = 16;

struct Params {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  long long slab;    // elements per (image, group), < 2^31
  int hw, cpg, groups, n_slabs, k;
  float inv_hw;      // 1 / hw, for the channel of an element
  int held;          // vectors of a share held in shared memory
  int table;         // channels in the shared-memory table (0: none)
  int table_offset;  // its byte offset in dynamic shared memory
  int wdtype, bdtype;
  float eps;
  int silu;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16
__device__ __forceinline__ float load_param(const void* p, int dtype, int i) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const Pack<T, V>* p, bool streaming) {
  if constexpr (sizeof(Pack<T, V>) == 16) {
    uint4 u = streaming ? __ldcs(reinterpret_cast<const uint4*>(p))
                        : __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<Pack<T, V>*>(&u);
  } else {
    return *p;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(Pack<T, V>* p, const Pack<T, V>& v) {
  if constexpr (sizeof(Pack<T, V>) == 16) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
  } else {
    *p = v;
  }
}

// (count, mean, M2) of a set of values
struct Stats {
  float n, mean, m2;
};

// Chan et al.'s pairwise merge (the weight by the fast reciprocal: it
// lies on every call's critical path)
__device__ __forceinline__ Stats chan(Stats a, Stats b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, f = __fdividef(b.n, n);
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ Stats shfl_down(Stats s, int m) {
  return {__shfl_down_sync(0xffffffffu, s.n, m),
          __shfl_down_sync(0xffffffffu, s.mean, m),
          __shfl_down_sync(0xffffffffu, s.m2, m)};
}

// lane 0 gets the merge of the first `width` lanes' stats (a power of two
// up to 32), in a fixed order
__device__ __forceinline__ Stats warp_merge(Stats s, int width = 32) {
  for (int m = width / 2; m > 0; m >>= 1) s = chan(s, shfl_down(s, m));
  return s;
}

// one thread's sums of (x - shift) and (x - shift)^2, the shift being the
// first value it saw: no cancellation of E[x^2] - E[x]^2 where the mean is
// far from 0; two partial sums each, for shorter dependency chains
struct Acc {
  float shift = 0.0f, s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f}, n = 0.0f;

  template <typename T, int V>
  __device__ __forceinline__ void add(const Pack<T, V>& p) {
    if (n == 0.0f) shift = to_float(p.v[0]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = to_float(p.v[e]) - shift;
      s1[e & 1] += d;
      s2[e & 1] = fmaf(d, d, s2[e & 1]);
    }
    n += V;
  }

  __device__ __forceinline__ Stats stats() const {
    if (n == 0.0f) return {0.0f, 0.0f, 0.0f};
    const float t1 = s1[0] + s1[1], m = t1 / n;
    return {n, shift + m, fmaxf(s2[0] + s2[1] - t1 * m, 0.0f)};
  }
};

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// v * sigmoid(v) with one special-function op (the exponential): 1 / (1 +
// e^-v) by Newton's method from an integer-trick seed (relative error
// below 1e-7 after three steps), so the SFU is not the limit at the memory
// rate; v is clamped at -80, where SiLU is 0 in fp32 all the same
__device__ __forceinline__ float silu(float v) {
  const float d = 1.0f + ex2_approx(fmaxf(v, -80.0f) * -1.4426950408889634f);
  float r = __int_as_float(0x7EF311C7 - __float_as_int(d));
#pragma unroll
  for (int it = 0; it < 3; ++it) r = fmaf(r, fmaf(-d, r, 1.0f), r);
  return v * r;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> normalise(const Pack<T, V>& in, float a,
                                                float c, bool apply_silu) {
  Pack<T, V> out;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float v = fmaf(to_float(in.v[e]), a, c);
    if (apply_silu) v = silu(v);
    out.v[e] = from_float<T>(v);
  }
  return out;
}

// One launch, a cluster of p.k CTAs per slab. A CTA holds the first
// min(share, p.held) vectors of its share in dynamic shared memory,
// followed by the table of (scale, bias) of the p.table channels the share
// touches (0: read them from global memory per vector); the rest of the
// share, if any, is read twice from global memory.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gn_kernel(Params p) {
  using P = Pack<T, V>;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Stats red[kWarps];
  __shared__ Stats cta_stats;      // this CTA's, read by the cluster
  __shared__ float2 norm;          // (mean, rstd) of the slab

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = blockDim.x, nwarps = nt / 32;
  const int k = p.k;
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / k;    // the slab
  const int nv = static_cast<int>(p.slab / V);
  const int v0 = static_cast<int>(static_cast<long long>(nv) * rank / k);
  const int cnt = static_cast<int>(static_cast<long long>(nv) * (rank + 1) / k) - v0;
  const int held = min(cnt, p.held);
  const int e0 = v0 * V;
  const int cl0 = e0 / p.hw;       // the share's first channel in the slab
  const int c0 = s % p.groups * p.cpg;
  const P* src = reinterpret_cast<const P*>(static_cast<const T*>(p.x) + s * p.slab) + v0;
  P* dst = reinterpret_cast<P*>(static_cast<T*>(p.y) + s * p.slab) + v0;
  P* sdata = reinterpret_cast<P*>(smem);
  float2* table = reinterpret_cast<float2*>(smem + p.table_offset);

  // the held part: this thread's vectors are tid + j * nt, j < J; it reads
  // back only what it copied, so each group is usable after its own wait
  const int J = tid < held ? (held - 1 - tid) / nt + 1 : 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    for (int j = J * c / kChunks; j < J * (c + 1) / kChunks; ++j) {
      const int i = tid + j * nt;
      if constexpr (sizeof(P) == 16) {
        cp_async16(sdata + i, src + i);
      } else {
        sdata[i] = src[i];
      }
    }
    cp_async_commit();
  }
  for (int i = tid; i < p.table && cl0 + i < p.cpg; i += nt) {
    table[i] = make_float2(load_param(p.w, p.wdtype, c0 + cl0 + i),
                           load_param(p.b, p.bdtype, c0 + cl0 + i));
  }
  Acc acc;
  // the streamed part, while the copies are in flight
  for (int i0 = held + tid; i0 < cnt; i0 += nt * kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < cnt) v[u] = load_pack(src + i, false);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * nt < cnt) acc.add(v[u]);
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    switch (c) {
      case 0: cp_async_wait<kChunks - 1>(); break;
      case 1: cp_async_wait<kChunks - 2>(); break;
      case 2: cp_async_wait<kChunks - 3>(); break;
      default: cp_async_wait<0>(); break;
    }
    for (int j = J * c / kChunks; j < J * (c + 1) / kChunks; ++j) {
      acc.add(sdata[tid + j * nt]);
    }
  }

  // the CTA's statistics, then the cluster's: every CTA merges the k ranks
  // in the same order, so all normalise with the same numbers
  Stats st = warp_merge(acc.stats());
  if (lane == 0) red[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = warp_merge(lane < nwarps ? red[lane] : Stats{0.0f, 0.0f, 0.0f}, nwarps);
    if (k == 1 && lane == 0) {
      norm = make_float2(st.mean, rsqrtf(st.m2 / st.n + p.eps));
    } else if (lane == 0) {
      cta_stats = st;
    }
  }
  if (k > 1) {
    cluster.sync();
    if (warp == 0) {
      Stats r{0.0f, 0.0f, 0.0f};
      if (lane < k) r = *cluster.map_shared_rank(&cta_stats, lane);
      r = warp_merge(r, k);
      if (lane == 0) norm = make_float2(r.mean, rsqrtf(r.m2 / r.n + p.eps));
    }
  }
  __syncthreads();
  const float mean = norm.x, rstd = norm.y;
  const bool silu_on = p.silu != 0;

  auto apply = [&](int i, const P& in) {
    // the vector's channel in the slab: o / hw in 32 bits (o < 2^31),
    // rounded through fp32 and corrected by one either way
    const int o = e0 + i * V;
    int cl = __float2int_rz(static_cast<float>(o) * p.inv_hw);
    cl -= cl * p.hw > o;
    cl += (cl + 1) * p.hw <= o;
    const float2 wb = p.table
        ? table[cl - cl0]
        : make_float2(load_param(p.w, p.wdtype, c0 + cl),
                      load_param(p.b, p.bdtype, c0 + cl));
    const float a = wb.x * rstd;
    store_pack(dst + i, normalise(in, a, fmaf(-mean, a, wb.y), silu_on));
  };
#pragma unroll 4
  for (int i = tid; i < held; i += nt) apply(i, sdata[i]);
  for (int i0 = held + tid; i0 < cnt; i0 += nt * kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < cnt) v[u] = load_pack(src + i, true);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < cnt) apply(i, v[u]);
    }
  }
  if (k > 1) cluster.sync();   // no CTA leaves while another may read its statistics
}

// ---------------------------------------------------------------------------
// NHWC (channels-last): a pixel's C channels are contiguous, so a group is
// a strided run of C / groups channels in every pixel. The slab is again
// an (image, group): hw rows of cpg channels, one row per pixel, rows C
// apart, read in packs of V elements (8 bytes, else 4 or one element: the
// widest the run is a whole number of, chosen by the caller). k CTAs (a
// cluster, k <= 2) own a slab, each a contiguous range of its rows. A
// CTA's threads are laid out as (rows, r = cpg / V packs): a thread keeps
// the same pack of the run in every row it visits, so its channels and
// their (scale, bias) never change, and once the statistics are known it
// applies y = x a + c per element with no channel arithmetic. The
// held/streamed split, the cp.async groups, the statistics, the cluster
// merge and the stores are the NCHW kernel's.
// ---------------------------------------------------------------------------

struct NhwcParams {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  long long hw;      // rows of a slab: the pixels of an image
  long long c;       // a row's stride in elements: the channels
  int cpg;           // channels per group: a row's width
  int r;             // packs per row (cpg / V)
  int groups, n_slabs, k;
  int held;          // packs of a share held in shared memory
  int wdtype, bdtype;
  float eps;
  int silu;
};

// cp.async of one pack: 16 bytes through L2 only, 4 or 8 bytes through L1
template <int B>
__device__ __forceinline__ void cp_async_pack(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(B));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gn_nhwc_kernel(NhwcParams p) {
  using P = Pack<T, V>;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Stats red[kWarps];
  __shared__ Stats cta_stats;      // this CTA's, read by the cluster
  __shared__ float2 norm;          // (mean, rstd) of the slab

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = blockDim.x, nwarps = nt / 32;
  const int k = p.k, R = p.r;
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / k;    // the slab
  const int img = s / p.groups, grp = s % p.groups;
  const long long r0 = p.hw * rank / k;
  const int rows = static_cast<int>(p.hw * (rank + 1) / k - r0);
  const int tr = nt / R;           // rows a pass of the CTA covers
  const int active = tr * R;       // threads that move data
  const bool on = tid < active;
  const int col = on ? tid % R : 0;
  const int cnt = rows * R;        // packs of the share
  const int held = min(cnt, p.held);
  // this thread's packs are i = tid + j * active of the share: row r0 +
  // tid / R + j * tr, pack col of the group's run in that row
  const long long step = tr * p.c / V;
  const long long first =
      ((img * p.hw + r0 + (on ? tid / R : 0)) * p.c + static_cast<long long>(grp) * p.cpg) / V +
      col;
  const P* src = reinterpret_cast<const P*>(p.x) + first;
  P* dst = reinterpret_cast<P*>(p.y) + first;
  P* sdata = reinterpret_cast<P*>(smem);
  const int jh = on && tid < held ? (held - 1 - tid) / active + 1 : 0;
  const int jc = on && tid < cnt ? (cnt - 1 - tid) / active + 1 : 0;

#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    for (int j = jh * ch / kChunks; j < jh * (ch + 1) / kChunks; ++j) {
      if constexpr (sizeof(P) >= 4) {
        cp_async_pack<sizeof(P)>(sdata + tid + j * active, src + j * step);
      } else {
        sdata[tid + j * active] = src[j * step];
      }
    }
    cp_async_commit();
  }
  // the (scale, bias) of the thread's channels, while the data is in flight
  float a[V], c[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a[e] = load_param(p.w, p.wdtype, grp * p.cpg + col * V + e);
    c[e] = load_param(p.b, p.bdtype, grp * p.cpg + col * V + e);
  }
  Acc acc;
  for (int j0 = jh; j0 < jc; j0 += kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < jc) v[u] = load_pack(src + (j0 + u) * step, false);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < jc) acc.add(v[u]);
    }
  }
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    switch (ch) {
      case 0: cp_async_wait<kChunks - 1>(); break;
      case 1: cp_async_wait<kChunks - 2>(); break;
      case 2: cp_async_wait<kChunks - 3>(); break;
      default: cp_async_wait<0>(); break;
    }
    for (int j = jh * ch / kChunks; j < jh * (ch + 1) / kChunks; ++j) {
      acc.add(sdata[tid + j * active]);
    }
  }

  // the CTA's statistics, then the cluster's, as gn_kernel merges them
  Stats st = warp_merge(acc.stats());
  if (lane == 0) red[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = warp_merge(lane < nwarps ? red[lane] : Stats{0.0f, 0.0f, 0.0f}, nwarps);
    if (k == 1 && lane == 0) {
      norm = make_float2(st.mean, rsqrtf(st.m2 / st.n + p.eps));
    } else if (lane == 0) {
      cta_stats = st;
    }
  }
  if (k > 1) {
    cluster.sync();
    if (warp == 0) {
      Stats r{0.0f, 0.0f, 0.0f};
      if (lane < k) r = *cluster.map_shared_rank(&cta_stats, lane);
      r = warp_merge(r, k);
      if (lane == 0) norm = make_float2(r.mean, rsqrtf(r.m2 / r.n + p.eps));
    }
  }
  __syncthreads();

  if (jc > 0) {
    // y = x a + c per element: the affine folded into the statistics once
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a[e] *= norm.y;
      c[e] = fmaf(-norm.x, a[e], c[e]);
    }
    const bool silu_on = p.silu != 0;
    auto apply = [&](const P& in) {
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = fmaf(to_float(in.v[e]), a[e], c[e]);
        if (silu_on) v = silu(v);
        out.v[e] = from_float<T>(v);
      }
      return out;
    };
#pragma unroll 4
    for (int j = 0; j < jh; ++j) store_pack(dst + j * step, apply(sdata[tid + j * active]));
    for (int j0 = jh; j0 < jc; j0 += kUnroll) {
      P v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u < jc) v[u] = load_pack(src + (j0 + u) * step, true);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u < jc) store_pack(dst + (j0 + u) * step, apply(v[u]));
      }
    }
  }
  if (k > 1) cluster.sync();   // no CTA leaves while another may read its statistics
}

// one thread's shifted sums for the two groups its 16-byte vector can
// touch (the grid kernel's): elements [0, split) fall in the first,
// [split, V) in the second
struct Acc2 {
  float shift[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  int n = 0;   // vectors

  template <typename T, int V>
  __device__ __forceinline__ void add(const Pack<T, V>& p, int split) {
    if (n == 0) {
      shift[0] = to_float(p.v[0]);
      shift[1] = to_float(p.v[V - 1]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x = to_float(p.v[e]);
      if (e < split) {
        const float d = x - shift[0];
        s1[0] += d;
        s2[0] = fmaf(d, d, s2[0]);
      } else {
        const float d = x - shift[1];
        s1[1] += d;
        s2[1] = fmaf(d, d, s2[1]);
      }
    }
    ++n;
  }

  __device__ __forceinline__ Stats stats(int g, float count) const {
    if (count == 0.0f) return {0.0f, 0.0f, 0.0f};
    const float m = s1[g] / count;
    return {count, shift[g] + m, fmaxf(s2[g] - s1[g] * m, 0.0f)};
  }
};

// The NHWC path as one grid of co-resident CTAs (a cooperative launch),
// for slabs that a group's strided run cannot feed at the memory rate:
// each CTA takes a range of an image's pixels across all C channels, one
// contiguous block of memory, so its copies are whole 16-byte vectors of
// consecutive pixels as in NCHW. It holds what fits of its range in shared
// memory (the rest is read twice), writes its (count, mean, M2) per group,
// and waits at the grid's sync (cooperative groups); then it merges its image's
// partials per group (every CTA in the same order) and applies y = x a + c
// from shared memory. A thread keeps one vector of the C channels in every
// pixel it visits (gn_nhwc_kernel's layout, the run being all C).

constexpr int kMaxGridGroups = 128;

struct GridParams {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  Stats* part;          // (n, chunks, groups)
  long long hw;         // pixels of an image
  int c, cpg, groups;
  int r;                // vectors per pixel (c / V)
  int chunks;           // CTAs per image
  int held;             // vectors of a range held in shared memory
  int wdtype, bdtype;
  float eps;
  int silu;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gn_grid_kernel(GridParams p) {
  using P = Pack<T, V>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Stats part[2][kThreads];
  __shared__ float2 norm[kMaxGridGroups];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int R = p.r, tr = blockDim.x / R, active = tr * R;
  const int img = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const long long r0 = p.hw * chunk / p.chunks;
  const int rows = static_cast<int>(p.hw * (chunk + 1) / p.chunks - r0);
  const bool on = tid < active;
  const int col = on ? tid % R : 0;
  const int cnt = rows * R, held = min(cnt, p.held);
  const int jh = on && tid < held ? (held - 1 - tid) / active + 1 : 0;
  const int jc = on && tid < cnt ? (cnt - 1 - tid) / active + 1 : 0;
  const long long step = static_cast<long long>(tr) * R;
  const long long first = (img * p.hw + r0 + (on ? tid / R : 0)) * R + col;
  const P* src = reinterpret_cast<const P*>(p.x) + first;
  P* dst = reinterpret_cast<P*>(p.y) + first;
  P* sdata = reinterpret_cast<P*>(smem);
  const int e0 = col * V, lo = e0 / p.cpg, split = min(V, (lo + 1) * p.cpg - e0);

#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    for (int j = jh * ch / kChunks; j < jh * (ch + 1) / kChunks; ++j) {
      cp_async_pack<sizeof(P)>(sdata + tid + j * active, src + j * step);
    }
    cp_async_commit();
  }
  float a[V], c[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a[e] = load_param(p.w, p.wdtype, e0 + e);
    c[e] = load_param(p.b, p.bdtype, e0 + e);
  }
  Acc2 acc;
  for (int j0 = jh; j0 < jc; j0 += kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < jc) v[u] = load_pack(src + (j0 + u) * step, false);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < jc) acc.add(v[u], split);
    }
  }
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    switch (ch) {
      case 0: cp_async_wait<kChunks - 1>(); break;
      case 1: cp_async_wait<kChunks - 2>(); break;
      case 2: cp_async_wait<kChunks - 3>(); break;
      default: cp_async_wait<0>(); break;
    }
    for (int j = jh * ch / kChunks; j < jh * (ch + 1) / kChunks; ++j) {
      acc.add(sdata[tid + j * active], split);
    }
  }

  // this CTA's statistics per group: each column's over its rows, then
  // each group's over the columns it spans, into the grid's partials;
  // after the grid sync, each group's over the image's CTAs (16 lanes a
  // group, every CTA in the same order)
  part[0][tid] = acc.stats(0, static_cast<float>(acc.n) * split);
  part[1][tid] = acc.stats(1, static_cast<float>(acc.n) * (V - split));
  __syncthreads();
  Stats col_lo{0.0f, 0.0f, 0.0f}, col_hi{0.0f, 0.0f, 0.0f};
  if (tid < R) {
    for (int r = 0; r < tr; ++r) {
      col_lo = chan(col_lo, part[0][tid + r * R]);
      col_hi = chan(col_hi, part[1][tid + r * R]);
    }
  }
  __syncthreads();
  if (tid < R) {
    part[0][tid] = col_lo;
    part[1][tid] = col_hi;
  }
  __syncthreads();
  Stats* out = p.part + static_cast<long long>(blockIdx.x) * p.groups;
  for (int g = tid; g < p.groups; g += blockDim.x) {
    Stats st{0.0f, 0.0f, 0.0f};
    for (int cc = g * p.cpg / V; cc <= ((g + 1) * p.cpg - 1) / V; ++cc) {
      st = chan(st, cc * V / p.cpg == g ? part[0][cc] : part[1][cc]);
    }
    out[g] = st;
  }
  cg::this_grid().sync();
  const Stats* in = p.part + static_cast<long long>(img) * p.chunks * p.groups;
  for (int g0 = 2 * warp; g0 < p.groups; g0 += 2 * nwarps) {
    const int g = g0 + lane / 16;
    Stats st{0.0f, 0.0f, 0.0f};
    if (g < p.groups) {
      // four partials in flight at a time: they come from L2
      for (int q0 = lane % 16; q0 < p.chunks; q0 += 64) {
        Stats got[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          got[u] = Stats{0.0f, 0.0f, 0.0f};
          if (q0 + 16 * u < p.chunks) {
            const float* f = reinterpret_cast<const float*>(in + (q0 + 16 * u) * p.groups + g);
            got[u] = Stats{__ldcg(f), __ldcg(f + 1), __ldcg(f + 2)};
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) st = chan(st, got[u]);
      }
    }
    for (int m = 8; m > 0; m >>= 1) {
      st = chan(st, Stats{__shfl_down_sync(0xffffffffu, st.n, m, 16),
                          __shfl_down_sync(0xffffffffu, st.mean, m, 16),
                          __shfl_down_sync(0xffffffffu, st.m2, m, 16)});
    }
    if (lane % 16 == 0 && g < p.groups) {
      norm[g] = make_float2(st.mean, rsqrtf(st.m2 / st.n + p.eps));
    }
  }
  __syncthreads();
  if (jc == 0) return;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float2 nm = norm[e < split ? lo : lo + 1];
    a[e] *= nm.y;
    c[e] = fmaf(-nm.x, a[e], c[e]);
  }
  const bool silu_on = p.silu != 0;
  auto apply = [&](const P& in) {
    P o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v = fmaf(to_float(in.v[e]), a[e], c[e]);
      if (silu_on) v = silu(v);
      o.v[e] = from_float<T>(v);
    }
    return o;
  };
#pragma unroll 4
  for (int j = 0; j < jh; ++j) store_pack(dst + j * step, apply(sdata[tid + j * active]));
  for (int j0 = jh; j0 < jc; j0 += kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < jc) v[u] = load_pack(src + (j0 + u) * step, true);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < jc) store_pack(dst + (j0 + u) * step, apply(v[u]));
    }
  }
}

struct DeviceFlags {
  bool set[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t allow_cluster16(DeviceFlags& flags, Kernel* kernel) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && flags.set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && kept) flags.set[dev] = true;
  return e;
}

template <typename T, int V>
cudaError_t launch(Params p, long long held_bytes, cudaStream_t stream) {
  auto* kernel = gn_kernel<T, V>;
  // a CTA's share, the part it holds and the channels a run of the share
  // can touch (core/kernels.py::group_norm_plan computes the same)
  const long long share = (p.slab / V + p.k - 1) / p.k;
  p.held = static_cast<int>(share < held_bytes / static_cast<long long>(sizeof(Pack<T, V>))
                                ? share
                                : held_bytes / static_cast<long long>(sizeof(Pack<T, V>)));
  long long table = (share * V + p.hw - 1) / p.hw + 1;
  table = table < p.cpg ? table : p.cpg;
  p.table = table <= kMaxTable ? static_cast<int>(table) : 0;
  p.table_offset = static_cast<int>((p.held * sizeof(Pack<T, V>) + 15) / 16 * 16);
  const size_t smem = p.table_offset + p.table * sizeof(float2);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, kernel, smem);
  if (e != cudaSuccess) return e;
  if (p.k > 8) {
    static DeviceFlags flags;
    e = allow_cluster16(flags, kernel);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_slabs * p.k);
  cfg.blockDim = dim3(p.held * sizeof(Pack<T, V>) >= 64 * 1024 || p.held < share
                          ? kThreads : kThreads / 2);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // k = 1: no cluster attribute; each CTA is its own cluster
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.k > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Params& p, long long held_bytes, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = p.hw % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  return vec ? launch<T, kVec>(p, held_bytes, stream)
             : launch<T, 1>(p, held_bytes, stream);
}

template <typename T, int V>
cudaError_t launch_nhwc(NhwcParams p, long long held_bytes, cudaStream_t stream) {
  auto* kernel = gn_nhwc_kernel<T, V>;
  const long long share = (p.hw + p.k - 1) / p.k * p.r;   // packs, the largest
  const long long fit = held_bytes / static_cast<long long>(sizeof(Pack<T, V>));
  p.held = static_cast<int>(share < fit ? share : fit);
  const size_t smem = (p.held * sizeof(Pack<T, V>) + 15) / 16 * 16;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, kernel, smem > 0 ? smem : 16);
  if (e != cudaSuccess) return e;
  const int threads =
      p.held * sizeof(Pack<T, V>) >= 64 * 1024 || p.held < share ? kThreads : kThreads / 2;
  if (p.r > threads) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_slabs * p.k);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.k > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the pack of `bytes` bytes (8, 4, or one element)
template <typename T>
cudaError_t run_nhwc(NhwcParams p, int bytes, long long held_bytes, cudaStream_t stream) {
  if (bytes == 8) return launch_nhwc<T, 8 / sizeof(T)>(p, held_bytes, stream);
  if (bytes == 4) return launch_nhwc<T, 4 / sizeof(T)>(p, held_bytes, stream);
  return launch_nhwc<T, 1>(p, held_bytes, stream);
}

template <typename T>
cudaError_t launch_grid(GridParams p, int n, int threads, long long held_bytes,
                        cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto* kernel = gn_grid_kernel<T, V>;
  const long long share = (p.hw + p.chunks - 1) / p.chunks * p.r;   // vectors, the largest
  const long long fit = held_bytes / 16;
  p.held = static_cast<int>(share < fit ? share : fit);
  const size_t smem = static_cast<size_t>(p.held) * 16;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, kernel, smem > 0 ? smem : 16);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * p.chunks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the grid must be co-resident: refuse (and leave no error behind) where
  // it is not
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e != cudaSuccess) return e;
  if (static_cast<long long>(n) * p.chunks > static_cast<long long>(sms) * per_sm) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (n, c, h, w) contiguous; w, b: (c). dtype / wdtype / bdtype: 0 =
// float32, 1 = bfloat16, 2 = float16. k: CTAs per (image, group) slab, a
// power of two up to 16 (n * groups * k CTAs in all); held_bytes: the most
// of its share a CTA holds in shared memory, the rest it reads twice.
// device: the CUDA device of x; the caller's current device is restored.
// Returns a cudaError_t (0 = success).
int ea_group_norm_silu(const void* x, void* y, const void* w, const void* b,
                       int n, int c, int h, int wd, int groups, float eps,
                       int silu, int dtype, int wdtype, int bdtype, int k,
                       long long held_bytes, int device, void* stream) {
  if (n < 1 || groups < 1 || c % groups != 0 || h < 1 || wd < 1 ||
      k < 1 || k > kMaxCluster || (k & (k - 1)) != 0 || held_bytes < 16 ||
      static_cast<long long>(n) * groups * k >= (1LL << 31) ||
      wdtype < 0 || wdtype > 2 || bdtype < 0 || bdtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x; p.y = y; p.w = w; p.b = b;
  p.hw = h * wd;
  p.cpg = c / groups;
  p.slab = static_cast<long long>(p.cpg) * p.hw;
  if (p.slab >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.inv_hw = 1.0f / static_cast<float>(p.hw);
  p.groups = groups;
  p.n_slabs = n * groups;
  p.k = k;
  p.wdtype = wdtype; p.bdtype = bdtype;
  p.eps = eps;
  p.silu = silu;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) e = run<float>(p, held_bytes, s);
  else if (dtype == 1) e = run<__nv_bfloat16>(p, held_bytes, s);
  else if (dtype == 2) e = run<__half>(p, held_bytes, s);
  else e = cudaErrorInvalidValue;
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}

// x, y: (n, c, h, w) channels-last (n, h, w, c contiguous); w, b: (c).
// vec_bytes: the pack, 8, 4 or the element size, whose elements V divide
// c / groups, the pointers aligned to it; k (1 or 2) and held_bytes as
// ea_group_norm_silu's. Returns a cudaError_t (0 = success).
int ea_group_norm_silu_nhwc(const void* x, void* y, const void* w, const void* b,
                            int n, int c, int h, int wd, int groups, int vec_bytes,
                            float eps, int silu, int dtype, int wdtype, int bdtype, int k,
                            long long held_bytes, int device, void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  if (n < 1 || groups < 1 || c % groups != 0 || h < 1 || wd < 1 || k < 1 || k > 2 ||
      held_bytes < 16 || dtype < 0 || dtype > 2 || wdtype < 0 || wdtype > 2 ||
      bdtype < 0 || bdtype > 2 ||
      (vec_bytes != 8 && vec_bytes != 4 && vec_bytes != item) || vec_bytes < item ||
      static_cast<long long>(n) * groups * k >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int v = vec_bytes / item;
  NhwcParams p;
  p.x = x; p.y = y; p.w = w; p.b = b;
  p.hw = static_cast<long long>(h) * wd;
  p.c = c;
  p.cpg = c / groups;
  p.r = p.cpg / v;
  p.groups = groups;
  p.n_slabs = n * groups;
  p.k = k;
  p.wdtype = wdtype; p.bdtype = bdtype;
  p.eps = eps;
  p.silu = silu;
  if (p.cpg % v != 0 || reinterpret_cast<uintptr_t>(x) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(y) % vec_bytes != 0 || p.hw * p.r >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) e = run_nhwc<float>(p, vec_bytes, held_bytes, s);
  else if (dtype == 1) e = run_nhwc<__nv_bfloat16>(p, vec_bytes, held_bytes, s);
  else e = run_nhwc<__half>(p, vec_bytes, held_bytes, s);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}

// The NHWC path as one cooperative grid (gn_grid_kernel): x, y (n, c, h,
// w) channels-last; part: fp32 scratch of n * chunks * groups * 3;
// chunks: CTAs per image, each a range
// of its pixels, all n * chunks CTAs of `threads` threads co-resident;
// held_bytes: the most of its range a CTA holds on chip, the rest it reads
// twice. 16-byte packs: c a multiple of 16 / itemsize, no pack across more
// than two groups, x and y 16-byte aligned. Returns a cudaError_t (0 =
// success).
int ea_group_norm_silu_nhwc_grid(const void* x, void* y, const void* w, const void* b,
                                 void* part, int n, int c, int h, int wd,
                                 int groups, int chunks, int threads, long long held_bytes,
                                 float eps, int silu, int dtype, int wdtype, int bdtype,
                                 int device, void* stream) {
  const int item = dtype == 0 ? 4 : 2, v = 16 / item;
  if (n < 1 || groups < 1 || groups > kMaxGridGroups || c % groups != 0 || c % v != 0 ||
      (threads != kThreads && threads != kThreads / 2) || c / v > threads || h < 1 ||
      wd < 1 || chunks < 1 || chunks > static_cast<long long>(h) * wd ||
      static_cast<long long>(n) * chunks >= (1LL << 31) || held_bytes < 16 ||
      held_bytes > kMaxSmem - 16 * 1024 || dtype < 0 || dtype > 2 || wdtype < 0 ||
      wdtype > 2 || bdtype < 0 || bdtype > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GridParams p;
  p.x = x; p.y = y; p.w = w; p.b = b;
  p.part = static_cast<Stats*>(part);
  p.hw = static_cast<long long>(h) * wd;
  p.c = c;
  p.cpg = c / groups;
  p.groups = groups;
  p.r = c / v;
  p.chunks = chunks;
  p.wdtype = wdtype; p.bdtype = bdtype;
  p.eps = eps;
  p.silu = silu;
  if ((p.hw + chunks - 1) / chunks * p.r >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int col = 0; col < p.r; ++col) {   // at most two groups per pack
    if ((col * v + v - 1) / p.cpg - col * v / p.cpg > 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) e = launch_grid<float>(p, n, threads, held_bytes, s);
  else if (dtype == 1) e = launch_grid<__nv_bfloat16>(p, n, threads, held_bytes, s);
  else e = launch_grid<__half>(p, n, threads, held_bytes, s);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}

// Blocks of the bf16 kernel (16-byte vectors) that fit on one SM with
// `threads` threads and `smem_bytes` of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and clusters of k that
// fit on the device at once (cudaOccupancyMaxActiveClusters). out:
// [blocks per SM, active clusters].
int ea_group_norm_occupancy(int k, int threads, long long smem_bytes,
                            int* out) {
  auto* kernel = gn_kernel<__nv_bfloat16, 8>;
  static SmemGrant grant;
  cudaError_t e = grant_smem(grant, kernel, smem_bytes);
  if (e != cudaSuccess) return e;
  if (k > 8) {
    static DeviceFlags flags;
    e = allow_cluster16(flags, kernel);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(k * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads,
                                                    smem_bytes);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
  return static_cast<int>(e);
}

const char* ea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

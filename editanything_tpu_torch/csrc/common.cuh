// Device helpers shared by the port's CUDA kernels: the bf16 mma.sync
// m16n8k16 fragment code (ldmatrix loads, bf16 packing, the product) and
// warp reductions (flash_attention.cu,
// sam_twoway.cu, sam_upscale.cu), and for the SAM mask-decoder kernels
// storage-dtype conversions, block-wide tile copies into shared memory
// (cp.async; flash_attention.cu's ring uses the zero-filling form), and
// one warp's 16-row matrix product in the fragment layout of mma.sync,
// with an exact fp32 twin in the same layout.
//
// warp_mm's output layout, for lane = threadIdx.x % 32, g = lane / 4,
// tig = lane % 4: c[t][0], c[t][1] hold row g, columns t * 8 + 2 * tig and
// + 1; c[t][2], c[t][3] the same columns of row g + 8. Code written against
// this layout (bias, LayerNorm by quad shuffles, stores) serves both dtypes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ea {

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// The dynamic shared memory a kernel has been granted, per device: function
// attributes belong to a device's context, so a process that launches on
// several cards opts in on each one. A device numbered kMaxDevices or above
// is opted in before every launch.
constexpr int kMaxDevices = 64;
struct SmemGrant {
  int bytes[kMaxDevices] = {};
};

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device, unless that device has granted as much already. most_shared: also
// ask for the largest shared memory carve-out of the SM's L1, so that as
// many blocks of that size fit as the SM can hold.
template <typename Kernel>
cudaError_t grant_smem(SmemGrant& grant, Kernel* kernel, size_t smem,
                       bool most_shared = false) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int want = static_cast<int>(smem);
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && want <= grant.bytes[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           want);
  if (e == cudaSuccess && most_shared) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && kept) grant.bytes[dev] = want;
  return e;
}

// row padding in elements: spreads the rows of a warp's fragment loads over
// the banks and keeps every row 16-byte aligned
template <typename T>
__host__ __device__ constexpr int pad_of() {
  return sizeof(T) == 2 ? 8 : 4;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the storage dtype: the value a product of T inputs sees
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float gelu(float x) {   // exact (erf) GELU
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// the src-size form: copies 16 bytes if valid, else writes 16 zero bytes to
// shared memory and reads nothing (src must still be a global address)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a rows x cols tile, global (row stride lds) -> shared (row
// stride ldd), by the whole block: 16-byte cp.async where the layout allows
// it (every load in flight at once), element copies otherwise. Completes at
// the next cp_async_wait that covers it; visible to the block after the
// __syncthreads that follows.
template <typename T>
__device__ void copy_tile_async(T* dst, int ldd, const T* src, long long lds,
                                int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  if (cols % V == 0 && ldd % V == 0 && lds % V == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int chunks = cols / V;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * V;
      cp_async16(dst + r * ldd + c, src + r * lds + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ldd + c] = src[r * lds + c];
    }
  }
}

// the same copy, complete (for this thread) on return
template <typename T>
__device__ void copy_tile(T* dst, int ldd, const T* src, long long lds,
                          int rows, int cols) {
  copy_tile_async(dst, ldd, src, lds, rows, cols);
  cp_async_commit();
  cp_async_wait<0>();
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A (16 x K) * W (NT*8 x K)^T for the calling warp, A and W row-major
// in shared memory (strides lda, ldw in elements, even), K a multiple of 16:
// bf16 on the tensor cores with fp32 sums
template <int NT>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4],
                                        const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* W, int ldw,
                                        int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    a[0] = lds32(A + g * lda + kk + tig * 2);
    a[1] = lds32(A + (g + 8) * lda + kk + tig * 2);
    a[2] = lds32(A + g * lda + kk + 8 + tig * 2);
    a[3] = lds32(A + (g + 8) * lda + kk + 8 + tig * 2);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat16* w = W + (t * 8 + g) * ldw + kk + tig * 2;
      mma_bf16(c[t], a, lds32(w), lds32(w + 8));
    }
  }
}

// the same product in exact fp32 FMAs on the CUDA cores (the tensor cores
// have no exact fp32 mode): the tests' path
template <int NT>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* A,
                                        int lda, const float* W, int ldw,
                                        int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float w0 = W[(t * 8 + tig * 2) * ldw + k];
      const float w1 = W[(t * 8 + tig * 2 + 1) * ldw + k];
      c[t][0] = fmaf(a0, w0, c[t][0]);
      c[t][1] = fmaf(a0, w1, c[t][1]);
      c[t][2] = fmaf(a1, w0, c[t][2]);
      c[t][3] = fmaf(a1, w1, c[t][3]);
    }
  }
}

}  // namespace ea

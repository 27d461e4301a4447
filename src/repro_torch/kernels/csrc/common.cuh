// Shared helpers for the kernels: element conversion, the finite masking
// sentinel of the plain versions (kernels/ref.py), 16-byte loads, cp.async,
// and the tensor-core fragment helpers of the two bf16 attention kernels.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// -2**30: a fully masked tile softmaxes to exp(0) = 1 per lane and is then
// wiped by alpha = exp(NEG_INF - m) = 0 once a visible key arrives, where a
// true -inf would give exp(-inf - -inf) = NaN.
constexpr float kNegInf = -1073741824.0f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Max / sum over the 16 lanes of an aligned half-warp.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte loads: 16 / sizeof(T) elements of a row at once (the wrapper
// checks that every base pointer is 16-byte aligned and D is a multiple of
// 16, so every row starts aligned).
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Unpack 16 loaded bytes into 16 / sizeof(T) floats at dst[0], dst[1], ...
template <typename T>
__device__ __forceinline__ void unpack(uint4 u, float* dst);

template <>
__device__ __forceinline__ void unpack<float>(uint4 u, float* dst) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 u, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// A (ROWS, D) tile of rows row0 .. row0 + ROWS - 1 of a strided array, moved
// in two steps so the loads of the next tile can be in flight while the
// current one is computed on: load_rows() issues every 16-byte load of the
// calling thread into registers, store_rows() converts them to f32 in
// shared memory (row stride D + 1).  Rows outside [lo, hi] (inclusive) are
// never read and come out as zeros.
template <typename T, int D, int ROWS, int THREADS>
struct RowTile {
  static constexpr int V = 16 / sizeof(T);       // elements per load
  static constexpr int CPR = D / V;              // loads per row
  static constexpr int N = (ROWS * CPR + THREADS - 1) / THREADS;
  uint4 r[N];

  __device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                            size_t base, int stride,
                                            int row0, int lo, int hi) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int row = i / CPR, col = (i % CPR) * V;
      const int g = row0 + row;
      r[u] = (row < ROWS && g >= lo && g <= hi)
                 ? load16(src + base + (size_t)g * stride + col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store_rows(float* dst) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int row = i / CPR, col = (i % CPR) * V;
      if (row < ROWS) {
        float f[V];
        unpack<T>(r[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) dst[row * (D + 1) + col + j] = f[j];
      }
    }
  }
};

// 16-byte asynchronous copy global -> shared (.cg: cached in L2 only);
// with valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 accumulate) and
// the shared-memory loads that fill them, for the bf16 attention kernels.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats as a bf16 pair (x in the low half), and what rounding left.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y, float& rx,
                                              float& ry) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  rx = x - f.x;
  ry = y - f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// The transpose of an 8x8 bf16 matrix held as one fragment register a
// lane (row lane / 4, columns 2 (lane % 4) and + 1): the same layout of
// the transposed matrix.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// Dtype codes shared with kernels/ops.py.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace repro_torch

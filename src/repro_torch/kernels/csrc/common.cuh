// Shared helpers for the kernels: element conversion, the finite masking
// sentinel of the plain versions (kernels/ref.py), 16-byte loads, cp.async.
#pragma once

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

// Dtype codes shared with kernels/ops.py.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace repro_torch

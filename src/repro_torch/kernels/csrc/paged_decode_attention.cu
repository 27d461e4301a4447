// Paged decode attention for Hopper (sm_90a), CUDA cores, f32 math.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention :27, body _kernel_with_prefetch :77 / _body :90,
// launched by pl.pallas_call at :47).  One new query token per request
// attends the positions 0 .. cur_lens[b] (inclusive: its own k/v is already
// written) of its cache, which lives in a pool of pages shared by all
// requests: position p sits in page tables[b][p / BS], row p % BS.  A table
// entry of -1 is an unallocated page, and its positions are masked.
//
// Layout: q/out (B, Hq, D), pool_k/pool_v (NB, BS, Hkv, D), f32 or bf16;
// tables (B, MB) int32; cur_lens (B,) int32.  The G = Hq / Hkv query heads
// of a group share one kv head.
//
// What bounds it: as the contiguous decode kernel (decode_attention.cu),
// every live key and value row is read once for only 4 * G * D flops, so it
// is bound by bytes; paging adds one table entry per row.  What the design
// does about it: the same (kv head, batch) blocks with the G query rows
// together and an online softmax over tiles of 64 positions.  The block
// first copies its request's table row to shared memory (the TPU kernel's
// scalar prefetch), so a row's page is a shared-memory read and not a
// global load the data load must wait for; each thread then issues its
// 16-byte loads one tile ahead.  A row past cur_len or in an
// unallocated page is never loaded, so whatever a foreign or free page
// holds, even NaN, cannot reach the result.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int D>
size_t smem_bytes(int G, int MB) {
  // sQ (G, D+1), sK and sV (BK, D+1), sS (G, BK), sO (G, D), m/l/alpha (G);
  // the table row (MB) of int32
  return sizeof(float) *
             ((size_t)G * (D + 1) + 2 * BK * (D + 1) + (size_t)G * BK +
              (size_t)G * D + 3 * (size_t)G) +
         sizeof(int) * (size_t)MB;
}

// A (BK, D) tile of positions row0 .. row0 + BK - 1 of one request's kv
// head, gathered page by page through the table row in shared memory;
// RowTile's two steps (loads into registers,
// then f32 into shared memory, row stride D + 1).  Positions past hi or in
// an unallocated page come out as zeros and are never read.
template <typename T, int D>
struct PagedTile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CPR = D / V;
  static constexpr int N = (BK * CPR + THREADS - 1) / THREADS;
  uint4 r[N];

  __device__ __forceinline__ void load_rows(const T* __restrict__ pool,
                                            const int* __restrict__ table,
                                            int bs, int hkv, int hk, int row0,
                                            int hi) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int row = i / CPR, col = (i % CPR) * V;
      const int p = row0 + row;
      const int page = (row < BK && p <= hi) ? table[p / bs] : -1;
      r[u] = page >= 0
                 ? load16(pool + (((size_t)page * bs + p % bs) * hkv + hk) * D +
                          col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store_rows(float* dst) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int row = i / CPR, col = (i % CPR) * V;
      if (row < BK) {
        float f[V];
        unpack<T>(r[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) dst[row * (D + 1) + col + j] = f[j];
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v,
                        const int* __restrict__ tables,
                        const int* __restrict__ cur_lens, T* __restrict__ out,
                        int MB, int BS, int Hq, int Hkv, float scale) {
  constexpr int DP = D + 1;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + G * DP;
  float* sV = sK + BK * DP;
  float* sS = sV + BK * DP;
  float* sO = sS + G * BK;
  float* sM = sO + G * D;
  float* sL = sM + G;
  float* sA = sL + G;
  int* table = reinterpret_cast<int*>(sA + G);  // this request's table row

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hi = min(cur_lens[b], MB * BS - 1);  // last position (inclusive)

  for (int i = tid; i < MB; i += THREADS) table[i] = tables[(size_t)b * MB + i];

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    sQ[g * DP + c] = to_f32(q[((size_t)b * Hq + hk * G + g) * D + c]);
    sO[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  __syncthreads();  // the table row is in shared memory

  PagedTile<T, D> tk, tv;
  tk.load_rows(pool_k, table, BS, Hkv, hk, 0, hi);
  tv.load_rows(pool_v, table, BS, Hkv, hk, 0, hi);

  for (int kb = 0; kb <= hi; kb += BK) {
    __syncthreads();  // init done / previous tile's sK, sV, sS consumed
    tk.store_rows(sK);
    tv.store_rows(sV);
    __syncthreads();
    if (kb + BK <= hi) {  // the next tile's loads fly during this compute
      tk.load_rows(pool_k, table, BS, Hkv, hk, kb + BK, hi);
      tv.load_rows(pool_v, table, BS, Hkv, hk, kb + BK, hi);
    }

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, j = i % BK;
      const int p = kb + j;
      const bool live = p <= hi && table[p / BS] >= 0;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * DP + d], sK[j * DP + d], s);
      sS[i] = live ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      const float a = sS[g * BK + lane], c = sS[g * BK + lane + 32];
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      const float rs = warp_sum(pa + pc);
      sS[g * BK + lane] = pa;
      sS[g * BK + lane + 32] = pc;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + rs;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, c = i % D;
      float o = sO[i] * sA[g];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) o = fmaf(sS[g * BK + j], sV[j * DP + c], o);
      sO[i] = o;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    store(out + ((size_t)b * Hq + hk * G + g) * D + c,
          sO[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* pk, const void* pv, const void* tables,
           const void* cur_lens, void* out, int B, int MB, int BS, int Hq,
           int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(Hq / Hkv, MB);
  if (smem > 227 * 1024) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(tables),
      static_cast<const int*>(cur_lens), static_cast<T*>(out), MB, BS, Hq, Hkv,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* pk, const void* pv,
               const void* tables, const void* cur_lens, void* out, int B,
               int MB, int BS, int Hq, int Hkv, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, pk, pv, tables, cur_lens, out, B, MB, BS, Hq,
                           Hkv, scale, s);
    case 32:
      return launch<T, 32>(q, pk, pv, tables, cur_lens, out, B, MB, BS, Hq,
                           Hkv, scale, s);
    case 64:
      return launch<T, 64>(q, pk, pv, tables, cur_lens, out, B, MB, BS, Hq,
                           Hkv, scale, s);
    case 128:
      return launch<T, 128>(q, pk, pv, tables, cur_lens, out, B, MB, BS, Hq,
                            Hkv, scale, s);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch (0 = launched), or -1 for an
// unsupported dtype / head dim / group size.
extern "C" int paged_decode_attention(int dtype, const void* q,
                                      const void* pool_k, const void* pool_v,
                                      const void* tables, const void* cur_lens,
                                      void* out, int B, int MB, int BS, int Hq,
                                      int Hkv, int D, float scale,
                                      void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, pool_k, pool_v, tables, cur_lens, out, B,
                             MB, BS, Hq, Hkv, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, pool_k, pool_v, tables, cur_lens,
                                     out, B, MB, BS, Hq, Hkv, scale, s);
  return -1;
}

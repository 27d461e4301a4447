// Decode attention for Hopper (sm_90a), CUDA cores, f32 math.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py (_kernel,
// launched by pl.pallas_call at :97).  One new query token per request
// attends its cache at k_pos <= cur_lens[b] (the token's own k/v is already
// written at slot cur_len), behind an optional window and softcap.
//
// Layout: q/out (B, Hq, D), k/v (B, L, Hkv, D), f32 or bf16; cur_lens (B,)
// int32.  The G = Hq / Hkv query heads of a group share one kv head.
//
// What bounds it: every cached key and value row of the live range is read
// once for only 4 * G * D flops, so it is bound by bytes.  What the design
// does about it: one block per (kv head, batch) keeps the G query rows of
// the group together, so each k/v row crosses from device memory once for
// all G heads (the TPU kernel's (G, D) tile), and the loop covers only the
// live range [max(0, cur - window + 1), cur]: no row past cur_len or behind
// the window is ever loaded, so garbage there, even NaN, cannot reach the
// result.  Each thread issues its share of a K/V tile as 16-byte loads into
// registers one tile ahead, so the next tile's loads are in flight while
// the current one is computed on.  At decode batch 4 with 8 kv heads that
// is 32 blocks on 132 SMs; splitting the key range across blocks
// (flash-decoding) is later work.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int D>
size_t smem_bytes(int G) {
  // sQ (G, D+1), sK and sV (BK, D+1), sS (G, BK), sO (G, D), m/l/alpha (G)
  return sizeof(float) *
         ((size_t)G * (D + 1) + 2 * BK * (D + 1) + (size_t)G * BK +
          (size_t)G * D + 3 * (size_t)G);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ cur_lens,
                  T* __restrict__ out, int L, int Hq, int Hkv, int window,
                  float softcap, float scale) {
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

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cur = cur_lens[b];
  const int hi = min(cur, L - 1);  // last live key (inclusive)
  const int lo = window > 0 ? max(0, cur - window + 1) : 0;

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    sQ[g * DP + c] = to_f32(q[((size_t)b * Hq + hk * G + g) * D + c]);
    sO[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  // K and V rows of one position are (Hkv * D) apart; this head's start:
  const size_t base = ((size_t)b * L * Hkv + hk) * D;
  const int stride = Hkv * D;
  RowTile<T, D, BK, THREADS> tk, tv;
  int kb = (lo / BK) * BK;
  tk.load_rows(k, base, stride, kb, lo, hi);
  tv.load_rows(v, base, stride, kb, lo, hi);

  for (; kb <= hi; kb += BK) {
    __syncthreads();  // init done / previous tile's sK, sV, sS consumed
    tk.store_rows(sK);
    tv.store_rows(sV);
    __syncthreads();
    if (kb + BK <= hi) {  // the next tile's loads fly during this compute
      tk.load_rows(k, base, stride, kb + BK, lo, hi);
      tv.load_rows(v, base, stride, kb + BK, lo, hi);
    }

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, j = i % BK;
      const int kp = kb + j;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * DP + d], sK[j * DP + d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sS[i] = (kp >= lo && kp <= hi) ? s : kNegInf;
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
int launch(const void* q, const void* k, const void* v, const void* cur_lens,
           void* out, int B, int L, int Hq, int Hkv, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(Hq / Hkv);
  if (smem > 227 * 1024) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cur_lens),
      static_cast<T*>(out), L, Hq, Hkv, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* cur_lens, void* out, int B, int L, int Hq, int Hkv,
               int window, float softcap, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, cur_lens, out, B, L, Hq, Hkv, window,
                           softcap, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, cur_lens, out, B, L, Hq, Hkv, window,
                           softcap, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, cur_lens, out, B, L, Hq, Hkv, window,
                           softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, cur_lens, out, B, L, Hq, Hkv, window,
                            softcap, scale, s);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch (0 = launched), or -1 for an
// unsupported dtype / head dim / group size.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* cur_lens,
                                void* out, int B, int L, int Hq, int Hkv,
                                int D, int window, float softcap, float scale,
                                void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k, v, cur_lens, out, B, L, Hq, Hkv, window,
                             softcap, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, cur_lens, out, B, L, Hq, Hkv,
                                     window, softcap, scale, s);
  return -1;
}

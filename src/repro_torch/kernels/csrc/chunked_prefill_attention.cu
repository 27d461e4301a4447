// Chunked-prefill flash attention for Hopper (sm_90a): bf16 on tensor
// cores, f32 on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/chunked_prefill_attention.py
// (_kernel, launched by pl.pallas_call at :111).  One kernel serves the
// whole prefill family: whole-prompt prefill (offset 0), a Convertible
// Decoder's restricted chunk (offset = chunk start, keys = the live cache)
// and sliding-window / softcapped layers.  Row t of q sits at absolute
// position offset[b] + t; key k_pos is visible iff k_pos <= q_pos,
// k_pos < lengths[b] and, when window > 0, k_pos > q_pos - window.  A row
// with no visible key at all gets what the plain version's softmax over an
// all-masked row gives: the mean of v over all Skv keys.
//
// Layout: q/out (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), f32 or bf16;
// offset/lengths (B,) int32.  GQA: q head h reads kv head h / (Hq / Hkv).
// Ragged edges are masked here; the wrapper pads nothing.
//
// What bounds it: each q/out row and each needed k/v row moves once, and
// the two chained products take ~4 D flops per visible (query, key) pair.
// At the main-path shape (B=1, Sq=512 into Skv=2048, Hq=32, Hkv=8, D=128,
// bf16) that is 6 MB against 2.15 GFLOP: 0.0031 ms of bytes and 0.0022 ms
// of bf16 tensor-core work, but 0.032 ms on CUDA cores at 67 TFLOP/s f32.
// So the bf16 path has to run both products on tensor cores.
//
// bf16 path (prefill_wg_kernel, prefill_wg.cuh): wgmma, TMA and a
// warp-specialised producer at every head dim, the rows padded to whole
// 64-column swizzle blocks by the TMA map's zero fill at D = 16, 32 and
// 112.  At the main-path shape above it takes 0.019 ms where the mma.sync
// kernel it replaced took 0.031 on an H100 80GB HBM3 at 700 W
// (chip_prefill_probe.py and chip_compare.py).  P enters P V as a hi + lo
// pair of bf16: a single bf16 P errs by ~2^-9 |v| whatever the output's
// size and fails the 2e-5 + 2 bf16 steps bound on outputs near zero
// (kernels/ref.py chunked_prefill_attention_split_p_ref shows both on the
// CPU).
//
// f32 path (prefill_f32_kernel): the reference's 2e-5 needs f32 products
// (TF32 keeps ~3 digits), so f32 inputs run on CUDA cores: one block per
// (64-row q tile, head, batch), 256 threads as a 16 x 16 grid, tiles
// widened to f32 in shared memory, one K/V tile of 16-byte loads ahead
// (at D = 256 none ahead: the loads would take 128 registers a thread;
// the tiles take 214,016 B of shared memory, one block per SM).
#include <stdint.h>

#include "common.cuh"
#include "prefill_wg.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PSTRIDE = BK + 1;

template <int D>
constexpr size_t f32_smem_bytes() {
  // sQ, sK, sV: (rows, D + 1) f32 — the +1 keeps column walks conflict-free
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * PSTRIDE);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ offset,
                       const int* __restrict__ lengths, float* __restrict__ out,
                       int Sq, int Skv, int Hq, int Hkv, int window,
                       float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * DP;

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int t0 = blockIdx.x * BQ;
  const int t1 = min(Sq, t0 + BQ);  // exclusive
  const int off = offset[b];
  const int len = min(lengths[b], Skv);
  // keys any row of this tile can see: [k_lo, k_hi)
  const int k_hi = min(len, off + t1);
  const int k_lo = window > 0 ? max(0, off + t0 - window + 1) : 0;

  {
    RowTile<float, D, BQ, THREADS> tq;  // rows t0.. of this head
    tq.load_rows(q, ((size_t)b * Sq * Hq + h) * D, Hq * D, t0, t0, Sq - 1);
    tq.store_rows(sQ);
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // K and V rows of one position are (Hkv * D) apart; this head's start:
  const size_t kv_base = ((size_t)b * Skv * Hkv + hk) * D;
  const int stride = Hkv * D;
  // Up to D = 128 the next K/V tile's loads fly in registers during this
  // tile's compute (2 x D / 4 registers a thread); at D = 256 that would be
  // 128 registers beside the 64 of acc, so each tile is loaded when needed.
  constexpr bool kPrefetch = D <= 128;
  RowTile<float, D, BK, THREADS> tk, tv;
  int kb = (k_lo / BK) * BK;
  if constexpr (kPrefetch) {
    tk.load_rows(k, kv_base, stride, kb, k_lo, k_hi - 1);
    tv.load_rows(v, kv_base, stride, kb, k_lo, k_hi - 1);
  }

  for (; kb < k_hi; kb += BK) {
    __syncthreads();  // sQ written / previous tile's sK, sV, sP consumed
    if constexpr (kPrefetch) {
      tk.store_rows(sK);
      tv.store_rows(sV);
    } else {
      tk.load_rows(k, kv_base, stride, kb, k_lo, k_hi - 1);
      tk.store_rows(sK);
      tk.load_rows(v, kv_base, stride, kb, k_lo, k_hi - 1);
      tk.store_rows(sV);
    }
    __syncthreads();
    if (kPrefetch && kb + BK < k_hi) {  // loads fly during this compute
      tk.load_rows(k, kv_base, stride, kb + BK, k_lo, k_hi - 1);
      tv.load_rows(v, kv_base, stride, kb + BK, k_lo, k_hi - 1);
    }

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = off + t0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kb + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool vis = kp <= q_pos && kp < len &&
                         (window <= 0 || kp > q_pos - window);
        s[i][j] = vis ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * PSTRIDE + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * PSTRIDE + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vx = sV[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= Sq) continue;
    float* o = out + (((size_t)b * Sq + t) * Hq + h) * D;
    if (m[i] == kNegInf) {
      // no visible key: the plain version's softmax is uniform over Skv
      for (int c = 0; c < DC; ++c) {
        float sum = 0.f;
        for (int kp = 0; kp < Skv; ++kp)
          sum += v[(((size_t)b * Skv + kp) * Hkv + hk) * D + tx + 16 * c];
        o[tx + 16 * c] = sum / (float)Skv;
      }
    } else {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c] / den;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v,
               const void* offset, const void* lengths, void* out, int B,
               int Sq, int Skv, int Hq, int Hkv, int window, float softcap,
               float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_smem_bytes<D>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  prefill_f32_kernel<D><<<grid, THREADS, f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(offset),
      static_cast<const int*>(lengths), static_cast<float*>(out), Sq, Skv, Hq,
      Hkv, window, softcap, scale);
  return (int)cudaGetLastError();
}

// bf16 runs prefill_wg_kernel at every head dim, f32 prefill_f32_kernel.
template <bool BF16>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* offset, const void* lengths, void* out, int B,
               int Sq, int Skv, int Hq, int Hkv, int window, float softcap,
               float scale, cudaStream_t s) {
#define REPRO_PREFILL_CASE(DD)                                               \
  case DD:                                                                   \
    return BF16 ? launch_wg<DD>(q, k, v, offset, lengths, out, B, Sq, Skv,  \
                                Hq, Hkv, window, softcap, scale, s)          \
                : launch_f32<DD>(q, k, v, offset, lengths, out, B, Sq, Skv,  \
                                 Hq, Hkv, window, softcap, scale, s);
  switch (D) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
    REPRO_PREFILL_CASE(112)
    REPRO_PREFILL_CASE(128)
    REPRO_PREFILL_CASE(256)
    default:
      return -1;
  }
#undef REPRO_PREFILL_CASE
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch (0 = launched), or -1 for an
// unsupported dtype / head dim / grouping.
extern "C" int chunked_prefill_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* offset, const void* lengths, void* out, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int window, float softcap, float scale,
    void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv) return -1;
  if (dtype == kF32)
    return dispatch_d<false>(D, q, k, v, offset, lengths, out, B, Sq, Skv, Hq,
                             Hkv, window, softcap, scale, s);
  if (dtype == kBF16)
    return dispatch_d<true>(D, q, k, v, offset, lengths, out, B, Sq, Skv, Hq,
                            Hkv, window, softcap, scale, s);
  return -1;
}

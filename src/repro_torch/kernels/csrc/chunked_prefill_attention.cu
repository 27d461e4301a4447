// Chunked-prefill flash attention for Hopper (sm_90a), CUDA cores, f32 math.
//
// Replaces the TPU kernel src/repro/kernels/chunked_prefill_attention.py
// (_kernel, launched by pl.pallas_call at :111).  One kernel serves the
// whole prefill family: whole-prompt prefill (offset 0), a Convertible
// Decoder's restricted chunk (offset = chunk start, keys = the live cache)
// and sliding-window / softcapped layers.  Row t of q sits at absolute
// position offset[b] + t; key k_pos is visible iff k_pos <= q_pos,
// k_pos < lengths[b] and, when window > 0, k_pos > q_pos - window.
//
// Layout: q/out (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), f32 or bf16;
// offset/lengths (B,) int32.  GQA: q head h reads kv head h / (Hq / Hkv).
//
// What bounds it: at the serving shapes (D = 128, a prompt of hundreds to
// thousands of tokens against a max_len cache) the work is the two chained
// products, ~4*D flops per visible (query, key) pair; the bytes are each
// q/k/v row once.  So it is bound by operations.  This first version runs
// them on CUDA cores in f32 (no tensor cores, so f32 inputs keep f32
// accuracy), far below the bf16 tensor-core peak; wgmma and TMA are later
// work.
//
// Design: the TPU grid (B, Hq, Sq/BQ, Skv/BK) walked its innermost kv axis in
// order, carrying (m, l, acc) in VMEM scratch.  Here one block owns one
// (q tile, head, batch) and loops over kv tiles itself, keeping m, l and
// the output accumulator in registers (256 threads as a 16 x 16 grid, each
// owning 4 query rows x 4 keys of a score tile and 4 rows x D/16 columns of
// the output).  The loop runs only over the tiles that hold a visible key
// for some row of the q tile: from the window's start to
// min(lengths, offset + last row + 1).  The TPU kernel walked every tile.
// Ragged edges are masked here (q rows past Sq, keys outside the range are
// not loaded), so the wrapper pads nothing.  Tiles move as 16-byte loads
// into registers, one K/V tile ahead of the compute.  A row with no visible
// key at all gets what the plain version's softmax over an all-masked row
// gives: the mean of v over all Skv keys.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PSTRIDE = BK + 1;

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK, sV: (rows, D + 1) f32 — the +1 keeps column walks conflict-free
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * PSTRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ offset,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int Sq, int Skv, int Hq, int Hkv, int window,
                   float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ float smem[];
  float* sQ = smem;
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
    RowTile<T, D, BQ, THREADS> tq;   // rows t0.. of this head, Hq * D apart
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
  RowTile<T, D, BK, THREADS> tk, tv;
  int kb = (k_lo / BK) * BK;
  tk.load_rows(k, kv_base, stride, kb, k_lo, k_hi - 1);
  tv.load_rows(v, kv_base, stride, kb, k_lo, k_hi - 1);

  for (; kb < k_hi; kb += BK) {
    __syncthreads();  // sQ written / previous tile's sK, sV, sP consumed
    tk.store_rows(sK);
    tv.store_rows(sV);
    __syncthreads();
    if (kb + BK < k_hi) {  // the next tile's loads fly during this compute
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
    T* o = out + (((size_t)b * Sq + t) * Hq + h) * D;
    if (m[i] == kNegInf) {
      // no visible key: the plain version's softmax is uniform over Skv
      for (int c = 0; c < DC; ++c) {
        float sum = 0.f;
        for (int kp = 0; kp < Skv; ++kp)
          sum += to_f32(v[(((size_t)b * Skv + kp) * Hkv + hk) * D + tx + 16 * c]);
        store(o + tx + 16 * c, sum / (float)Skv);
      }
    } else {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[i][c] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* offset,
           const void* lengths, void* out, int B, int Sq, int Skv, int Hq,
           int Hkv, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  prefill_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(offset),
      static_cast<const int*>(lengths), static_cast<T*>(out), Sq, Skv, Hq,
      Hkv, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* offset, const void* lengths, void* out, int B,
               int Sq, int Skv, int Hq, int Hkv, int window, float softcap,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, offset, lengths, out, B, Sq, Skv, Hq, Hkv,
                           window, softcap, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, offset, lengths, out, B, Sq, Skv, Hq, Hkv,
                           window, softcap, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, offset, lengths, out, B, Sq, Skv, Hq, Hkv,
                           window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, offset, lengths, out, B, Sq, Skv, Hq,
                            Hkv, window, softcap, scale, s);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch (0 = launched), or -1 for an
// unsupported dtype / head dim.
extern "C" int chunked_prefill_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* offset, const void* lengths, void* out, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int window, float softcap, float scale,
    void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k, v, offset, lengths, out, B, Sq, Skv, Hq,
                             Hkv, window, softcap, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, offset, lengths, out, B, Sq,
                                     Skv, Hq, Hkv, window, softcap, scale, s);
  return -1;
}

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
// bf16 path (prefill_tc_kernel), FlashAttention-2 style with mma.sync:
//  * A block owns BM = 64 packed query rows of one kv head: row p is token
//    p / G, query head p % G of the group, so the G heads that read one kv
//    head share every K/V tile a block loads (read once per block, not G
//    times).  4 warps, 16 rows each.  Grid (ceil(Sq G / BM), Hkv, B), the
//    last rows of the prompt (the most keys under a causal mask) first.
//  * Q is loaded once (cp.async, then ldmatrix into registers).  K/V tiles
//    of BK = 64 keys stay bf16 in a 2-stage cp.async ring; rows are padded
//    by 16 bytes so that ldmatrix (K) and ldmatrix.trans (V) are free of
//    bank conflicts.  Only the kv tiles that hold a visible key for some row
//    of the block are visited; keys outside that range are never loaded
//    (zero-filled) and weigh 0.
//  * S = Q K^T (mma.sync m16n8k16, bf16 in, f32 accumulate) stays in
//    registers; the online softmax runs on the accumulator fragment in the
//    log2 domain (scale * log2 e folded in, exp2f), row max and sum by quad
//    shuffles.  A tile wholly visible to every row of the warp skips the
//    mask arithmetic.
//  * P feeds P V from registers (the accumulator fragment is the A
//    fragment), as a hi + lo pair of bf16: p_hi = bf16(p), p_lo =
//    bf16(p - p_hi), two MMAs into one accumulator.  A single bf16 P errs
//    by ~2^-9 |v| whatever the output's size and fails the 2e-5 + 2 bf16
//    steps bound on outputs near zero (kernels/ref.py
//    chunked_prefill_attention_split_p_ref shows both on the CPU); the pair
//    keeps P to ~2^-16.  The row sum is taken from the f32 P.
//  * D = 256 (Gemma): O is 128 f32 registers a thread, so Q's fragments
//    are read from shared memory at each k-step instead of being held; the
//    ring and Q take 168,960 B of shared memory, one block per SM (Gemma-2
//    9B's 512-token prompt is 16 x 8 blocks: one wave on 132 SMs).
//
// f32 path (prefill_f32_kernel): the reference's 2e-5 needs f32 products
// (TF32 keeps ~3 digits), so f32 inputs run on CUDA cores: one block per
// (64-row q tile, head, batch), 256 threads as a 16 x 16 grid, tiles
// widened to f32 in shared memory, one K/V tile of 16-byte loads ahead
// (at D = 256 none ahead: the loads would take 128 registers a thread;
// the tiles take 214,016 B of shared memory, one block per SM).
//
// wgmma + TMA (warp-specialised producer, 64-row warpgroup tiles) is the
// next step for the bf16 path.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kBM = 16 * kTcWarps;  // packed query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kTcStages = 2;

template <int D>
constexpr size_t tc_smem_bytes() {
  // sQ (kBM, D + 8), then kTcStages x {K, V} (kBK, D + 8), bf16
  return sizeof(__nv_bfloat16) * (size_t)(D + 8) *
         (kBM + kTcStages * 2 * kBK);
}

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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ offset,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out, int Sq, int Skv, int Hq,
                      int Hkv, int window, float softcap, float scale) {
  constexpr int LD = D + 8;      // padded smem row (elements)
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  constexpr int NT = kBK / 8;    // score n-tiles (8 keys) per tile
  constexpr int DT = D / 8;      // output n-tiles (8 columns)
  constexpr int KS = D / 16;     // k-steps of Q K^T
  // Q in registers up to D = 128 (KS x 4 a thread); at D = 256 the O
  // accumulator alone is 128 registers a thread, so Q's fragment is read
  // from shared memory at each k-step instead (one more ldmatrix per 8 of
  // K's and V's).
  constexpr bool kQInRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sKV = sQ + kBM * LD;  // stage s: K, then V, each kBK x LD

  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int P = Sq * G;                                  // packed rows
  const int p0 = (gridDim.x - 1 - blockIdx.x) * kBM;     // heaviest first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = offset[b];
  const int len = min(lengths[b], Skv);
  const int t_first = p0 / G, t_last = (min(p0 + kBM, P) - 1) / G;
  // keys any row of this block can see: [k_lo, k_hi)
  const int k_hi = min(len, off + t_last + 1);
  const int k_lo = window > 0 ? max(0, off + t_first - window + 1) : 0;
  const int kb0 = (k_lo / kBK) * kBK;
  const int ntiles = k_hi > kb0 ? (k_hi - kb0 + kBK - 1) / kBK : 0;

  // Q rows (packed), zero past P.
  for (int c = tid; c < kBM * CPR; c += kTcThreads) {
    const int r = c / CPR, col = (c % CPR) * 8, p = p0 + r;
    const bool ok = p < P;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * Sq + p / G) * Hq + hk * G + p % G) * D + col
           : q;
    cp_async16(sQ + r * LD + col, src, ok);
  }
  const size_t kv_base = ((size_t)b * Skv * Hkv + hk) * D;
  auto load_tile = [&](int kb, int stage) {
    __nv_bfloat16* dk = sKV + (size_t)stage * 2 * kBK * LD;
    __nv_bfloat16* dv = dk + kBK * LD;
    for (int c = tid; c < kBK * CPR; c += kTcThreads) {
      const int r = c / CPR, col = (c % CPR) * 8, kp = kb + r;
      const bool ok = kp >= k_lo && kp < k_hi;
      const size_t o = ok ? kv_base + (size_t)kp * Hkv * D + col : 0;
      cp_async16(dk + r * LD + col, k + o, ok);
      cp_async16(dv + r * LD + col, v + o, ok);
    }
  };
  if (ntiles > 0) load_tile(kb0, 0);
  cp_async_commit();

  // This thread's two rows of the warp's 16: r0 = lane / 4 and r0 + 8.
  const int rw = warp * 16;
  const int pr[2] = {p0 + rw + (lane >> 2), p0 + rw + (lane >> 2) + 8};
  const int qpos[2] = {off + pr[0] / G, off + pr[1] / G};
  // The warp's token range, for the whole-tile visibility test.
  const int wp_lo = min(p0 + rw, P - 1), wp_hi = min(p0 + rw + 15, P - 1);
  const int wq_lo = off + wp_lo / G, wq_hi = off + wp_hi / G;
  const float qk_scale = softcap > 0.f ? scale : scale * kLog2e;

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // This warp's Q fragment for k-step ks, from shared memory.
  auto q_frag = [&](int ks, uint32_t (&r)[4]) {
    ldsm_x4(r, sQ + (rw + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   ks * 16 + (lane >> 4) * 8);
  };
  uint32_t qf[kQInRegs ? KS : 1][4];

  for (int it = 0; it < ntiles; ++it) {
    const int kb = kb0 + it * kBK;
    if (it + 1 < ntiles) {
      load_tile(kb + kBK, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and Q) landed for every thread
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) q_frag(ks, qf[ks]);
      }
    }
    const __nv_bfloat16* sK = sKV + (size_t)(it & 1) * 2 * kBK * LD;
    const __nv_bfloat16* sV = sK + kBK * LD;

    // S = Q K^T, (16 rows x 64 keys) per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        q_frag(ks, a);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // scale (log2 domain), softcap, mask; element e of n-tile j is row
    // pr[e / 2], key kb + 8 j + 2 (lane % 4) + e % 2
    const bool full = kb + kBK - 1 <= wq_lo && kb + kBK <= len &&
                      (window <= 0 || kb > wq_hi - window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * qk_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap) * kLog2e;
        if (!full) {
          const int kp = kb + j * 8 + (lane & 3) * 2 + (e & 1);
          const int qp = qpos[e >> 1];
          const bool vis = kp <= qp && kp < len &&
                           (window <= 0 || kp > qp - window);
          x = vis ? x : kNegInf;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragment
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = exp2f(m[h] - mx);
      m[h] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * alpha[h] + rs[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P as bf16 hi + lo straight from the score fragment
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      float r0, r1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* src = s[2 * kk + (i >> 1)] + (i & 1) * 2;
        ph[i] = pack_bf16(src[0], src[1], r0, r1);
        pl[i] = pack_bf16(r0, r1);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, sV + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LD +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, bf[0], bf[1]);
        mma_bf16(o[2 * dp], pl, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], ph, bf[2], bf[3]);
        mma_bf16(o[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = pr[h];
    if (p >= P) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * Sq + p / G) * Hq + hk * G + p % G) * D;
    if (m[h] == kNegInf) {
      // no visible key: the plain version's softmax is uniform over Skv
      for (int j = 0; j < DT; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        float s0 = 0.f, s1 = 0.f;
        for (int kp = 0; kp < Skv; ++kp) {
          const __nv_bfloat16* vr = v + kv_base + (size_t)kp * Hkv * D + c;
          s0 += __bfloat162float(vr[0]);
          s1 += __bfloat162float(vr[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(s0 / (float)Skv, s1 / (float)Skv);
      }
    } else {
      const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + (lane & 3) * 2) =
            __floats2bfloat162_rn(o[j][2 * h] / den, o[j][2 * h + 1] / den);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* offset,
              const void* lengths, void* out, int B, int Sq, int Skv, int Hq,
              int Hkv, int window, float softcap, float scale,
              cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tc_smem_bytes<D>());
  if (attr != cudaSuccess) return (int)attr;
  const int P = Sq * (Hq / Hkv);
  const dim3 grid((P + kBM - 1) / kBM, Hkv, B);
  prefill_tc_kernel<D><<<grid, kTcThreads, tc_smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(offset),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Sq,
      Skv, Hq, Hkv, window, softcap, scale);
  return (int)cudaGetLastError();
}

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

template <bool TC>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* offset, const void* lengths, void* out, int B,
               int Sq, int Skv, int Hq, int Hkv, int window, float softcap,
               float scale, cudaStream_t s) {
#define REPRO_PREFILL_CASE(DD)                                               \
  case DD:                                                                   \
    return TC ? launch_tc<DD>(q, k, v, offset, lengths, out, B, Sq, Skv, Hq, \
                              Hkv, window, softcap, scale, s)                \
              : launch_f32<DD>(q, k, v, offset, lengths, out, B, Sq, Skv,    \
                               Hq, Hkv, window, softcap, scale, s);
  switch (D) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
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

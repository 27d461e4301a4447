// Chunk-parallel RWKV-6 (WKV6) recurrence for Hopper (sm_90a), CUDA cores,
// f32.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (_kernel, launched by
// pl.pallas_call at :89 through kernels/ops.py wkv6_op).  Per (batch b,
// head h), with state S (K x K, key rows i, value columns j) and per-token
// r, k, v, w (K each), u (K):
//
//   y_t = r_t (S + u k_t (x) v_t),      S <- w_t . S + k_t (x) v_t
//
// computed C tokens (a chunk) at a time.  With L_t = sum_{r<=t} log w_r
// inside the chunk (L_{-1} = 0) and S0 the state entering it:
//
//   y_t   = (r_t e^{L_{t-1}}) S0
//         + sum_{s<t} [sum_i r_t,i k_s,i e^{L_{t-1},i - L_s,i}] v_s
//         + (r_t . u . k_t) v_t
//   S_out = e^{L_C-1} . S0 + sum_s (k_s e^{L_C-1 - L_s}) (x) v_s
//
// Every exponent is a sum of log w <= 0 over a range of tokens, so no
// factor exceeds 1 and nothing overflows, whatever the chunk length or the
// decay: the pairwise decay e^{L_{t-1} - L_s} is computed directly (as
// 2^(difference of log2 prefixes)), not as the TPU kernel's product
// e^{L_{t-1}} e^{-L_s}.
//
// Layout: r, k, v, w, y (B, S, H, K) contiguous, read in place through the
// token stride H * K; u (H, K); s0, sT (B, H, K, K).  Positions past S read
// as w = 1, k = r = v = 0, which leaves the state as it is.
//
// What bounds it: every input is read once and y written once for about
// 2 (C + K) flops per output and 2 C per state element, so at the main-path
// shape (B=1, S=1024, H=40, K=64, C=16) it is bound by bytes (about 54 MB
// at 3.35 TB/s, 0.016 ms).  A sequential walk over the chunks cannot get
// near that: 64 chunks in series per head at B = 1.  So the sequence is cut
// into segments of T tokens, a whole number of chunks (kernels/ops.py
// wkv6_segment: 64 tokens, 16 segments at the main shape), and one C call
// runs three kernels back to back:
//
//  1. wkv6_segment_kernel, grid (nseg - 1, H, B): for every
//     segment but the last, its total decay e^{L_last} (K values) and its
//     own state contribution dS = sum_s (k_s e^{L_last - L_s}) (x) v_s: the
//     chunk walk below from a zero state, without the outputs.  Into
//     scratch, (B, H, nseg - 1, K * K + K) floats.
//  2. wkv6_scan_kernel, a thread per (b, h, i, j): S_{g+1} = e^{L_last,g}
//     . S_g + dS_g from s0, in segment order, writing the state entering
//     each segment over dS_g.  No atomics: two calls are bit-equal.
//  3. wkv6_output_kernel, grid (nseg, H, B): each segment's
//     outputs, chunk by chunk with the arithmetic above, from its entering
//     state; the last segment also carries its state to sT.
//
// Inside a block: 256 threads own all K value columns of the head, so the
// C x C scores are computed once per chunk and head.  r, k, w, v tiles come
// by 16-byte cp.async, the next chunk's in flight during this one's math
// (two stages).  The log2 prefix of w runs four threads per channel with a
// shuffle scan; the state lives in registers (a 4 x 4 block per thread) and
// a copy in shared memory for the y product; four barriers per chunk (two
// in pass 1).  f32 throughout (TF32 would break the reference's 2e-4); the
// pairwise decays use the approximate ex2 (relative error ~2^-22).
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMaxSegment = 64;

struct WkvParams {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* sT;
  float* ws;  // (B, H, nseg - 1, K * K + K): dS, then the entering state; decay
  int B, S, H, C, T, nseg;
};

// Row stride (floats) of a (rows, K) tile in shared memory: 16-byte rows for
// cp.async and float4 reads, and not a multiple of 32 banks.
template <int K>
__host__ __device__ constexpr int row_stride() {
  return K + 4;
}

// Shared memory of chunk_walk<K, OUT> for chunks of C tokens: two
// stages of the (C, K) tiles (r, k, w, v; without r for pass 1), k', the
// chunk's decay and u; for the outputs also r' transposed (K, C + 1), the
// state (K, K) and the scores (C, C + 1).
template <int K, bool OUT>
__host__ __device__ constexpr size_t chunks_smem_floats(int C) {
  return (size_t)(2 * (OUT ? 4 : 3) + 1) * C * row_stride<K>() + 2 * K +
         (OUT ? (size_t)K * (C + 1) + K * K + C * (C + 1) : 0);
}

__device__ __forceinline__ float fast_exp2(float x) {  // rel. err. ~2^-22
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows g0 .. g0 + n - 1 of x's (b, h) slice into dst (stride row_stride);
// rows at or past S are zero-filled without being read.
template <int K>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ x,
                                          const WkvParams& p, int b, int h,
                                          int g0, int n) {
  constexpr int CPR = K / 4, KS = row_stride<K>();
  for (int c = threadIdx.x; c < n * CPR; c += kThreads) {
    const int t = c / CPR, col = (c % CPR) * 4, g = g0 + t;
    const bool ok = g < p.S;
    const float* src = ok ? x + (((size_t)b * p.S + g) * p.H + h) * K + col : x;
    cp_async16(dst + t * KS + col, src, ok);
  }
}

// Called by threads 0 .. 4K - 1 (whole warps): four threads per channel
// i = tid / 4, each over a quarter of the n rows of sw, which holds raw w.
// Replaces sw by the inclusive prefix L of log2 w over the rows; rows at or
// past `valid` count as w = 1.  Calls f(t, L_{t-1}, L_t, L_{n-1}) for each
// of the thread's rows t and returns L_{n-1}.
template <int K, typename F>
__device__ __forceinline__ float log2_prefix(float* sw, int n, int valid,
                                             F f) {
  constexpr int KS = row_stride<K>();
  const int i = threadIdx.x >> 2, tg = threadIdx.x & 3;
  const int per = (n + 3) >> 2, t0 = tg * per, t1 = min(n, t0 + per);
  float run = 0.f;
  for (int t = t0; t < t1; ++t) {
    run += t < valid ? log2f(fmaxf(sw[t * KS + i], 1e-38f)) : 0.f;
    sw[t * KS + i] = run;
  }
  float incl = run;  // scan of the four quarters' sums
  float x = __shfl_up_sync(0xffffffffu, incl, 1, 4);
  if (tg >= 1) incl += x;
  x = __shfl_up_sync(0xffffffffu, incl, 2, 4);
  if (tg >= 2) incl += x;
  const float total = __shfl_sync(0xffffffffu, incl, 3, 4);
  float before = incl - run;
  for (int t = t0; t < t1; ++t) {
    const float upto = (incl - run) + sw[t * KS + i];
    sw[t * KS + i] = upto;
    f(t, before, upto, total);
    before = upto;
  }
  return total;
}

// The body of passes 1 (OUT = false) and 3 (OUT = true), grid (segments,
// H, B): a walk over segment g's chunks carrying the state in registers
// (thread tid < (K/4)^2 owns rows i0 .. i0 + 3, columns j0 .. j0 + 3).
//  * Pass 1 starts from a zero state, runs every segment but the last, and
//    writes the state at its end (dS) and its total decay to scratch.
//  * Pass 3 starts from the segment's entering state (s0, or the scan's
//    slot g - 1), writes y, and carries the last segment's state to sT.
template <int K, bool OUT>
__device__ __forceinline__ void chunk_walk(const WkvParams& p) {
  constexpr int KS = row_stride<K>(), Q = K / 4, NA = OUT ? 4 : 3;
  const int C = p.C, CA = C + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);  // 2 x ([r,] k, w, v)
  float* sKp = tiles + 2 * NA * C * KS;  // k_s e^{L_C-1 - L_s}
  float* sDec = sKp + C * KS;            // e^{L_C-1}
  float* sU = sDec + K;
  float* sRpT = sU + K;                  // r_t e^{L_{t-1}}, as (i, t)
  float* sS = sRpT + K * CA;             // the state entering the chunk
  float* sA = sS + K * K;                // scores (t, s) for s <= t

  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g0 = g * p.T, g1 = min(p.S, g0 + p.T);
  const bool last = g == p.nseg - 1;
  const size_t bh = (size_t)b * p.H + h;
  float* slot = p.ws + (bh * (p.nseg - 1) + g) * (K * K + K);
  const bool owner = tid < Q * Q;
  const int i0 = (tid / Q) * 4, j0 = (tid % Q) * 4;
  float st[4][4] = {};
  if (OUT && owner) {
    const float* s_in = g == 0 ? p.s0 + bh * K * K : slot - (K * K + K);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x =
          *reinterpret_cast<const float4*>(s_in + (i0 + a) * K + j0);
      st[a][0] = x.x;
      st[a][1] = x.y;
      st[a][2] = x.z;
      st[a][3] = x.w;
    }
  }
  if (OUT)
    for (int i = tid; i < K; i += kThreads) sU[i] = p.u[(size_t)h * K + i];

  auto load_chunk = [&](int c0, int stage) {
    float* d = tiles + stage * NA * C * KS;
    if (OUT) {
      load_rows<K>(d, p.r, p, b, h, c0, C);
      d += C * KS;
    }
    load_rows<K>(d, p.k, p, b, h, c0, C);
    load_rows<K>(d + C * KS, p.w, p, b, h, c0, C);
    load_rows<K>(d + 2 * C * KS, p.v, p, b, h, c0, C);
  };
  const int nchunks = (g1 - g0 + C - 1) / C;
  float log_decay = 0.f;  // pass 1: the segment's log2 decay so far
  load_chunk(g0, 0);
  cp_async_commit();
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = g0 + ci * C;
    if (ci + 1 < nchunks) {
      load_chunk(c0 + C, (ci + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ci landed; the previous chunk is consumed
    float* sR = tiles + (ci & 1) * NA * C * KS;  // pass 3 only
    float* sK = OUT ? sR + C * KS : sR;
    float* sW = sK + C * KS;  // w, then the log2 prefix L
    float* sV = sW + C * KS;
    const int valid = min(C, g1 - c0);
    if (OUT && owner) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(sS + (i0 + a) * K + j0) =
            make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
    }
    if (tid < 4 * K) {  // log2 prefix of w; r', k', the chunk's decay
      const int i = tid >> 2;
      const float total = log2_prefix<K>(
          sW, C, valid, [&](int t, float before, float upto, float all) {
            if (OUT) sRpT[i * CA + t] = sR[t * KS + i] * fast_exp2(before);
            sKp[t * KS + i] = sK[t * KS + i] * fast_exp2(all - upto);
          });
      if ((tid & 3) == 0) sDec[i] = fast_exp2(total);
      log_decay += total;
    }
    __syncthreads();
    if (OUT) {
      // scores: the C (C + 1) / 2 pairs s <= t, one per thread
      for (int idx = tid; idx < C * (C + 1) / 2; idx += kThreads) {
        int t = (int)((sqrtf(8.f * idx + 1.f) - 1.f) * 0.5f);
        while (t * (t + 1) / 2 > idx) --t;
        while ((t + 1) * (t + 2) / 2 <= idx) ++t;
        const int s = idx - t * (t + 1) / 2;
        const float* rt = sR + t * KS;
        const float* ks = sK + s * KS;
        float a = 0.f;
        if (s < t) {
          const float* lp = sW + (t - 1) * KS;
          const float* ls = sW + s * KS;
#pragma unroll 8
          for (int i = 0; i < K; ++i)
            a = fmaf(rt[i] * ks[i], fast_exp2(lp[i] - ls[i]), a);
        } else {
#pragma unroll 8
          for (int i = 0; i < K; ++i) a = fmaf(rt[i] * sU[i], ks[i], a);
        }
        sA[t * CA + s] = a;
      }
      __syncthreads();
      // y: four columns of one row per thread, the rows of a chunk on
      // neighbouring lanes (so they share each load of the state)
      for (int idx = tid; idx < C * Q; idx += kThreads) {
        const int t = idx % C, j = (idx / C) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int i = 0; i < K; ++i) {
          const float x = sRpT[i * CA + t];
          const float4 sq = *reinterpret_cast<const float4*>(sS + i * K + j);
          acc.x = fmaf(x, sq.x, acc.x);
          acc.y = fmaf(x, sq.y, acc.y);
          acc.z = fmaf(x, sq.z, acc.z);
          acc.w = fmaf(x, sq.w, acc.w);
        }
        for (int s = 0; s < C; ++s) {
          const float x = s <= t ? sA[t * CA + s] : 0.f;
          const float4 vq = *reinterpret_cast<const float4*>(sV + s * KS + j);
          acc.x = fmaf(x, vq.x, acc.x);
          acc.y = fmaf(x, vq.y, acc.y);
          acc.z = fmaf(x, vq.z, acc.z);
          acc.w = fmaf(x, vq.w, acc.w);
        }
        if (t < valid)
          *reinterpret_cast<float4*>(
              p.y + (((size_t)b * p.S + c0 + t) * p.H + h) * K + j) = acc;
      }
    }
    // the state after the chunk (in pass 3, after a segment's last chunk
    // only for the last segment: the scan gave the others' next state)
    if (owner && (!OUT || last || ci + 1 < nchunks)) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = sDec[i0 + a];
#pragma unroll
        for (int c = 0; c < 4; ++c) st[a][c] *= d;
      }
      for (int s = 0; s < C; ++s) {
        const float4 kq = *reinterpret_cast<const float4*>(sKp + s * KS + i0);
        const float4 vq = *reinterpret_cast<const float4*>(sV + s * KS + j0);
        const float ka[4] = {kq.x, kq.y, kq.z, kq.w};
        const float va[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[a][c] = fmaf(ka[a], va[c], st[a][c]);
      }
    }
    __syncthreads();  // this stage, the scores and sS are consumed
  }
  float* dst = OUT ? (last ? p.sT + bh * K * K : nullptr) : slot;
  if (dst && owner) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(dst + (i0 + a) * K + j0) =
          make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
  }
  if (!OUT && tid < 4 * K && (tid & 3) == 0)
    slot[K * K + (tid >> 2)] = exp2f(log_decay);
}

// Passes 1 and 3 under their own names, so a profile tells them apart.
template <int K>
__global__ void __launch_bounds__(kThreads)
    wkv6_segment_kernel(const WkvParams p) {
  chunk_walk<K, false>(p);
}
template <int K>
__global__ void __launch_bounds__(kThreads)
    wkv6_output_kernel(const WkvParams p) {
  chunk_walk<K, true>(p);
}

// Pass 2: the scan over segments, one thread per state element.
template <int K>
__global__ void __launch_bounds__(kThreads) wkv6_scan_kernel(const WkvParams p) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)p.B * p.H * K * K) return;
  const int bh = (int)(e / (K * K)), ij = (int)(e % (K * K)), i = ij / K;
  float s = p.s0[e];
  float* slot = p.ws + (size_t)bh * (p.nseg - 1) * (K * K + K);
  for (int g = 0; g < p.nseg - 1; ++g, slot += K * K + K) {
    s = fmaf(slot[K * K + i], s, slot[ij]);
    slot[ij] = s;  // the state entering segment g + 1
  }
}

template <int K>
int launch(const WkvParams& p, cudaStream_t stream) {
  // Once per instantiation: allow the most shared memory any chunk takes.
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      wkv6_segment_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * chunks_smem_floats<K, false>(kMaxChunk)));
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      wkv6_output_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * chunks_smem_floats<K, true>(kMaxChunk)));
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr3 != cudaSuccess) return (int)attr3;
  cudaError_t err;
  if (p.nseg > 1) {
    wkv6_segment_kernel<K>
        <<<dim3(p.nseg - 1, p.H, p.B), kThreads,
           sizeof(float) * chunks_smem_floats<K, false>(p.C), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t n = (size_t)p.B * p.H * K * K;
    wkv6_scan_kernel<K>
        <<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  wkv6_output_kernel<K>
      <<<dim3(p.nseg, p.H, p.B), kThreads,
         sizeof(float) * chunks_smem_floats<K, true>(p.C), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launches (0 = launched), or -1 for an
// unsupported head dim, chunk or segment length.  ws is scratch of
// (nseg - 1) * B * H * (K * K + K) floats, nseg = ceil(S / segment); unused
// (may be null) when nseg == 1.
extern "C" int wkv6(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* s0, void* y, void* sT, void* ws,
                    int B, int S, int H, int K, int chunk, int segment,
                    void* stream) {
  using namespace repro_torch;
  if (chunk < 1 || chunk > kMaxChunk || S < 1 || B < 1 || H < 1) return -1;
  if (segment < chunk || segment % chunk || segment > kMaxSegment) return -1;
  WkvParams p{};
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = static_cast<float*>(y);
  p.sT = static_cast<float*>(sT);
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.S = S;
  p.H = H;
  p.C = chunk;
  p.T = segment;
  p.nseg = (S + segment - 1) / segment;
  if (p.nseg > 1 && p.ws == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 8:
      return launch<8>(p, s);
    case 16:
      return launch<16>(p, s);
    case 32:
      return launch<32>(p, s);
    case 64:
      return launch<64>(p, s);
    default:
      return -1;
  }
}

// Chunked RWKV-6 (WKV6) recurrence for Hopper (sm_90a), CUDA cores, f32.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (_kernel, launched by
// pl.pallas_call at :89 through kernels/ops.py wkv6_op).  Per (batch b,
// head h), with state S (K x K, key rows i, value columns j) and per-token
// r, k, v, w (K each), u (K):
//
//   y_t = r_t (S + u k_t (x) v_t),      S <- w_t . S + k_t (x) v_t
//
// computed C tokens at a time.  With L_t = sum_{r<=t} log w_r inside the
// chunk (L_{-1} = 0) and S0 the state entering it:
//
//   y_t   = (r_t e^{L_{t-1}}) S0
//         + sum_{s<t} [sum_i r_t,i k_s,i e^{L_{t-1},i - L_s,i}] v_s
//         + (r_t . u . k_t) v_t
//   S_out = e^{L_C-1} . S0 + sum_s (k_s e^{L_C-1 - L_s}) (x) v_s
//
// Every exponent here is a sum of log w <= 0 over a range of tokens, so no
// factor exceeds 1 and nothing overflows, whatever the chunk length or the
// decay: the pairwise decay e^{L_{t-1} - L_s} is computed directly, not as
// the TPU kernel's product e^{L_{t-1}} e^{-L_s}.
//
// Layout: r, k, v, w, y (B, S, H, K) contiguous, read in place through the
// token stride H * K (no transposed or padded copies); u (H, K); s0, sT
// (B, H, K, K).  A ragged last chunk is masked here: positions past S read
// as w = 1, k = r = v = 0, which leaves the state as it is.
//
// What bounds it: every input is read once and y written once for about
// 2 (C + K) flops per output and 2 C per state element, so at the main-path
// shape (B=1, S=1024, H=40, K=64, C=16) it is bound by bytes (about 54 MB
// at 3.35 TB/s, 0.016 ms).  What the design does about it: the state never
// leaves the chip between chunks (a slice of it lives in shared memory for
// the whole sequence, the TPU kernel's VMEM scratch), and the sequential
// chunk axis of the TPU grid becomes a loop inside the block.  The value
// columns of the state are independent, so each block owns JB = 16 of them:
// grid (H, K / JB, B), 160 blocks at the prefiller's B = 1 on 132 SMs
// (one block per (b, h) would leave 92 SMs idle).  The r, k, w tiles and
// the C x C scores are recomputed by each of a head's K / JB blocks; those
// re-reads come from L2.  Loads are not overlapped with compute yet.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;

template <int K>
struct Dims {
  static constexpr int JB = K < 16 ? K : 16;  // value columns per block
  static constexpr int KP = K + 1;            // padded row of a (C, K) tile
};

template <int K>
size_t smem_floats(int C) {
  using D = Dims<K>;
  // sR, sK, sL (C, KP); sV (C, JB); sA (C, C); sS (K, JB); sU (K)
  return 3 * (size_t)C * D::KP + (size_t)C * D::JB + (size_t)C * C +
         (size_t)K * D::JB + K;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sT, int S, int H,
                int C) {
  constexpr int JB = Dims<K>::JB, KP = Dims<K>::KP;
  extern __shared__ float smem[];
  float* sR = smem;           // r, then r e^{L_{t-1}}
  float* sK = sR + C * KP;    // k, then k e^{L_C-1 - L_s}
  float* sL = sK + C * KP;    // log w, then its inclusive prefix L
  float* sV = sL + C * KP;    // this block's value columns of v
  float* sA = sV + C * JB;    // intra-chunk scores, (t, s) for s <= t
  float* sS = sA + C * C;     // this block's state columns, (K, JB)
  float* sU = sS + K * JB;

  const int h = blockIdx.x, j0 = blockIdx.y * JB, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t tok = (size_t)H * K;  // stride between tokens
  const size_t head = (size_t)b * S * tok + (size_t)h * K;
  const size_t st = ((size_t)b * H + h) * K * K;

  for (int i = tid; i < K * JB; i += THREADS)
    sS[i] = s0[st + (size_t)(i / JB) * K + j0 + i % JB];
  for (int i = tid; i < K; i += THREADS) sU[i] = u[(size_t)h * K + i];

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // state init done / previous chunk consumed the tiles
    for (int i = tid; i < C * K; i += THREADS) {
      const int t = i / K, c = i % K, g = c0 + t;
      float rv = 0.f, kv = 0.f, lw = 0.f;  // past S: w = 1, k = r = 0
      if (g < S) {
        const size_t o = head + (size_t)g * tok + c;
        rv = r[o];
        kv = k[o];
        lw = logf(fmaxf(w[o], 1e-38f));
      }
      sR[t * KP + c] = rv;
      sK[t * KP + c] = kv;
      sL[t * KP + c] = lw;
    }
    for (int i = tid; i < C * JB; i += THREADS) {
      const int t = i / JB, g = c0 + t;
      sV[i] = g < S ? v[head + (size_t)g * tok + j0 + i % JB] : 0.f;
    }
    __syncthreads();
    for (int c = tid; c < K; c += THREADS) {  // L_t, inclusive prefix
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += sL[t * KP + c];
        sL[t * KP + c] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < C * C; i += THREADS) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      if (s < t) {
        const float* lp = sL + (t - 1) * KP;
        const float* ls = sL + s * KP;
#pragma unroll 8
        for (int c = 0; c < K; ++c)
          a = fmaf(sR[t * KP + c] * sK[s * KP + c], expf(lp[c] - ls[c]), a);
      } else if (s == t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c)
          a = fmaf(sR[t * KP + c] * sU[c], sK[t * KP + c], a);
      }
      sA[i] = a;
    }
    __syncthreads();
    const float* lc = sL + (C - 1) * KP;  // L_C-1 (padding adds log 1 = 0)
    for (int i = tid; i < C * K; i += THREADS) {
      const int t = i / K, c = i % K;
      const float lprev = t > 0 ? sL[(t - 1) * KP + c] : 0.f;
      sR[t * KP + c] *= expf(lprev);
      sK[t * KP + c] *= expf(lc[c] - sL[t * KP + c]);
    }
    __syncthreads();
    for (int i = tid; i < C * JB; i += THREADS) {
      const int t = i / JB, jj = i % JB, g = c0 + t;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < K; ++c) acc = fmaf(sR[t * KP + c], sS[c * JB + jj], acc);
      for (int s = 0; s <= t; ++s) acc = fmaf(sA[t * C + s], sV[s * JB + jj], acc);
      if (g < S) y[head + (size_t)g * tok + j0 + jj] = acc;
    }
    __syncthreads();  // every read of the old state is done
    for (int i = tid; i < K * JB; i += THREADS) {
      const int c = i / JB, jj = i % JB;
      float acc = expf(lc[c]) * sS[i];
      for (int s = 0; s < C; ++s)
        acc = fmaf(sK[s * KP + c], sV[s * JB + jj], acc);
      sS[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * JB; i += THREADS)
    sT[st + (size_t)(i / JB) * K + j0 + i % JB] = sS[i];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B, int S,
           int H, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<K>(C);
  if (smem > 227 * 1024) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, K / Dims<K>::JB, B);
  wkv6_kernel<K><<<grid, THREADS, smem, stream>>>(r, k, v, w, u, s0, y, sT, S,
                                                  H, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch (0 = launched), or -1 for an
// unsupported head dim or chunk length.
extern "C" int wkv6(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* s0, void* y, void* sT, int B,
                    int S, int H, int K, int chunk, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > 64 || S < 1) return -1;
  const float* fr = static_cast<const float*>(r);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fw = static_cast<const float*>(w);
  const float* fu = static_cast<const float*>(u);
  const float* fs = static_cast<const float*>(s0);
  float* fy = static_cast<float*>(y);
  float* fT = static_cast<float*>(sT);
  switch (K) {
    case 8:
      return launch<8>(fr, fk, fv, fw, fu, fs, fy, fT, B, S, H, chunk, s);
    case 16:
      return launch<16>(fr, fk, fv, fw, fu, fs, fy, fT, B, S, H, chunk, s);
    case 32:
      return launch<32>(fr, fk, fv, fw, fu, fs, fy, fT, B, S, H, chunk, s);
    case 64:
      return launch<64>(fr, fk, fv, fw, fu, fs, fy, fT, B, S, H, chunk, s);
    default:
      return -1;
  }
}

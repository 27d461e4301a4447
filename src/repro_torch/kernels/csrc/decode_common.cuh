// Split-KV (flash-decoding) decode attention for Hopper (sm_90a): the device
// and launch code that decode_attention.cu and paged_decode_attention.cu
// share.  CUDA cores, f32 math.
//
// One new query token per request attends the live positions [lo, hi] of its
// cache: hi = min(cur_len, P - 1), lo = max(0, cur_len - window + 1) with a
// window, else 0; P is the cache length, or MB * BS positions of pages.  The
// cache may be one slice of a longer one, whose local row 0 is absolute
// position pos0 (0 for a whole cache): [lo, hi] is then the absolute range
// intersected with [pos0, pos0 + P), in local rows, and may be empty.  Two
// kernels run back to back on one stream, launched by one C call:
//
//  1. decode_split_kernel, grid (Hkv * gchunks, B, nsplit).  Block (h, b, s)
//     reduces the positions [s * split, (s + 1) * split) ∩ [lo, hi] of kv
//     head h for up to GMAX query heads of its group, and writes the
//     unnormalised partial o (f32) with its running max m and sum l (log2
//     domain) to scratch.  A block whose split misses [lo, hi] returns at
//     once.  With nsplit == 1 it writes the normalised output itself and the
//     second kernel is not launched.
//  2. decode_combine_kernel merges, for each (b, query head, d), the
//     partials of the splits that meet [lo, hi], which it works out again
//     from cur_lens (so a split that returned early is never read), by the
//     log-sum-exp rule, in split order.  No atomics: two calls on the same
//     inputs are bit-equal.
//
// With `lse` set (a slice's partial, to be merged across slices by the
// caller) the output is f32 whatever the input type, and each (b, query head)
// also gets lse = ln(sum of exp(score)) over its live keys, natural base; a
// row with no live key gets o = 0 and lse = -inf.
//
// Inside a split: K/V tiles of TR rows stay in their input type in a ring of
// kStages shared-memory slots, filled by 16-byte cp.async (.cg, L2 only), and
// are converted to f32 at use.  Q lives in registers.  Each warp takes its
// own rows of every tile (up to a warp's 32 lanes per row, 16 bytes or, for
// f32 at D = 256, twice 16 bytes a lane) and keeps its own
// online softmax; the warps' states are merged once, at the end of the
// split, so the tile loop waits at one barrier per tile.  A row outside
// [lo, hi], or in an unallocated page, is never loaded (cp.async with source
// size 0 writes zeros) and weighs 0, so whatever is stored there, even NaN,
// cannot reach the result.
//
// The host picks `split` (kernels/ops.py decode_split) from P, B and Hkv
// alone, never from cur_lens, which lives on the device.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kSplitQuantum = 64;  // every split is a multiple (>= any tile)
constexpr int kSplitMax = 2048;    // bounds the paged row table
constexpr float kLn2 = 0.6931471805599453f;

struct DecodeParams {
  const void* q;        // (B, Hq, D)
  const void* k;        // (B, L, Hkv, D), or the pool (NB, BS, Hkv, D)
  const void* v;
  const int* cur_lens;  // (B,)
  const int* tables;    // paged: (B, MB) page ids, -1 = unallocated
  void* out;            // (B, Hq, D): the input type, or f32 with lse
  float* lse;           // (B, Hq) f32, or null: a slice's partial (above)
  float* part_o;        // (B, Hq, nsplit, D)
  float* part_ml;       // (B, Hq, nsplit, 2): m, l
  int B, Hq, Hkv, D, G, gchunks;
  int P;                // positions: L, or MB * BS
  int MB, BS;
  int pos0;             // absolute position of local row 0
  int window;
  float softcap, scale;
  int split, nsplit;
};

// How a (TR, D) tile is cut: V elements per 16-byte chunk, CPR chunks per
// row, LPR lanes per row (at most a warp), CPL chunks per lane and row
// (W = CPL * V values), RPW rows per warp step, STEPS steps per warp and
// tile.  A tile has at least 32 rows (or one step of every warp) but holds
// at most 16 KB of K, so the 4-slot K/V ring stays at 128 KB at D = 256
// (bf16: 32 rows, 8 values a lane; f32: 16 rows, two chunks a lane).
template <typename T, int D>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CPR = D / V;
  static constexpr int LPR = CPR < 32 ? CPR : 32;
  static constexpr int CPL = CPR / LPR;
  static constexpr int W = CPL * V;
  static constexpr int RPW = 32 / LPR;
  static constexpr int CAP = 16384 / (D * (int)sizeof(T));
  static constexpr int TR0 = CAP < 32 ? CAP : 32;
  static constexpr int TR = RPW * kWarps > TR0 ? RPW * kWarps : TR0;
  static constexpr int STEPS = TR / (RPW * kWarps);
  static constexpr int CHUNKS = TR * CPR;  // 16-byte chunks of one K tile
  static constexpr int ELEMS = TR * D;
  static_assert(CPR % LPR == 0 && kSplitQuantum % TR == 0, "tile");
  static_assert(TR % (RPW * kWarps) == 0, "tile steps");
  static_assert(CHUNKS % kThreads == 0, "tile chunks");
};

// The K/V ring, which the warps' merge reuses after the tile loop; the
// paged row table (split ints) follows it.
template <typename T, int D, int GMAX>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)kStages * 2 * Tile<T, D>::ELEMS * sizeof(T) >
                 (size_t)kWarps * GMAX * (D + 2) * sizeof(float)
             ? (size_t)kStages * 2 * Tile<T, D>::ELEMS * sizeof(T)
             : (size_t)kWarps * GMAX * (D + 2) * sizeof(float);
}

template <typename T, int D, int GMAX, bool PAGED>
size_t smem_bytes(int split) {
  return ring_bytes<T, D, GMAX>() + (PAGED ? sizeof(int) * (size_t)split : 0);
}

// The live rows [lo, hi] of request b, local (empty when lo > hi).
__device__ __forceinline__ void live_range(const DecodeParams& p, int b,
                                           int& lo, int& hi) {
  const int cur = p.cur_lens[b];
  hi = min(cur, p.pos0 + p.P - 1) - p.pos0;
  lo = max(p.window > 0 ? cur - p.window + 1 : 0, p.pos0) - p.pos0;
}

// The normalised output of a (b, query head) with its m, l (log2 domain)
// and, for a slice's partial, its natural-base lse (-inf with no live key).
template <typename T>
__device__ __forceinline__ void write_out(const DecodeParams& p, size_t bh,
                                          int d, float O, float M, float Ls) {
  const float res = O / fmaxf(Ls, 1e-30f);
  if (p.lse == nullptr) {
    store(static_cast<T*>(p.out) + bh * p.D + d, res);
    return;
  }
  static_cast<float*>(p.out)[bh * p.D + d] = res;
  if (d == 0)
    p.lse[bh] = Ls > 0.f ? (M + log2f(Ls)) * kLn2 : __int_as_float(0xff800000);
}

template <typename T, int D, int GMAX, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const DecodeParams p) {
  using S = Tile<T, D>;
  constexpr int V = S::V, CPR = S::CPR, LPR = S::LPR, RPW = S::RPW;
  constexpr int CPL = S::CPL, W = S::W, TR = S::TR, STEPS = S::STEPS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int* rows = reinterpret_cast<int*>(smem + ring_bytes<T, D, GMAX>());

  const int hk = blockIdx.x / p.gchunks;
  const int g0 = (blockIdx.x % p.gchunks) * GMAX;
  const int gn = min(GMAX, p.G - g0);
  const int b = blockIdx.y, s0 = blockIdx.z * p.split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / LPR, li = lane % LPR;

  // This lane's columns of a row: chunks li + c * LPR, c < CPL, V values
  // each; value c * V + e of a lane's W is column col(c) + e.
  auto col = [&](int c) { return (li + c * LPR) * V; };
  // q's loads go out with cur_lens', before anything waits on either.
  float q[GMAX][W];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (g < gn) {
        unpack<T>(load16(static_cast<const T*>(p.q) +
                         ((size_t)b * p.Hq + hk * p.G + g0 + g) * D + col(c)),
                  q[g] + c * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) q[g][c * V + e] = 0.f;
      }
    }
  }
  int lo, hi;
  live_range(p, b, lo, hi);
  const int first = max(lo, s0), last = min(hi, s0 + p.split - 1);
  if (p.nsplit > 1 && first > last) return;  // the combine never reads it

  const T* __restrict__ K = static_cast<const T*>(p.k);
  const T* __restrict__ Vc = static_cast<const T*>(p.v);

  if constexpr (PAGED) {
    // Once per block, a warp per page: the page id is read once and its
    // base row computed once; each position of the split -> its pool row
    // (page * BS + offset), or -1 if it is not live or its page is -1.
    const int np = p.split / p.BS, pg0 = s0 / p.BS;
    for (int j = warp; j < np; j += kWarps) {
      const int page =
          pg0 + j < p.MB ? p.tables[(size_t)b * p.MB + pg0 + j] : -1;
      const int base = page * p.BS;
      for (int r = lane; r < p.BS; r += 32) {
        const int i = j * p.BS + r, pos = s0 + i;
        rows[i] = (page >= 0 && pos >= first && pos <= last) ? base + r : -1;
      }
    }
    __syncthreads();
  }
  // Row of position s0 + i in the (rows, Hkv, D) array, -1 = not loaded.
  auto row_index = [&](int i) -> int {
    if constexpr (PAGED) {
      return rows[i];
    } else {
      const int pos = s0 + i;
      return (pos >= first && pos <= last) ? b * p.P + pos : -1;
    }
  };

  float m[GMAX], l[GMAX], o[GMAX][W];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) o[g][e] = 0.f;
  }

  const int t0 = first <= last ? (first - s0) / TR : 0;
  const int nt = first <= last ? (last - s0) / TR - t0 + 1 : 0;
  auto load_tile = [&](int t, int slot) {
    T* dk = ring + (size_t)slot * 2 * S::ELEMS;
    T* dv = dk + S::ELEMS;
#pragma unroll
    for (int u = 0; u < S::CHUNKS / kThreads; ++u) {
      const int c = tid + u * kThreads;
      const int row = c / CPR, cc = (c % CPR) * V;
      const int ri = row_index(t * TR + row);
      const size_t off = ri >= 0 ? ((size_t)ri * p.Hkv + hk) * D + cc : 0;
      cp_async16(dk + row * D + cc, K + off, ri >= 0);
      cp_async16(dv + row * D + cc, Vc + off, ri >= 0);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_tile(t0 + st, st);
    cp_async_commit();
  }
  const float qk_scale = p.scale * (p.softcap > 0.f ? 1.f : kLog2e);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed for all; tile i - 1's slot is free
    if (i + kStages - 1 < nt)
      load_tile(t0 + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();

    const T* sk = ring + (size_t)(i % kStages) * 2 * S::ELEMS;
    const T* sv = sk + S::ELEMS;
    const int t = t0 + i;
    // All GMAX rows are computed, with no test on gn, so the compiler can
    // interleave the independent (step, row) chains; rows past gn have
    // q = 0 and are never written.
    float s[STEPS][GMAX];
    bool live[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int row = (warp * STEPS + j) * RPW + rg;
      live[j] = row_index(t * TR + row) >= 0;
      float kf[W];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        unpack<T>(*reinterpret_cast<const uint4*>(sk + row * D + col(c)),
                  kf + c * V);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) acc = fmaf(q[g][e], kf[e], acc);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        s[j][g] = acc * qk_scale;  // scores are kept in the log2 domain
      }
    }
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[j][g] = p.softcap * tanhf(s[j][g] / p.softcap) * kLog2e;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < STEPS; ++j)
        mx = fmaxf(mx, live[j] ? s[j][g] : kNegInf);
      const float alpha = exp2f(m[g] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        s[j][g] = live[j] ? exp2f(s[j][g] - mx) : 0.f;
        ps += s[j][g];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < W; ++e) o[g][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int row = (warp * STEPS + j) * RPW + rg;
      float vf[W];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        unpack<T>(*reinterpret_cast<const uint4*>(sv + row * D + col(c)),
                  vf + c * V);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int e = 0; e < W; ++e) o[g][e] = fmaf(s[j][g], vf[e], o[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // The RPW row groups of each warp hold states over different rows: merge
  // them across lanes; then lanes 0 .. LPR - 1 hold the warp's state.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mx), c = exp2f(mo - mx);
      l[g] = l[g] * a + lo2 * c;
#pragma unroll
      for (int e = 0; e < W; ++e)
        o[g][e] =
            o[g][e] * a + __shfl_xor_sync(0xffffffffu, o[g][e], off) * c;
      m[g] = mx;
    }
  }

  // Merge the warps' states through shared memory, warp 0 first.
  __syncthreads();  // every warp is done with the ring
  float* so = reinterpret_cast<float*>(smem);  // (kWarps, GMAX, D)
  float* sml = so + kWarps * GMAX * D;         // (kWarps, GMAX, 2)
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gn) {
        float* dst = so + (warp * GMAX + g) * D;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e) dst[col(c) + e] = o[g][c * V + e];
        if (li == 0) {
          sml[(warp * GMAX + g) * 2] = m[g];
          sml[(warp * GMAX + g) * 2 + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sml[(w * GMAX + g) * 2]);
    float O = 0.f, Ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sml[(w * GMAX + g) * 2] - M);
      Ls = fmaf(sml[(w * GMAX + g) * 2 + 1], c, Ls);
      O = fmaf(so[(w * GMAX + g) * D + d], c, O);
    }
    const size_t bh = (size_t)b * p.Hq + hk * p.G + g0 + g;
    if (p.nsplit == 1) {
      write_out<T>(p, bh, d, O, M, Ls);
    } else {
      const size_t ps = bh * p.nsplit + blockIdx.z;
      p.part_o[ps * D + d] = O;
      if (d == 0) {
        p.part_ml[ps * 2] = M;
        p.part_ml[ps * 2 + 1] = Ls;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const DecodeParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.B * p.Hq * p.D) return;
  const int d = i % p.D, bh = i / p.D, b = bh / p.Hq;
  int lo, hi;
  live_range(p, b, lo, hi);
  // no live key at all: O = Ls = 0, the plain version's 0 (and lse -inf)
  float M = kNegInf, O = 0.f, Ls = 0.f;
  if (lo <= hi) {
    const int f = lo / p.split, e = hi / p.split;
    const float* ml = p.part_ml + (size_t)bh * p.nsplit * 2;
    const float* po = p.part_o + (size_t)bh * p.nsplit * p.D + d;
    for (int s = f; s <= e; ++s) M = fmaxf(M, ml[2 * s]);
    for (int s = f; s <= e; ++s) {
      const float c = exp2f(ml[2 * s] - M);
      Ls = fmaf(ml[2 * s + 1], c, Ls);
      O = fmaf(po[(size_t)s * p.D], c, O);
    }
  }
  write_out<T>(p, bh, d, O, M, Ls);
}

template <typename T, int D, int GMAX, bool PAGED>
int launch_decode(const DecodeParams& p, cudaStream_t stream) {
  // Once per instantiation: allow the most shared memory any split takes.
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<T, D, GMAX, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, D, GMAX, PAGED>(kSplitMax));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.Hkv * p.gchunks, p.B, p.nsplit);
  decode_split_kernel<T, D, GMAX, PAGED>
      <<<grid, kThreads, smem_bytes<T, D, GMAX, PAGED>(p.split), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return (int)err;
  const int n = p.B * p.Hq * p.D;
  decode_combine_kernel<T>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int GMAX, bool PAGED>
int dispatch_decode_d(const DecodeParams& p, cudaStream_t s) {
  switch (p.D) {
    case 16:
      return launch_decode<T, 16, GMAX, PAGED>(p, s);
    case 32:
      return launch_decode<T, 32, GMAX, PAGED>(p, s);
    case 64:
      return launch_decode<T, 64, GMAX, PAGED>(p, s);
    case 128:
      return launch_decode<T, 128, GMAX, PAGED>(p, s);
    case 256:
      return launch_decode<T, 256, GMAX, PAGED>(p, s);
    default:
      return -1;
  }
}

// Checks the split, sizes the grid and launches; -1 for what the kernels do
// not take.  Groups of up to 4 query heads run with GMAX = 4; larger groups
// with GMAX = 8, in ceil(G / 8) blocks per kv head.
template <bool PAGED>
int dispatch_decode(int dtype, DecodeParams p, cudaStream_t s) {
  if (p.B <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv || p.P <= 0) return -1;
  if (p.split <= 0 || p.split % kSplitQuantum || p.split > kSplitMax)
    return -1;
  if (PAGED && (p.BS <= 0 || p.split % p.BS)) return -1;
  p.G = p.Hq / p.Hkv;
  const int gmax = p.G > 4 ? 8 : 4;
  p.gchunks = (p.G + gmax - 1) / gmax;
  p.nsplit = (p.P + p.split - 1) / p.split;
  if (p.nsplit > 1 && (p.part_o == nullptr || p.part_ml == nullptr))
    return -1;
  if (dtype == kF32)
    return gmax == 4 ? dispatch_decode_d<float, 4, PAGED>(p, s)
                     : dispatch_decode_d<float, 8, PAGED>(p, s);
  if (dtype == kBF16)
    return gmax == 4 ? dispatch_decode_d<__nv_bfloat16, 4, PAGED>(p, s)
                     : dispatch_decode_d<__nv_bfloat16, 8, PAGED>(p, s);
  return -1;
}

}  // namespace
}  // namespace repro_torch

// Split-KV (flash-decoding) decode attention for Hopper (sm_90a): the device
// and launch code that decode_attention.cu and paged_decode_attention.cu
// share.  The dtype picks the kernel: bf16 runs decode_tc_kernel (tensor
// cores), f32 runs decode_split_kernel (CUDA cores, f32 products: the
// reference's 2e-5 needs them, and TF32 keeps ~3 digits).
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py (_kernel
// :30, launched by pl.pallas_call at :97) and
// src/repro/kernels/paged_decode_attention.py (_kernel_with_prefetch :77 /
// _body :90, pallas_call at :47).
//
// What bounds it: the live keys' K and V, read once.  A key of a kv head is
// 4 D bytes of bf16 K and V for 4 G D flops, about G flops a byte, far below
// the tensor cores' ridge (~295), so the bound is bytes.  On CUDA cores the
// same products are 2 G' D f32 FMAs a key (G' the group padded to 4 or 8):
// at D = 128 and G' = 8, reading at 3.35 TB/s takes 13.4 T FMA/s, 40 % of
// the card's f32 rate before any unpacking, shuffle or exp2f, so such a
// kernel cannot come near its byte bound.  On tensor cores the products are
// under 1 % of the bf16 rate: the bf16 kernel moves them there, and keeps
// enough blocks and loads in flight to stream the keys.
//
// One new query token per request attends the live positions [lo, hi] of its
// cache: hi = min(cur_len, P - 1), lo = max(0, cur_len - window + 1) with a
// window, else 0; P is the cache length, or MB * BS positions of pages.  The
// cache may be one slice of a longer one, whose local row 0 is absolute
// position pos0 (0 for a whole cache): [lo, hi] is then the absolute range
// intersected with [pos0, pos0 + P), in local rows, and may be empty.  Two
// kernels run back to back on one stream, launched by one C call:
//
//  1. The split pass, grid (Hkv * gchunks, B, nsplit).  Block (h, b, s)
//     reduces the positions [s * split, (s + 1) * split) ∩ [lo, hi] of kv
//     head h for the query heads of its group (all of them, or a chunk of
//     a large group), and writes the unnormalised partial o (f32) with its
//     running max m and sum l (log2 domain) to scratch.  A block whose
//     split misses [lo, hi] returns at once.  With nsplit == 1 it writes
//     the normalised output itself and the second kernel is not launched.
//  2. decode_combine_kernel merges, for each (b, query head, d), the
//     partials of the splits that meet [lo, hi], which it works out again
//     from cur_lens (so a split that returned early is never read), by the
//     log-sum-exp rule, in split order.  No atomics: two calls on the same
//     inputs are bit-equal.
//
// With `lse` set (a slice's partial, to be merged across slices by the
// caller) the output is f32 whatever the input type, and each (b, query head)
// also gets lse = ln(sum of exp(score)) over its live keys, natural base; a
// row with no live key gets o = 0 and lse = -inf.  A row outside [lo, hi],
// or in an unallocated page, is never loaded (cp.async with source size 0
// writes zeros) and weighs 0, so whatever is stored there, even NaN, cannot
// reach the result.  PAGED is a template argument of each kernel: a block
// first turns its split's page ids into a table of pool rows in shared
// memory, then addresses rows through it exactly as the contiguous kernel
// addresses its cache, so the two compute in the same order.
//
// bf16 (decode_tc_kernel), mma.sync m16n8k16 (bf16 in, f32 accumulate):
//  * Keys on M ("swap AB").  A warp computes S^T = K Q^T for 16 keys (the
//    16 rows of the A tile, K by ldmatrix) and 8 query heads (the 8 columns
//    of B: Q^T in registers, loaded once).  The other design, the G heads
//    as the 16 rows of A, pads G <= 8 to 16 rows and holds O as 16 x D
//    accumulators a warp, 128 registers a lane at D = 256, half of them
//    padding; with heads on N, O^T is D x 8 (D / 4 registers a lane), Q^T
//    half as large, and every group of the model zoo (G = 1, 2, 4, 5, 7,
//    8) fits the one n-tile, so all cost the same.  8 < G <= 16 take two
//    n-tiles in one block (at D = 256 their Q^T is read from shared memory
//    at each k-step, to stay clear of spills); larger groups a block per
//    16 heads.
//  * The online softmax runs on the score fragment in the log2 domain
//    (scale * log2 e folded in, softcap before the max): a lane holds keys
//    lane / 4 and + 8 for heads 2 (lane % 4) and + 1; the max over the 16
//    keys is three xor shuffles, and the row sum stays a lane's partial
//    until the end of the split.
//  * P V: O^T (D x 8) += V^T P^T, V^T by ldmatrix.trans, P^T from the
//    score fragment packed to bf16 and transposed in registers by
//    movmatrix.  P is a hi + lo pair of bf16 (p_hi = bf16(p), p_lo =
//    bf16(p - p_hi)), two MMAs into one accumulator, as in the prefill
//    kernel: a single bf16 P errs by ~2^-9 |v| and fails the 2e-5 + 2 bf16
//    steps bound on outputs near zero (kernels/ref.py
//    decode_attention_split_p_ref shows both on the CPU).  The row sum
//    comes from the f32 P.
//  * Four warps a block.  A tile is KW blocks of 16 keys, and DW warps
//    share each block, each taking D / DW of O's columns (TcTile<D>: at
//    D <= 128 four blocks of 16 keys; at D = 256 two, with O^T split
//    between the warps of a pair, so a lane holds 32 accumulators, not
//    64).  Each key block keeps its own online softmax, and the blocks'
//    states are merged once, at the end of the split.  The tiles (K then
//    V, rows padded by 16 bytes so ldmatrix is free of bank conflicts)
//    stay bf16 in a ring of STAGES slots filled by 16-byte cp.async (.cg):
//    70 KB at D = 128 and 101 KB at D = 256, so an SM holds 3 and 2
//    blocks (kernels/ops.py decode_blocks_per_sm, held to the occupancy
//    calculator), which the split rule fills twice over.  On an H100
//    (PERF.md, chip_decode_sweep.py) blocks of one or two warps were
//    slower than four at the main path's shapes; four warps on a 64-key
//    tile at D = 256 would leave one block an SM.
//
// f32 (decode_split_kernel): K/V tiles of TR rows stay f32 in a ring of
// kStages shared-memory slots, filled by 16-byte cp.async, Q in registers.
// Each warp takes its own rows of every tile (up to a warp's 32 lanes per
// row, 16 bytes or, at D = 256, twice 16 bytes a lane) and keeps its own
// online softmax for up to GMAX query heads; the warps' states are merged
// once, at the end of the split, so the tile loop waits at one barrier per
// tile.
//
// The host picks `split` (kernels/ops.py decode_split) from P, B, Hkv and D
// alone, never from cur_lens, which lives on the device.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// f32 (decode_split_kernel)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
// bf16 (decode_tc_kernel; its tile shape is TcTile<D>)
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
// Every split is a whole number of the serving path's 128-position pages
// (so the paged and contiguous kernels cut any positions alike) and of
// every tile; kSplitMax bounds the paged row table.
constexpr int kSplitQuantum = 128;
constexpr int kSplitMax = 2048;
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
// (f32: 16 rows, two chunks a lane).
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

// How the bf16 kernel cuts a tile at head dim D: KW warps take 16 keys
// each, and DW warps share those 16 keys, each computing their scores and
// its own D / DW of O's columns; the ring holds STAGES tiles.  At D <= 128
// four warps take 64 keys and two tiles fit in 70 KB (3 blocks an SM); at
// D = 256 a tile of 64 keys would take 68 KB, so two pairs of warps take 32
// keys, and three tiles take 101 KB (2 blocks an SM, each with two tiles'
// loads in flight).
template <int D>
struct TcTile {
  static constexpr int DW = D > 128 ? 2 : 1;
  static constexpr int KW = kTcWarps / DW;
  static constexpr int KEYS = 16 * KW;
  static constexpr int STAGES = D > 128 ? 3 : 2;
  static_assert(kSplitQuantum % KEYS == 0 && (D / 16) % DW == 0, "tile");
};

// The bf16 kernel's shared memory: the K/V ring (STAGES slots of K then V,
// KEYS rows of D + 8 bf16 each), which the warps' merge reuses after the
// tile loop; Q's rows when Q^T is not held in registers; the paged row
// table (split ints).
template <int D, int NH>
__host__ __device__ constexpr bool tc_q_in_regs() {
  return (D / 16) * NH <= 16;  // Q^T: 2 (D / 16) NH registers a lane
}
template <int D>
__host__ __device__ constexpr size_t tc_ring_bytes() {
  return sizeof(__nv_bfloat16) * TcTile<D>::STAGES * 2 * TcTile<D>::KEYS *
         (D + 8);
}
template <int D, int NH>
__host__ __device__ constexpr size_t tc_q_bytes() {
  return tc_q_in_regs<D, NH>() ? 0 : sizeof(__nv_bfloat16) * 8 * NH * (D + 8);
}
template <int D, int NH, bool PAGED>
size_t tc_smem_bytes(int split) {
  return tc_ring_bytes<D>() + tc_q_bytes<D, NH>() +
         (PAGED ? sizeof(int) * (size_t)split : 0);
}

// Split pass, bf16, tensor cores (design at the top of this file): the
// query heads g0 .. g0 + 8 NH - 1 of kv head blockIdx.x / gchunks (those
// past the group are zero and never written).
template <int D, int NH, bool PAGED>
__global__ void __launch_bounds__(kTcThreads)
    decode_tc_kernel(const DecodeParams p) {
  using bf16 = __nv_bfloat16;
  using S = TcTile<D>;
  constexpr int KEYS = S::KEYS, STAGES = S::STAGES, KW = S::KW, DW = S::DW;
  constexpr int LD = D + 8;     // padded smem row (elements)
  constexpr int KS = D / 16;    // k-steps of K Q^T
  constexpr int MT = KS / DW;   // 16-row tiles of O^T a warp
  constexpr int CPR = D / 8;    // 16-byte chunks a row
  constexpr int HB = 8 * NH;    // query heads a block
  constexpr int OS = D + 4;     // row stride of the merge (floats)
  constexpr bool kQRegs = tc_q_in_regs<D, NH>();
  static_assert((size_t)KW * HB * (OS + 2) * sizeof(float) <=
                    tc_ring_bytes<D>(),
                "the merge fits the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* sq = reinterpret_cast<bf16*>(smem + tc_ring_bytes<D>());
  int* rows = reinterpret_cast<int*>(smem + tc_ring_bytes<D>() +
                                     tc_q_bytes<D, NH>());

  const int hk = blockIdx.x / p.gchunks;
  const int g0 = (blockIdx.x % p.gchunks) * HB;
  const int gn = min(HB, p.G - g0);
  const int b = blockIdx.y, s0 = blockIdx.z * p.split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp / DW, dw = warp % DW;  // key block, column share
  const int gi = lane >> 2, ti = lane & 3;   // fragment row, column pair
  const bf16* Q =
      static_cast<const bf16*>(p.q) + ((size_t)b * p.Hq + hk * p.G + g0) * D;

  // Q^T, the B operand of S^T = K Q^T: for head 8 h + gi and k-step ks,
  // b0 = q[16 ks + 2 ti .. + 1] and b1 = q[16 ks + 8 + 2 ti .. + 1].  Its
  // loads go out with cur_lens', before anything waits on either.
  uint32_t qf[kQRegs ? NH : 1][kQRegs ? KS : 1][2];
  if constexpr (kQRegs) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int g = h * 8 + gi;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          Q + (size_t)min(g, gn - 1) * D + 2 * ti);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qf[h][ks][0] = g < gn ? __ldg(src + ks * 8) : 0u;
        qf[h][ks][1] = g < gn ? __ldg(src + ks * 8 + 4) : 0u;
      }
    }
  }
  int lo, hi;
  live_range(p, b, lo, hi);
  const int first = max(lo, s0), last = min(hi, s0 + p.split - 1);
  if (p.nsplit > 1 && first > last) return;  // the combine never reads it

  const bf16* __restrict__ K = static_cast<const bf16*>(p.k);
  const bf16* __restrict__ Vc = static_cast<const bf16*>(p.v);
  if constexpr (!kQRegs) {
    // Q's rows (zero past the group) in their own cp.async group, the
    // oldest: it has landed whenever tile 0 has
    for (int c = tid; c < HB * CPR; c += kTcThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      cp_async16(sq + r * LD + col, Q + (r < gn ? (size_t)r * D + col : 0),
                 r < gn);
    }
    cp_async_commit();
  }
  if constexpr (PAGED) {
    // Once per block, a warp per page: the page id is read once and its
    // base row computed once; each position of the split -> its pool row
    // (page * BS + offset), or -1 if it is not live or its page is -1.
    const int np = p.split / p.BS, pg0 = s0 / p.BS;
    for (int j = warp; j < np; j += kTcWarps) {
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

  // O^T (this warp's D / DW rows d x 8 heads per n-tile h): o[mt][h] is
  // the accumulator fragment of rows d = 16 (dw MT + mt) + gi (elements 0,
  // 1, heads 8 h + 2 ti and + 1) and d + 8 (elements 2, 3).  m, l per head
  // 8 h + 2 ti + j; l is this lane's share (its keys gi and gi + 8).
  float o[MT][NH][4], m[NH][2], l[NH][2];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[h][j] = kNegInf;
      l[h][j] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][h][e] = 0.f;
  }

  const int t0 = first <= last ? (first - s0) / KEYS : 0;
  const int nt = first <= last ? (last - s0) / KEYS - t0 + 1 : 0;
  auto load_tile = [&](int t, int slot) {
    bf16* dk = ring + (size_t)slot * 2 * KEYS * LD;
    bf16* dv = dk + KEYS * LD;
#pragma unroll
    for (int u = 0; u < KEYS * CPR / kTcThreads; ++u) {
      const int c = tid + u * kTcThreads;
      const int row = c / CPR, cc = (c % CPR) * 8;
      const int ri = row_index(t * KEYS + row);
      const size_t off = ri >= 0 ? ((size_t)ri * p.Hkv + hk) * D + cc : 0;
      cp_async16(dk + row * LD + cc, K + off, ri >= 0);
      cp_async16(dv + row * LD + cc, Vc + off, ri >= 0);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load_tile(t0 + st, st);
    cp_async_commit();
  }
  const float qk_scale = p.scale * (p.softcap > 0.f ? 1.f : kLog2e);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed for all; tile i - 1's slot is free
    if (i + STAGES - 1 < nt)
      load_tile(t0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const bf16* sk = ring + (size_t)(i % STAGES) * 2 * KEYS * LD +
                     kw * 16 * LD;  // this warp's 16 keys
    const bf16* sv = sk + KEYS * LD + dw * MT * 16;
    const int kr = (t0 + i) * KEYS + kw * 16 + gi;
    const bool live0 = row_index(kr) >= 0, live1 = row_index(kr + 8) >= 0;

    // S^T = K Q^T: 16 keys x 8 heads per n-tile, two accumulators (even
    // and odd k-steps) so the MMAs of one n-tile do not wait on each other
    float acc[NH][2][4];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][0][e] = acc[h][1][e] = 0.f;
    uint32_t qs[NH][4];  // Q^T of two k-steps, from shared memory
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sk + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + ks * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        if constexpr (kQRegs) {
          mma_bf16(acc[h][ks & 1], a, qf[h][ks][0], qf[h][ks][1]);
        } else {
          if ((ks & 1) == 0)
            ldsm_x4(qs[h], sq + (h * 8 + (lane & 7)) * LD + ks * 16 +
                               (lane >> 3) * 8);
          mma_bf16(acc[h][ks & 1], a, qs[h][(ks & 1) * 2],
                   qs[h][(ks & 1) * 2 + 1]);
        }
      }
    }

    // Scores (log2 domain, softcap, dead keys out), the online softmax
    // over the 16 keys, and P^T as the B operand of P V: the fragment of
    // keys 0-7 (8-15) packed to bf16 is an 8x8 matrix with keys on rows;
    // its transpose is b0 (b1).
    uint32_t ph[NH][2], pl[NH][2];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float x[4], pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = (acc[h][0][e] + acc[h][1][e]) * qk_scale;
        if (p.softcap > 0.f)
          x[e] = p.softcap * tanhf(x[e] / p.softcap) * kLog2e;
        x[e] = (e < 2 ? live0 : live1) ? x[e] : kNegInf;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(x[j], x[2 + j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[h][j], mx);
        const float alpha = exp2f(m[h][j] - mn);
        pr[j] = live0 ? exp2f(x[j] - mn) : 0.f;
        pr[2 + j] = live1 ? exp2f(x[2 + j] - mn) : 0.f;
        l[h][j] = l[h][j] * alpha + (pr[j] + pr[2 + j]);
        m[h][j] = mn;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          o[mt][h][j] *= alpha;
          o[mt][h][2 + j] *= alpha;
        }
      }
      float r0, r1, r2, r3;
      ph[h][0] = movmatrix_trans(pack_bf16(pr[0], pr[1], r0, r1));
      pl[h][0] = movmatrix_trans(pack_bf16(r0, r1));
      ph[h][1] = movmatrix_trans(pack_bf16(pr[2], pr[3], r2, r3));
      pl[h][1] = movmatrix_trans(pack_bf16(r2, r3));
    }

    // O^T += V^T P^T over this warp's columns, P as bf16 hi + lo
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, sv + ((lane & 7) + (lane >> 4) * 8) * LD + mt * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        mma_bf16(o[mt][h], a, ph[h][0], ph[h][1]);
        mma_bf16(o[mt][h], a, pl[h][0], pl[h][1]);
      }
    }
  }
  cp_async_wait<0>();

  // A head's row sum over the 8 lanes that share its column.
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[h][j] += __shfl_xor_sync(0xffffffffu, l[h][j], off);

  // Merge the key blocks' states through shared memory, block 0 first
  // (the stride OS keeps the fragment's stores free of bank conflicts).
  __syncthreads();  // every warp is done with the ring
  float* so = reinterpret_cast<float*>(smem);  // (KW, HB, OS)
  float* sml = so + KW * HB * OS;              // (KW, HB, 2)
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = h * 8 + 2 * ti + j;
      float* dst = so + (kw * HB + g) * OS + dw * MT * 16 + gi;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        dst[mt * 16] = o[mt][h][j];
        dst[mt * 16 + 8] = o[mt][h][2 + j];
      }
      if (dw == 0 && gi == 0) {
        sml[(kw * HB + g) * 2] = m[h][j];
        sml[(kw * HB + g) * 2 + 1] = l[h][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += kTcThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < KW; ++w) M = fmaxf(M, sml[(w * HB + g) * 2]);
    float O = 0.f, Ls = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float c = exp2f(sml[(w * HB + g) * 2] - M);
      Ls = fmaf(sml[(w * HB + g) * 2 + 1], c, Ls);
      O = fmaf(so[(w * HB + g) * OS + d], c, O);
    }
    const size_t bh = (size_t)b * p.Hq + hk * p.G + g0 + g;
    if (p.nsplit == 1) {
      write_out<bf16>(p, bh, d, O, M, Ls);
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

// With more than one split, the combine pass after the split pass.
template <typename T>
int launch_combine(const DecodeParams& p, cudaStream_t stream) {
  if (p.nsplit == 1) return 0;
  const int n = p.B * p.Hq * p.D;
  decode_combine_kernel<T>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int GMAX, bool PAGED>
int launch_f32(const DecodeParams& p, cudaStream_t stream) {
  // Once per instantiation: allow the most shared memory any split takes.
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<float, D, GMAX, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<float, D, GMAX, PAGED>(kSplitMax));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.Hkv * p.gchunks, p.B, p.nsplit);
  decode_split_kernel<float, D, GMAX, PAGED>
      <<<grid, kThreads, smem_bytes<float, D, GMAX, PAGED>(p.split),
         stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : launch_combine<float>(p, stream);
}

// Once per instantiation: allow the most shared memory any split takes.
template <int D, int NH, bool PAGED>
cudaError_t allow_tc_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_tc_kernel<D, NH, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tc_smem_bytes<D, NH, PAGED>(kSplitMax));
  return attr;
}

template <int D, int NH, bool PAGED>
int launch_tc(const DecodeParams& p, cudaStream_t stream) {
  const cudaError_t attr = allow_tc_smem<D, NH, PAGED>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.Hkv * p.gchunks, p.B, p.nsplit);
  decode_tc_kernel<D, NH, PAGED>
      <<<grid, kTcThreads, tc_smem_bytes<D, NH, PAGED>(p.split), stream>>>(
          p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err
                            : launch_combine<__nv_bfloat16>(p, stream);
}

// Blocks of the bf16 split pass (contiguous cache, NH = 1) that one SM
// holds at head dim D, by the occupancy calculator; -1 on an error.
template <int D>
int tc_blocks_per_sm() {
  int n = 0;
  if (allow_tc_smem<D, 1, false>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_tc_kernel<D, 1, false>, kTcThreads,
          tc_smem_bytes<D, 1, false>(0)) != cudaSuccess)
    return -1;
  return n;
}

// The split pass of each dtype at head dim D.  `wide` picks the larger
// block: f32 GMAX = 8 query heads instead of 4, bf16 two n-tiles of 8 heads
// (NH = 2) instead of one.
template <int D, bool PAGED>
int launch_d(int dtype, bool wide, const DecodeParams& p, cudaStream_t s) {
  if (dtype == kF32)
    return wide ? launch_f32<D, 8, PAGED>(p, s)
                : launch_f32<D, 4, PAGED>(p, s);
  return wide ? launch_tc<D, 2, PAGED>(p, s) : launch_tc<D, 1, PAGED>(p, s);
}

// Checks the split, sizes the grid and launches; -1 for what the kernels do
// not take.  f32 runs groups of up to 4 query heads with GMAX = 4 and
// larger ones with GMAX = 8, in ceil(G / 8) blocks per kv head; bf16 runs
// groups of up to 8 with NH = 1 and larger ones with NH = 2, in
// ceil(G / 16) blocks per kv head.
template <bool PAGED>
int dispatch_decode(int dtype, DecodeParams p, cudaStream_t s) {
  if (p.B <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv || p.P <= 0) return -1;
  if (p.split <= 0 || p.split % kSplitQuantum || p.split > kSplitMax)
    return -1;
  if (PAGED && (p.BS <= 0 || p.split % p.BS)) return -1;
  if (dtype != kF32 && dtype != kBF16) return -1;
  p.G = p.Hq / p.Hkv;
  p.nsplit = (p.P + p.split - 1) / p.split;
  if (p.nsplit > 1 && (p.part_o == nullptr || p.part_ml == nullptr))
    return -1;
  const bool wide = p.G > (dtype == kF32 ? 4 : 8);
  const int heads = dtype == kF32 ? (wide ? 8 : 4) : (wide ? 16 : 8);
  p.gchunks = (p.G + heads - 1) / heads;
  switch (p.D) {
    case 16:
      return launch_d<16, PAGED>(dtype, wide, p, s);
    case 32:
      return launch_d<32, PAGED>(dtype, wide, p, s);
    case 64:
      return launch_d<64, PAGED>(dtype, wide, p, s);
    case 128:
      return launch_d<128, PAGED>(dtype, wide, p, s);
    case 256:
      return launch_d<256, PAGED>(dtype, wide, p, s);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

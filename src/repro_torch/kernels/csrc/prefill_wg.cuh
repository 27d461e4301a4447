// bf16 chunked-prefill flash attention at head dims 64, 128 and 256 for
// Hopper: wgmma, TMA and a warp-specialised producer.
//
// Replaces, for bf16 inputs at D = 64, 128 and 256, the TPU kernel
// src/repro/kernels/chunked_prefill_attention.py (_kernel, launched by
// pl.pallas_call at :111); chunked_prefill_attention.cu dispatches here and
// keeps prefill_tc_kernel (mma.sync) for D = 16, 32 and 112.  It computes
// what that kernel computes: row t of q sits at offset[b] + t; key k_pos is
// visible iff k_pos <= q_pos, k_pos < lengths[b] and, when window > 0,
// k_pos > q_pos - window; softcap (tanh) when softcap > 0; a row with no
// visible key gets the mean of v over all Skv keys.
//
// What bounds it: ~4 D flops per visible (query, key) pair on bf16 tensor
// cores.  Llama-3.1-8B's burst prompt (Sq 2048, len 1500, 32 / 8 heads,
// D 128) is 31.9 GFLOP, 0.032 ms at 989 TFLOP/s; Gemma-2-9B's prompt past
// its window (Sq 5120, len 4600, window 4096, 16 / 8 heads, D 256) 204
// GFLOP, 0.206 ms.  mma.sync from 4 warps (prefill_tc_kernel) reached 0.10
// to 0.15 of that; only wgmma reaches the full rate.
//
// Design (FlashAttention-3's shape, simplified):
//  * A block of 384 threads owns BM = 128 packed query rows of one kv head
//    (row p is token p / G, query head p % G of the group), so every K/V
//    tile is read once for the G heads.  Warpgroups 0 and 1 consume, 64
//    rows each; warpgroup 2 produces.  Grid (Hkv ceil(Sq G / BM), B),
//    block x on row block x / Hkv from the end of kv head x % Hkv: the
//    blocks of the last rows of the prompt (the most keys), every head's,
//    go first, so a grid of several waves ends on its lightest blocks.
//    Only the kv tiles that hold a key some row of the block can see are
//    visited.
//  * The producer lowers its registers to 24 (setmaxnreg) and one of its
//    threads keeps TMA loads of 64-key K and V tiles in flight, in a ring of
//    2 stages with full / empty mbarriers, K and V on barriers of their
//    own so that Q K^T starts before V lands.  A tile is D / 64 boxes of 64
//    columns (128 B, the swizzle's span) x 64 keys of one head, from a 4-D
//    map (D, Hkv, Skv, B): rows past Skv come as zeros.  The consumers raise
//    theirs to 240.
//  * Q comes once by cp.async into the same 128-byte-swizzled layout.
//    Shared memory: Q (128 D 2 B) + 2 x (K + V, 64 D 2 B each): 192 KB at
//    D = 256, 96 KB at 128, 48 KB at 64; registers hold one block an SM.
//  * S = Q K^T: D / 16 x wgmma m64n64k16, Q and K both K-major from
//    swizzled shared memory, f32 in registers (32 a thread).  The online
//    softmax runs on that accumulator as in prefill_tc_kernel (log2 domain,
//    row max and sum by quad shuffles), and it is what sets the pace: with
//    two warps a scheduler its instructions, not the tensor cores, bound a
//    tile.  So the softcap is a template flag, a tile every row of the
//    warpgroup sees whole runs code without the mask, exp2 is ex2.approx
//    and tanh is computed from ex2 and rcp.approx (tanh_fast).
//  * O += P V: wgmma m64nDk16 with A, the bf16 P, from registers (the S
//    accumulator's fragment, packed) and B, V, key-major from shared memory
//    with the transpose bit; P as a hi + lo pair (p_hi = bf16(p), p_lo =
//    bf16(p - p_hi)), two products into one f32 accumulator (D / 2 a
//    thread), the row sum from the f32 P (a single bf16 P fails the
//    reference's 2e-5 + 2 bf16 steps bound: kernels/ref.py
//    chunked_prefill_attention_split_p_ref).  Each product is committed
//    and waited for before its registers are read or its stage released.
//  * Tile i's Q K^T and tile i - 1's P V are issued together, and tile i's
//    softmax runs while P V holds the tensor cores (FlashAttention-3's
//    intra-warpgroup overlap); O is rescaled once P V has landed.  (Issuing
//    Q K^T before the rescale, and FlashAttention-3's ping-pong of the two
//    warpgroups, measured no faster on an H100 at D = 256.)
//  * Tile and ring, measured at D = 128 on an H100 80GB HBM3 at 700 W
//    (chip_prefill_probe.py --variants bn128,stages3,per-head-order, two
//    turns each): 64-key tiles against 128 (S and P 64 registers each)
//    0.0191 against 0.0202 ms at Llama's 512-token prompt, 0.0208 against
//    0.0237 at Qwen's, 0.113 against 0.108 at the burst prompt, 0.206
//    against 0.197 at the planned convertible chunk: 128-key tiles lose
//    6-14 % where prompts are short, the most launched rows, and gain 4-5 %
//    where they are long, so 64 at every D.  3 stages gain nothing (within
//    2 %).  Heaviest rows first across every head, against per head:
//    0.0208 against 0.0263 ms at Qwen's prompt (160 blocks, two waves),
//    0.113 against 0.118 at the burst, 0.206 against 0.221 at the chunk,
//    0.0191 against 0.0186 at Llama's prompt (one wave).
//  * Dead keys weigh exactly 0: a TMA tile copies real memory up to the
//    tensor's edge, so the first and last tile may hold rows behind the
//    window or past lengths[b], whatever they contain (NaN too).  S of such
//    a key is replaced by the mask (a select, not a product), and its V row
//    is zeroed in shared memory before P V (0 x NaN would be NaN).
#pragma once

#include <stdint.h>

#include <type_traits>

#include <cuda.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWgBM = 128;      // packed query rows a block
constexpr int kWgBN = 64;       // keys a tile (kernels/ref.py PREFILL_TILE_KEYS)
constexpr int kWgStages = 2;    // slots of the K / V ring
constexpr int kWgConsumers = 2;                    // warpgroups of 64 rows
constexpr int kWgThreads = 128 * (kWgConsumers + 1);

template <int D>
struct WgLayout {                    // byte offsets from a 1024-B aligned base
  static constexpr int kQBlock = 64 * 128;         // 64 rows x 64 columns
  static constexpr int kKVBlock = kWgBN * 128;     // kWgBN rows x 64 columns
  static constexpr int kTile = kWgBN * D * 2;      // one K or V tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kWgStages * kTile;
  static constexpr int kQ = kV + kWgStages * kTile;
  static constexpr int kBar = kQ + kWgBM * D * 2;  // full K, full V, empty K,
  static constexpr int kBytes = kBar + 4 * kWgStages * 8 + 1024;  // empty V
};

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// tanh x = 1 - 2 / (1 + 2^(2 x log2 e)) by ex2 and rcp.approx: its
// absolute error is a few 1e-7 everywhere, as tanhf's is near +-1 (x 50, the
// softcap, ~1e-5 of a logit); a fifth of tanhf's instructions.
__device__ __forceinline__ float tanh_fast(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(1.f + ex2_ftz(x * 2.8853900817779268f)));
  return 1.f - 2.f * r;
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Generic-proxy writes (cp.async, st.shared) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins each accumulator register at this point of the program, so that no
// read of it is scheduled above the wgmma.wait_group before the call.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define REPRO_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_F32(d, i)                                                    \
  REPRO_F8(d, i), REPRO_F8(d, i + 8), REPRO_F8(d, i + 16), REPRO_F8(d, i + 24)

// d (64 x 64, f32) += a (64 x 16) b (64 x 16)^T: a and b K-major bf16 in
// shared memory (descriptors).  S = Q K^T of a 64-key tile.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F32(d, 0)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N, f32) += a (64 x 16, bf16 fragment in registers) b (16 x N),
// N = 2 x d's size: b from shared memory MN-major (the transpose bit).
// O += P V.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d, 0), REPRO_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d, 0), REPRO_F32(d, 32), REPRO_F32(d, 64),
        REPRO_F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef REPRO_F32
#undef REPRO_F8

template <int D, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
    prefill_wg_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ offset,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out, int Sq, int Skv, int Hq,
                      int Hkv, int window, float softcap, float scale) {
  static_assert(D == 64 || D == 128 || D == 256,
                "one wgmma m64nDk16 product covers O's columns");
  using L = WgLayout<D>;
  constexpr int CB = D / 64;     // 128-byte column blocks of a row
  constexpr int NT = kWgBN / 8;  // 8-key n-blocks of S
  constexpr int KS = D / 16;     // k-steps of Q K^T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_v = full_k + kWgStages;
  uint64_t* empty_k = full_v + kWgStages;
  uint64_t* empty_v = empty_k + kWgStages;

  const int G = Hq / Hkv;
  // block x is row block x / Hkv from the end of kv head x % Hkv: the
  // last rows of the prompt (the most keys) first, every head's
  const int hk = blockIdx.x % Hkv, b = blockIdx.y;
  const int P = Sq * G;                                  // packed rows
  const int p0 = (gridDim.x / Hkv - 1 - blockIdx.x / Hkv) * kWgBM;
  const int tid = threadIdx.x;
  const int off = offset[b];
  const int len = min(lengths[b], Skv);
  const int t_first = p0 / G, t_last = (min(p0 + kWgBM, P) - 1) / G;
  // keys any row of this block can see: [k_lo, k_hi)
  const int k_hi = min(len, off + t_last + 1);
  const int k_lo = window > 0 ? max(0, off + t_first - window + 1) : 0;
  const int kb0 = (k_lo / kWgBN) * kWgBN;
  const int ntiles = k_hi > kb0 ? (k_hi - kb0 + kWgBN - 1) / kWgBN : 0;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 4 * kWgConsumers);   // one arrival a warp
      mbar_init(&empty_v[s], 4 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kWgConsumers) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * kWgConsumers) {
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kWgStages, par = (it / kWgStages) & 1;
        const int kb = kb0 + it * kWgBN;
        unsigned char* dk = smem + L::kK + s * L::kTile;
        unsigned char* dv = smem + L::kV + s * L::kTile;
        mbar_wait(&empty_k[s], par ^ 1);
        mbar_expect_tx(&full_k[s], L::kTile);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load_4d(dk + c * L::kKVBlock, &tm_k, &full_k[s], c * 64, hk, kb,
                      b);
        mbar_wait(&empty_v[s], par ^ 1);
        mbar_expect_tx(&full_v[s], L::kTile);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load_4d(dv + c * L::kKVBlock, &tm_v, &full_v[s], c * 64, hk, kb,
                      b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 packed rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5,
              lane = tid & 31;
    // This warpgroup's Q rows, packed, zero past P, swizzled as TMA would:
    // 16-byte chunk u of row r at block u / 8, chunk (u % 8) ^ (r % 8).
    unsigned char* sQ = smem + L::kQ + wg * (64 * D * 2);
    for (int c = wtid; c < 64 * (D / 8); c += 128) {
      const int r = c / (D / 8), u = c % (D / 8), p = p0 + wg * 64 + r;
      const bool ok = p < P;
      const __nv_bfloat16* src =
          ok ? q + (((size_t)b * Sq + p / G) * Hq + hk * G + p % G) * D + u * 8
             : q;
      cp_async16(sQ + (u >> 3) * L::kQBlock + r * 128 +
                     (((u & 7) ^ (r & 7)) << 4),
                 src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    const uint32_t q_addr = smem_u32(sQ);

    // This thread's two rows of the warp's 16: r0 = lane / 4 and r0 + 8.
    const int rw = wg * 64 + warp * 16;
    const int pr[2] = {p0 + rw + (lane >> 2), p0 + rw + (lane >> 2) + 8};
    const int qpos[2] = {off + pr[0] / G, off + pr[1] / G};
    // The warpgroup's token range, for the whole-tile visibility test.
    const int wp_lo = min(p0 + wg * 64, P - 1);
    const int wp_hi = min(p0 + wg * 64 + 63, P - 1);
    const int wq_lo = off + wp_lo / G, wq_hi = off + wp_hi / G;
    // S is scaled into the log2 domain; with a softcap (kCap), tanh takes
    // s * scale / softcap and its result is scaled by softcap * log2 e.
    const float qk_scale = kCap ? scale / softcap : scale * kLog2e;
    const float cap_log2e = softcap * kLog2e;

    float o[D / 2];    // element 4 j + e: n-block j, as an S element e
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[4 * NT];                          // S, then P, of one tile
    uint32_t ph[kWgBN / 16][4], pl[kWgBN / 16][4];   // P as A fragments

    // S = Q K^T of tile it (64 rows x 64 keys a warpgroup), issued.
    auto issue_qk = [&](int it) {
      const int s = it % kWgStages;
      const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kTile);
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) sc[i] = 0.f;
      mbar_wait(&full_k[s], (it / kWgStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_ss(sc,
                 sw128_desc(q_addr + (ks >> 2) * L::kQBlock + (ks & 3) * 32,
                            16, 1024),
                 sw128_desc(k_addr + (ks >> 2) * L::kKVBlock + (ks & 3) * 32,
                            16, 1024));
      wgmma_commit();
    };
    // O += P V of tile it, issued; V's rows outside [k_lo, k_hi) (the
    // first or last tile) are zeroed first, by both warpgroups together.
    auto issue_pv = [&](int it) {
      const int s = it % kWgStages, kb = kb0 + it * kWgBN;
      unsigned char* sV = smem + L::kV + s * L::kTile;
      mbar_wait(&full_v[s], (it / kWgStages) & 1);
      if (kb < k_lo || kb + kWgBN > k_hi) {
        for (int c = tid; c < kWgBN * (D / 8); c += 128 * kWgConsumers) {
          const int r = c % kWgBN, u = c / kWgBN, kp = kb + r;
          if (kp < k_lo || kp >= k_hi)
            *reinterpret_cast<uint4*>(sV + (u >> 3) * L::kKVBlock + r * 128 +
                                      (u & 7) * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_bar_sync(3, 128 * kWgConsumers);
      }
      const uint32_t v_addr = smem_u32(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, L::kKVBlock,
                                       1024);
        wgmma_rs(o, ph[kk], dv);
        wgmma_rs(o, pl[kk], dv);
      }
      wgmma_commit();
    };
    // Mask (when `masked`) and online softmax of tile it on sc (S lands as
    // P); returns the factor O's rows take before P V of this tile.
    auto softmax = [&](int it, float (&alpha)[2], auto masked) {
      const int kb = kb0 + it * kWgBN;
      // element 4 j + e is row pr[e / 2], key kb + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * qk_scale;
          if constexpr (kCap) x = cap_log2e * tanh_fast(x);
          if constexpr (decltype(masked)::value) {
            const int kp = kb + j * 8 + (lane & 3) * 2 + (e & 1);
            const int qp = qpos[e >> 1];
            const bool vis = kp <= qp && kp < len &&
                             (window <= 0 || kp > qp - window);
            x = vis ? x : kNegInf;
          }
          sc[4 * j + e] = x;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[h] = ex2_ftz(m[h] - mx);
        m[h] = mx;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) {
        sc[i] = ex2_ftz(sc[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = l[h] * alpha[h] + rs[h];
      }
    };
    // A tile every row of the warpgroup sees whole skips the mask.
    auto softmax_tile = [&](int it, float (&alpha)[2]) {
      const int kb = kb0 + it * kWgBN;
      if (kb + kWgBN - 1 <= wq_lo && kb + kWgBN <= len &&
          (window <= 0 || kb > wq_hi - window))
        softmax(it, alpha, std::false_type{});
      else
        softmax(it, alpha, std::true_type{});
    };
    // O's rows times alpha (a warp none of whose rows' max moved skips
    // it: x 1 is exact).
    auto rescale = [&](const float (&alpha)[2]) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    };
    // P as bf16 hi + lo A fragments, k-step kk = keys 16 kk .. 16 kk + 15.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* src = sc + 4 * (2 * kk + (i >> 1)) + (i & 1) * 2;
          float r0, r1;
          ph[kk][i] = pack_bf16(src[0], src[1], r0, r1);
          pl[kk][i] = pack_bf16(r0, r1);
        }
      }
    };

    // Tile it's Q K^T and tile it - 1's P V are in flight together; tile
    // it's softmax runs while P V still holds the tensor cores, and O is
    // rescaled once that product has landed.
    if (ntiles > 0) {
      float alpha[2];
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&empty_k[0]);
      softmax_tile(0, alpha);       // O is still 0: nothing to rescale
      pack_p();
      for (int it = 1; it < ntiles; ++it) {
        issue_qk(it);
        issue_pv(it - 1);
        wgmma_wait<1>();
        fence_regs(sc);
        if (lane == 0) mbar_arrive(&empty_k[it % kWgStages]);
        softmax_tile(it, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(&empty_v[(it - 1) % kWgStages]);
        rescale(alpha);
        pack_p();
      }
      issue_pv(ntiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty_v[(ntiles - 1) % kWgStages]);
    }

    const size_t kv_base = ((size_t)b * Skv * Hkv + hk) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pr[h];
      if (p >= P) continue;
      __nv_bfloat16* dst =
          out + (((size_t)b * Sq + p / G) * Hq + hk * G + p % G) * D;
      if (m[h] == kNegInf) {
        // no visible key: the plain version's softmax is uniform over Skv
        for (int j = 0; j < D / 8; ++j) {
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
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + (lane & 3) * 2) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] / den,
                                    o[4 * j + 2 * h + 1] / den);
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// libraries link no libcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) != cudaSuccess ||
        got != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// K or V, (B, Skv, Hkv, D) bf16, as a 4-D map, innermost first: (D, Hkv,
// Skv, B); a box is 64 columns (128 B) of kWgBN rows of one head.
bool kv_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, int B,
            int Skv, int Hkv, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Skv * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, kWgBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps are encoded at each call and passed by value (__grid_constant__),
// so a captured CUDA graph replays the call as it was made.
template <int D>
int launch_wg(const void* q, const void* k, const void* v, const void* offset,
              const void* lengths, void* out, int B, int Sq, int Skv, int Hq,
              int Hkv, int window, float softcap, float scale,
              cudaStream_t stream) {
  auto kernel = softcap > 0.f ? prefill_wg_kernel<D, true>
                              : prefill_wg_kernel<D, false>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(prefill_wg_kernel<D, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           WgLayout<D>::kBytes),
      cudaFuncSetAttribute(prefill_wg_kernel<D, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           WgLayout<D>::kBytes)};
  if (attr[softcap > 0.f] != cudaSuccess) return (int)attr[softcap > 0.f];
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_k, tm_v;
  if (!kv_map(encode, &tm_k, k, B, Skv, Hkv, D) ||
      !kv_map(encode, &tm_v, v, B, Skv, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const int P = Sq * (Hq / Hkv);
  const dim3 grid(Hkv * ((P + kWgBM - 1) / kWgBM), B);
  kernel<<<grid, kWgThreads, WgLayout<D>::kBytes, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(offset),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Sq,
      Skv, Hq, Hkv, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

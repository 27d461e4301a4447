// Paged decode attention for Hopper (sm_90a): split-KV (flash-decoding), CUDA
// cores, f32 math.  The kernels are in decode_common.cuh, shared with
// decode_attention.cu.
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
// What bounds it: as the contiguous kernel, bytes (every live key and value
// row read once for 4 * G * D flops); paging adds a table entry per page.
// What the design does about it: the contiguous kernel's split-KV blocks,
// with splits of whole pages.  Each block reads its split's page ids once
// and turns them into a table of pool rows in shared memory (one warp per
// page, no division); its tile loads then address rows through that table
// exactly as the contiguous kernel addresses its cache, and a -1 page's
// rows are neither loaded nor weighed.  With the same split rule as the
// contiguous kernel, the two compute in the same order: over interleaved
// pages this kernel gives bit for bit what the contiguous one gives on the
// same KV gathered.
#include "decode_common.cuh"

// Returns the cudaError_t of the launches (0 = launched), or -1 for an
// unsupported dtype / head dim / split (split must be a multiple of BS).
// part_o (B, Hq, nsplit, D) and part_ml (B, Hq, nsplit, 2), f32, nsplit =
// ceil(MB * BS / split), are scratch the caller allocates; unused (may be
// null) when nsplit == 1.
extern "C" int paged_decode_attention(int dtype, const void* q,
                                      const void* pool_k, const void* pool_v,
                                      const void* tables, const void* cur_lens,
                                      void* out, void* part_o, void* part_ml,
                                      int B, int MB, int BS, int Hq, int Hkv,
                                      int D, float scale, int split,
                                      void* stream) {
  using namespace repro_torch;
  DecodeParams p{};
  p.q = q;
  p.k = pool_k;
  p.v = pool_v;
  p.cur_lens = static_cast<const int*>(cur_lens);
  p.tables = static_cast<const int*>(tables);
  p.out = out;
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.P = MB * BS;
  p.MB = MB;
  p.BS = BS;
  p.window = 0;
  p.softcap = 0.f;
  p.scale = scale;
  p.split = split;
  return dispatch_decode<true>(dtype, p, static_cast<cudaStream_t>(stream));
}

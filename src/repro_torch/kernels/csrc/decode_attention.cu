// Decode attention for Hopper (sm_90a): split-KV (flash-decoding), bf16 on
// tensor cores, f32 on CUDA cores.  The kernels, and what bounds them, are
// in decode_common.cuh.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py (_kernel,
// launched by pl.pallas_call at :97).  One new query token per request
// attends its cache at k_pos <= cur_lens[b] (the token's own k/v is already
// written at slot cur_len), behind an optional window and softcap.
//
// Layout: q/out (B, Hq, D), k/v (B, L, Hkv, D), f32 or bf16; cur_lens (B,)
// int32.  The G = Hq / Hkv query heads of a group share one kv head.
//
// decode_attention_partial runs the same kernels on one slice of a cache
// whose positions are split across ranks (context parallelism): local row 0
// is absolute position pos0, and it writes the slice's normalised o (f32)
// with its log-sum-exp for the caller's merge across slices
// (models/ops.py, kernels/ref.py merge_decode_partials).
#include "decode_common.cuh"

// Returns the cudaError_t of the launches (0 = launched), or -1 for an
// unsupported dtype / head dim / split.  part_o (B, Hq, nsplit, D) and
// part_ml (B, Hq, nsplit, 2), f32, nsplit = ceil(L / split), are scratch
// the caller allocates; unused (may be null) when nsplit == 1.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* cur_lens,
                                void* out, void* part_o, void* part_ml, int B,
                                int L, int Hq, int Hkv, int D, int window,
                                float softcap, float scale, int split,
                                void* stream) {
  using namespace repro_torch;
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.cur_lens = static_cast<const int*>(cur_lens);
  p.tables = nullptr;
  p.out = out;
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.P = L;
  p.MB = 0;
  p.BS = 1;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.split = split;
  return dispatch_decode<false>(dtype, p, static_cast<cudaStream_t>(stream));
}

// A slice's partial: q (B, Hq, D), k/v (B, L, Hkv, D) holding absolute
// positions pos0 .. pos0 + L - 1, cur_lens (B,) absolute.  Writes out (B, Hq,
// D) f32, the output over the slice's live keys, and lse (B, Hq) f32, their
// natural-base log-sum-exp (o = 0, lse = -inf for a row with none).  Scratch
// and return value as decode_attention's.
extern "C" int decode_attention_partial(
    int dtype, const void* q, const void* k, const void* v,
    const void* cur_lens, void* out, void* lse, void* part_o, void* part_ml,
    int B, int L, int Hq, int Hkv, int D, int pos0, int window, float softcap,
    float scale, int split, void* stream) {
  using namespace repro_torch;
  if (pos0 < 0 || lse == nullptr) return -1;
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.cur_lens = static_cast<const int*>(cur_lens);
  p.tables = nullptr;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.P = L;
  p.MB = 0;
  p.BS = 1;
  p.pos0 = pos0;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.split = split;
  return dispatch_decode<false>(dtype, p, static_cast<cudaStream_t>(stream));
}

// Blocks of the bf16 split pass one SM holds at head dim D (a contiguous
// cache, groups of up to 8 query heads), as the occupancy calculator gives
// it; -1 for another head dim.  kernels/ops.py decode_blocks_per_sm, which
// the split rule reads, is held to it on the card.
extern "C" int decode_blocks_per_sm(int D) {
  using namespace repro_torch;
  switch (D) {
    case 16:
      return tc_blocks_per_sm<16>();
    case 32:
      return tc_blocks_per_sm<32>();
    case 64:
      return tc_blocks_per_sm<64>();
    case 128:
      return tc_blocks_per_sm<128>();
    case 256:
      return tc_blocks_per_sm<256>();
    default:
      return -1;
  }
}

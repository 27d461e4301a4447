// Decode attention for Hopper (sm_90a): split-KV (flash-decoding), CUDA
// cores, f32 math.  The kernels are in decode_common.cuh.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py (_kernel,
// launched by pl.pallas_call at :97).  One new query token per request
// attends its cache at k_pos <= cur_lens[b] (the token's own k/v is already
// written at slot cur_len), behind an optional window and softcap.
//
// Layout: q/out (B, Hq, D), k/v (B, L, Hkv, D), f32 or bf16; cur_lens (B,)
// int32.  The G = Hq / Hkv query heads of a group share one kv head.
//
// What bounds it: every live key and value row is read once for only
// 4 * G * D flops (about 1 flop per byte at G = 4, far below the ~295 of
// the tensor cores' ridge), so it is bound by bytes.  What the design does
// about it: it reads only the live range, each k/v row once for all G
// query heads of its group, and it fills the card: the key axis is cut
// into splits (grid (Hkv, B, nsplit)), so at decode batch 4 with 8 kv heads
// and a 2048-token cache some 280 blocks carry live rows instead of 32,
// each keeping three 16 KB tiles of cp.async loads in flight.  A second,
// small kernel merges the splits' partials.
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

// routed_cuda: closest hit per routed (chunk, g-block) pair of the TLAS
// path (kernels/tlas.py).
//
// Replaces the TPU kernel tracer/kernels/tlas.py:_routed_kernel, reached
// through tlas._routed_call (grid (Npairs,)). Pair p walks chunk
// pair_c[p]'s prims for the S subpackets of packet pair_gb[p], each with
// its chunk-relative candidate row; the global slot offset is
// pair_c[p] * lpc * leaf_size.
//   * the split closest-hit walk of leafcull.cu (leafwalk.cuh): the rows
//     r = p * S + s are cut into items of at most W walked leaves, planned
//     on the device, walked by a persistent grid of SP-thread CTAs, one
//     thread per ray, the sqrt only where disc > 0 and the next item
//     staged by cp.async; leafwalk::PairRows maps a row to its chunk
//     pair_c[p] and feature row pair_gb[p] * S + s;
//   * each ray's best merges by a 64-bit atomicMin on (bits of -u) << 32 |
//     global slot into keys (Npairs, S, SP): largest u, lowest global slot
//     on ties, bit for bit with the plain version; an epilogue writes
//     t = (-u) * (1/a) and the slot in the (Npairs, SP, S) layout, and
//     (3e38, 2^30) for a row with count 0;
//   * pairs are sorted chunk-major and items follow row order, so the
//     persistent grid walks the prim table (10M spheres: ~160 MB against
//     a 50 MB L2) chunk by chunk.
// Bound on this card: operations, as leafcull.cu (17 fp32 operations per
// missed test, each its own instruction); before the split one CTA walked
// a whole row, and the longest rows ran alone at the end of the launch.

#include "leafwalk.cuh"

// pair_c, pair_gb (Npairs,) i32; feats (G, S, SP, 16) f32; cand
// (Npairs, S, rowlen) i32; prims (C, lpc * leaf_size, 4) f32; starts
// (Npairs * S + 1,) i32 the item plan for W leaves per item; keys
// (Npairs, S, SP) u64 initialised to the miss key; t / slot
// (Npairs, SP, S). Returns cudaGetLastError() after the launches.
extern "C" int tracer_routed(const void* pair_c, const void* pair_gb,
                             const void* feats, const void* cand,
                             const void* prims, const void* starts,
                             void* keys, void* t, void* slot, int npairs,
                             int S, int SP, int rowlen, int leaf_size,
                             int lpc, int lpg, int W, void* stream) {
  const leafwalk::Rows rows{(const float*)feats, (const int32_t*)cand,
                            (const float4*)prims, (const int32_t*)starts,
                            npairs * S, rowlen, leaf_size, lpc, lpg, W};
  const leafwalk::PairRows map{(const int32_t*)pair_c,
                               (const int32_t*)pair_gb, S};
  return leafwalk::closest(map, rows, keys, t, slot, S, SP,
                           (cudaStream_t)stream);
}

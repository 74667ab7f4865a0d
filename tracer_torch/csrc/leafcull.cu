// leafcull_cuda: closest hit of each ray against the prims of its
// subpacket's candidate leaves, per table chunk.
//
// Replaces the TPU kernel tracer/kernels/leafcull.py:_leafcull_kernel
// (with _leafcull_step), reached through leafcull._leafcull_call
// (tracer/kernels/leafcull.py:702). What it computes is the same, but
// for the test of a (ray, prim) pair, which takes the reference's sums on
// oc = o - c (walk.cuh) where the TPU kernel expands |o|^2 - 2 o.c +
// (|c|^2 - r^2), and so takes the reference's hits on rays from anywhere;
// how is rethought for Hopper:
//   * the TPU's lane-quarter leaf assembly, pair-packed entries and
//     sentinel entry are gone: prims sit slot-major as (cx, cy, cz, r^2)
//     float4 and the walk reads exactly the walked leaves;
//   * the rows (one per (chunk c, packet g, subpacket s); count > 0 lists
//     leaves, count < 0 groups, 0 nothing) are split into items of at most
//     W leaves and walked by a persistent grid, one thread per ray, with
//     the split test and a two-stage cp.async ring (leafwalk.cuh);
//   * contract: the largest u = oc.d + sqrt(disc) with disc > 0 and
//     u < -eps*a, then the lowest global prim slot among equal u (the TPU
//     kernel's per-lane strict > plus its min-slot epilogue), merged per
//     ray by a 64-bit atomicMin on a (bits of -u, slot) key into keys of
//     shape (C, G, S, SP), which the wrapper initialises to the miss key
//     (leafwalk::ClosestWalk, rows mapped by leafwalk::GridRows);
//   * an epilogue kernel writes t = (-u) * (1/a), rounded once as the plain
//     version does, and the slot, or (3e38, 2^30) for a miss, in the
//     (C, G, SP, S) layout of the outputs.
//
// Bound on this card: operations. A missed (ray, prim) test is 17 fp32
// operations up to disc, each mul, add and sub its own instruction (no
// FMA, so the kernel rounds like leafcull_plain); prims come from L2 (the
// 100k table is ~2.2 MB). The recorded bound counts 20 operations per test at
// the 67 TFLOP/s FMA rate, so this design reaches at most about half of it.
// Before the split, one CTA walked a whole row, which left the longest rows
// running alone at the end of the launch, took the sqrt on every pair and
// exposed every staging load; the item split, the persistent grid, the
// split test and the cp.async ring address those three.

#include "leafwalk.cuh"

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; prims
// (C, lpc * leaf_size, 4) f32; starts (C * G * S + 1,) i32 the item plan for
// W leaves per item; keys (C, G, S, SP) u64 initialised to the miss key;
// t / slot (C, G, SP, S). Returns cudaGetLastError() after the launches.
extern "C" int tracer_leafcull(const void* feats, const void* cand,
                               const void* prims, const void* starts,
                               void* keys, void* t, void* slot, int C, int G,
                               int S, int SP, int rowlen, int leaf_size,
                               int lpc, int lpg, int W, void* stream) {
  const leafwalk::Rows rows{(const float*)feats, (const int32_t*)cand,
                            (const float4*)prims, (const int32_t*)starts,
                            C * G * S, rowlen, leaf_size, lpc, lpg, W};
  return leafwalk::closest(leafwalk::GridRows{G * S}, rows, keys, t, slot, S,
                           SP, (cudaStream_t)stream);
}

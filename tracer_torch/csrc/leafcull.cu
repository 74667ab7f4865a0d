// leafcull_cuda: closest hit of each ray against the prims of its
// subpacket's candidate leaves, per table chunk.
//
// Replaces the TPU kernel tracer/kernels/leafcull.py:_leafcull_kernel
// (with _leafcull_step), reached through leafcull._leafcull_call. What it
// computes is the same; how is rethought for Hopper:
//   * one CTA per (chunk c, packet g, subpacket s), one thread per ray
//     (blockDim = SP); the TPU's lane-quarter leaf assembly, pair-packed
//     entries and sentinel entry are gone -- prims sit slot-major as
//     (cx, cy, cz, |c|^2 - r^2) float4 and the walk reads exactly the
//     listed leaves;
//   * the CTA stages a batch of its leaves' prims (512 float4 = 8 KB) in
//     shared memory, then every thread tests every staged prim
//     (walk::closest_walk, shared with routed.cu);
//   * a row count of 0 writes (3e38, 2^30) at once (no work in that chunk);
//     a negative count is group mode: walk every member leaf of the listed
//     groups.
// Update rule: ok && (u > ub || (u == ub && slot < ib)) -- largest
// u = oc.d + sqrt(disc), lowest global prim slot on ties, the contract of
// the TPU kernel's per-lane strict > plus its min-slot epilogue.
//
// Bound on this card: the inner loop is ~20 fp32 operations per (ray, prim)
// pair; prim data is read once per CTA from L2 (the 100k-sphere table is
// ~2.2 MB, resident in the 50 MB L2) and a subpacket has few candidate
// leaves, so the kernel is bound by instruction throughput and the serial
// leaf loop, not by bytes. The arithmetic is written with __fmul_rn /
// __fadd_rn so nvcc does not contract it into FMAs: the kernel then rounds
// exactly like the plain PyTorch version (leafcull_plain), at the cost of
// the instructions FMA would save -- a trade for a later tuning pass.

#include "walk.cuh"

namespace {

__global__ void leafcull_kernel(const float* __restrict__ feats,
                                const int32_t* __restrict__ cand,
                                const float4* __restrict__ prims,
                                float* __restrict__ t_out,
                                int32_t* __restrict__ slot_out,
                                int G, int S, int SP, int rowlen,
                                int leaf_size, int lpc, int lpg) {
  __shared__ float4 s_prim[walk::kStage];
  __shared__ int32_t s_slot[walk::kStage];

  const int blk = blockIdx.x;
  const int s = blk % S;
  const int g = (blk / S) % G;
  const int c = blk / (S * G);
  const int r = threadIdx.x;

  const int32_t* row = cand + ((size_t)(c * G + g) * S + s) * rowlen;
  const size_t out = (((size_t)c * G + g) * SP + r) * S + s;
  const float* f = feats + (((size_t)g * S + s) * SP + r) * walk::kFeat;
  const int chunk_slot0 = c * lpc * leaf_size;
  walk::closest_walk(row, f, prims + chunk_slot0, chunk_slot0, leaf_size,
                     lpg, s_prim, s_slot, t_out + out, slot_out + out);
}

}  // namespace

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; prims
// (C, lpc * leaf_size, 4) f32; t / slot (C, G, SP, S). Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_leafcull(const void* feats, const void* cand,
                               const void* prims, void* t, void* slot,
                               int C, int G, int S, int SP, int rowlen,
                               int leaf_size, int lpc, int lpg,
                               void* stream) {
  const long long blocks = (long long)C * G * S;
  if (blocks > 0) {
    leafcull_kernel<<<(unsigned)blocks, SP, 0, (cudaStream_t)stream>>>(
        (const float*)feats, (const int32_t*)cand, (const float4*)prims,
        (float*)t, (int32_t*)slot, G, S, SP, rowlen, leaf_size, lpc, lpg);
  }
  return (int)cudaGetLastError();
}

// routed_cuda: closest hit per routed (chunk, g-block) pair of the TLAS
// path (kernels/tlas.py).
//
// Replaces the TPU kernel tracer/kernels/tlas.py:_routed_kernel, reached
// through tlas._routed_call (grid (Npairs,)). Pair p walks chunk
// pair_c[p]'s prims for the S subpackets of packet pair_gb[p], each with
// its chunk-relative candidate row; the global slot offset is
// pair_c[p] * lpc * leaf_size.
//   * one CTA per (pair p, subpacket s), one thread per ray; the body is
//     leafcull.cu's (walk::closest_walk): prims staged in shared memory,
//     largest u, lowest global slot on ties, bit for bit with the plain
//     version;
//   * a row with count 0 writes (3e38, 2^30) at once;
//   * the TPU's scalar prefetch, SMEM pair tables and entries-block
//     residency do not carry over: a CTA reads its pair's two ids itself,
//     and a chunk's prims come through L2, kept warm because pairs are
//     sorted chunk-major and CTAs start in pair order.
// Bound on this card: instruction throughput in the inner loop (~20 fp32
// operations per (ray, prim) test); the prim table (10M spheres: ~160 MB)
// is read chunk by chunk through the 50 MB L2.

#include "walk.cuh"

namespace {

__global__ void routed_kernel(const int32_t* __restrict__ pair_c,
                              const int32_t* __restrict__ pair_gb,
                              const float* __restrict__ feats,
                              const int32_t* __restrict__ cand,
                              const float4* __restrict__ prims,
                              float* __restrict__ t_out,
                              int32_t* __restrict__ slot_out,
                              int S, int SP, int rowlen, int leaf_size,
                              int lpc, int lpg) {
  __shared__ float4 s_prim[walk::kStage];
  __shared__ int32_t s_slot[walk::kStage];

  const int p = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const int c = pair_c[p];
  const int g = pair_gb[p];
  const int r = threadIdx.x;

  const int32_t* row = cand + ((size_t)p * S + s) * rowlen;
  const size_t out = ((size_t)p * SP + r) * S + s;
  const float* f = feats + (((size_t)g * S + s) * SP + r) * walk::kFeat;
  const int chunk_slot0 = c * lpc * leaf_size;
  walk::closest_walk(row, f, prims + chunk_slot0, chunk_slot0, leaf_size,
                     lpg, s_prim, s_slot, t_out + out, slot_out + out);
}

}  // namespace

// pair_c, pair_gb (Npairs,) i32; feats (G, S, SP, 16) f32; cand
// (Npairs, S, rowlen) i32; prims (C, lpc * leaf_size, 4) f32; t / slot
// (Npairs, SP, S). Returns cudaGetLastError() after the launch.
extern "C" int tracer_routed(const void* pair_c, const void* pair_gb,
                             const void* feats, const void* cand,
                             const void* prims, void* t, void* slot,
                             int npairs, int S, int SP, int rowlen,
                             int leaf_size, int lpc, int lpg, void* stream) {
  const long long blocks = (long long)npairs * S;
  if (blocks > 0) {
    routed_kernel<<<(unsigned)blocks, SP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pair_c, (const int32_t*)pair_gb, (const float*)feats,
        (const int32_t*)cand, (const float4*)prims, (float*)t,
        (int32_t*)slot, S, SP, rowlen, leaf_size, lpc, lpg);
  }
  return (int)cudaGetLastError();
}

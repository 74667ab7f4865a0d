// anyhit_cuda: is each ray occluded by any prim of its subpacket's
// candidate leaves over the segment (EPSILON, t_max)?
//
// Replaces the TPU kernel tracer/kernels/leafcull.py:_anyhit_kernel,
// reached through leafcull._anyhit_call. Per chunk a ray is occluded when a
// walked prim gives disc > 0, u < -eps*a and u > -a*t_max (feature column
// 13; u > -a*t_max <=> t < t_max); the result is ORed over chunks. The
// TPU kernel's 4-leaf lane-quarter blocks, i32 masks in place of i1 and
// 16-leaf while_loop steps exist for the TPU and are gone:
//   * the shape of leafcull.cu: one CTA per (chunk c, packet g, subpacket
//     s), one thread per ray, batches of 512 prims staged in shared memory,
//     the same (ray, prim) test (walk::ray_prim_u), bit for bit;
//   * early exit: after each staged batch, __syncthreads_and(occluded)
//     ends the walk once every ray of the subpacket is occluded, in leaf
//     and group mode alike. The result does not depend on it: a ray that
//     is occluded stays so, and the plain version, which walks everything,
//     gives identical flags;
//   * the OR over chunks needs no atomics: the output starts at 0 and a
//     CTA writes 1 for its occluded rays; CTAs of other chunks write the
//     same value to the same place.
// Bound on this card: like leafcull.cu, instruction throughput in the
// inner loop (~20 fp32 operations per (ray, prim) test) over prims read
// from L2; the early exit cuts the work to what occlusion needs.

#include "walk.cuh"

namespace {

__global__ void anyhit_kernel(const float* __restrict__ feats,
                              const int32_t* __restrict__ cand,
                              const float4* __restrict__ prims,
                              int32_t* __restrict__ occ_out,
                              int G, int S, int SP, int rowlen,
                              int leaf_size, int lpc, int lpg) {
  __shared__ float4 s_prim[walk::kStage];

  const int blk = blockIdx.x;
  const int s = blk % S;
  const int g = (blk / S) % G;
  const int c = blk / (S * G);
  const int r = threadIdx.x;

  const int32_t* row = cand + ((size_t)(c * G + g) * S + s) * rowlen;
  const int nc = row[0];
  const int total = walk::row_leaves(nc, lpg);   // CTA-uniform
  const walk::Ray ray =
      walk::load_ray(feats + (((size_t)g * S + s) * SP + r) * walk::kFeat);
  const float4* cprims = prims + (size_t)c * lpc * leaf_size;
  const int leaves_per_stage = walk::kStage / leaf_size;

  int occ = 0;
  for (int j0 = 0; j0 < total; j0 += leaves_per_stage) {
    const int np = min(leaves_per_stage, total - j0) * leaf_size;
    walk::stage(row, nc, j0, np, leaf_size, lpg, cprims, 0, s_prim,
                nullptr);
    __syncthreads();
    for (int i = 0; i < np; ++i) {
      float disc;
      const float u = walk::ray_prim_u(ray, s_prim[i], &disc);
      occ |= disc > 0.0f && u < -ray.epsa && u > ray.negat;
    }
    // Barrier and vote in one: every thread reaches it the same number of
    // times, so the exit is uniform across the CTA.
    if (__syncthreads_and(occ)) break;
  }
  if (occ) occ_out[((size_t)g * SP + r) * S + s] = 1;
}

}  // namespace

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; prims
// (C, lpc * leaf_size, 4) f32; occ (G, SP, S) i32, zero on entry. Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_anyhit(const void* feats, const void* cand,
                             const void* prims, void* occ, int C, int G,
                             int S, int SP, int rowlen, int leaf_size,
                             int lpc, int lpg, void* stream) {
  const long long blocks = (long long)C * G * S;
  if (blocks > 0) {
    anyhit_kernel<<<(unsigned)blocks, SP, 0, (cudaStream_t)stream>>>(
        (const float*)feats, (const int32_t*)cand, (const float4*)prims,
        (int32_t*)occ, G, S, SP, rowlen, leaf_size, lpc, lpg);
  }
  return (int)cudaGetLastError();
}

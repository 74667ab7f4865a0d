// anyhit_cuda: is each ray occluded by any prim of its subpacket's
// candidate leaves over the segment (EPSILON, t_max)?
//
// Replaces the TPU kernel tracer/kernels/leafcull.py:_anyhit_kernel,
// reached through leafcull._anyhit_call (tracer/kernels/leafcull.py:953).
// Per chunk a ray is occluded when a walked prim gives disc > 0,
// u < -eps*a and u > -a*t_max (feature column 13; u > -a*t_max <=>
// t < t_max); the result is ORed over chunks. The TPU kernel's 4-leaf
// lane-quarter blocks, i32 masks in place of i1 and 16-leaf while_loop
// steps exist for the TPU and are gone:
//   * the walk of leafcull.cu: rows split into items of at most W leaves on
//     a persistent grid, one thread per ray, the split test, a two-stage
//     cp.async ring (leafwalk.cuh), bit for bit with anyhit_plain;
//   * the OR over items and chunks needs no atomics: the output starts at
//     0 and a CTA writes 1 for its occluded rays with a plain store; other
//     CTAs write the same value to the same place;
//   * early exit: a thread stops testing its item at the first occluding
//     prim, and before each item it reads its ray's flag from the output
//     and skips the item's tests where it is set, so a warp or a whole CTA
//     skips items once all of its rays are occluded. A flag another CTA
//     has not written yet only costs work; the flags do not depend on it
//     and stay those of anyhit_plain, which walks everything.
//
// Bound on this card: operations, as leafcull.cu (17 fp32 operations per
// missed test, each its own instruction, prims from L2); the early exit
// cuts the work to what occlusion needs.

#include "leafwalk.cuh"

namespace {

struct AnyhitWalk : leafwalk::GridRows {
  static constexpr bool kSlots = false;
  int32_t* occ;   // (G, SP, S)
  int S;

  __device__ __forceinline__ int32_t* flag(int gs, int x) const {
    return occ + ((size_t)(gs / S) * blockDim.x + x) * S + gs % S;
  }

  __device__ __forceinline__ bool done(int gs, int x) const {
    return __ldcg(flag(gs, x)) != 0;
  }

  __device__ __forceinline__ void run(int, int gs, int x,
                                      const walk::Ray& ray, const float4* q,
                                      const int32_t*, int np) const {
#pragma unroll 8
    for (int i = 0; i < np; ++i) {
      float bp;
      const float disc = walk::ray_prim_disc(ray, q[i], &bp);
      if (disc > 0.0f) {
        const float u = __fadd_rn(bp, __fsqrt_rn(disc));
        if (u < -ray.epsa && u > ray.negat) {
          *flag(gs, x) = 1;
          return;
        }
      }
    }
  }
};

}  // namespace

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; prims
// (C, lpc * leaf_size, 4) f32; starts (C * G * S + 1,) i32 the item plan for
// W leaves per item; occ (G, SP, S) i32, zero on entry. Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_anyhit(const void* feats, const void* cand,
                             const void* prims, const void* starts, void* occ,
                             int C, int G, int S, int SP, int rowlen,
                             int leaf_size, int lpc, int lpg, int W,
                             void* stream) {
  const leafwalk::Rows rows{(const float*)feats, (const int32_t*)cand,
                            (const float4*)prims, (const int32_t*)starts,
                            C * G * S, rowlen, leaf_size, lpc, lpg, W};
  return leafwalk::launch(AnyhitWalk{{G * S}, (int32_t*)occ, S}, rows, SP,
                          (cudaStream_t)stream);
}

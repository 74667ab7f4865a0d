// tilecull_cuda: nearest hit of each ray of a 128-ray subpacket against the
// prims of its candidate 128-prim tiles.
//
// Replaces the TPU kernel tracer/kernels/tilecull.py:_tilecull_kernel,
// reached through tilecull._tilecull_call. What it computes is the same;
// the TPU mechanics are gone: no (128 rays x 128 lanes) outer-product
// planes carried through the tile loop, no lane-wise best and min-over-lanes
// epilogue, no S-subpacket grid steps.
//   * one CTA of 128 threads per subpacket, one ray per thread;
//   * the CTA walks its row's `count` candidate tiles in the listed
//     (ascending) order, stages each tile's 128 float4 prims
//     (cx, cy, cz, |c|^2 - r^2) in shared memory, one per thread, and every
//     thread tests all 128 with walk::ray_prim_u, the u-form test the leaf
//     walks share;
//   * t = (-u) * (1/a); a prim is taken when disc > 0, t > EPSILON and
//     t < the best so far, in ascending slot order, so the result is the
//     smallest t and the lowest slot among equal t -- the TPU kernel's
//     lane-wise best plus its lowest-slot epilogue. A miss is (3e38, 2^30).
//
// Bound on this card: operations. Each listed tile costs 128 x 128 tests
// of ~20 fp32 operations on 2 KB of prims that sit in L2; the arithmetic is
// spelled with __fmul_rn / __fadd_rn (walk.cuh) so nvcc does not contract
// it into FMAs, and the kernel rounds exactly like tilecull_plain.

#include "walk.cuh"

namespace {

constexpr int kSub = 128;
constexpr float kEps = 1e-6f;

__global__ void __launch_bounds__(kSub)
tilecull_kernel(const float* __restrict__ feats,
                const int32_t* __restrict__ cand,
                const float4* __restrict__ prims, float* __restrict__ t_out,
                int32_t* __restrict__ slot_out, int S, int kp) {
  __shared__ float4 s_prim[kSub];
  const int blk = blockIdx.x;            // g * S + s
  const int r = threadIdx.x;
  const int32_t* row = cand + (size_t)blk * kp;
  const walk::Ray ray = walk::load_ray(feats + ((size_t)blk * kSub + r)
                                       * walk::kFeat);
  const int nc = row[0];
  float tb = walk::kBig;
  int ib = walk::kNoSlot;
  for (int k = 0; k < nc; ++k) {
    const int tile = row[1 + k];
    s_prim[r] = prims[(size_t)tile * kSub + r];
    __syncthreads();
    for (int i = 0; i < kSub; ++i) {
      float disc;
      const float u = walk::ray_prim_u(ray, s_prim[i], &disc);
      const float t = __fmul_rn(-u, ray.inva);
      if (disc > 0.0f && t > kEps && t < tb) {
        tb = t;
        ib = tile * kSub + i;
      }
    }
    __syncthreads();
  }
  const int g = blk / S, s = blk % S;
  const size_t out = ((size_t)g * kSub + r) * S + s;
  t_out[out] = tb;
  slot_out[out] = ib;
}

}  // namespace

// feats (G, S, 128, 16) f32; cand (G, S, kp) i32 count-embedded tile rows;
// prims (T + 1, 128, 4) f32; t / slot (G, 128, S). Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_tilecull(const void* feats, const void* cand,
                               const void* prims, void* t, void* slot, int G,
                               int S, int kp, void* stream) {
  const long long blocks = (long long)G * S;
  if (blocks > 0) {
    tilecull_kernel<<<(unsigned)blocks, kSub, 0, (cudaStream_t)stream>>>(
        (const float*)feats, (const int32_t*)cand, (const float4*)prims,
        (float*)t, (int32_t*)slot, S, kp);
  }
  return (int)cudaGetLastError();
}

// tilecull_cuda: nearest hit of each ray of a 128-ray subpacket against the
// prims of its candidate 128-prim tiles.
//
// Replaces the TPU kernel tracer/kernels/tilecull.py:_tilecull_kernel,
// reached through tilecull._tilecull_call. What it computes is the same;
// the TPU mechanics are gone: no (128 rays x 128 lanes) outer-product
// planes carried through the tile loop, no lane-wise best and min-over-lanes
// epilogue, no S-subpacket grid steps.
//   * the rows are split into items of at most W listed tiles and walked by
//     a persistent grid (tilewalk.cuh), one ray per thread; a row is a
//     subpacket, [count, tile ids..., padding];
//   * every thread tests its ray against each staged prim with the test
//     of the leaf walks on oc = o - c, split: disc first, then
//     u = b' + sqrt(disc),
//     t = (-u) * (1/a), and the compare, only where disc > 0;
//   * a prim is taken when disc > 0, t > EPSILON and t < 3e38; the per-ray
//     key (t, slot) is merged by atomicMin, so the result is the smallest t
//     and the lowest slot among equal t, the TPU kernel's lane-wise best
//     plus its lowest-slot epilogue, whatever the listed order. A miss is
//     (3e38, 2^30), the key the wrapper initialises.
//
// Bound on this card: operations. Each listed tile costs 128 x 128 tests of
// 17 fp32 operations up to disc, each mul, add and sub its own instruction
// (no FMA, so the kernel rounds like tilecull_plain); the recorded bound
// counts 21 operations at the 67 TFLOP/s FMA rate, so this kernel can
// reach at most about half of it. Prims sit in L2 (2 KB a tile). The
// rounded sqrt's sequence runs only where disc > 0.

#include "tilewalk.cuh"

namespace {

struct TileWalk {
  using Ray = walk::Ray;
  const float* feats;       // (G * S, 128, 16)
  const int32_t* cand;      // (G * S, kp)
  const float4* tiles;      // (T + 1, 128)
  int kp;

  __device__ __forceinline__ Ray load(int r, int x) const {
    return walk::load_ray(feats + ((size_t)r * tilewalk::kRays + x)
                          * walk::kFeat);
  }
  __device__ __forceinline__ int count(int r) const {
    return min(max(__ldg(cand + (size_t)r * kp), 0), kp - 1);
  }
  __device__ __forceinline__ const int32_t* list(int r) const {
    return cand + (size_t)r * kp + 1;
  }
  __device__ __forceinline__ uint32_t base(int tile, int) const {
    return (uint32_t)tile * tilewalk::kTile;
  }
  __device__ __forceinline__ void test(const Ray& ray, float4 q,
                                       uint32_t slot,
                                       unsigned long long& best) const {
    float bp;
    const float disc = walk::ray_prim_disc(ray, q, &bp);
    if (disc > 0.0f) {
      const float u = __fadd_rn(bp, __fsqrt_rn(disc));
      const float t = __fmul_rn(-u, ray.inva);
      if (t > tilewalk::kEps && t < walk::kBig) {
        const unsigned long long key = tilewalk::pack(t, slot);
        best = key < best ? key : best;
      }
    }
  }
};

}  // namespace

// feats (G, S, 128, 16) f32; cand (G, S, kp) i32 count-embedded tile rows;
// prims (T + 1, 128, 4) f32; starts (G * S + 1,) i32 the item plan for
// chunk W; keys (G * S * 128,) u64 initialised to the miss key. Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_tilecull(const void* feats, const void* cand,
                               const void* prims, const void* starts,
                               void* keys, int rows, int kp, int W,
                               void* stream) {
  const TileWalk w{(const float*)feats, (const int32_t*)cand,
                   (const float4*)prims, kp};
  return tilewalk::launch(w, (const int32_t*)starts, rows, W,
                          (unsigned long long*)keys, (cudaStream_t)stream);
}

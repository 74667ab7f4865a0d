// cull_cuda: the packet cull. Nearest hit of each ray of a 1024-ray packet
// against the prims of the packet's candidate 128-prim tiles.
//
// Replaces the TPU kernel tracer/kernels/cull_pallas.py:_cull_kernel,
// reached through cull_pallas._cull_packets. What it computes is the same;
// the TPU mechanics are gone: no (8, 128) ray planes, no masked-sum lane
// extraction of each prim, no scalar-prefetched count and candidate tables.
//   * a packet is 8 blocks of 128 rays that share the packet's row of
//     listed tiles (rays (g, 1024, 8) as [ox oy oz dx dy dz 0 0], the
//     layout of traverse_cuda); each ray's result depends only on its own
//     ray and the listed tiles, so the rows of blocks are split into items
//     of at most W listed tiles and walked by a persistent grid
//     (tilewalk.cuh), one ray per thread;
//   * the test is the TPU kernel's b-form, split: hb = oc.d,
//     cq = |oc|^2 - r^2, disc4 = hb^2 - a*cq for every pair, and only where
//     disc4 > 0 the root t = (-hb - sqrt(disc4)) / a and the compare; each
//     op spelled with __fmul_rn / __fadd_rn / __fsqrt_rn so that nvcc
//     contracts nothing into an FMA and cull_plain rounds it the same, bit
//     for bit;
//   * a prim is taken when disc4 > 0, EPSILON < t < +inf; the per-ray key
//     (t, k * 128 + lane), k the listed position, is merged by atomicMin,
//     so among equal t the first in (listed position, lane) order wins, as
//     in cull_plain, for any listed order; the wrapper maps k back to its
//     tile through cand. A miss is (+inf, -1);
//   * the walk runs to min(count, K) listed tiles. The TPU kernel loops to
//     the raw count, which tile_candidates lets exceed K on overflow, and
//     then reads cand past the packet's K columns; that is not copied.
//
// Bound on this card: operations. Each listed tile costs 1024 x 128 tests
// of 17 fp32 operations up to disc4, each its own instruction (no FMA); the
// recorded bound counts 25 operations at the 67 TFLOP/s FMA rate, so this
// kernel can reach at most about half of it. Prims sit in L2. The SASS of a
// missed test is 22 issue slots: LDS.128, BSSY, 17 FADD/FMUL, FSETP, BRA,
// BSYNC (no FFMA; the rounded sqrt's sequence runs only where disc4 > 0).

#include "tilewalk.cuh"

namespace {

constexpr int kBlocks = 8;    // 128-ray blocks of a 1024-ray packet

struct CullRay {
  float ox, oy, oz, dx, dy, dz, a, inv_a;
};

struct CullWalk {
  using Ray = CullRay;
  const float4* rays;       // (g * 1024, 2)
  const int32_t* cand;      // (g, K)
  const int32_t* counts;    // (g,)
  const float4* tiles;      // (T + 1, 128): centre, r^2
  int K;

  __device__ __forceinline__ Ray load(int r, int x) const {
    const size_t ray = (size_t)r * tilewalk::kRays + x;
    const float4 o4 = rays[2 * ray];
    const float4 d4 = rays[2 * ray + 1];
    Ray q;
    q.ox = o4.x; q.oy = o4.y; q.oz = o4.z;
    q.dx = o4.w; q.dy = d4.x; q.dz = d4.y;
    q.a = __fadd_rn(__fadd_rn(__fmul_rn(q.dx, q.dx), __fmul_rn(q.dy, q.dy)),
                    __fmul_rn(q.dz, q.dz));
    q.inv_a = __fdiv_rn(1.0f, fmaxf(q.a, 1e-30f));
    return q;
  }
  __device__ __forceinline__ int count(int r) const {
    return min(max(__ldg(counts + r / kBlocks), 0), K);
  }
  __device__ __forceinline__ const int32_t* list(int r) const {
    return cand + (size_t)(r / kBlocks) * K;
  }
  __device__ __forceinline__ uint32_t base(int, int k) const {
    return (uint32_t)k * tilewalk::kTile;
  }
  __device__ __forceinline__ void test(const Ray& r, float4 q, uint32_t idx,
                                       unsigned long long& best) const {
    const float ocx = __fsub_rn(r.ox, q.x);
    const float ocy = __fsub_rn(r.oy, q.y);
    const float ocz = __fsub_rn(r.oz, q.z);
    const float hb = __fadd_rn(__fadd_rn(__fmul_rn(ocx, r.dx),
                                         __fmul_rn(ocy, r.dy)),
                               __fmul_rn(ocz, r.dz));
    const float cq = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                  __fmul_rn(ocz, ocz)),
        q.w);
    const float disc4 = __fsub_rn(__fmul_rn(hb, hb), __fmul_rn(r.a, cq));
    if (disc4 > 0.0f) {
      const float t = __fmul_rn(__fsub_rn(-hb, __fsqrt_rn(disc4)), r.inv_a);
      if (t > tilewalk::kEps && t < __int_as_float(0x7f800000)) {
        const unsigned long long key = tilewalk::pack(t, idx);
        best = key < best ? key : best;
      }
    }
  }
};

}  // namespace

// rays (g, 1024, 8) f32; tiles (T + 1, 128, 4) f32; cand (g, K) i32; counts
// (g,) i32; starts (g * 8 + 1,) i32 the item plan for chunk W over the
// packets' 128-ray blocks; keys (g * 1024,) u64 initialised to the miss
// key. Returns cudaGetLastError() after the launch.
extern "C" int tracer_cull(const void* rays, const void* tiles,
                           const void* cand, const void* counts,
                           const void* starts, void* keys, int g, int K,
                           int W, void* stream) {
  const CullWalk w{(const float4*)rays, (const int32_t*)cand,
                   (const int32_t*)counts, (const float4*)tiles, K};
  return tilewalk::launch(w, (const int32_t*)starts, g * kBlocks, W,
                          (unsigned long long*)keys, (cudaStream_t)stream);
}

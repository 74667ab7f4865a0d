// Pieces shared by the walks over slot-major prims (float4 (cx, cy, cz,
// r^2)) and the 16-column ray features: the (ray, prim) tests, and
// the staging and item-plan helpers of the split walks (leafwalk.cuh for
// leafcull.cu, routed.cu and anyhit.cu, tilewalk.cuh for tilecull.cu and
// cull.cu) and of the packet walk (traverse.cu). A row is [count, ids...]:
// count > 0 lists relative leaf ids, count < 0 lists -count relative group
// ids whose leaves_per_group member leaves are all walked, 0 means nothing.
//
// The (ray, prim) test is spelled with __fmul_rn / __fadd_rn / __fsub_rn
// so that nvcc does not contract it into FMAs: each kernel then rounds
// exactly like its plain PyTorch version, bit for bit. It works on
// oc = o - c, as the reference does, and not on |o|^2 - 2 o.c + |c|^2: off
// the world's origin those terms are of size |c|^2 and, in f32, lose a
// discriminant of size r^2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr float kBig = 3.0e38f;
constexpr int kNoSlot = 1 << 30;
constexpr int kFeat = 16;

// Ray features (leafcull._feature_rows): d, o, 1, 0, 0, 0, a, 1/a, eps*a,
// -a*t_max.
struct Ray {
  float dx, dy, dz, ox, oy, oz, av, inva, epsa, negat;
};

static __device__ __forceinline__ Ray load_ray(const float* f) {
  Ray r;
  r.dx = f[0]; r.dy = f[1]; r.dz = f[2];
  r.ox = f[3]; r.oy = f[4]; r.oz = f[5];
  r.av = f[10]; r.inva = f[11]; r.epsa = f[12]; r.negat = f[13];
  return r;
}

// The reference's sums (src/hit.c:19-39) on oc = o - c, halved: b' = oc.d,
// cq = oc.oc - r^2 and disc = b'^2 - a*cq, a quarter of the reference's
// b^2 - 4ac exactly (b = 2b'). Returns disc, b' out; the near root's
// u = b' + sqrt(disc) is the caller's, where disc > 0, and t = -u/a.
static __device__ __forceinline__ float ray_prim_disc(const Ray& r, float4 q,
                                                      float* bp) {
  const float ocx = __fsub_rn(r.ox, q.x);
  const float ocy = __fsub_rn(r.oy, q.y);
  const float ocz = __fsub_rn(r.oz, q.z);
  *bp = __fadd_rn(__fadd_rn(__fmul_rn(ocx, r.dx), __fmul_rn(ocy, r.dy)),
                  __fmul_rn(ocz, r.dz));                       // oc.d
  const float cq = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                __fmul_rn(ocz, ocz)),
      q.w);                                                    // |oc|^2 - r^2
  return __fsub_rn(__fmul_rn(*bp, *bp), __fmul_rn(r.av, cq));
}

// One 16-byte cp.async into shared memory, committed as its own group.
static __device__ __forceinline__ void cp_async16(void* smem,
                                                  const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The row of ``item`` in an item plan (kernels/tilewalk.py:plan_items): the
// largest r with starts[r] <= item (rows with no items share their start
// with the next row, so this is the non-empty one).
static __device__ __forceinline__ int row_of(const int32_t* starts, int R,
                                             int item) {
  int lo = 0, hi = R - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(starts + mid) <= item) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Number of leaves a row walks.
static __device__ __forceinline__ int row_leaves(int nc, int lpg) {
  return nc > 0 ? nc : -nc * lpg;
}

}  // namespace walk

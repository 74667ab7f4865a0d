// Pieces shared by the walks over slot-major prims (float4 (cx, cy, cz,
// |c|^2 - r^2)) and the 16-column ray features: the per-row closest walk of
// routed.cu (closest_walk, one CTA per row), the (ray, prim) tests, and the
// staging and item-plan helpers of the split walks (leafwalk.cuh for
// leafcull.cu and anyhit.cu, tilewalk.cuh for tilecull.cu and cull.cu).
//
// closest_walk runs one CTA per subpacket row and one thread per ray. It
// stages a batch of its row's prims in shared memory, then every thread
// tests every staged prim with ray_prim_u. A row is [count, ids...]:
// count > 0 lists relative leaf ids, count < 0 lists -count relative group
// ids whose leaves_per_group member leaves are all walked, 0 means nothing.
//
// The (ray, prim) test is spelled with __fmul_rn / __fadd_rn so that nvcc
// does not contract it into FMAs: each kernel then rounds exactly like its
// plain PyTorch version, bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr float kBig = 3.0e38f;
constexpr int kNoSlot = 1 << 30;
constexpr int kFeat = 16;
constexpr int kStage = 512;   // prims staged per batch (8 KB of float4)

// Ray features (leafcull._feature_rows): d, -2o, 1, 0, o.d, |o|^2, a, 1/a,
// eps*a, -a*t_max.
struct Ray {
  float dx, dy, dz, nox2, noy2, noz2, od, oo, av, inva, epsa, negat;
};

static __device__ __forceinline__ Ray load_ray(const float* f) {
  Ray r;
  r.dx = f[0]; r.dy = f[1]; r.dz = f[2];
  r.nox2 = f[3]; r.noy2 = f[4]; r.noz2 = f[5];
  r.od = f[8]; r.oo = f[9]; r.av = f[10]; r.inva = f[11]; r.epsa = f[12];
  r.negat = f[13];
  return r;
}

// u = oc.d + sqrt(max(disc, 0)) of the near root, t = -u / a; disc out.
static __device__ __forceinline__ float ray_prim_u(const Ray& r, float4 q,
                                                   float* disc) {
  const float m1 = __fadd_rn(__fadd_rn(__fmul_rn(r.dx, q.x),
                                       __fmul_rn(r.dy, q.y)),
                             __fmul_rn(r.dz, q.z));            // c.d
  const float m2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r.nox2, q.x),
                                                 __fmul_rn(r.noy2, q.y)),
                                       __fmul_rn(r.noz2, q.z)),
                             q.w);                             // -2o.c + ccr
  const float bp = __fsub_rn(r.od, m1);                        // oc.d
  const float cq = __fadd_rn(m2, r.oo);                        // |oc|^2 - r^2
  *disc = __fsub_rn(__fmul_rn(bp, bp), __fmul_rn(r.av, cq));
  return __fadd_rn(bp, sqrtf(fmaxf(*disc, 0.0f)));
}

// ray_prim_u split in two: disc and b' = oc.d here, in the same operations;
// the near root's u = b' + sqrt(disc) is the caller's, where disc > 0 (there
// sqrt(max(disc, 0)) is sqrt(disc), so the split changes no bit).
static __device__ __forceinline__ float ray_prim_disc(const Ray& r, float4 q,
                                                      float* bp) {
  const float m1 = __fadd_rn(__fadd_rn(__fmul_rn(r.dx, q.x),
                                       __fmul_rn(r.dy, q.y)),
                             __fmul_rn(r.dz, q.z));            // c.d
  const float m2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r.nox2, q.x),
                                                 __fmul_rn(r.noy2, q.y)),
                                       __fmul_rn(r.noz2, q.z)),
                             q.w);                             // -2o.c + ccr
  *bp = __fsub_rn(r.od, m1);                                   // oc.d
  const float cq = __fadd_rn(m2, r.oo);                        // |oc|^2 - r^2
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

// Stage the prims of leaves [j0, j0 + n) of a row (n * leaf_size <= kStage)
// into shared memory, with their global slots when s_slot is not null.
// Every thread of the CTA calls it; the caller syncs afterwards.
static __device__ __forceinline__ void stage(
    const int32_t* row, int nc, int j0, int np, int leaf_size, int lpg,
    const float4* __restrict__ cprims, int chunk_slot0, float4* s_prim,
    int32_t* s_slot) {
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const int j = j0 + i / leaf_size;
    const int leaf = nc > 0 ? row[1 + j] : row[1 + j / lpg] * lpg + j % lpg;
    const int p = leaf * leaf_size + i % leaf_size;
    s_prim[i] = cprims[p];
    if (s_slot) s_slot[i] = chunk_slot0 + p;
  }
}

// The closest-hit walk of one row; every thread of the CTA calls it with
// the same row. Keeps the largest u below -eps*a, lowest global slot on
// ties: ok && (u > ub || (u == ub && slot < ib)). Writes t = -u/a and the
// slot, or (3e38, 2^30) where nothing hits.
static __device__ __forceinline__ void closest_walk(
    const int32_t* row, const float* f, const float4* __restrict__ cprims,
    int chunk_slot0, int leaf_size, int lpg, float4* s_prim, int32_t* s_slot,
    float* t_out, int32_t* slot_out) {
  const int nc = row[0];
  const Ray ray = load_ray(f);
  const int total = row_leaves(nc, lpg);
  const int leaves_per_stage = kStage / leaf_size;
  float ub = -kBig;
  int ib = kNoSlot;
  for (int j0 = 0; j0 < total; j0 += leaves_per_stage) {
    const int np = min(leaves_per_stage, total - j0) * leaf_size;
    stage(row, nc, j0, np, leaf_size, lpg, cprims, chunk_slot0, s_prim,
          s_slot);
    __syncthreads();
    for (int i = 0; i < np; ++i) {
      float disc;
      const float u = ray_prim_u(ray, s_prim[i], &disc);
      const int slot = s_slot[i];
      if (disc > 0.0f && u < -ray.epsa && (u > ub || (u == ub && slot < ib))) {
        ub = u;
        ib = slot;
      }
    }
    __syncthreads();
  }
  *t_out = ib < kNoSlot ? __fmul_rn(-ub, ray.inva) : kBig;
  *slot_out = ib;
}

}  // namespace walk

// leafcull_cuda: closest hit of each ray against the prims of its
// subpacket's candidate leaves.
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
//     shared memory, then every thread tests every staged prim;
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kNoSlot = 1 << 30;
constexpr int kFeat = 16;
constexpr int kStage = 512;   // prims staged per batch (8 KB of float4)

__global__ void leafcull_kernel(const float* __restrict__ feats,
                                const int32_t* __restrict__ cand,
                                const float4* __restrict__ prims,
                                float* __restrict__ t_out,
                                int32_t* __restrict__ slot_out,
                                int G, int S, int SP, int rowlen,
                                int leaf_size, int lpc, int lpg) {
  __shared__ float4 s_prim[kStage];
  __shared__ int32_t s_slot[kStage];

  const int blk = blockIdx.x;
  const int s = blk % S;
  const int g = (blk / S) % G;
  const int c = blk / (S * G);
  const int r = threadIdx.x;

  const int32_t* row = cand + ((size_t)(c * G + g) * S + s) * rowlen;
  const int nc = row[0];
  const size_t out = (((size_t)c * G + g) * SP + r) * S + s;
  if (nc == 0) {
    t_out[out] = kBig;
    slot_out[out] = kNoSlot;
    return;
  }

  // Ray features (leafcull._feature_rows): d, -2o, 1, 0, o.d, |o|^2, a,
  // 1/a, eps*a.
  const float* f = feats + (((size_t)g * S + s) * SP + r) * kFeat;
  const float dx = f[0], dy = f[1], dz = f[2];
  const float nox2 = f[3], noy2 = f[4], noz2 = f[5];
  const float od = f[8], oo = f[9], av = f[10], inva = f[11], epsa = f[12];

  const int total = nc > 0 ? nc : -nc * lpg;
  const int leaves_per_stage = kStage / leaf_size;
  const float4* cprims = prims + (size_t)c * lpc * leaf_size;
  const int chunk_slot0 = c * lpc * leaf_size;

  float ub = -kBig;
  int ib = kNoSlot;
  for (int j0 = 0; j0 < total; j0 += leaves_per_stage) {
    const int np = min(leaves_per_stage, total - j0) * leaf_size;
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      const int j = j0 + i / leaf_size;
      const int leaf = nc > 0 ? row[1 + j] : row[1 + j / lpg] * lpg + j % lpg;
      const int p = leaf * leaf_size + i % leaf_size;
      s_prim[i] = cprims[p];
      s_slot[i] = chunk_slot0 + p;
    }
    __syncthreads();
    for (int i = 0; i < np; ++i) {
      const float4 q = s_prim[i];
      const float m1 = __fadd_rn(__fadd_rn(__fmul_rn(dx, q.x),
                                           __fmul_rn(dy, q.y)),
                                 __fmul_rn(dz, q.z));          // c.d
      const float m2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(nox2, q.x),
                                                     __fmul_rn(noy2, q.y)),
                                           __fmul_rn(noz2, q.z)),
                                 q.w);                         // -2o.c + ccr
      const float bp = __fsub_rn(od, m1);                      // oc.d
      const float cq = __fadd_rn(m2, oo);                      // |oc|^2 - r^2
      const float disc = __fsub_rn(__fmul_rn(bp, bp), __fmul_rn(av, cq));
      // t = (-bp - sqrt(disc)) / a = -u / a: the smallest valid t is the
      // largest u below -eps*a.
      const float u = __fadd_rn(bp, sqrtf(fmaxf(disc, 0.0f)));
      const int slot = s_slot[i];
      if (disc > 0.0f && u < -epsa && (u > ub || (u == ub && slot < ib))) {
        ub = u;
        ib = slot;
      }
    }
    __syncthreads();
  }
  t_out[out] = ib < kNoSlot ? __fmul_rn(-ub, inva) : kBig;
  slot_out[out] = ib;
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

// conecull_cuda: the phase-B walk. Closest hit of each ray against the prims
// of its subpacket's candidate leaves, per table chunk, where every walked
// prim is first tested against the subpacket's bounding cone and only the
// survivors get the quadratic test.
//
// Replaces the TPU kernel tracer/kernels/conecull.py:_conecull_kernel,
// reached through conecull._conecull_call. What it computes is the same;
// the TPU mechanics are gone: no lane-quarter leaf assembly from
// pair-packed entries, no 7-pass butterfly compaction of 128-lane rows, no
// (8, 16, 128) block-major accumulator with its two-pass drain, no SMEM
// cone scalars.
//   * one CTA of SP threads per (chunk c, packet g, subpacket s), one ray per
//     thread; grid (C * G * S);
//   * the CTA walks its row's prims SP at a time in walk order (listed
//     leaves, or every member leaf of the listed groups; leaf ids at or past
//     lpc hold no prim), one prim per thread, and each thread cone-tests its
//     prim;
//   * survivors are compacted with __ballot_sync / __popc inside each warp
//     and a prefix over the warps' counts in shared memory, and appended
//     (prim, global slot) to a shared buffer of 2 * SP entries;
//   * whenever SP or more are buffered, every thread tests its ray against
//     the first SP of them with walk::ray_prim_u and keeps (u, slot) by
//     "larger u, or equal u and lower slot"; the rest move down. The buffer
//     is drained at the end. That update rule makes the order in which the
//     survivors arrive irrelevant: the result is the leaf walk's, bit for
//     bit, because the cone test only drops prims that no ray of the
//     subpacket can accept.
// The cone test and the quadratic are spelled with __fmul_rn / __fadd_rn /
// __fsqrt_rn in the plain version's order, so conecull_plain gives the same
// t, slots and survivor counts.
//
// Bound on this card: operations. ~22 fp32 operations per cone test (one per
// walked prim per subpacket) and ~19 per (ray, survivor) quadratic test; the
// prims sit in L2. The walk is a loop of barriers per SP prims, so rows with
// few prims leave threads idle; that is for a later tuning pass.

#include "walk.cuh"

namespace {

constexpr int kConeFeat = 16;
constexpr float kSentinelCcr = 1.0e29f;

struct Cone {
  float o0x, o0y, o0z, ux, uy, uz, cth, rho2, sinrho;
};

__device__ __forceinline__ Cone load_cone(const float* k) {
  Cone c;
  c.o0x = k[0]; c.o0y = k[1]; c.o0z = k[2];
  c.ux = k[3]; c.uy = k[4]; c.uz = k[5];
  c.cth = k[7]; c.rho2 = k[9]; c.sinrho = k[10];
  return c;
}

// conecull.cone_keep: kept when u.v + sin*rho >= cos*sqrt(max(q, 0)) or
// q <= 0, with v = c - o0 and q = |v|^2 - rho^2; never for a slot that holds
// no sphere.
__device__ __forceinline__ bool cone_keep(const Cone& k, float4 p) {
  const float vx = __fsub_rn(p.x, k.o0x);
  const float vy = __fsub_rn(p.y, k.o0y);
  const float vz = __fsub_rn(p.z, k.o0z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                             __fmul_rn(vz, vz));
  const float uv = __fadd_rn(__fadd_rn(__fmul_rn(k.ux, vx),
                                       __fmul_rn(k.uy, vy)),
                             __fmul_rn(k.uz, vz));
  const float q = __fsub_rn(d2, k.rho2);
  const float sq = __fsqrt_rn(fmaxf(q, 0.0f));
  return (__fadd_rn(uv, k.sinrho) >= __fmul_rn(k.cth, sq) || q <= 0.0f) &&
         p.w < kSentinelCcr;
}

__device__ __forceinline__ void test_buffered(const walk::Ray& ray,
                                              const float4* s_prim,
                                              const int32_t* s_slot, int n,
                                              float* ub, int* ib) {
  for (int i = 0; i < n; ++i) {
    float disc;
    const float u = walk::ray_prim_u(ray, s_prim[i], &disc);
    const int slot = s_slot[i];
    if (disc > 0.0f && u < -ray.epsa &&
        (u > *ub || (u == *ub && slot < *ib))) {
      *ub = u;
      *ib = slot;
    }
  }
}

__global__ void conecull_kernel(const float* __restrict__ feats,
                                const int32_t* __restrict__ cand,
                                const float* __restrict__ cones,
                                const float4* __restrict__ prims,
                                float* __restrict__ t_out,
                                int32_t* __restrict__ slot_out,
                                int32_t* __restrict__ kept_out, int G, int S,
                                int SP, int rowlen, int leaf_size, int lpc,
                                int lpg) {
  extern __shared__ float4 s_prim[];                     // 2 * SP prims
  int32_t* s_slot = (int32_t*)(s_prim + 2 * SP);         // 2 * SP slots
  int32_t* s_cnt = s_slot + 2 * SP;                      // one per warp

  const int blk = blockIdx.x;
  const int s = blk % S;
  const int g = (blk / S) % G;
  const int c = blk / (S * G);
  const int r = threadIdx.x;
  const int warp = r >> 5, lane = r & 31, nwarps = SP >> 5;

  const int32_t* row = cand + ((size_t)(c * G + g) * S + s) * rowlen;
  const walk::Ray ray =
      walk::load_ray(feats + (((size_t)g * S + s) * SP + r) * walk::kFeat);
  const Cone cone = load_cone(cones + ((size_t)g * S + s) * kConeFeat);
  const int chunk_slot0 = c * lpc * leaf_size;
  const float4* cprims = prims + chunk_slot0;
  const int nc = row[0];
  const int total = walk::row_leaves(nc, lpg) * leaf_size;

  float ub = -walk::kBig;
  int ib = walk::kNoSlot;
  int nbuf = 0, kept = 0;
  for (int base = 0; base < total; base += SP) {
    const int i = base + r;
    bool keep = false;
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int slot = 0;
    if (i < total) {
      const int j = i / leaf_size;
      const int leaf = nc > 0 ? row[1 + j] : row[1 + j / lpg] * lpg + j % lpg;
      if (leaf < lpc) {
        const int ps = leaf * leaf_size + i % leaf_size;
        p = cprims[ps];
        slot = chunk_slot0 + ps;
        keep = cone_keep(cone, p);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, added = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int n = s_cnt[w];
      before += w < warp ? n : 0;
      added += n;
    }
    if (keep) {
      const int at = nbuf + before + __popc(ballot & ((1u << lane) - 1u));
      s_prim[at] = p;
      s_slot[at] = slot;
    }
    nbuf += added;
    kept += added;
    __syncthreads();
    if (nbuf >= SP) {
      test_buffered(ray, s_prim, s_slot, SP, &ub, &ib);
      __syncthreads();
      const int rest = nbuf - SP;
      if (r < rest) {
        s_prim[r] = s_prim[SP + r];
        s_slot[r] = s_slot[SP + r];
      }
      nbuf = rest;
      __syncthreads();
    }
  }
  test_buffered(ray, s_prim, s_slot, nbuf, &ub, &ib);

  const size_t out = (((size_t)c * G + g) * SP + r) * S + s;
  t_out[out] = ib < walk::kNoSlot ? __fmul_rn(-ub, ray.inva) : walk::kBig;
  slot_out[out] = ib;
  if (r == 0) kept_out[((size_t)c * G + g) * S + s] = kept;
}

}  // namespace

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; cones (G, S, 16) f32;
// prims (C, lpc * leaf_size, 4) f32; t / slot (C, G, SP, S); kept (C, G, S)
// i32. SP must be a multiple of 32, at most 1024. Returns cudaGetLastError()
// after the launch.
extern "C" int tracer_conecull(const void* feats, const void* cand,
                               const void* cones, const void* prims, void* t,
                               void* slot, void* kept, int C, int G, int S,
                               int SP, int rowlen, int leaf_size, int lpc,
                               int lpg, void* stream) {
  const long long blocks = (long long)C * G * S;
  const size_t smem = (size_t)2 * SP * (sizeof(float4) + sizeof(int32_t)) +
                      (size_t)(SP / 32) * sizeof(int32_t);
  if (blocks > 0) {
    conecull_kernel<<<(unsigned)blocks, SP, smem, (cudaStream_t)stream>>>(
        (const float*)feats, (const int32_t*)cand, (const float*)cones,
        (const float4*)prims, (float*)t, (int32_t*)slot, (int32_t*)kept, G, S,
        SP, rowlen, leaf_size, lpc, lpg);
  }
  return (int)cudaGetLastError();
}

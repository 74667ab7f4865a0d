// soft_cuda: the checked soft evaluation's composite and its backward on
// the card (diff/sparse.py soft_composite_cuda, soft_backward_cuda), over
// one block of subpackets sorted by their candidate leaves. Three entry
// points:
//   * soft_gather: a warp a subpacket walks its listed leaves' slots and
//     writes the real ones (a slot that holds a sphere) as two rows,
//     (cx, cy, cz, r) and (a0, a1, a2, sphere id), at the subpacket's
//     offset, in slot order; padding slots are dropped here, before any
//     per-ray work (they carry sigma 0 and t past every real candidate in
//     the model, so they add exactly 0 to every sum and gradient);
//   * soft_rays: a team (a warp, or the CTA's 256 threads for wide
//     subpackets) a ray computes every candidate's t, sorts the 64-bit
//     keys (t's order-preserving bits, candidate index) by a bitonic
//     network, its stages of pairs at most 32 apart in registers, the
//     wider ones in shared memory (device memory past 16,384 keys), so
//     the order is torch.argsort(stable=True)'s; then in that order the
//     forward scan (s = sigma (1 - 1e-6), L = log1p(-s), E the exclusive
//     prefix, w = s exp(E), the image), the ray's loss term and d loss /
//     d image (clip's 0.5 on either bound), and the reverse scan
//     R_i = sum_{k>i} w_k G_k + T sum_c g_c bg_c, to d loss / d sigma_i =
//     (exp(E_i) G_i - R_i / (1 - s_i)) (1 - 1e-6), written with w_i at
//     (ray, candidate) in a plane of 8 bytes a lane, where the forward
//     scan left (s_i, mirror.y_i) for the reverse one;
//   * soft_grads: a thread a candidate runs over the subpacket's rays,
//     recomputes the lane's forward and takes its derivatives to (c, r)
//     and albedo, sums them in registers, and adds them into the scene's
//     gradients with one atomic a (subpacket, candidate, attribute).
//
// Replaces no TPU kernel: the JAX package computes this composite with
// XLA operations (tracer/diff/sparse.py), and the port first wrote it as
// ~40 torch planes forward and ~60 autograd planes backward a block
// (diff/sparse.py _soft_block, the tests' oracle).
//
// Bound on this card: operations. At grad_100k's 131,072 rays about 140 M
// real (ray, candidate) pairs, each needing one forward and one backward,
// ~200 float32 operations and ~16 special-function ones: ~0.95 ms at 67
// TFLOP/s and the special-function units' ~4.2 T/s (chip_smoke.py's
// bound); the sort's bitonic network, K log2(K)^2 / 4 compare-exchanges a
// ray of K keys, comes on top; bytes: the candidate rows (~80 MB) and the
// plane (~2.2 GB written and read once, twice for (s, mirror.y)), ~1.3 ms
// at 3.35 TB/s where L2 does not hold it. The design keeps to it: nothing
// of a lane lives in device memory but its 8 bytes of the plane, a lane's
// forward runs three times (t for the key, the forward scan, the
// backward) where storing it would cost ~150 bytes a lane, the ray-major
// work (sort, scans) and the candidate-major work (the reduction over
// rays) each run on their own axis, wide subpackets spread over one CTA
// a ray. The forward rounds as the torch operations do (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn, expf; nothing contracted into an
// FMA), so t, sigma and mirror.y are bit for bit those of diff/sparse.py
// _lane_forward on the card, and the sort orders as torch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kKeep = (float)(1.0 - 1e-6);
constexpr float kZ0 = (float)(128.0 / 255.0);
constexpr float kZ1 = (float)(178.0 / 255.0);
constexpr int kMaxSP = 128;    // rays a subpacket (soft_grads' rows)
constexpr int kChunk = 128;    // candidates a soft_grads CTA
constexpr int kThreads = 256;  // soft_gather, soft_rays

struct RayRow {
  float ox, oy, oz, dx, dy, dz, inva, sinva;
};

__device__ __forceinline__ RayRow load_ray(const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           long row) {
  RayRow q;
  q.ox = o[3 * row];
  q.oy = o[3 * row + 1];
  q.oz = o[3 * row + 2];
  q.dx = d[3 * row];
  q.dy = d[3 * row + 1];
  q.dz = d[3 * row + 2];
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(q.dx, q.dx),
                                      __fmul_rn(q.dy, q.dy)),
                            __fmul_rn(q.dz, q.dz));
  q.inva = __fdiv_rn(1.f, fmaxf(a, 1e-30f));
  q.sinva = __fsqrt_rn(q.inva);
  return q;
}

// The values of a lane's forward that its backward reads.
struct Lane {
  float qx, qy, qz, qq, ser, perp, mr, sdf, v1, e1, y1, disc, h, t, v2, e2,
      y2, sigma, px, py, pz, pp, nn, nx, ny, nz, dn, my;
};

// soft._sigmoid(x) = 1 / (1 + exp(clip(-x, -30, 30))), with v = -x and
// e = exp(clip(v)).
__device__ __forceinline__ float sig_parts(float x, float& v, float& e) {
  v = -x;
  e = expf(fminf(fmaxf(v, -30.f), 30.f));
  return __fdiv_rn(1.f, __fadd_rn(1.f, e));
}

// t_ca and the perpendicular vector's squared length, then t_soft: the
// first steps of lane_forward, in its operations.
__device__ __forceinline__ float lane_t(const RayRow& q, float4 c, float se,
                                        Lane& f) {
  const float ocx = __fsub_rn(c.x, q.ox);
  const float ocy = __fsub_rn(c.y, q.oy);
  const float ocz = __fsub_rn(c.z, q.oz);
  const float tca = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ocx, q.dx), __fmul_rn(ocy, q.dy)),
                __fmul_rn(ocz, q.dz)),
      q.inva);
  f.qx = __fsub_rn(ocx, __fmul_rn(tca, q.dx));
  f.qy = __fsub_rn(ocy, __fmul_rn(tca, q.dy));
  f.qz = __fsub_rn(ocz, __fmul_rn(tca, q.dz));
  f.qq = __fadd_rn(__fadd_rn(__fmul_rn(f.qx, f.qx), __fmul_rn(f.qy, f.qy)),
                   __fmul_rn(f.qz, f.qz));
  const float perp2 = fmaxf(f.qq, 0.f);
  f.ser = __fmul_rn(se, c.w);
  const float eps2 = __fmul_rn(f.ser, f.ser);
  f.perp = __fsqrt_rn(__fadd_rn(perp2, eps2));
  f.disc = __fsub_rn(__fmul_rn(c.w, c.w), perp2);
  f.h = __fsqrt_rn(__fadd_rn(fmaxf(f.disc, 0.f), eps2));
  f.t = __fsub_rn(tca, __fmul_rn(__fsub_rn(f.h, f.ser), q.sinva));
  return f.t;
}

// diff/sparse.py _lane_forward: sigma, t_soft and mirror.y of a
// (ray, candidate) lane, c = (cx, cy, cz, r).
__device__ __forceinline__ void lane_forward(const RayRow& q, float4 c,
                                             float es, float se, Lane& f) {
  lane_t(q, c, se, f);
  f.mr = fmaxf(c.w, 1e-6f);
  f.sdf = __fdiv_rn(__fsub_rn(f.perp, c.w), f.mr);
  f.y1 = sig_parts(__fmul_rn(-f.sdf, es), f.v1, f.e1);
  f.y2 = sig_parts(__fmul_rn(f.t, es), f.v2, f.e2);
  f.sigma = __fmul_rn(f.y1, f.y2);
  f.px = __fsub_rn(__fadd_rn(q.ox, __fmul_rn(f.t, q.dx)), c.x);
  f.py = __fsub_rn(__fadd_rn(q.oy, __fmul_rn(f.t, q.dy)), c.y);
  f.pz = __fsub_rn(__fadd_rn(q.oz, __fmul_rn(f.t, q.dz)), c.z);
  f.pp = __fadd_rn(__fadd_rn(__fmul_rn(f.px, f.px), __fmul_rn(f.py, f.py)),
                   __fmul_rn(f.pz, f.pz));
  f.nn = __fsqrt_rn(fmaxf(f.pp, 1e-20f));
  f.nx = __fdiv_rn(f.px, f.nn);
  f.ny = __fdiv_rn(f.py, f.nn);
  f.nz = __fdiv_rn(f.pz, f.nn);
  f.dn = __fadd_rn(__fadd_rn(__fmul_rn(q.dx, f.nx), __fmul_rn(q.dy, f.ny)),
                   __fmul_rn(q.dz, f.nz));
  f.my = __fsub_rn(q.dy, __fmul_rn(__fmul_rn(2.f, f.dn), f.ny));
}

// A candidate's shade, albedo + 0.5 sky(mirror); the shade's blue sky is 1.
__device__ __forceinline__ void shade(float4 a, float my, float& s0,
                                      float& s1, float& s2) {
  const float t = __fmul_rn(0.5f, __fadd_rn(my, 1.f));
  const float u = __fsub_rn(1.f, t);
  s0 = __fadd_rn(a.x, __fmul_rn(0.5f, __fadd_rn(u, __fmul_rn(t, kZ0))));
  s1 = __fadd_rn(a.y, __fmul_rn(0.5f, __fadd_rn(u, __fmul_rn(t, kZ1))));
  s2 = __fadd_rn(a.z, 0.5f);
}

// d maximum(x, c) / dx: 1 above c, 0.5 at it, 0 below.
__device__ __forceinline__ float tie(float x, float c) {
  return x > c ? 1.f : (x == c ? 0.5f : 0.f);
}

__device__ __forceinline__ float sig_grad(float gy, float v, float e,
                                          float y) {
  return gy * (y * y) * e * (tie(v, -30.f) * tie(-v, -30.f));
}

// diff/sparse.py _lane_backward: d loss / d (cx, cy, cz, r) of a lane from
// d loss / d sigma and d loss / d mirror.y, added into g.
__device__ __forceinline__ void lane_backward(const RayRow& q, const Lane& f,
                                              float r, float gsig, float gmy,
                                              float es, float se, float* g) {
  const float gx1 = sig_grad(gsig * f.y2, f.v1, f.e1, f.y1);
  const float gx2 = sig_grad(gsig * f.y1, f.v2, f.e2, f.y2);
  float gt = gx2 * es;
  const float gnum = -(gx1 * es) / f.mr;
  float gr = -gnum - gnum * f.sdf * tie(r, 1e-6f);
  const float gpe = gnum * 0.5f / f.perp;
  const float gdn = -2.f * gmy * f.ny;
  const float gnx = gdn * q.dx;
  const float gny = gdn * q.dy - gmy * (2.f * f.dn);
  const float gnz = gdn * q.dz;
  const float gnn = -(gnx * f.nx + gny * f.ny + gnz * f.nz) / f.nn;
  const float gpp = gnn * 0.5f / f.nn * tie(f.pp, 1e-20f);
  const float gpx = gnx / f.nn + 2.f * f.px * gpp;
  const float gpy = gny / f.nn + 2.f * f.py * gpp;
  const float gpz = gnz / f.nn + 2.f * f.pz * gpp;
  gt = gt + (gpx * q.dx + gpy * q.dy + gpz * q.dz);
  const float gsq = -gt * q.sinva;
  const float gh = gsq * 0.5f / f.h;
  const float gdisc = gh * tie(f.disc, 0.f);
  gr = gr - gsq * se + 2.f * r * gdisc + (gpe + gh) * 2.f * f.ser * se;
  const float gqq = (gpe - gdisc) * tie(f.qq, 0.f);
  const float gqx = 2.f * f.qx * gqq;
  const float gqy = 2.f * f.qy * gqq;
  const float gqz = 2.f * f.qz * gqq;
  const float gdot = (gt - (gqx * q.dx + gqy * q.dy + gqz * q.dz)) * q.inva;
  g[0] += gqx + gdot * q.dx - gpx;
  g[1] += gqy + gdot * q.dy - gpy;
  g[2] += gqz + gdot * q.dz - gpz;
  g[3] += gr;
}

// t's bits in an order that sorts as the floats (-0 as +0).
__device__ __forceinline__ uint32_t ordered(float t) {
  const uint32_t u = __float_as_uint(__fadd_rn(t, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A team of TEAM threads on one ray: a warp, or the whole CTA.
template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if (TEAM == 32) __syncwarp(); else __syncthreads();
}

// The exclusive prefix sum of v over the team's ranks; total = the sum.
template <int TEAM>
__device__ __forceinline__ float team_excl(float v, float& total,
                                           float* wsum) {
  const int lane = threadIdx.x & 31;
  float x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  float ex = __shfl_up_sync(kFull, x, 1);
  ex = lane == 0 ? 0.f : ex;
  if (TEAM == 32) {
    total = __shfl_sync(kFull, x, 31);
    return ex;
  }
  const int warp = threadIdx.x >> 5;
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  float before = 0.f, tot = 0.f;
#pragma unroll
  for (int k = 0; k < TEAM / 32; ++k) {
    const float s = wsum[k];
    if (k < warp) before += s;
    tot += s;
  }
  __syncthreads();
  total = tot;
  return before + ex;
}

// The sum of v over the team's higher ranks; total = the sum.
template <int TEAM>
__device__ __forceinline__ float team_suffix_excl(float v, float& total,
                                                  float* wsum) {
  const int lane = threadIdx.x & 31;
  float x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(kFull, x, o);
    if (lane + o < 32) x += y;
  }
  float ex = __shfl_down_sync(kFull, x, 1);
  ex = lane == 31 ? 0.f : ex;
  if (TEAM == 32) {
    total = __shfl_sync(kFull, x, 0);
    return ex;
  }
  const int warp = threadIdx.x >> 5;
  if (lane == 0) wsum[warp] = x;
  __syncthreads();
  float after = 0.f, tot = 0.f;
#pragma unroll
  for (int k = 0; k < TEAM / 32; ++k) {
    const float s = wsum[k];
    if (k > warp) after += s;
    tot += s;
  }
  __syncthreads();
  total = tot;
  return after + ex;
}

template <int TEAM>
__device__ __forceinline__ float team_sum(float v, float* wsum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (TEAM == 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) wsum[warp] = v;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < TEAM / 32; ++k) tot += wsum[k];
  __syncthreads();
  return tot;
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
  const uint32_t lo = __shfl_xor_sync(kFull, (uint32_t)v, mask);
  const uint32_t hi = __shfl_xor_sync(kFull, (uint32_t)(v >> 32), mask);
  return ((uint64_t)hi << 32) | lo;
}

// Stages j = jmax .. 1 of the bitonic merge of size k on one aligned
// group of 64 keys, held by a warp as a = keys[base + lane] and
// b = keys[base + lane + 32]: j = 32 pairs a with b, smaller j pair lanes.
__device__ __forceinline__ void group_stages(uint64_t& a, uint64_t& b,
                                             int base, int lane, int k,
                                             int jmax) {
  const bool up_a = ((base + lane) & k) == 0;
  const bool up_b = ((base + lane + 32) & k) == 0;
  for (int j = jmax; j > 0; j >>= 1) {
    if (j == 32) {
      if ((a > b) == up_a) {
        const uint64_t t = a;
        a = b;
        b = t;
      }
    } else {
      const uint64_t pa = shfl_xor64(a, j), pb = shfl_xor64(b, j);
      // The lower element of a pair keeps the smaller key when ascending.
      const bool lower = (lane & j) == 0;
      a = (lower == up_a) ? (a < pa ? a : pa) : (a < pa ? pa : a);
      b = (lower == up_b) ? (b < pb ? b : pb) : (b < pb ? pb : b);
    }
  }
}

// Bitonic sort of keys[0, m), m a power of two of at least 64, ascending,
// by the team. Every stage that pairs keys at most 32 apart runs in
// registers on aligned groups of 64, a warp a group (the first six merge
// sizes whole); the stages of wider pairs go through memory.
template <int TEAM>
__device__ void team_sort(uint64_t* keys, int m, int rank) {
  const int lane = threadIdx.x & 31;
  for (int g = rank >> 5; g < (m >> 6); g += TEAM / 32) {
    const int base = g << 6;
    uint64_t a = keys[base + lane], b = keys[base + lane + 32];
    for (int k = 2; k <= 64; k <<= 1) group_stages(a, b, base, lane, k, k >> 1);
    keys[base + lane] = a;
    keys[base + lane + 32] = b;
  }
  team_sync<TEAM>();
  for (int k = 128; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int i = rank; i < (m >> 1); i += TEAM) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      team_sync<TEAM>();
    }
    for (int g = rank >> 5; g < (m >> 6); g += TEAM / 32) {
      const int base = g << 6;
      uint64_t a = keys[base + lane], b = keys[base + lane + 32];
      group_stages(a, b, base, lane, k, 32);
      keys[base + lane] = a;
      keys[base + lane + 32] = b;
    }
    team_sync<TEAM>();
  }
}

__global__ void __launch_bounds__(kThreads)
soft_gather(const int32_t* __restrict__ leaf_ids,
            const uint8_t* __restrict__ valid, int ldw,
            const int32_t* __restrict__ s2s, int ls,
            const float* __restrict__ centers,
            const float* __restrict__ radii,
            const float* __restrict__ albedo,
            const int32_t* __restrict__ off, int P,
            float4* __restrict__ cand, float4* __restrict__ alb,
            int32_t* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (p >= P) return;
  const int base = off[p];
  const int width = (off[p + 1] - base) / ls;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int l = 0; l < width; ++l) {
    const long at = (long)p * ldw + l;
    if (!valid[at]) continue;
    const long lid = leaf_ids[at];
    for (int s0 = 0; s0 < ls; s0 += 32) {
      const int s = s0 + lane;
      const int sid = s < ls ? s2s[lid * ls + s] : -1;
      const unsigned real = __ballot_sync(kFull, sid >= 0);
      if (sid >= 0) {
        const int k = base + n + __popc(real & below);
        cand[k] = make_float4(centers[3L * sid], centers[3L * sid + 1],
                              centers[3L * sid + 2], radii[sid]);
        alb[k] = make_float4(albedo[3L * sid], albedo[3L * sid + 1],
                             albedo[3L * sid + 2], __int_as_float(sid));
      }
      n += __popc(real);
    }
  }
  if (lane == 0) count[p] = n;
}

// One ray a team: rows p0 .. p0 + np - 1 of the block, SP rays each;
// teams a CTA, SP / teams CTAs a subpacket. keys: kcap 64-bit keys a team,
// in dynamic shared memory where gkeys is null.
template <int TEAM>
__global__ void __launch_bounds__(kThreads)
soft_rays(const float4* __restrict__ cand, const float4* __restrict__ alb,
          const int32_t* __restrict__ off, const int32_t* __restrict__ count,
          const float* __restrict__ o, const float* __restrict__ d,
          const int32_t* __restrict__ owner,
          const float* __restrict__ target, float* __restrict__ img,
          float* __restrict__ term, float4* __restrict__ gray,
          float2* __restrict__ plane, uint64_t* __restrict__ gkeys, int p0,
          int teams, int kcap, int SP, int n, float es, float se,
          float scale) {
  extern __shared__ uint64_t skeys[];
  __shared__ float wsum[kThreads / 32];
  const int team = threadIdx.x / TEAM, rank = threadIdx.x % TEAM;
  const int groups = SP / teams;
  const int p = p0 + blockIdx.x / groups;
  const int ray = (blockIdx.x % groups) * teams + team;
  const long row = (long)p * SP + ray;
  uint64_t* keys = gkeys != nullptr
      ? gkeys + ((long)blockIdx.x * teams + team) * kcap
      : skeys + (long)team * kcap;
  const int own = owner[row];
  if (own >= n) {  // bucket padding: no image, no loss, no gradient
    if (rank == 0) {
      img[3 * row] = img[3 * row + 1] = img[3 * row + 2] = 0.f;
      term[row] = 0.f;
      gray[row] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int base = off[p], cap = off[p + 1] - base, cnt = count[p];
  const float4* cd = cand + base;
  const float4* ad = alb + base;
  const RayRow q = load_ray(o, d, row);
  int m = 64;
  while (m < cnt) m <<= 1;
  for (int j = rank; j < m; j += TEAM) {
    uint64_t key = ~0ull;
    if (j < cnt) {
      Lane f;
      key = ((uint64_t)ordered(lane_t(q, cd[j], se, f)) << 32) | (uint32_t)j;
    }
    keys[j] = key;
  }
  team_sync<TEAM>();
  team_sort<TEAM>(keys, m, rank);

  // Forward scan in t order; E replaces t in the key, and (s, mirror.y)
  // wait in the candidate's slot of the plane for the reverse scan.
  float2* pl = plane + (long)SP * base + (long)ray * cap;
  float carry = 0.f, acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  for (int i0 = 0; i0 < cnt; i0 += TEAM) {
    const int i = i0 + rank;
    float s = 0.f, L = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
    uint32_t j = 0;
    if (i < cnt) {
      j = (uint32_t)keys[i];
      Lane f;
      lane_forward(q, cd[j], es, se, f);
      s = __fmul_rn(f.sigma, kKeep);
      L = log1pf(-s);
      shade(ad[j], f.my, s0, s1, s2);
      pl[j] = make_float2(s, f.my);
    }
    float tot;
    const float ex = team_excl<TEAM>(L, tot, wsum);
    if (i < cnt) {
      const float E = __fadd_rn(carry, ex);
      const float w = __fmul_rn(s, expf(E));
      acc0 += w * s0;
      acc1 += w * s1;
      acc2 += w * s2;
      keys[i] = ((uint64_t)__float_as_uint(E) << 32) | j;
    }
    carry = __fadd_rn(carry, tot);
  }
  const float T = expf(carry);
  const float tb = __fmul_rn(0.5f, __fadd_rn(q.dy, 1.f));
  const float ub = __fsub_rn(1.f, tb);
  const float bg[3] = {__fadd_rn(ub, __fmul_rn(tb, kZ0)),
                       __fadd_rn(ub, __fmul_rn(tb, kZ1)),
                       __fadd_rn(ub, __fmul_rn(tb, 1.f))};
  const float x[3] = {
      __fadd_rn(team_sum<TEAM>(acc0, wsum), __fmul_rn(T, bg[0])),
      __fadd_rn(team_sum<TEAM>(acc1, wsum), __fmul_rn(T, bg[1])),
      __fadd_rn(team_sum<TEAM>(acc2, wsum), __fmul_rn(T, bg[2]))};
  float g[3], im[3], tm = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    im[c] = fminf(fmaxf(x[c], 0.f), 1.f);
    const float cdv = tie(x[c], 0.f) * tie(-fmaxf(x[c], 0.f), -1.f);
    if (target != nullptr) {
      const float df = im[c] - target[3L * own + c];
      tm += df * df;
      g[c] = 2.f * df * scale * cdv;
    } else {
      tm += im[c];
      g[c] = scale * cdv;
    }
  }
  if (rank == 0) {
    img[3 * row] = im[0];
    img[3 * row + 1] = im[1];
    img[3 * row + 2] = im[2];
    term[row] = tm;
    gray[row] = make_float4(g[0], g[1], g[2], 0.f);
  }
  team_sync<TEAM>();

  // Reverse scan: R_i = sum_{k>i} w_k G_k + T sum_c g_c bg_c. Each
  // position is read back by the thread that wrote it.
  carry = T * (g[0] * bg[0] + g[1] * bg[1] + g[2] * bg[2]);
  for (int i0 = cnt > 0 ? ((cnt - 1) / TEAM) * TEAM : -1; i0 >= 0;
       i0 -= TEAM) {
    const int i = i0 + rank;
    float s = 0.f, eE = 0.f, w = 0.f, G = 0.f;
    uint32_t j = 0;
    if (i < cnt) {
      const uint64_t k = keys[i];
      j = (uint32_t)k;
      const float2 sm = pl[j];
      s = sm.x;
      eE = expf(__uint_as_float((uint32_t)(k >> 32)));
      w = __fmul_rn(s, eE);
      float s0, s1, s2;
      shade(ad[j], sm.y, s0, s1, s2);
      G = g[0] * s0 + g[1] * s1 + g[2] * s2;
    }
    float tot;
    const float after = team_suffix_excl<TEAM>(w * G, tot, wsum);
    if (i < cnt) {
      const float R = carry + after;
      pl[j] = make_float2((eE * G - R / (1.f - s)) * kKeep, w);
    }
    carry += tot;
  }
}

// A thread a candidate of subpacket p0 + blockIdx.y, over its SP rays.
__global__ void __launch_bounds__(kChunk)
soft_grads(const float4* __restrict__ cand, const float4* __restrict__ alb,
           const int32_t* __restrict__ off,
           const int32_t* __restrict__ count, const float* __restrict__ o,
           const float* __restrict__ d, const float4* __restrict__ gray,
           const float2* __restrict__ plane, float* __restrict__ gc,
           float* __restrict__ gr, float* __restrict__ ga, int p0, int SP,
           float es, float se) {
  __shared__ RayRow rays[kMaxSP];
  __shared__ float4 grow[kMaxSP];
  const int p = p0 + blockIdx.y;
  const int base = off[p], cap = off[p + 1] - base, cnt = count[p];
  if (blockIdx.x * kChunk >= cnt) return;
  for (int r = threadIdx.x; r < SP; r += kChunk) {
    const long row = (long)p * SP + r;
    rays[r] = load_ray(o, d, row);
    const float4 g = gray[row];
    // w: the mirror's term 0.25 sum_{c<2} g_c (z_c - 1).
    grow[r] = make_float4(g.x, g.y, g.z,
                          0.25f * (g.x * (kZ0 - 1.f) + g.y * (kZ1 - 1.f)));
  }
  __syncthreads();
  const int j = blockIdx.x * kChunk + threadIdx.x;
  if (j >= cnt) return;
  const float4 c = cand[base + j];
  const float4 a = alb[base + j];
  const float2* pl = plane + (long)SP * base + j;
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  float ga0 = 0.f, ga1 = 0.f, ga2 = 0.f;
  for (int r = 0; r < SP; ++r) {
    const float4 gw = grow[r];
    if (gw.x == 0.f && gw.y == 0.f && gw.z == 0.f) continue;
    const float2 u = pl[(long)r * cap];
    const RayRow q = rays[r];
    Lane f;
    lane_forward(q, c, es, se, f);
    ga0 += gw.x * u.y;
    ga1 += gw.y * u.y;
    ga2 += gw.z * u.y;
    lane_backward(q, f, c.w, u.x, u.y * gw.w, es, se, g);
  }
  const long sid = __float_as_int(a.w);
  atomicAdd(gc + 3 * sid, g[0]);
  atomicAdd(gc + 3 * sid + 1, g[1]);
  atomicAdd(gc + 3 * sid + 2, g[2]);
  atomicAdd(gr + sid, g[3]);
  atomicAdd(ga + 3 * sid, ga0);
  atomicAdd(ga + 3 * sid + 1, ga1);
  atomicAdd(ga + 3 * sid + 2, ga2);
}

template <int TEAM>
cudaError_t launch_rays(int grid, int threads, size_t smem,
                        cudaStream_t stream, const float4* cand,
                        const float4* alb, const int32_t* off,
                        const int32_t* count, const float* o, const float* d,
                        const int32_t* owner, const float* target,
                        float* img, float* term, float4* gray, float2* plane,
                        uint64_t* gkeys, int p0, int teams, int kcap, int sp,
                        int n, float es, float se, float scale) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soft_rays<TEAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  soft_rays<TEAM><<<grid, threads, smem, stream>>>(
      cand, alb, off, count, o, d, owner, target, img, term, gray, plane,
      gkeys, p0, teams, kcap, sp, n, es, se, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tracer_soft_gather(const int32_t* leaf_ids,
                                  const uint8_t* valid, const int32_t* s2s,
                                  const float* centers, const float* radii,
                                  const float* albedo, const int32_t* off,
                                  float4* cand, float4* alb, int32_t* count,
                                  int ldw, int ls, int P,
                                  cudaStream_t stream) {
  if (P <= 0) return 0;
  const int warps = kThreads / 32;
  soft_gather<<<(P + warps - 1) / warps, kThreads, 0, stream>>>(
      leaf_ids, valid, ldw, s2s, ls, centers, radii, albedo, off, P, cand,
      alb, count);
  return (int)cudaGetLastError();
}

extern "C" int tracer_soft_rays(const float4* cand, const float4* alb,
                                const int32_t* off, const int32_t* count,
                                const float* o, const float* d,
                                const int32_t* owner, const float* target,
                                float* img, float* term, float4* gray,
                                float2* plane, uint64_t* gkeys, int p0,
                                int np, int team, int teams, int kcap,
                                int sp, int n, float es, float se,
                                float scale, cudaStream_t stream) {
  if (np <= 0) return 0;
  if ((team != 32 && team != 256) || teams < 1 || team * teams > kThreads
      || (team == 256 && teams != 1) || sp % teams != 0 || sp > kMaxSP)
    return (int)cudaErrorInvalidValue;
  const int grid = np * (sp / teams);
  const size_t smem = gkeys != nullptr
      ? 0 : (size_t)teams * kcap * sizeof(uint64_t);
  const cudaError_t e = team == 32
      ? launch_rays<32>(grid, 32 * teams, smem, stream, cand, alb, off, count,
                        o, d, owner, target, img, term, gray, plane, gkeys,
                        p0, teams, kcap, sp, n, es, se, scale)
      : launch_rays<256>(grid, 256, smem, stream, cand, alb, off, count, o,
                         d, owner, target, img, term, gray, plane, gkeys, p0,
                         teams, kcap, sp, n, es, se, scale);
  return (int)e;
}

extern "C" int tracer_soft_grads(const float4* cand, const float4* alb,
                                 const int32_t* off, const int32_t* count,
                                 const float* o, const float* d,
                                 const float4* gray, const float2* plane,
                                 float* gc, float* gr, float* ga, int p0,
                                 int np, int chunks, int sp, float es,
                                 float se, cudaStream_t stream) {
  if (np <= 0 || chunks <= 0) return 0;
  if (sp > kMaxSP || np > 65535) return (int)cudaErrorInvalidValue;
  soft_grads<<<dim3(chunks, np), kChunk, 0, stream>>>(
      cand, alb, off, count, o, d, gray, plane, gc, gr, ga, p0, sp, es, se);
  return (int)cudaGetLastError();
}

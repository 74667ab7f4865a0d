// phase_a_cuda: phase A's count-embedded candidate rows, one warp a row:
// the slab test of the row's subpacket bounds against its chunk's group
// boxes, the first survivors kept in ascending order and all counted, the
// first k0 groups refined to their member leaves, those compacted and
// counted, and the finished row written with the group-mode fallback and
// the overflow flag (kernels/conecull.py phase_a_cuda).
//
// Replaces no TPU kernel: phase A is XLA operations in the JAX package
// (tracer/kernels/conecull.py cone_candidates, tracer/kernels/tlas.py
// tlas_candidates), and the port first wrote it as the same chain of torch
// operations (conecull.candidate_rows, tlas._pair_block_rows). That chain
// materialises (rows, groups) and (rows, k0 * lpg) planes in device
// memory (at 10M spheres a 630 MB gathered leaf-box plane and some 40
// interval operations over each plane, 16 ms a query) and, at 100k
// spheres, issues some 340 launches a query that the host takes longer to
// issue than the card to run. Both paths run one algorithm, so one kernel
// serves them.
//
// Bound on this card: bytes, rows out plus one pass over the chunk boxes:
// at 10M spheres 51,520 rows of 256 ids (52.8 MB) and 7.5 MB of leaf boxes,
// about 0.02 ms; the slab tests (~26M leaf boxes, ~10M group boxes, ~60
// fp32 operations each) are well under that at 67 TFLOP/s. The design:
//   * a CTA of R = gcd(S, 8) warps takes R rows of one pair (one chunk);
//     it stages the chunk's group boxes in shared memory (attr-major, up to
//     kTile groups at a time), and each warp sweeps them 32 a step in
//     ascending order: __ballot_sync and __popc give each survivor its
//     rank, the first ones go to the warp's list in shared memory, all
//     are counted. No plane of tests or ids is ever written;
//   * a row whose group count passes k0 is in group mode whatever its
//     leaves, so its refine is skipped; else the warp refines its groups'
//     member leaves 32 a step (two groups at lpg = 16), reading the
//     attr-major leaf boxes (L2-resident) with neighbouring lanes on
//     neighbouring floats, and stops once the row is past its leaf budget;
//   * the row goes out once, 32 lanes on neighbouring ids; the overflow
//     flag is set by one store from each warp that sees overflow, after
//     the launch zeroed it;
//   * every slab-test operation rounds as the torch chain's does: an IEEE
//     reciprocal, each product rounded (no FMA contraction), min and max
//     that return NaN when either side is NaN; so rows and flag are bit
//     for bit the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;    // rows (warps) per CTA
constexpr int kTile = 1024;     // group boxes staged at a time
constexpr int kSmemMax = 232448;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// One axis of a subpacket's interval bounds: origin [ol, oh] and the
// reciprocals of the direction bounds, or free where they straddle 0.
struct Axis {
  float ol, oh, ilo, ihi;
  bool free;
};

__device__ __forceinline__ Axis axis_of(const float* b, int a) {
  Axis x;
  x.ol = b[a];
  x.oh = b[3 + a];
  const float dl = b[6 + a], dh = b[9 + a];
  x.free = dl <= 0.0f && dh >= 0.0f;
  x.ilo = __frcp_rn(x.free ? 1.0f : dh);
  x.ihi = __frcp_rn(x.free ? 1.0f : dl);
  return x;
}

// The interval product [al, ah] x [ilo, ihi] as conecull.py's imul.
__device__ __forceinline__ void imul(float al, float ah, const Axis& x,
                                     float& lo, float& hi) {
  const float p1 = __fmul_rn(al, x.ilo), p2 = __fmul_rn(al, x.ihi);
  const float p3 = __fmul_rn(ah, x.ilo), p4 = __fmul_rn(ah, x.ihi);
  lo = min_nan(min_nan(p1, p2), min_nan(p3, p4));
  hi = max_nan(max_nan(p1, p2), max_nan(p3, p4));
}

// conecull._slab_hit_cols for one box: whether any ray inside the bounds
// could meet it (tmax >= tmin && tmax > EPSILON).
__device__ __forceinline__ bool slab_hit(const Axis (&ax)[3],
                                         const float (&lo)[3],
                                         const float (&hi)[3]) {
  float tnear = 0.0f, tfar = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const Axis& x = ax[a];
    float t1l, t1h, t2l, t2h;
    imul(__fsub_rn(lo[a], x.oh), __fsub_rn(lo[a], x.ol), x, t1l, t1h);
    imul(__fsub_rn(hi[a], x.oh), __fsub_rn(hi[a], x.ol), x, t2l, t2h);
    const float tn = x.free ? -1.0e18f : min_nan(t1l, t2l);
    const float tf = x.free ? 1.0e18f : max_nan(t1h, t2h);
    tnear = a == 0 ? tn : max_nan(tnear, tn);
    tfar = a == 0 ? tf : min_nan(tfar, tf);
  }
  return tfar >= tnear && tfar > 1.0e-6f;
}

// Rows r = blockIdx.x * R + warp. Without pair tables row r reads bounds
// r in chunk 0; with them row (p, s) = (r / S, r % S) reads bounds
// pair_gb[p] * S + s in chunk pair_c[p] and is empty unless
// pair_active[p]. R divides S, so a CTA's rows share one chunk.
__global__ void __launch_bounds__(kMaxWarps * 32)
phase_a_rows(const float* __restrict__ bounds,
             const float* __restrict__ gmin, const float* __restrict__ gmax,
             const float* __restrict__ leaf_boxes,
             const int32_t* __restrict__ pair_c,
             const int32_t* __restrict__ pair_gb,
             const uint8_t* __restrict__ pair_active,
             int32_t* __restrict__ rows, uint8_t* __restrict__ overflow,
             int S, int R, int gpc, int lpg, int lpc, int nrl, int k0, int k,
             int kg, int keep_l, int gkeep, int rowlen, int tile, int glist,
             int llist) {
  extern __shared__ float smem[];
  float* sbox = smem;                                    // [6][tile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* gl = reinterpret_cast<int*>(smem + 6 * tile) + warp * (glist + llist);
  int* ll = gl + glist;

  const int r0 = blockIdx.x * R;
  const int row = r0 + warp;
  const int p = r0 / S;
  int chunk = 0, b = row;
  bool active = true;
  if (pair_gb != nullptr) {
    chunk = pair_c[p];
    b = pair_gb[p] * S + (row - p * S);
    active = pair_active[p] != 0;
  }
  const float* bb = bounds + (size_t)b * 12;
  const Axis ax[3] = {axis_of(bb, 0), axis_of(bb, 1), axis_of(bb, 2)};
  const int g0 = chunk * gpc;            // the chunk's first global group

  // Groups, ascending, 32 a step.
  int gtotal = 0;
  for (int t0 = 0; t0 < gpc; t0 += tile) {
    const int n = min(tile, gpc - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t g = (size_t)(g0 + t0 + i) * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        sbox[a * tile + i] = gmin[g + a];
        sbox[(3 + a) * tile + i] = gmax[g + a];
      }
    }
    __syncthreads();
    if (!active) continue;               // CTA-uniform
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      bool hit = false;
      if (i < n && (g0 + t0 + i) * lpg < nrl) {
        const float lo[3] = {sbox[i], sbox[tile + i], sbox[2 * tile + i]};
        const float hi[3] = {sbox[3 * tile + i], sbox[4 * tile + i],
                             sbox[5 * tile + i]};
        hit = slab_hit(ax, lo, hi);
      }
      const unsigned m = __ballot_sync(kFull, hit);
      const int pos = gtotal + __popc(m & below);
      if (hit && pos < glist) gl[pos] = t0 + i;
      gtotal += __popc(m);
    }
  }
  __syncwarp();

  // Leaves of the first k0 groups, unless the groups already put the row
  // in group mode; the row is in group mode once ltotal > lcap.
  const int lcap = min(k, keep_l);
  int ltotal = 0;
  if (gtotal <= k0) {
    const int nleaf = gtotal * lpg;
    for (int m0 = 0; m0 < nleaf && ltotal <= lcap; m0 += 32) {
      const int m = m0 + lane;
      bool hit = false;
      int leaf = 0;
      if (m < nleaf) {
        const int gi = m / lpg, j = m - gi * lpg;
        const int grp = gl[gi];
        leaf = grp * lpg + j;
        if (chunk * lpc + leaf < nrl) {
          const float* lb = leaf_boxes + (size_t)(g0 + grp) * (6 * lpg) + j;
          const float lo[3] = {lb[0], lb[lpg], lb[2 * lpg]};
          const float hi[3] = {lb[3 * lpg], lb[4 * lpg], lb[5 * lpg]};
          hit = slab_hit(ax, lo, hi);
        }
      }
      const unsigned mk = __ballot_sync(kFull, hit);
      const int pos = ltotal + __popc(mk & below);
      if (hit && pos < llist) ll[pos] = leaf;
      ltotal += __popc(mk);
    }
  }
  __syncwarp();

  // The row: [count, ids...]; group mode lists min(gtotal, gkeep, kg)
  // groups padded with gpc to max(k, kg), leaf mode its leaves; lpc after.
  const bool use_g = gtotal > k0 || ltotal > lcap;
  const int gcnt = min(gtotal, gkeep);
  const int gshow = min(gcnt, kg);
  const int width = max(k, kg);
  int32_t* o = rows + (size_t)row * rowlen;
  for (int pos = lane; pos < rowlen; pos += 32) {
    int v;
    if (pos == 0) {
      v = use_g ? -gshow : ltotal;
    } else if (use_g) {
      v = pos <= gshow ? gl[pos - 1] : (pos <= width ? gpc : lpc);
    } else {
      v = pos <= ltotal ? ll[pos - 1] : lpc;
    }
    o[pos] = v;
  }
  if (lane == 0 && use_g && (gcnt > kg || gtotal > gkeep)) *overflow = 1;
}

}  // namespace

// bounds (Pb, 12) f32 [o_lo | o_hi | d_lo | d_hi]; gmin, gmax (G, 3) f32;
// leaf_boxes (G, 6 * lpg) f32 attr-major; pair_c, pair_gb (npairs,) i32
// and pair_active (npairs,) bool, or all three null (then npairs = Pb / S,
// pair p is packet p in chunk 0); rows (npairs * S, rowlen) i32; overflow
// one byte, zeroed here. Returns cudaGetLastError() after the launch.
extern "C" int tracer_phase_a(const void* bounds, const void* gmin,
                              const void* gmax, const void* leaf_boxes,
                              const void* pair_c, const void* pair_gb,
                              const void* pair_active, void* rows,
                              void* overflow, int nrows, int S, int gpc,
                              int lpg, int lpc, int nrl, int k0, int k,
                              int kg, int keep_l, int gkeep, int rowlen,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(overflow, 0, 1, st);
  if (nrows > 0) {
    int R = kMaxWarps;
    while (S % R) R >>= 1;               // gcd(S, 8)
    const int tile = min(gpc, kTile);
    const int glist = min(max(k0, kg), gpc);
    const int llist = min(k, keep_l);
    const size_t smem = (size_t)tile * 6 * sizeof(float)
                        + (size_t)R * (glist + llist) * sizeof(int);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(phase_a_rows,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    phase_a_rows<<<(unsigned)(nrows / R), R * 32, smem, st>>>(
        (const float*)bounds, (const float*)gmin, (const float*)gmax,
        (const float*)leaf_boxes, (const int32_t*)pair_c,
        (const int32_t*)pair_gb, (const uint8_t*)pair_active,
        (int32_t*)rows, (uint8_t*)overflow, S, R, gpc, lpg, lpc, nrl, k0, k,
        kg, keep_l, gkeep, rowlen, tile, glist, llist);
  }
  return (int)cudaGetLastError();
}

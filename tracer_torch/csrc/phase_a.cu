// phase_a_cuda: phase A's count-embedded candidate rows, one warp a row:
// the slab test of the row's subpacket bounds against its chunk's group
// boxes, the first survivors kept in ascending order and all counted, the
// first k0 groups refined to their member leaves, those compacted and
// counted, and the finished row written with the group-mode fallback and
// the overflow flag (kernels/conecull.py phase_a_cuda). Tables of several
// chunks take a second kernel, phase_a_chunk_rows, one warp a subpacket
// writing its row in every chunk (below).
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
//
// Several chunks (phase_a_chunk_rows; the render's leaf-16 tables at 100k
// spheres have three chunks of 185 groups): the rows of every (chunk,
// subpacket) pair equal conecull.candidate_rows at C > 1, not exact. There
// the group refine takes the first k0 survivors of all the chunks, the
// leaf budget K_l counts the refined leaves of all the chunks, and each
// chunk counts and lists its own groups and leaves. Chunks are contiguous
// ranges of groups and of leaves, so one warp sweeps all C * gpc groups
// once, ascending:
//   * a survivor's rank within its chunk (reset at each gpc boundary)
//     puts the chunk's first kg groups straight into the chunk's row, and
//     the chunk's count goes to the row's count column, read back at the
//     end; no group list is kept;
//   * while the survivors total at most k0 (so all are refined) and the
//     refined leaves at most K_l, the survivors wait in a list of up to 64
//     and are refined 32 leaves a step once 32 wait, and at the end, so
//     that sparse survivors still fill the lanes; the first K_l leaves
//     are listed in shared memory; a chunk lists
//     leaves only while the leaves total at most K_l, so its own are a run
//     of that list, bounded by a binary search;
//   * each row is then finished: its count and its padding in group mode,
//     its leaves in leaf mode.
// The shared memory is fixed whatever the tables: a tile of up to kTile
// group boxes, and per warp the leaf list (K_l <= 512 in the not exact
// mode) and the groups waiting, 42 KB a CTA. Bound on this card: bytes,
// the rows out: at the render's budgets 3 x 7,760 rows of 256 ids (23.8
// MB), about 7 us; at the top of the escalation ladder 3 x 7,760 x 3,072
// ids (286 MB), about 85 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;    // rows (warps) per CTA
constexpr int kTile = 1024;     // group boxes staged at a time
constexpr int kSmemMax = 232448;
constexpr int kLeafList = 512;  // the multi-chunk leaf list, per warp

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

// The first index of the ascending list a[0, n) whose value is at least v.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0;
  while (lo < n) {
    const int mid = (lo + n) >> 1;
    if (a[mid] < v) lo = mid + 1; else n = mid;
  }
  return lo;
}

// The member leaves of the n groups sl[0, n) (global ids, ascending), 32
// a step, appended to the warp's leaf list ll while its count ltotal is
// at most keep_l; the sweep stops once it passes.
__device__ __forceinline__ void refine_groups(
    const Axis (&ax)[3], const float* __restrict__ leaf_boxes, const int* sl,
    int n, int lpg, int nrl, int keep_l, int* ll, int& ltotal) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int nleaf = n * lpg;
  for (int m0 = 0; m0 < nleaf && ltotal <= keep_l; m0 += 32) {
    const int mm = m0 + lane;
    bool hit = false;
    int leaf = 0;
    if (mm < nleaf) {
      const int gi = mm / lpg, j = mm - gi * lpg;
      const int grp = sl[gi];
      leaf = grp * lpg + j;
      if (leaf < nrl) {
        const float* lb = leaf_boxes + (size_t)grp * (6 * lpg) + j;
        const float lo[3] = {lb[0], lb[lpg], lb[2 * lpg]};
        const float hi[3] = {lb[3 * lpg], lb[4 * lpg], lb[5 * lpg]};
        hit = slab_hit(ax, lo, hi);
      }
    }
    const unsigned mk = __ballot_sync(kFull, hit);
    const int pos = ltotal + __popc(mk & below);
    if (hit && pos < keep_l) ll[pos] = leaf;
    ltotal += __popc(mk);
  }
}

// Rows of tables in C > 1 chunks, as conecull.candidate_rows (not exact):
// warp w of CTA b takes bounds row p = b * kMaxWarps + w and writes its
// row in every chunk c, at row c * P + p. One ascending sweep over all
// C * gpc groups: a survivor's rank in its chunk (reset at each gpc
// boundary) puts the chunk's first kg straight into its row, and the lane
// that holds a chunk's last group leaves the chunk's count in the row's
// count column. While the survivors total at most k0 and the refined
// leaves at most keep_l, the survivors wait in a list of up to 64, and
// are refined once 32 wait and at the end; the first keep_l leaves are
// listed: a chunk lists leaves only while the leaves total at most
// keep_l, so its own are a run of that list, whose end is a binary
// search for the next chunk's first id. Then the warp finishes each row:
// its count, and the padding, or its leaves.
__global__ void __launch_bounds__(kMaxWarps * 32)
phase_a_chunk_rows(const float* __restrict__ bounds,
                   const float* __restrict__ gmin,
                   const float* __restrict__ gmax,
                   const float* __restrict__ leaf_boxes,
                   int32_t* __restrict__ rows, uint8_t* __restrict__ overflow,
                   int P, int C, int gpc, int lpg, int lpc, int nrl, int k0,
                   int k, int kg, int keep_l, int gkeep, int rowlen,
                   int tile) {
  extern __shared__ float smem[];
  float* sbox = smem;                                    // [6][tile]
  const int G = C * gpc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* ll = reinterpret_cast<int*>(smem + 6 * tile)
            + warp * (kLeafList + 64);                   // leaves listed
  int* sl = ll + kLeafList;                              // groups waiting

  const int p = blockIdx.x * kMaxWarps + warp;
  const bool live = p < P;               // warp-uniform
  const float* bb = bounds + (size_t)min(p, P - 1) * 12;
  const Axis ax[3] = {axis_of(bb, 0), axis_of(bb, 1), axis_of(bb, 2)};
  const size_t cstride = (size_t)P * rowlen;             // chunk to chunk
  int32_t* const o0 = rows + (size_t)p * rowlen;

  // Every group, ascending, 32 a step. cur is the chunk that holds the
  // step's first group, nb the next chunk's first group, and cc counts
  // chunk cur's survivors so far.
  int gtotal = 0, ltotal = 0, cc = 0, nwait = 0, cur = 0, nb = gpc;
  for (int t0 = 0; t0 < G; t0 += tile) {
    const int n = min(tile, G - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t g = (size_t)(t0 + i) * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        sbox[a * tile + i] = gmin[g + a];
        sbox[(3 + a) * tile + i] = gmax[g + a];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane, s0 = t0 + i0, g = s0 + lane;
      bool hit = false;
      if (i < n && g * lpg < nrl) {
        const float lo[3] = {sbox[i], sbox[tile + i], sbox[2 * tile + i]};
        const float hi[3] = {sbox[3 * tile + i], sbox[4 * tile + i],
                             sbox[5 * tile + i]};
        hit = slab_hit(ax, lo, hi);
      }
      const unsigned m = __ballot_sync(kFull, hit);
      // The lane's chunk (a division only in the steps where a chunk
      // starts) and its rank there: the survivors of earlier steps (the
      // step's first chunk only) and of the chunk's lanes below it.
      int c = cur;
      if (nb <= s0 + 31) {               // warp-uniform
        if (g >= nb) c = cur + 1 + (g - nb) / gpc;
      }
      const int cs = c * gpc, first = max(cs - s0, 0);
      const int rank = (first == 0 ? cc : 0)
                       + __popc(m & below & ~((1u << first) - 1u));
      int32_t* o = o0 + (size_t)c * cstride;
      if (hit && rank < kg) o[1 + rank] = g - cs;
      if (i < n && g == cs + gpc - 1) o[0] = rank + hit;
      const int incl = __shfl_sync(kFull, rank + hit, 31);
      while (nb <= s0 + 32) {
        ++cur;
        nb += gpc;
      }
      cc = nb - gpc == s0 + 32 ? 0 : incl;
      gtotal += __popc(m);
      // Refine the survivors while the groups are within k0 and the
      // leaves within keep_l (past either, every row is in group mode and
      // the refine is not read).
      if (gtotal > k0 || ltotal > keep_l) continue;
      if (hit) sl[nwait + __popc(m & below)] = g;
      nwait += __popc(m);
      if (nwait < 32) continue;
      __syncwarp();
      refine_groups(ax, leaf_boxes, sl, nwait, lpg, nrl, keep_l, ll, ltotal);
      nwait = 0;
      __syncwarp();                      // sl is read before it is reused
    }
  }
  if (!live) return;                     // no barrier below
  __syncwarp();
  if (gtotal <= k0)
    refine_groups(ax, leaf_boxes, sl, nwait, lpg, nrl, keep_l, ll, ltotal);
  __syncwarp();                          // the counts and lists are written

  // Chunk c's row: group mode where the groups pass k0, the leaves pass
  // keep_l or the chunk's own pass k; min(gcnt, kg) chunk-relative groups
  // (written above) padded with gpc to max(k, kg), else its leaves; lpc
  // after.
  const bool all_g = gtotal > k0 || ltotal > keep_l;
  const int nl = min(ltotal, keep_l);
  const int width = max(k, kg);
  bool ovf = false;
  int ls = 0;
  int cnts = 0;                          // lane j: chunk (c & ~31) + j's count
  for (int c = 0; c < C; ++c) {
    int32_t* o = o0 + (size_t)c * cstride;
    if ((c & 31) == 0 && c + lane < C) cnts = o[(size_t)lane * cstride];
    const int gcnt = __shfl_sync(kFull, cnts, c & 31);
    const int le = ls + lower_bound(ll + ls, nl - ls, (c + 1) * lpc);
    const int lcnt = le - ls;
    const bool use_g = all_g || lcnt > k;
    const int gshow = min(gcnt, kg);
    ovf |= use_g && (gcnt > kg || gtotal > gkeep);
    for (int pos = lane; pos < rowlen; pos += 32) {
      if (pos == 0) {
        o[0] = use_g ? -gshow : lcnt;
      } else if (use_g) {
        if (pos > gshow) o[pos] = pos <= width ? gpc : lpc;
      } else {
        o[pos] = pos <= lcnt ? ll[ls + pos - 1] - c * lpc : lpc;
      }
    }
    ls = le;
  }
  if (lane == 0 && ovf) *overflow = 1;
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

// Tables of C > 1 chunks: bounds (P, 12) f32; gmin, gmax (C * gpc, 3) f32;
// leaf_boxes (C * gpc, 6 * lpg) f32 attr-major; rows (C * P, rowlen) i32,
// chunk-major; overflow one byte, zeroed here. The shared memory is at
// most 42 KB a CTA whatever the tables (a tile of group boxes, each
// warp's leaf list and groups waiting for the refine); keep_l, the leaf
// prefix of the not
// exact mode, is at most kLeafList. Returns cudaGetLastError() after the
// launch.
extern "C" int tracer_phase_a_chunks(const void* bounds, const void* gmin,
                                     const void* gmax, const void* leaf_boxes,
                                     void* rows, void* overflow, int P,
                                     int C, int gpc, int lpg, int lpc,
                                     int nrl, int k0, int k, int kg,
                                     int keep_l, int gkeep, int rowlen,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(overflow, 0, 1, st);
  if (keep_l > kLeafList) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    const int tile = min(C * gpc, kTile);
    const size_t smem = (size_t)tile * 6 * sizeof(float)
                        + (size_t)kMaxWarps * (kLeafList + 64) * sizeof(int);
    phase_a_chunk_rows<<<(unsigned)((P + kMaxWarps - 1) / kMaxWarps),
                         kMaxWarps * 32, smem, st>>>(
        (const float*)bounds, (const float*)gmin, (const float*)gmax,
        (const float*)leaf_boxes, (int32_t*)rows, (uint8_t*)overflow, P, C,
        gpc, lpg, lpc, nrl, k0, k, kg, keep_l, gkeep, rowlen, tile);
  }
  return (int)cudaGetLastError();
}

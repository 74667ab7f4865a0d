// conecull_cuda: the phase-B walk. Closest hit of each ray against the prims
// of its subpacket's candidate leaves, per table chunk, where every walked
// prim is first tested against the subpacket's bounding cone and only the
// survivors get the quadratic test.
//
// Replaces the TPU kernel tracer/kernels/conecull.py:_conecull_kernel,
// reached through conecull._conecull_call (pallas_call at
// tracer/kernels/conecull.py:837). What it computes is the same; the TPU
// mechanics are gone: no lane-quarter leaf assembly from pair-packed
// entries, no 7-pass butterfly compaction of 128-lane rows, no
// (8, 16, 128) block-major accumulator with its two-pass drain, no SMEM
// cone scalars.
//
// Bound on this card: operations. ~22 fp32 operations per cone test (one
// per walked prim per subpacket) and ~19 per (ray, survivor) quadratic
// test; the prims sit in L2. The first design gave each (chunk, packet,
// subpacket) row one CTA that walked it SP prims per step with two to four
// barriers a step, so the longest rows (the leaf walk's tail: p99 1,024,
// max 1,232 walked leaves at 100k spheres) ran alone at the end of the
// launch. This one walks the split leaf walk's items (leafwalk.cuh: the
// item plan, the (-u, slot) keys, the ray step and the epilogue), in a
// loop of its own:
//   * rows are cut into items of at most W walked leaves, planned on the
//     device by one CTA (plan_kernel: ceil(walked leaves / W) items a row,
//     scanned; tilewalk.plan_items over walked_leaves in one launch, where
//     the wrapper's torch ops took eight and the call was bound by the
//     host's time to issue them); init_kernel sets the keys and kept;
//     a grid of SP-thread CTAs (cone_items), kRuns per resident slot,
//     walks them, each CTA one run of consecutive items, found without a
//     search after the run's first; the next item is staged by cp.async
//     while the current one is tested;
//   * the cone step, by the whole CTA on every item: each thread cone-tests
//     its staged prims against cones[gs], the survivors are appended to a
//     shared list in any order (a __ballot_sync / __popc rank under one
//     shared atomicAdd per warp), the item's survivor count goes to kept[r]
//     with one atomicAdd, and one barrier publishes the list; staged leaves
//     at or past lpc hold no prim and are never kept;
//   * the list gathers the survivors of a row's consecutive items (a few
//     per item: 5 % of the prims at leaf 32), and the ray step runs once
//     the row ends in the run or the list could not take another item: the
//     closest-hit walk's (leafwalk::ClosestWalk::run) on the list, disc
//     and b' first, the sqrt only where disc > 0, each ray's best merged by
//     a 64-bit atomicMin on (bits of -u) << 32 | slot into keys
//     (C, G, S, SP); leafwalk::unpack_kernel writes t = (-u) * (1/a) and
//     the slot in the (C, G, SP, S) layout.
// Its loop is not walk_items': the runs, the gathered list and the
// oversubscribed grid would each branch the leaf walks' shared loop.
// The key's minimum is "larger u, or equal u and lower slot" whatever the
// order of items and survivors, and the cone test only drops prims that no
// ray of the subpacket can accept, so t and slots equal the leaf walk's bit
// for bit. The cone test and the quadratic are spelled with __fmul_rn /
// __fadd_rn / __fsqrt_rn in the plain version's order, so conecull_plain
// gives the same t, slots and survivor counts.

#include "leafwalk.cuh"

namespace {

constexpr int kConeFeat = 16;
constexpr float kSentinelRsq = -1.0e29f;   // r^2 of a slot with no sphere

struct Cone {
  float o0x, o0y, o0z, ux, uy, uz, cth, rho2, sinrho;
};

__device__ __forceinline__ Cone load_cone(const float* k) {
  Cone c;
  c.o0x = __ldg(k + 0); c.o0y = __ldg(k + 1); c.o0z = __ldg(k + 2);
  c.ux = __ldg(k + 3); c.uy = __ldg(k + 4); c.uz = __ldg(k + 5);
  c.cth = __ldg(k + 7); c.rho2 = __ldg(k + 9); c.sinrho = __ldg(k + 10);
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
         p.w > kSentinelRsq;
}

// Items of one CTA's run, with what the walk reads of their row cached.
struct RunItem {
  int r;        // row
  int j0;       // first walked leaf
  int n;        // walked leaves, 1..W
  int leaves;   // walked leaves of the row
  int slot0;    // global slot of the row's chunk's first prim
  int gs;       // the row's feature row
};

__device__ __forceinline__ void set_row(const leafwalk::Rows& t, int GS,
                                        RunItem& it) {
  it.leaves = walk::row_leaves(__ldg(t.cand + (size_t)it.r * t.rowlen),
                               t.lpg);
  it.slot0 = it.r / GS * t.lpc * t.leaf_size;
  it.gs = it.r % GS;
}

// Item ``item`` of the plan, found by search (a run's first).
__device__ __forceinline__ RunItem item_at(const leafwalk::Rows& t, int GS,
                                           int item) {
  const leafwalk::Item at = leafwalk::item_at(t, item);
  RunItem it{at.r, at.j0, at.n, 0, 0, 0};
  set_row(t, GS, it);
  return it;
}

// The item after ``it`` in plan order: the rest of its row, else the first
// item of the next row that has one. No search: a load or two per row.
__device__ __forceinline__ RunItem item_after(const leafwalk::Rows& t, int GS,
                                              RunItem it, int item) {
  if (it.j0 + t.W < it.leaves) {
    it.j0 += t.W;
  } else {
    do ++it.r; while (__ldg(t.starts + it.r + 1) <= item);
    it.j0 = 0;
    set_row(t, GS, it);
  }
  it.n = min(t.W, it.leaves - it.j0);
  return it;
}

// q = i / d and m = i % d for i >= 0, d > 0; by shift and mask where
// d_log2 >= 0 (d = 1 << d_log2). The staging divides by the leaf size and
// the leaves per group for every staged prim; with / and % in their place
// the walk kernel took 8 % longer (0.137 against 0.126 ms at leaf 32 on an
// H100 80GB HBM3, 700 W, chip_smoke.py's phase-B line).
__device__ __forceinline__ void div_mod(int i, int d, int d_log2, int& q,
                                        int& m) {
  if (d_log2 >= 0) {
    q = i >> d_log2;
    m = i & (d - 1);
  } else {
    q = i / d;
    m = i - q * d;
  }
}

// log2(d) of a power of two d, else -1.
__device__ __forceinline__ int log2_of(int d) {
  return (d & (d - 1)) == 0 ? __ffs(d) - 1 : -1;
}

// Start the copies of an item's prims (and store their global slots) into
// one stage; every thread of the CTA calls it. A leaf at or past lpc holds
// no prim: its slots are -1 and nothing is copied.
__device__ __forceinline__ void stage(const leafwalk::Rows& t,
                                      const RunItem& it, float4* s_prim,
                                      int32_t* s_slot, int ls_log2,
                                      int lpg_log2) {
  const int32_t* row = t.cand + (size_t)it.r * t.rowlen;
  const int nc = __ldg(row);
  const int ls = t.leaf_size;
  const int np = it.n * ls;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    int jl, lane, leaf;
    div_mod(i, ls, ls_log2, jl, lane);
    const int j = it.j0 + jl;
    if (nc > 0) {
      leaf = __ldg(row + 1 + j);
    } else {
      int g, m;
      div_mod(j, t.lpg, lpg_log2, g, m);
      leaf = __ldg(row + 1 + g) * t.lpg + m;
    }
    if (leaf >= t.lpc) {
      s_slot[i] = -1;
      continue;
    }
    const int p = it.slot0 + leaf * ls + lane;
    walk::cp_async16(s_prim + i, t.prims + p);
    s_slot[i] = p;
  }
}

struct ConeWalk {
  leafwalk::Rows t;
  leafwalk::ClosestWalk<leafwalk::GridRows> closest;   // keys (R, SP)
  const float* cones;   // (G * S, kConeFeat)
  int32_t* kept;        // (R,), zero on entry
};

// The cone step of one item, by every thread of the CTA: its staged prims
// ``q``/``slot`` (np) cone-tested against the row's cone, the survivors
// appended to the list (in any order) after its first ``listed``, the
// item's survivors added to kept[r]; returns the list's new length.
__device__ __forceinline__ int filter(const ConeWalk& w, const RunItem& it,
                                      const float4* q, const int32_t* slot,
                                      int np, float4* l_prim,
                                      int32_t* l_slot, int* count,
                                      int listed) {
  const Cone k = load_cone(w.cones + (size_t)it.gs * kConeFeat);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  for (int i = threadIdx.x; i - (int)threadIdx.x < np; i += blockDim.x) {
    const int s = i < np ? slot[i] : -1;
    const float4 p = s >= 0 ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const bool keep = s >= 0 && cone_keep(k, p);
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    int at = 0;
    if ((threadIdx.x & 31) == 0 && b) at = atomicAdd(count, __popc(b));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(b & below);
    if (keep) {
      l_prim[at] = p;
      l_slot[at] = s;
    }
  }
  __syncthreads();    // the list is complete
  const int n = *(volatile int*)count;
  if (threadIdx.x == 0 && n > listed) atomicAdd(w.kept + it.r, n - listed);
  return n;
}

// Prims the survivor list holds (one item's at least); runs per resident
// CTA: a run costs more where more rows end in it (each end is a ray
// step), and with several runs per slot the card hands the next run to
// whichever slot frees first.
constexpr int kListPrims = 512;
constexpr int kRuns = 4;

__host__ __device__ __forceinline__ int list_prims(int P) {
  return P > kListPrims ? P : kListPrims;
}

// One CTA of SP threads walks one run of consecutive items.
__global__ void __launch_bounds__(leafwalk::kMaxThreads, leafwalk::kMinCtas)
cone_items(ConeWalk w) {
  const leafwalk::Rows& t = w.t;
  extern __shared__ __align__(16) float4 s_prim[];   // [2 P + L]
  const int P = t.W * t.leaf_size;
  const int L = list_prims(P);
  int32_t* s_slot = reinterpret_cast<int32_t*>(s_prim + 2 * P + L);
  // The list's two counts: the list switches to the other, zeroed, count
  // each time the rays test it, so no thread zeroes a count another may
  // still read.
  int* s_count = reinterpret_cast<int*>(s_slot + 2 * P + L);   // [2]
  const int x = threadIdx.x;
  const int GS = w.closest.GS;
  const int total = __ldg(t.starts + t.R);
  const int per = (total + gridDim.x - 1) / gridDim.x;
  int item = blockIdx.x * per;
  const int end = min(item + per, total);
  if (item >= end) return;
  const int ls_log2 = log2_of(t.leaf_size), lpg_log2 = log2_of(t.lpg);
  if (x < 2) s_count[x] = 0;
  int c = 0, listed = 0;
  RunItem cur = item_at(t, GS, item);
  stage(t, cur, s_prim, s_slot, ls_log2, lpg_log2);
  for (int st = 0;; st ^= 1) {
    walk::cp_async_wait_all();
    __syncthreads();    // this item landed; every thread is done with the
                        // other stage and, if the rays tested it, the list
    const int next = item + 1;
    RunItem nxt = cur;
    if (next < end) {
      nxt = item_after(t, GS, cur, next);
      stage(t, nxt, s_prim + (st ^ 1) * P, s_slot + (st ^ 1) * P, ls_log2,
            lpg_log2);
    }
    // The survivors of a row's consecutive items gather in the list; its
    // rays test them once the row ends or the list could overflow.
    const int n = filter(w, cur, s_prim + st * P, s_slot + st * P,
                         cur.n * t.leaf_size, s_prim + 2 * P, s_slot + 2 * P,
                         s_count + c, listed);
    listed = n;
    if (next >= end || nxt.r != cur.r || n + P > L) {
      if (n > 0) {
        const walk::Ray ray = walk::load_ray(
            t.feats + ((size_t)cur.gs * blockDim.x + x) * walk::kFeat);
        w.closest.run(cur.r, cur.gs, x, ray, s_prim + 2 * P, s_slot + 2 * P,
                      n);
      }
      if (x == 0) s_count[c ^ 1] = 0;
      c ^= 1;
      listed = 0;
    }
    if (next >= end) break;
    item = next;
    cur = nxt;
  }
}

// The launch's set-up: keys (n of them) to the miss key and kept (R) to
// zero, by a grid-stride loop.
__global__ void init_kernel(unsigned long long* __restrict__ keys,
                            long long n, int32_t* __restrict__ kept, int R) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    keys[i] = leafwalk::kMiss;
    if (i < R) kept[i] = 0;
  }
}

constexpr int kPlanThreads = 1024;   // one CTA; 32 warps

__device__ __forceinline__ int items_of(const leafwalk::Rows& t, int r) {
  const int leaves = walk::row_leaves(__ldg(t.cand + (size_t)r * t.rowlen),
                                      t.lpg);
  return (leaves + t.W - 1) / t.W;
}

// The item plan: starts[r] = the items of the rows before r, starts[R] =
// all of them. Each thread sums the items of one contiguous run of rows,
// the CTA scans the sums, and each thread writes its rows' starts.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(leafwalk::Rows t, int32_t* __restrict__ starts) {
  __shared__ int s_warp[kPlanThreads / 32];
  const int per = (t.R + kPlanThreads - 1) / kPlanThreads;
  const int r0 = min((int)threadIdx.x * per, t.R), r1 = min(r0 + per, t.R);
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += items_of(t, r);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;   // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {   // inclusive scan of the warps' sums
    int w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int before = x - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int r = r0; r < r1; ++r) {
    starts[r] = before;
    before += items_of(t, r);
  }
  if (threadIdx.x == kPlanThreads - 1) starts[t.R] = before;
}

int smem_bytes(int leaf_size, int W) {
  const int P = W * leaf_size;
  return (2 * P + list_prims(P)) * (int)(sizeof(float4) + sizeof(int32_t)) +
         2 * (int)sizeof(int);
}

// kRuns x SMs x resident CTAs of cone_items for SP-thread CTAs and
// ``smem`` bytes each, on the current device; 0 on error.
int grid_size(int SP, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cone_items, SP,
                                                    smem) != cudaSuccess)
    return 0;
  return kRuns * sms * per_sm;
}

}  // namespace

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; cones (G, S, 16)
// f32; prims (C, lpc * leaf_size, 4) f32; out: starts (C * G * S + 1,)
// i32, the item plan for W leaves per item; keys (C, G, S, SP) u64;
// t / slot (C, G, SP, S); kept (C, G, S) i32. SP must be a multiple of 32,
// at most 1024. Returns the first CUDA error of the launches (or of the
// occupancy query).
extern "C" int tracer_conecull(const void* feats, const void* cand,
                               const void* cones, const void* prims,
                               const void* starts, void* keys, void* t,
                               void* slot, void* kept, int C, int G, int S,
                               int SP, int rowlen, int leaf_size, int lpc,
                               int lpg, int W, void* stream) {
  const leafwalk::Rows rows{(const float*)feats, (const int32_t*)cand,
                            (const float4*)prims, (const int32_t*)starts,
                            C * G * S, rowlen, leaf_size, lpc, lpg, W};
  const leafwalk::GridRows map{G * S};
  const ConeWalk w{rows, {map, (unsigned long long*)keys},
                   (const float*)cones, (int32_t*)kept};
  const int smem = smem_bytes(leaf_size, W);
  const int grid = grid_size(SP, smem);
  if (grid <= 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)rows.R * SP;
  if (n > 0) {
    const long long blocks = (n + 255) / 256;
    init_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
        (unsigned long long*)keys, n, (int32_t*)kept, rows.R);
  }
  plan_kernel<<<1, kPlanThreads, 0, st>>>(rows, (int32_t*)starts);
  if (rows.R > 0) cone_items<<<grid, SP, smem, st>>>(w);
  if (n > 0) {
    leafwalk::unpack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const unsigned long long*)keys, rows.feats, (float*)t,
        (int32_t*)slot, map, S, SP, n);
  }
  return (int)cudaGetLastError();
}


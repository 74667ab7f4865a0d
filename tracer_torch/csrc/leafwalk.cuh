// The split leaf walk shared by leafcull.cu (closest hit per chunk),
// routed.cu (closest hit per routed (chunk, g-block) pair) and anyhit.cu
// (occlusion): each ray of an SP-ray subpacket against the prims of the
// leaves its count-embedded row walks.
//
// A row is [count, ids...] (walk.cuh). Its walk order is the listed leaves
// in leaf mode, and member j = row[1 + j / lpg] * lpg + j % lpg of the
// listed groups in group mode. Rows are split into work items of at most W
// walked leaves in that order: item = (row r, first walked leaf j0,
// n <= W leaves), at most W * leaf_size prims. The wrapper plans them on
// the device (kernels/tilewalk.py:plan_items over each row's walked-leaf
// count): starts[r] is row r's first item, starts[R] the total. A
// persistent grid of SP-thread CTAs, SMs x resident CTAs, strides over the
// items; a CTA maps an item to its row by binary search (walk::row_of). So
// a row that walks every group is spread over many SMs instead of one CTA
// walking it alone at the end of the launch. Items follow row order, so
// rows sorted by chunk are walked chunk by chunk.
//
// An item's prims (leaf_size consecutive float4s per leaf in its chunk's
// table), with their global slots, go to one of two shared-memory stages
// by cp.async. A CTA issues the copies of its next item before it tests
// the current one, so the loads overlap the tests, with one barrier per
// item.
//
// The test is split: disc and b' = oc.d for every pair
// (walk::ray_prim_disc), then u = b' + sqrt(disc) and the compare only
// where disc > 0, which is rare and nearly uniform across a warp. Where
// disc > 0, sqrt(max(disc, 0)) is sqrt(disc), and every op is spelled
// __fmul_rn / __fadd_rn / __fsqrt_rn, so the walks round as their plain
// versions do, bit for bit. A staged prim's slot is read only for an
// accepted pair.
//
// ``Walk`` supplies, for row r (of R rows), its chunk and its feature row
// gs, the two maps of GridRows (rows of a (C, G, S) grid) or PairRows
// (routed rows p * S + s), and for lane x:
//   kSlots                  whether ``run`` reads the staged slots;
//   bool done(gs, x)        the ray's result is already known: skip it;
//   void run(r, gs, x, ray, prims, slots, np)
//                           test the item's np staged prims and merge the
//                           ray's result.
// ClosestWalk is the closest-hit ``Walk`` of leafcull.cu and routed.cu,
// and ``closest`` launches it with its epilogue.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace leafwalk {

constexpr int kMaxThreads = 1024;  // SP <= 1024 rays per CTA
constexpr int kMinCtas = 2;        // 2048 threads per SM: <= 32 registers

// The rows, the prim table and the item plan of one launch.
struct Rows {
  const float* feats;      // (G * S, SP, 16) ray features
  const int32_t* cand;     // (R, rowlen) count-embedded rows
  const float4* prims;     // (C * lpc * leaf_size,) prims, slot-major
  const int32_t* starts;   // (R + 1,) the item plan
  int R, rowlen, leaf_size, lpc, lpg, W;
};

// Rows of a (C, G, S) grid: chunk r / GS, feature row r % GS.
struct GridRows {
  int GS;
  __device__ __forceinline__ int chunk(int r) const { return r / GS; }
  __device__ __forceinline__ int feat_row(int r) const { return r % GS; }
};

// Routed rows r = p * S + s: chunk pair_c[p], feature row
// pair_gb[p] * S + s.
struct PairRows {
  const int32_t* pair_c;
  const int32_t* pair_gb;
  int S;
  __device__ __forceinline__ int chunk(int r) const {
    return __ldg(pair_c + r / S);
  }
  __device__ __forceinline__ int feat_row(int r) const {
    return __ldg(pair_gb + r / S) * S + r % S;
  }
};

struct Item {
  int r;    // row
  int j0;   // first walked leaf
  int n;    // walked leaves, 1..W
};

static __device__ __forceinline__ Item item_at(const Rows& t, int item) {
  Item it;
  it.r = walk::row_of(t.starts, t.R, item);
  it.j0 = (item - __ldg(t.starts + it.r)) * t.W;
  const int nc = __ldg(t.cand + (size_t)it.r * t.rowlen);
  it.n = min(t.W, walk::row_leaves(nc, t.lpg) - it.j0);
  return it;
}

// Start the copies of an item's prims into one stage, and store their
// global slots when the walk reads them; every thread of the CTA calls it.
template <class Walk>
static __device__ __forceinline__ void stage(const Walk& w, const Rows& t,
                                             const Item& it, float4* s_prim,
                                             int32_t* s_slot) {
  const int32_t* row = t.cand + (size_t)it.r * t.rowlen;
  const int nc = __ldg(row);
  const int ls = t.leaf_size;
  const int slot0 = w.chunk(it.r) * t.lpc * ls;
  const int np = it.n * ls;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const int j = it.j0 + i / ls;
    const int leaf = nc > 0 ? __ldg(row + 1 + j)
                            : __ldg(row + 1 + j / t.lpg) * t.lpg + j % t.lpg;
    const int p = slot0 + leaf * ls + i % ls;
    walk::cp_async16(s_prim + i, t.prims + p);
    if (Walk::kSlots) s_slot[i] = p;
  }
}

template <class Walk>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
walk_items(Walk w, Rows t) {
  extern __shared__ __align__(16) float4 s_prim[];          // [2][P]
  const int P = t.W * t.leaf_size;
  int32_t* s_slot = reinterpret_cast<int32_t*>(s_prim + 2 * P);   // [2][P]
  const int x = threadIdx.x;
  const int total = __ldg(t.starts + t.R);
  int item = blockIdx.x;
  if (item >= total) return;
  Item cur = item_at(t, item);
  stage(w, t, cur, s_prim, s_slot);
  for (int st = 0;; st ^= 1) {
    walk::cp_async_wait_all();
    __syncthreads();    // this item landed; every thread is done with the
                        // other stage
    const int next = item + gridDim.x;
    Item nxt = cur;
    if (next < total) {
      nxt = item_at(t, next);
      stage(w, t, nxt, s_prim + (st ^ 1) * P, s_slot + (st ^ 1) * P);
    }
    const int gs = w.feat_row(cur.r);
    if (!w.done(gs, x)) {
      const walk::Ray ray = walk::load_ray(
          t.feats + ((size_t)gs * blockDim.x + x) * walk::kFeat);
      w.run(cur.r, gs, x, ray, s_prim + st * P, s_slot + st * P,
            cur.n * t.leaf_size);
    }
    if (next >= total) break;
    item = next;
    cur = nxt;
  }
}

// Shared memory of one CTA: two stages of W * leaf_size prims and slots.
static inline int smem_bytes(int leaf_size, int W) {
  return 2 * W * leaf_size * (int)(sizeof(float4) + sizeof(int32_t));
}

// SMs x resident CTAs of walk_items<Walk> with ``threads`` threads and
// ``smem`` bytes of shared memory each, on the current device; 0 on error.
template <class Walk>
int grid_size(int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, walk_items<Walk>, threads, smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Launch the walk with one thread per ray of ``threads``-ray subpackets on
// ``stream``; returns cudaGetLastError() (or the occupancy query's error).
template <class Walk>
int launch(const Walk& w, const Rows& t, int threads, cudaStream_t stream) {
  const int smem = smem_bytes(t.leaf_size, t.W);
  const int grid = grid_size<Walk>(threads, smem);
  if (grid <= 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  if (t.R > 0) walk_items<Walk><<<grid, threads, smem, stream>>>(w, t);
  return (int)cudaGetLastError();
}

constexpr unsigned long long kMiss = 0x7FFFFFFFFFFFFFFFull;  // no hit
constexpr unsigned long long kNone = ~0ull;   // no hit in this item

// The closest-hit walk over rows mapped by ``Map``: the largest
// u = oc.d + sqrt(disc) with disc > 0 and u < -eps*a, then the lowest
// global slot among equal u. Each thread keeps its ray's best over an item
// as the key (float bits of -u) << 32 | slot; -u > eps*a >= 0, so the bits
// order like the floats and the minimum key is the contract whatever order
// the items merge in. One 64-bit atomicMin per ray and item merges it into
// keys of shape (R, SP), initialised to kMiss. The key is on u and not on
// t = -u/a: two different u can round to one t, and a key on t would lose
// the slot tie-break.
template <class Map>
struct ClosestWalk : Map {
  static constexpr bool kSlots = true;
  unsigned long long* keys;   // (R, SP)

  __device__ __forceinline__ bool done(int, int) const { return false; }

  __device__ __forceinline__ void run(int r, int, int x,
                                      const walk::Ray& ray, const float4* q,
                                      const int32_t* slot, int np) const {
    unsigned long long best = kNone;
#pragma unroll 8
    for (int i = 0; i < np; ++i) {
      float bp;
      const float disc = walk::ray_prim_disc(ray, q[i], &bp);
      if (disc > 0.0f) {
        const float u = __fadd_rn(bp, __fsqrt_rn(disc));
        if (u < -ray.epsa) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(-u) << 32) |
              (uint32_t)slot[i];
          best = key < best ? key : best;
        }
      }
    }
    if (best != kNone) atomicMin(keys + (size_t)r * blockDim.x + x, best);
  }
};

// keys (R, SP), R = Q * S -> t, slot (Q, SP, S): t = (-u) * (1/a) (feature
// column 11 of row r's feature row) and the slot of a hit, (3e38, 2^30)
// for a miss.
template <class Map>
__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              const float* __restrict__ feats,
                              float* __restrict__ t_out,
                              int32_t* __restrict__ slot_out, Map map, int S,
                              int SP, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const long long r = k / SP;
  const int x = (int)(k % SP);
  const int s = (int)(r % S);
  const size_t out = ((size_t)(r / S) * SP + x) * S + s;
  const unsigned long long key = keys[k];
  if (key == kMiss) {
    t_out[out] = walk::kBig;
    slot_out[out] = walk::kNoSlot;
    return;
  }
  const float inva =
      feats[((size_t)map.feat_row((int)r) * SP + x) * walk::kFeat + 11];
  t_out[out] = __fmul_rn(__uint_as_float((uint32_t)(key >> 32)), inva);
  slot_out[out] = (int32_t)(uint32_t)key;
}

// The closest-hit walk of ``t``'s rows and its epilogue, on ``stream``:
// keys (R, SP) initialised to kMiss; t / slot (R / S, SP, S). Returns the
// first CUDA error of the launches.
template <class Map>
int closest(const Map& map, const Rows& t, void* keys, void* t_out,
            void* slot_out, int S, int SP, cudaStream_t stream) {
  const int rc = launch(ClosestWalk<Map>{map, (unsigned long long*)keys}, t,
                        SP, stream);
  if (rc != 0) return rc;
  const long long n = (long long)t.R * SP;
  if (n > 0) {
    unpack_kernel<Map><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        (const unsigned long long*)keys, t.feats, (float*)t_out,
        (int32_t*)slot_out, map, S, SP, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace leafwalk

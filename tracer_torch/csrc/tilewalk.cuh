// The tile walk shared by tilecull.cu (128-ray subpackets) and cull.cu
// (1024-ray packets): each ray of a 128-ray block against the prims of the
// 128-prim tiles its row lists, keeping the nearest hit.
//
// Rows are split into work items of at most W listed tiles: item = (ray
// block = row r, first listed position k0, n <= W tiles). The wrapper
// plans them on the device (kernels/tilewalk.py:plan_items): starts[r] is
// row r's first item, starts[R] the total. A persistent grid of 128-thread
// CTAs, SMs x resident CTAs, strides over the items; a CTA maps an item to
// its row by binary search over starts. So a row that lists every tile is
// spread over many SMs instead of running alone at the end of the launch.
//
// Each thread keeps its ray's best hit over the item's tiles in registers
// as a packed key (float bits of t << 32) | index and merges it with one
// atomicMin on a 64-bit key per ray. An accepted t is > EPSILON > 0, so
// its bits order like the floats: the minimum is the smallest t, then the
// lowest index, whatever order the items arrive in, and the result is the
// same bits on every run. The index is the walk's own (the slot for the
// tile cull, the listed position k * 128 + lane for the packet cull).
//
// The test is split: the discriminant first for every (ray, prim) pair,
// then the square root, t and the compare only where disc > 0 (rare, and
// nearly always uniform across a warp). The accepted pairs run the same
// operations in the same order as the plain versions, spelled with
// __fmul_rn / __fadd_rn / __fsqrt_rn so that nvcc contracts nothing into an
// FMA, and the results stay equal to them bit for bit.
//
// The item's tiles (2 KB each) go through a ring of two shared-memory
// stages filled by cp.async, all 128 threads loading 16 bytes each: the
// load of tile j + 1 overlaps the tests of tile j, with one barrier per
// tile. The stage parity runs on across items, so the first tile of the
// next item needs no extra barrier either.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace tilewalk {

constexpr int kRays = 128;    // rays per block, threads per CTA
constexpr int kTile = 128;    // prims per tile
constexpr int kResident = 16; // CTAs per SM: 2048 threads, <= 32 registers
constexpr float kEps = 1e-6f;
constexpr unsigned long long kNone = ~0ull;   // no hit in this item

static __device__ __forceinline__ unsigned long long pack(float t,
                                                         uint32_t idx) {
  return ((unsigned long long)__float_as_uint(t) << 32) | idx;
}

// The walk. ``Walk`` supplies, for row r and lane x:
//   Ray load(r, x)             the thread's ray;
//   int count(r)               listed tiles the row walks;
//   const int32_t* list(r)     its listed tile ids, position k at [k];
//   uint32_t base(tile, k)     index of lane 0 of the tile at position k;
//   void test(ray, q, idx, best)  one (ray, prim) test, folding an
//                              accepted hit into ``best``;
//   const float4* tiles        (T + 1, 128) prims.
// keys (R * 128,) are the merged results, ray r * 128 + x.
template <class Walk>
__global__ void __launch_bounds__(kRays, kResident)
walk_items(Walk w, const int32_t* __restrict__ starts, int R, int W,
           unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float4 s_tile[2][kTile];
  const int x = threadIdx.x;
  const int total = __ldg(starts + R);
  int stage = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const int r = walk::row_of(starts, R, item);
    const int k0 = (item - __ldg(starts + r)) * W;
    const int n = min(W, w.count(r) - k0);   // >= 1: the plan's clamps
    const int32_t* list = w.list(r) + k0;
    int tile = __ldg(list);
    walk::cp_async16(&s_tile[stage][x],
                     w.tiles + (size_t)tile * kTile + x);
    int next = n > 1 ? __ldg(list + 1) : 0;
    const typename Walk::Ray ray = w.load(r, x);
    unsigned long long best = kNone;
    for (int j = 0; j < n; ++j) {
      walk::cp_async_wait_all();
      __syncthreads();     // tile j landed; every thread is done with j - 1
      if (j + 1 < n) {
        walk::cp_async16(&s_tile[stage ^ 1][x],
                         w.tiles + (size_t)next * kTile + x);
      }
      const int after = j + 2 < n ? __ldg(list + j + 2) : 0;
      const float4* q = s_tile[stage];
      const uint32_t base = w.base(tile, k0 + j);
#pragma unroll 8
      for (int i = 0; i < kTile; ++i) w.test(ray, q[i], base + i, best);
      tile = next;
      next = after;
      stage ^= 1;
    }
    if (best != kNone) atomicMin(keys + (size_t)r * kRays + x, best);
  }
}

// SMs x resident CTAs of walk_items<Walk> on the current device, computed
// once per process (the port drives one card).
template <class Walk>
int grid_size() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, walk_items<Walk>, kRays, 0) != cudaSuccess)
      return 0;
    grid = sms * per_sm;
  }
  return grid;
}

// Launch the walk on ``stream``; returns cudaGetLastError() (or the error
// of the occupancy query).
template <class Walk>
int launch(const Walk& w, const int32_t* starts, int R, int W,
           unsigned long long* keys, cudaStream_t stream) {
  const int grid = grid_size<Walk>();
  if (grid <= 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorUnknown);
  }
  if (R > 0) walk_items<Walk><<<grid, kRays, 0, stream>>>(w, starts, R, W,
                                                           keys);
  return (int)cudaGetLastError();
}

}  // namespace tilewalk

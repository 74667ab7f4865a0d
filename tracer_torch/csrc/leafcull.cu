// leafcull_cuda: closest hit of each ray against the prims of its
// subpacket's candidate leaves, per table chunk.
//
// Replaces the TPU kernel tracer/kernels/leafcull.py:_leafcull_kernel
// (with _leafcull_step), reached through leafcull._leafcull_call
// (tracer/kernels/leafcull.py:702). What it computes is the same; how is
// rethought for Hopper:
//   * the TPU's lane-quarter leaf assembly, pair-packed entries and
//     sentinel entry are gone: prims sit slot-major as (cx, cy, cz,
//     |c|^2 - r^2) float4 and the walk reads exactly the walked leaves;
//   * the rows (one per (chunk c, packet g, subpacket s); count > 0 lists
//     leaves, count < 0 groups, 0 nothing) are split into items of at most
//     W leaves and walked by a persistent grid, one thread per ray, with
//     the split test and a two-stage cp.async ring (leafwalk.cuh);
//   * contract: the largest u = oc.d + sqrt(disc) with disc > 0 and
//     u < -eps*a, then the lowest global prim slot among equal u (the TPU
//     kernel's per-lane strict > plus its min-slot epilogue). Each thread
//     keeps its ray's best over an item as the key (float bits of -u) << 32
//     | slot; -u > eps*a >= 0, so the bits order like the floats and the
//     minimum key is the contract whatever order the items merge in. One
//     64-bit atomicMin per ray and item merges it into keys of shape
//     (C, G, S, SP), which the wrapper initialises to the miss key. The key
//     is on u and not on t = -u/a: two different u can round to one t, and
//     a key on t would lose the slot tie-break;
//   * an epilogue kernel writes t = (-u) * (1/a), rounded once as the plain
//     version does, and the slot, or (3e38, 2^30) for a miss, in the
//     (C, G, SP, S) layout of the outputs.
//
// Bound on this card: operations. A missed (ray, prim) test is 16 fp32
// operations up to disc, each mul and add its own instruction (no FMA, so
// the kernel rounds like leafcull_plain); prims come from L2 (the 100k
// table is ~2.2 MB). The recorded bound counts 19 operations per test at
// the 67 TFLOP/s FMA rate, so this design reaches at most about half of it.
// Before the split, one CTA walked a whole row, which left the longest rows
// running alone at the end of the launch, took the sqrt on every pair and
// exposed every staging load; the item split, the persistent grid, the
// split test and the cp.async ring address those three.

#include "leafwalk.cuh"

namespace {

constexpr unsigned long long kMiss = 0x7FFFFFFFFFFFFFFFull;  // no hit
constexpr unsigned long long kNone = ~0ull;   // no hit in this item

struct LeafcullWalk {
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

// keys (C, G, S, SP) -> t, slot (C, G, SP, S): t = (-u) * (1/a) (feature
// column 11) and the slot of a hit, (3e38, 2^30) for a miss.
__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              const float* __restrict__ feats,
                              float* __restrict__ t_out,
                              int32_t* __restrict__ slot_out, int GS, int S,
                              int SP, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const long long r = k / SP;             // (c * G + g) * S + s
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
      feats[((size_t)(r % GS) * SP + x) * walk::kFeat + 11];
  t_out[out] = __fmul_rn(__uint_as_float((uint32_t)(key >> 32)), inva);
  slot_out[out] = (int32_t)(uint32_t)key;
}

}  // namespace

// feats (G, S, SP, 16) f32; cand (C, G, S, rowlen) i32; prims
// (C, lpc * leaf_size, 4) f32; starts (C * G * S + 1,) i32 the item plan for
// W leaves per item; keys (C, G, S, SP) u64 initialised to the miss key;
// t / slot (C, G, SP, S). Returns cudaGetLastError() after the launches.
extern "C" int tracer_leafcull(const void* feats, const void* cand,
                               const void* prims, const void* starts,
                               void* keys, void* t, void* slot, int C, int G,
                               int S, int SP, int rowlen, int leaf_size,
                               int lpc, int lpg, int W, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const leafwalk::Rows rows{(const float*)feats, (const int32_t*)cand,
                            (const float4*)prims, (const int32_t*)starts,
                            C * G * S, G * S, rowlen, leaf_size, lpc, lpg,
                            W};
  const int rc = leafwalk::launch(
      LeafcullWalk{(unsigned long long*)keys}, rows, SP, st);
  if (rc != 0) return rc;
  const long long n = (long long)C * G * S * SP;
  if (n > 0) {
    unpack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const unsigned long long*)keys, (const float*)feats, (float*)t,
        (int32_t*)slot, G * S, S, SP, n);
  }
  return (int)cudaGetLastError();
}

// The persistent grid of tracer_leafcull for SP-ray subpackets and items of
// W leaves of leaf_size prims, on the current device.
extern "C" int tracer_leafcull_grid(int SP, int leaf_size, int W) {
  return leafwalk::grid_size<LeafcullWalk>(
      SP, leafwalk::smem_bytes(leaf_size, W));
}

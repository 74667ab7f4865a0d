// traverse_cuda: packet traversal of the escape-index BVH with one shared
// cursor per 1024-ray packet; returns each ray's argmin prim slot and the
// packet's visited-node count.
//
// Replaces the TPU kernel tracer/kernels/traverse_pallas.py:_traverse_kernel,
// reached through traverse_pallas._traverse_packets. What it computes is the
// same; the TPU mechanics are gone: no (8, 128) ray blocks, no masked-sum
// lane extraction of node data, no SMEM meta tables, no n_streams software
// pipelining.
//
// The contract: per packet one cursor; a node is entered when ANY ray's
// slab interval starts before that ray's best t; a leaf is then tested
// against all 1024 rays, in slot order with a strict < update (the lowest
// slot wins ties); the b-form (b = 2 oc.d, c = |oc|^2 - r^2, disc = b^2 -
// 4ac, t = (-b - sqrt(disc)) / 2a) is spelled with __fmul_rn / __fadd_rn /
// __fsqrt_rn, so nvcc contracts nothing into FMAs and the kernel rounds
// like traverse_plain: t, slots and steps bit for bit.
//
// The steps of a packet are serial by contract, and on bounce rays a few
// packets span the scene and walk thousands of steps while the others
// leave after one (parked rays). The walk is therefore split in two
// launches:
//   * walk: one CTA of 1024 threads per packet, one ray per thread, up to
//     ``cap`` steps; __syncthreads_or(box hit) is the packet's any(). A
//     packet still walking at the cap writes its state (cursor, steps and
//     each ray's best t and slot, in the outputs) and appends its id to a
//     device list;
//   * resume: a persistent grid of thread-block clusters of K CTAs walks
//     the listed packets to their end, each CTA holding 1024 / K of the
//     packet's rays. Per step every CTA takes its own any(), stores it,
//     tagged with the step, into each CTA's mailbox (distributed shared
//     memory) and waits until its own mailbox holds the K votes of the
//     step; all CTAs then take the same cursor and leave at the same step.
//     A leaf visit costs each SM 1024 / K rays' tests. The list length is
//     read on the device: no host sync.
// The state is small and the walk a pure function of it, so the resumed
// walk is exact.
//
// Per step the records (box, links) of both possible successors (the
// next node on a hit, the escape index on a miss) and a leaf's prims are
// copied into shared memory by cp.async at the top of the step and waited
// for after the vote, so their latency overlaps the slab test and the
// vote. The leaf test takes the discriminants of 8 prims with no branch
// between them, then the rare accepts, and the sqrt only where disc > 0
// and b < 0 (there sqrt(max(disc, 0)) is sqrt(disc), and b >= 0 gives
// t <= 0: no bit changes); its loop is templated on leaf sizes 4, 16 and
// 32. (Streaming node records through a
// shared-memory window ahead of the cursor, and the hardware cluster
// barrier in place of the mailboxes, were measured slower; PERF.md.)
//
// Bound on this card: the serial walk. A step is a slab test, two CTA
// barriers (and with K > 1 the mailbox exchange) and a read of staged
// records; a leaf visit adds leaf_size b-form tests per ray, 1024 / K per
// SM. The work (steps x 1024 slab tests plus leaf visits x leaf_size x 1024
// quadratic tests) is small against the card; a packet that walks
// thousands of steps is bound by the latency of its steps, which no split
// of its rays removes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPacket = 1024;
constexpr float kHuge = 3.0e38f;
constexpr float kEps = 1e-6f;
constexpr int kMaxLeaf = 32;
constexpr int kMaxCluster = 16;
constexpr int kLeafLoader = 32;   // threads kLeafLoader.. stage a leaf
constexpr int kGroup = 8;   // prims whose discriminants are taken together

struct Walk {
  const float4* rays;      // (g, 1024, 2) [ox oy oz dx] [dy dz 0 0]
  const float4* nodes;     // (M, 2) box min, box max
  const int4* links;       // (M,) escape, next on hit, leaf start, 0
  const float4* prims;     // (P,) center, r^2
  float* t;                // (g, 1024) best t, also the walk state
  int32_t* slot;           // (g, 1024) best slot, also the walk state
  int32_t* steps;          // (g,)
  int32_t* cursor;         // (g,) cursor of a packet cut at the cap
  int32_t* resume;         // [count, packet ids...] packets cut at the cap
  int M, leaf_size;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, invx, invy, invz, a4, inv2a;
};

// Shared memory of a CTA, by step parity: the staged records of the two
// possible successors ([hit, miss] x [box min, box max, links]) and the
// current leaf's prims; the cluster's vote mailboxes (step << 1 | any, by
// rank).
struct Stage {
  float4 rec[2][2][3];
  float4 leaf[2][kMaxLeaf];
  unsigned mail[2][kMaxCluster];
};

__device__ __forceinline__ float inv_dir(float d) {
  return d == 0.0f ? kHuge : __fdiv_rn(1.0f, d);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__device__ __forceinline__ Ray load_ray(const float4* rays, size_t ray) {
  const float4 o4 = rays[2 * ray];
  const float4 d4 = rays[2 * ray + 1];
  Ray r;
  r.ox = o4.x; r.oy = o4.y; r.oz = o4.z;
  r.dx = o4.w; r.dy = d4.x; r.dz = d4.y;
  r.invx = inv_dir(r.dx); r.invy = inv_dir(r.dy); r.invz = inv_dir(r.dz);
  const float a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  r.inv2a = __fdiv_rn(1.0f, __fmul_rn(2.0f, fmaxf(a, 1e-30f)));
  r.a4 = __fmul_rn(4.0f, a);
  return r;
}

__device__ __forceinline__ int4 as_int4(float4 v) {
  return make_int4(__float_as_int(v.x), __float_as_int(v.y),
                   __float_as_int(v.z), __float_as_int(v.w));
}

// The packet's any() of ``hit`` at step ``s``: the CTA's barrier, and with
// K > 1 the cluster's OR through the mailboxes: each CTA stores its vote,
// tagged with the step, into every CTA's mailbox (distributed shared
// memory), and every warp waits until its own CTA's mailbox holds the
// step's K votes. A mailbox word of step s is next written at step s + 2,
// which no CTA reaches before every CTA has voted at step s + 1, after
// all its warps read step s.
template <int K>
__device__ __forceinline__ bool vote(bool hit, Stage& sh, int s) {
  const bool mine = __syncthreads_or(hit);
  if constexpr (K == 1) {
    return mine;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int b = s & 1;
    const unsigned tag = (unsigned)s << 1;
    if (threadIdx.x < K)
      *cluster.map_shared_rank(&sh.mail[b][cluster.block_rank()],
                               threadIdx.x) = tag | (mine ? 1u : 0u);
    const unsigned lane = threadIdx.x & 31;
    unsigned v;
    do {
      v = lane < K ? *(volatile unsigned*)&sh.mail[b][lane] : tag;
    } while (!__all_sync(0xffffffffu, (v & ~1u) == tag));
    return __any_sync(0xffffffffu, v & 1u);
  }
}

// leaf_size b-form tests of this thread's ray against the leaf's prims,
// kGroup at a time: the discriminants of a group first, with no branch
// between them, then the rare accepts in slot order (the strict < keeps
// the lowest slot among equal t, as one loop over the prims would).
template <int LS>
__device__ __forceinline__ void leaf_test(const float4* q, int ls,
                                          int lstart, const Ray& r,
                                          float& tb, int& ib) {
  constexpr int n = LS > 0 ? LS : kMaxLeaf;
  constexpr int G = n < kGroup ? n : kGroup;
#pragma unroll
  for (int j0 = 0; j0 < n; j0 += G) {
    if (LS == 0 && j0 >= ls) break;
    float bq[G], disc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float4 p = q[j0 + j];    // center, r^2
      const float ocx = __fsub_rn(r.ox, p.x);
      const float ocy = __fsub_rn(r.oy, p.y);
      const float ocz = __fsub_rn(r.oz, p.z);
      bq[j] = __fmul_rn(2.0f, dot3(ocx, ocy, ocz, r.dx, r.dy, r.dz));
      const float cq = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), p.w);
      disc[j] = __fsub_rn(__fmul_rn(bq[j], bq[j]), __fmul_rn(r.a4, cq));
    }
    // b >= 0 gives -b - sqrt(disc) <= 0, so t <= 0: no accept, no sqrt.
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (disc[j] > 0.0f && bq[j] < 0.0f && (LS > 0 || j0 + j < ls)) {
        const float t =
            __fmul_rn(__fsub_rn(-bq[j], __fsqrt_rn(disc[j])), r.inv2a);
        if (t > kEps && t < tb) {
          tb = t;
          ib = lstart + j0 + j;
        }
      }
    }
  }
}

// Walk one packet from (cursor, steps) until the cursor leaves the tree or
// ``limit`` steps; ``s`` counts the CTA's steps over all its packets (the
// parity of the stage, the vote's tag). Every thread of every CTA of the
// cluster calls it with the same packet.
template <int K, int LS>
__device__ __forceinline__ void walk_packet(const Walk& w, Stage& sh,
                                            const Ray& r, float& tb, int& ib,
                                            int& cursor, int& steps,
                                            int limit, int& s) {
  if (cursor >= w.M || steps >= limit) return;
  const int x = threadIdx.x;
  const int ls = LS > 0 ? LS : w.leaf_size;
  float4 lo = __ldg(&w.nodes[2 * cursor]);
  float4 hi = __ldg(&w.nodes[2 * cursor + 1]);
  int4 ln = __ldg(&w.links[cursor]);
  while (true) {
    const int b = s & 1;
    // Stage the next node either way and this node's leaf; they are waited
    // for after the vote.
    if (x < 6) {
      const int c = x < 3 ? ln.y : ln.x;
      const int part = x % 3;
      if (c < w.M)
        walk::cp_async16(&sh.rec[b][x / 3][part],
                         part < 2 ? (const void*)&w.nodes[2 * c + part]
                                  : (const void*)&w.links[c]);
    } else if (ln.z >= 0 && x >= kLeafLoader && x < kLeafLoader + ls) {
      walk::cp_async16(&sh.leaf[b][x - kLeafLoader],
                       &w.prims[ln.z + x - kLeafLoader]);
    }
    const float t1x = __fmul_rn(__fsub_rn(lo.x, r.ox), r.invx);
    const float t2x = __fmul_rn(__fsub_rn(hi.x, r.ox), r.invx);
    const float t1y = __fmul_rn(__fsub_rn(lo.y, r.oy), r.invy);
    const float t2y = __fmul_rn(__fsub_rn(hi.y, r.oy), r.invy);
    const float t1z = __fmul_rn(__fsub_rn(lo.z, r.oz), r.invz);
    const float t2z = __fmul_rn(__fsub_rn(hi.z, r.oz), r.invz);
    const float tmin = fmaxf(fminf(t1x, t2x),
                             fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
    const float tmax = fminf(fmaxf(t1x, t2x),
                             fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
    const bool box_hit = tmax >= tmin && tmax > kEps && tmin < tb;
    const bool any = vote<K>(box_hit, sh, s);
    walk::cp_async_wait_all();
    __syncthreads();    // the staged records and prims are in
    if (any && ln.z >= 0) leaf_test<LS>(sh.leaf[b], ls, ln.z, r, tb, ib);
    cursor = any ? ln.y : ln.x;
    ++steps;
    ++s;
    if (cursor >= w.M || steps >= limit) return;
    const int nx = any ? 0 : 1;
    lo = sh.rec[b][nx][0];
    hi = sh.rec[b][nx][1];
    ln = as_int4(sh.rec[b][nx][2]);
  }
}

// Launch 1: one CTA per packet, up to ``cap`` steps.
template <int LS>
__global__ void __launch_bounds__(kPacket)
walk_kernel(Walk w, int cap) {
  __shared__ Stage sh;
  const int p = blockIdx.x;
  const size_t ray = (size_t)p * kPacket + threadIdx.x;
  const Ray r = load_ray(w.rays, ray);
  float tb = __int_as_float(0x7f800000);   // +inf
  int ib = -1, cursor = 0, steps = 0, s = 0;
  walk_packet<1, LS>(w, sh, r, tb, ib, cursor, steps, cap, s);
  w.t[ray] = tb;
  w.slot[ray] = ib;
  if (threadIdx.x == 0) {
    w.steps[p] = steps;
    if (cursor < w.M) {
      w.cursor[p] = cursor;
      w.resume[1 + atomicAdd(w.resume, 1)] = p;
    }
  }
}

// Launch 2: clusters of K CTAs walk the listed packets to their end.
template <int K, int LS>
__global__ void __launch_bounds__(kPacket / K)
resume_kernel(Walk w) {
  __shared__ Stage sh;
  constexpr int kRays = kPacket / K;
  int rank = 0;
  if constexpr (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    if (threadIdx.x < 2 * kMaxCluster)
      (&sh.mail[0][0])[threadIdx.x] = ~0u;    // a tag no step carries
    cluster.sync();    // no peer votes before the mailboxes are cleared
  }
  const int count = w.resume[0];
  int s = 0;
  for (int i = blockIdx.x / K; i < count; i += gridDim.x / K) {
    const int p = w.resume[1 + i];
    const size_t ray = (size_t)p * kPacket + rank * kRays + threadIdx.x;
    const Ray r = load_ray(w.rays, ray);
    float tb = w.t[ray];
    int ib = w.slot[ray];
    int cursor = w.cursor[p], steps = w.steps[p];
    walk_packet<K, LS>(w, sh, r, tb, ib, cursor, steps, INT_MAX, s);
    w.t[ray] = tb;
    w.slot[ray] = ib;
    if (rank == 0 && threadIdx.x == 0) w.steps[p] = steps;
  }
  if constexpr (K > 1) cg::this_cluster().sync();   // no CTA leaves while
                                                     // a peer may vote
}

// The launch configuration of resume_kernel<K, LS>, its attributes set;
// the caller sets gridDim.
template <int K, int LS>
cudaError_t resume_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  if (K > 8)
    e = cudaFuncSetAttribute(resume_kernel<K, LS>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(K);
  cfg->blockDim = dim3(kPacket / K);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// Clusters of resume_kernel<K, LS> resident at once on the current device
// (the occupancy query); 0 or a negative CUDA error code on failure.
template <int K, int LS>
int max_clusters() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resume_config<K, LS>(&cfg, &attr, 0);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, resume_kernel<K, LS>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <int K, int LS>
int launch_resume(const Walk& w, int g, cudaStream_t stream) {
  const int n = max_clusters<K, LS>();
  if (n < 0) return -n;
  if (n == 0) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resume_config<K, LS>(&cfg, &attr, stream);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3((n < g ? n : g) * K);
  e = cudaLaunchKernelEx(&cfg, resume_kernel<K, LS>, w);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int LS>
int run(const Walk& w, int g, int cluster, int cap, cudaStream_t stream) {
  walk_kernel<LS><<<g, kPacket, 0, stream>>>(w, cap > 0 ? cap : INT_MAX);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || cap <= 0) return (int)e;
  switch (cluster) {
    case 1: return launch_resume<1, LS>(w, g, stream);
    case 2: return launch_resume<2, LS>(w, g, stream);
    case 4: return launch_resume<4, LS>(w, g, stream);
    case 8: return launch_resume<8, LS>(w, g, stream);
    case 16: return launch_resume<16, LS>(w, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rays (g, 1024, 8) f32 [ox oy oz dx dy dz 0 0]; nodes (M, 8) f32; links
// (M, 4) i32; prims (P, 4) f32; t / slot (g, 1024); steps (g,); scratch
// (1 + 2g,) i32. With cap > 0 the walk stops each packet at ``cap`` steps
// and clusters of ``cluster`` CTAs (1, 2, 4, 8 or 16) resume it; with
// cap <= 0 one launch walks every packet to its end. leaf_size 1..32.
// Returns the first CUDA error of the launches.
extern "C" int tracer_traverse(const void* rays, const void* nodes,
                               const void* links, const void* prims, void* t,
                               void* slot, void* steps, void* scratch, int g,
                               int M, int leaf_size, int cluster, int cap,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (g <= 0) return (int)cudaGetLastError();
  int32_t* s = (int32_t*)scratch;
  const Walk w{(const float4*)rays, (const float4*)nodes, (const int4*)links,
               (const float4*)prims, (float*)t, (int32_t*)slot,
               (int32_t*)steps, s + 1 + g, s, M, leaf_size};
  if (cap > 0) {
    const cudaError_t e = cudaMemsetAsync(s, 0, sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  switch (leaf_size) {
    case 4: return run<4>(w, g, cluster, cap, st);
    case 16: return run<16>(w, g, cluster, cap, st);
    case 32: return run<32>(w, g, cluster, cap, st);
    default: return run<0>(w, g, cluster, cap, st);
  }
}

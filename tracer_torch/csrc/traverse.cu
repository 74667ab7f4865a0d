// traverse_cuda: packet traversal of the escape-index BVH with one shared
// cursor per 1024-ray packet; returns each ray's argmin prim slot and the
// packet's visited-node count.
//
// Replaces the TPU kernel tracer/kernels/traverse_pallas.py:_traverse_kernel,
// reached through traverse_pallas._traverse_packets. What it computes is the
// same; the TPU mechanics are gone: no (8, 128) ray blocks, no masked-sum
// lane extraction of node data, no SMEM meta tables, no n_streams software
// pipelining.
//   * one CTA of 1024 threads per packet, one ray per thread; the cursor is
//     uniform across the CTA, and __syncthreads_or(box_hit) is the packet's
//     any(); the same barrier orders every step, so the loop stays uniform;
//   * node boxes are two float4 and the links (escape, next-on-hit, leaf
//     start) one int4 per node, read through the read-only cache; every
//     thread reads the same address, so a node costs one broadcast;
//   * a leaf is tested only when some ray of the packet hit its box, and
//     then against all 1024 rays, in slot order with a strict < update, so
//     the lowest slot wins ties;
//   * the leaf test is the b-form of the TPU kernel (b = 2 oc.d,
//     c = |oc|^2 - r^2, disc = b^2 - 4ac, t = (-b - sqrt(disc)) / 2a),
//     spelled with __fmul_rn / __fadd_rn / __fsqrt_rn so nvcc does not
//     contract it into FMAs: the kernel then rounds exactly like the plain
//     PyTorch version (traverse_plain), t, slots and steps bit for bit.
//
// Bound on this card: not bytes (the 100k-sphere tables are ~3 MB and stay
// in L2) but the serial walk: every step is a dependent node load, a slab
// test and a CTA-wide barrier, and a packet pays the union of its rays'
// visited nodes. Node visits x 1024 slab tests plus leaf visits x leaf_size
// x 1024 quadratic tests is the work; the steps are latency-bound. A
// per-ray walk would drop the union but changes what `steps` means; it is
// left to a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPacket = 1024;
constexpr float kHuge = 3.0e38f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float inv_dir(float d) {
  return d == 0.0f ? kHuge : __fdiv_rn(1.0f, d);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kPacket)
traverse_kernel(const float4* __restrict__ rays,
                const float4* __restrict__ nodes,
                const int4* __restrict__ links,
                const float4* __restrict__ prims,
                float* __restrict__ t_out, int32_t* __restrict__ slot_out,
                int32_t* __restrict__ steps_out, int M, int leaf_size) {
  const size_t ray = (size_t)blockIdx.x * kPacket + threadIdx.x;
  const float4 o4 = rays[2 * ray];
  const float4 d4 = rays[2 * ray + 1];
  const float ox = o4.x, oy = o4.y, oz = o4.z;
  const float dx = o4.w, dy = d4.x, dz = d4.y;
  const float invx = inv_dir(dx), invy = inv_dir(dy), invz = inv_dir(dz);
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float inv2a = __fdiv_rn(1.0f, __fmul_rn(2.0f, fmaxf(a, 1e-30f)));
  const float a4 = __fmul_rn(4.0f, a);

  float tb = __int_as_float(0x7f800000);   // +inf
  int ib = -1;
  int cursor = 0;
  int steps = 0;
  while (cursor < M) {
    const float4 lo = __ldg(&nodes[2 * cursor]);
    const float4 hi = __ldg(&nodes[2 * cursor + 1]);
    const float t1x = __fmul_rn(__fsub_rn(lo.x, ox), invx);
    const float t2x = __fmul_rn(__fsub_rn(hi.x, ox), invx);
    const float t1y = __fmul_rn(__fsub_rn(lo.y, oy), invy);
    const float t2y = __fmul_rn(__fsub_rn(hi.y, oy), invy);
    const float t1z = __fmul_rn(__fsub_rn(lo.z, oz), invz);
    const float t2z = __fmul_rn(__fsub_rn(hi.z, oz), invz);
    const float tmin = fmaxf(fminf(t1x, t2x),
                             fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
    const float tmax = fminf(fmaxf(t1x, t2x),
                             fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
    const int box_hit = tmax >= tmin && tmax > kEps && tmin < tb;
    const int any_hit = __syncthreads_or(box_hit);
    const int4 ln = __ldg(&links[cursor]);    // (escape, next, lstart, 0)
    if (any_hit && ln.z >= 0) {
      for (int j = 0; j < leaf_size; ++j) {
        const float4 q = __ldg(&prims[ln.z + j]);    // center, r^2
        const float ocx = __fsub_rn(ox, q.x);
        const float ocy = __fsub_rn(oy, q.y);
        const float ocz = __fsub_rn(oz, q.z);
        const float bq = __fmul_rn(2.0f, dot3(ocx, ocy, ocz, dx, dy, dz));
        const float cq = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), q.w);
        const float disc = __fsub_rn(__fmul_rn(bq, bq), __fmul_rn(a4, cq));
        const float t = __fmul_rn(
            __fsub_rn(-bq, __fsqrt_rn(fmaxf(disc, 0.0f))), inv2a);
        if (disc > 0.0f && t > kEps && t < tb) {
          tb = t;
          ib = ln.z + j;
        }
      }
    }
    cursor = any_hit ? ln.y : ln.x;
    ++steps;
  }
  t_out[ray] = tb;
  slot_out[ray] = ib;
  if (threadIdx.x == 0) steps_out[blockIdx.x] = steps;
}

}  // namespace

// rays (g, 1024, 8) f32 [ox oy oz dx dy dz 0 0]; nodes (M, 8) f32; links
// (M, 4) i32; prims (P, 4) f32; t / slot (g, 1024); steps (g,). Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_traverse(const void* rays, const void* nodes,
                               const void* links, const void* prims, void* t,
                               void* slot, void* steps, int g, int M,
                               int leaf_size, void* stream) {
  if (g > 0) {
    traverse_kernel<<<g, kPacket, 0, (cudaStream_t)stream>>>(
        (const float4*)rays, (const float4*)nodes, (const int4*)links,
        (const float4*)prims, (float*)t, (int32_t*)slot, (int32_t*)steps, M,
        leaf_size);
  }
  return (int)cudaGetLastError();
}

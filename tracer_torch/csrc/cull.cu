// cull_cuda: the packet cull. Nearest hit of each ray of a 1024-ray packet
// against the prims of the packet's candidate 128-prim tiles.
//
// Replaces the TPU kernel tracer/kernels/cull_pallas.py:_cull_kernel,
// reached through cull_pallas._cull_packets. What it computes is the same;
// the TPU mechanics are gone: no (8, 128) ray planes, no masked-sum lane
// extraction of each prim, no scalar-prefetched count and candidate tables.
//   * one CTA of 1024 threads per packet, one ray per thread (the layout of
//     traverse_cuda: rays (g, 1024, 8) as [ox oy oz dx dy dz 0 0]);
//   * for k < min(count, K), 128 threads stage tile cand[p, k] (128 prims of
//     centre and r^2) in shared memory; after a barrier every thread tests
//     its ray against the 128 prims in ascending lane order;
//   * the test is the TPU kernel's b-form: hb = oc.d, cq = |oc|^2 - r^2,
//     disc4 = hb^2 - a*cq, t = (-hb - sqrt(disc4)) / a, accepted when
//     disc4 > 0, t > EPSILON and t < best (strict, so the first of equal t
//     in listed order wins); spelled with __fmul_rn / __fadd_rn /
//     __fsqrt_rn so nvcc does not contract it into FMAs and cull_plain
//     rounds it the same, bit for bit;
//   * the trip count is min(count, K). The TPU kernel loops to the raw
//     count, which tile_candidates lets exceed K on overflow, and then reads
//     cand past the packet's K columns; that is not copied.
//
// Bound on this card: operations. Each listed tile costs 1024 x 128 tests of
// ~25 fp32 operations on 2 KB of prims that sit in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPacket = 1024;
constexpr int kTile = 128;
constexpr float kEps = 1e-6f;

__global__ void __launch_bounds__(kPacket)
cull_kernel(const float4* __restrict__ rays, const float4* __restrict__ tiles,
            const int32_t* __restrict__ cand,
            const int32_t* __restrict__ counts, float* __restrict__ t_out,
            int32_t* __restrict__ slot_out, int K) {
  __shared__ float4 s_prim[kTile];
  const int p = blockIdx.x;
  const size_t ray = (size_t)p * kPacket + threadIdx.x;
  const float4 o4 = rays[2 * ray];
  const float4 d4 = rays[2 * ray + 1];
  const float ox = o4.x, oy = o4.y, oz = o4.z;
  const float dx = o4.w, dy = d4.x, dz = d4.y;
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  const float inv_a = __fdiv_rn(1.0f, fmaxf(a, 1e-30f));

  float tb = __int_as_float(0x7f800000);   // +inf
  int ib = -1;
  const int n = min(max(counts[p], 0), K);
  for (int k = 0; k < n; ++k) {
    const int tile = cand[(size_t)p * K + k];
    if (threadIdx.x < kTile)
      s_prim[threadIdx.x] = tiles[(size_t)tile * kTile + threadIdx.x];
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float4 q = s_prim[j];            // centre, r^2
      const float ocx = __fsub_rn(ox, q.x);
      const float ocy = __fsub_rn(oy, q.y);
      const float ocz = __fsub_rn(oz, q.z);
      const float hb = __fadd_rn(__fadd_rn(__fmul_rn(ocx, dx),
                                           __fmul_rn(ocy, dy)),
                                 __fmul_rn(ocz, dz));
      const float cq = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                    __fmul_rn(ocz, ocz)),
          q.w);
      const float disc4 = __fsub_rn(__fmul_rn(hb, hb), __fmul_rn(a, cq));
      const float t = __fmul_rn(
          __fsub_rn(-hb, __fsqrt_rn(fmaxf(disc4, 0.0f))), inv_a);
      if (disc4 > 0.0f && t > kEps && t < tb) {
        tb = t;
        ib = tile * kTile + j;
      }
    }
    __syncthreads();
  }
  t_out[ray] = tb;
  slot_out[ray] = ib;
}

}  // namespace

// rays (g, 1024, 8) f32; tiles (T + 1, 128, 4) f32; cand (g, K) i32; counts
// (g,) i32; t / slot (g, 1024). Returns cudaGetLastError() after the launch.
extern "C" int tracer_cull(const void* rays, const void* tiles,
                           const void* cand, const void* counts, void* t,
                           void* slot, int g, int K, void* stream) {
  if (g > 0) {
    cull_kernel<<<g, kPacket, 0, (cudaStream_t)stream>>>(
        (const float4*)rays, (const float4*)tiles, (const int32_t*)cand,
        (const int32_t*)counts, (float*)t, (int32_t*)slot, K);
  }
  return (int)cudaGetLastError();
}

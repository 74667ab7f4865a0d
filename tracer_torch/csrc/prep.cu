// prep_cuda: prep of the closest-hit and any-hit queries on the card
// (kernels/leafcull.py prep_cuda): each ray's octahedral Morton code as a
// sort key, then, after torch.sort, the cell table of the bucket padding
// and one pass that writes every padded slot's feature row and each ray's
// slot (dest). Three launches:
//   * prep_keys: one thread a ray writes its 32-bit octahedral code with
//     the sign bit flipped, an int32 that sorts as the unsigned code, so
//     the stable sort orders 32 bits where the torch operations sort an
//     int64, and gives the same permutation;
//   * prep_cells: one block of 1,024 threads finds the 2^cell_bits cell
//     bounds by binary search on the sorted keys, scans the cells'
//     padding across the block and writes (pstart, pad_before, cap) per
//     cell, a table of at most 48 KB (cell_bits <= 12);
//   * prep_rows: every slot stages the table in shared memory, finds its
//     cell by a binary search of pstart, takes its source ray
//     perm[clamp(min(slot - pad_before, cap), 0, B - 1)], computes that
//     ray's 16 feature columns from o, d and t_max, and stores them as
//     four 16-byte stores; slots past B + 2^cell_bits * SP up to the step
//     repeat the last slot's row; slot i < B also writes
//     dest[perm[i]] = i + pad_before[cell of sorted key i], as int64.
//
// Replaces no TPU kernel: prep is XLA operations in the JAX package
// (tracer/kernels/leafcull.py:475 prep_feats_bucketed, with
// tracer/core/sort.py octahedral_codes and plan_bucket_pad), and the port
// first wrote it as the same chain of torch operations
// (leafcull.prep_feats_plain): ~116 launches a call, a (3, Bp) int64
// cumsum that torch spreads over a few blocks (0.92 ms at 0.59M slots),
// a (B, 16) feature plane gathered into a (Bp, 16) one, a cat for the
// padding to the step and a scatter for dest.
//
// Bound on this card: bytes, o, d and perm read once and the rows and dest
// written once: at query_100k's 524,288 rays and 589,824 slots 54.5 MB,
// about 16 us at 3.35 TB/s. The design keeps to it: the keys are 4 bytes a
// ray, no plan over the slots goes to device memory (the cell table is at
// most 4,096 x 3 ints, read from shared memory), each row is computed
// from its ray where it is written, and the gathers of o and d read the
// ray's own 24 bytes. Every column rounds as the torch operations do
// (__fmul_rn, __fadd_rn, __fdiv_rn, nothing contracted into an FMA;
// clamps that return NaN where torch's do), so the rows and dest are bit
// for bit prep_feats_plain's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCellBits = 12;
constexpr int kCellThreads = 1024;   // prep_cells: 32 warps
constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 1024;  // prep_rows: grid-stride over slots
constexpr uint32_t kSign = 0x80000000u;

// torch.sign: (0 < x) - (x < 0), so NaN and -0 give 0.
__device__ __forceinline__ float sgn(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

// torch.clamp(x, lo, hi) of a float: NaN passes through.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// (x * 0.5 + 0.5) * 65535 clamped to [0, 65535], cast to int64 as torch's
// .to(torch.int64) casts, and its low 16 bits spread over 32 bits.
__device__ __forceinline__ uint32_t quantised_bits(float x) {
  const float q = clamp_nan(
      __fmul_rn(__fadd_rn(__fmul_rn(x, 0.5f), 0.5f), 65535.f), 0.f, 65535.f);
  uint32_t v = (uint32_t)((long long)q & 0xFFFF);
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// core/sort.py octahedral_codes of one direction.
__device__ __forceinline__ uint32_t octahedral_code(float dx, float dy,
                                                    float dz) {
  const float s = __fadd_rn(__fadd_rn(fabsf(dx), fabsf(dy)), fabsf(dz));
  const float u = __fdiv_rn(dx, s);
  const float v = __fdiv_rn(dy, s);
  float uu = u, vv = v;
  if (dz < 0.f) {
    uu = __fmul_rn(__fsub_rn(1.f, fabsf(v)), sgn(u));
    vv = __fmul_rn(__fsub_rn(1.f, fabsf(u)), sgn(v));
  }
  return quantised_bits(uu) | (quantised_bits(vv) << 1);
}

__global__ void __launch_bounds__(kThreads)
prep_keys(const float* __restrict__ d, int32_t* __restrict__ keys, int B) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  keys[i] = (int32_t)(octahedral_code(d[3 * i], d[3 * i + 1], d[3 * i + 2])
                      ^ kSign);
}

// The first index of sorted keys[0, n) not below q.
__device__ int first_not_below(const int32_t* __restrict__ keys, int n,
                           int32_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// cells (3, ncells) i32: pstart, pad_before, cap per cell, as
// core/sort.py plan_bucket_pad computes them. Thread t owns the cells
// [t * per, (t + 1) * per); one block-wide scan of their padding.
__global__ void __launch_bounds__(kCellThreads)
prep_cells(const int32_t* __restrict__ sorted_keys,
           int32_t* __restrict__ cells, int B, int SP, int cell_bits) {
  __shared__ int bounds[(1 << kMaxCellBits) + 1];
  __shared__ int warp_sums[kCellThreads / 32];
  const int ncells = 1 << cell_bits;
  for (int c = threadIdx.x; c < ncells; c += kCellThreads) {
    const uint32_t edge =
        (uint32_t)((unsigned long long)c << (32 - cell_bits));
    bounds[c] = first_not_below(sorted_keys, B, (int32_t)(edge ^ kSign));
  }
  if (threadIdx.x == 0) bounds[ncells] = B;
  __syncthreads();
  const int per = (ncells + kCellThreads - 1) / kCellThreads;
  const int lo = min((int)threadIdx.x * per, ncells);
  const int hi = min(lo + per, ncells);
  int own = 0;
  for (int c = lo; c < hi; ++c) {
    const int cnt = bounds[c + 1] - bounds[c];
    own += (SP - cnt % SP) % SP;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int before = incl - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int c = lo; c < hi; ++c) {
    const int start = bounds[c], cnt = bounds[c + 1] - start;
    cells[c] = start + before;
    cells[ncells + c] = before;
    cells[2 * ncells + c] = start + max(cnt - 1, 0);
    before += (SP - cnt % SP) % SP;
  }
}

__global__ void __launch_bounds__(kThreads)
prep_rows(const float* __restrict__ o, const float* __restrict__ d,
          const float* __restrict__ t_max,
          const int32_t* __restrict__ sorted_keys,
          const int64_t* __restrict__ perm, const int32_t* __restrict__ cells,
          float4* __restrict__ feats, int64_t* __restrict__ dest, int B,
          int total, int Bp, int cell_bits) {
  extern __shared__ int table[];   // pstart | pad_before | cap
  const int ncells = 1 << cell_bits;
  for (int i = threadIdx.x; i < 3 * ncells; i += kThreads) table[i] = cells[i];
  __syncthreads();
  const int* pstart = table;
  const int* pad_before = table + ncells;
  const int* cap = table + 2 * ncells;
  const float big = (float)3.0e38, eps = (float)1e-6, tiny = (float)1e-30;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < total; p += (long long)gridDim.x * kThreads) {
    const int q = (int)min(p, (long long)(Bp - 1));
    int lo = 0, hi = ncells;           // the last cell with pstart <= q
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pstart[mid] <= q) lo = mid + 1; else hi = mid;
    }
    const int c = lo - 1;
    const int src = max(0, min(min(q - pad_before[c], cap[c]), B - 1));
    const long long ray = perm[src];
    const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    const float a = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    const float inva = __fdiv_rn(1.f, isnan(a) ? a : fmaxf(a, tiny));
    const float negat = t_max ? __fmul_rn(-a, t_max[ray]) : -big;
    float4* row = feats + 4 * p;
    row[0] = make_float4(dx, dy, dz, o[3 * ray]);
    row[1] = make_float4(o[3 * ray + 1], o[3 * ray + 2], 1.f, 0.f);
    row[2] = make_float4(0.f, 0.f, a, inva);
    row[3] = make_float4(__fmul_rn(a, eps), negat, 0.f, 0.f);
    if (p < B) {
      const uint32_t code = (uint32_t)sorted_keys[p] ^ kSign;
      const int cell = (int)((unsigned long long)code >> (32 - cell_bits));
      dest[perm[p]] = p + pad_before[cell];
    }
  }
}

}  // namespace

// d (B, 3) f32; keys (B,) i32. Returns cudaGetLastError() after the launch.
extern "C" int tracer_prep_keys(const void* d, void* keys, int B,
                                void* stream) {
  if (B > 0)
    prep_keys<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>((const float*)d, (int32_t*)keys, B);
  return (int)cudaGetLastError();
}

// sorted_keys (B,) i32 ascending; cells (3, 2^cell_bits) i32, written.
// Returns cudaGetLastError() after the launch.
extern "C" int tracer_prep_cells(const void* sorted_keys, void* cells, int B,
                                 int SP, int cell_bits, void* stream) {
  if (cell_bits < 0 || cell_bits > kMaxCellBits || SP <= 0)
    return (int)cudaErrorInvalidValue;
  prep_cells<<<1, kCellThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sorted_keys, (int32_t*)cells, B, SP, cell_bits);
  return (int)cudaGetLastError();
}

// o, d (B, 3) f32; t_max (B,) f32 or null; sorted_keys (B,) i32; perm (B,)
// i64; cells (3, 2^cell_bits) i32 from tracer_prep_cells; feats (total,
// 16) f32 and dest (B,) i64, written; Bp = B + 2^cell_bits * SP <= total.
// Returns cudaGetLastError() after the launch.
extern "C" int tracer_prep_rows(const void* o, const void* d,
                                const void* t_max, const void* sorted_keys,
                                const void* perm, const void* cells,
                                void* feats, void* dest, int B, int total,
                                int Bp, int cell_bits, void* stream) {
  if (cell_bits < 0 || cell_bits > kMaxCellBits || B <= 0 || Bp > total)
    return (int)cudaErrorInvalidValue;
  const int blocks = min((total + kThreads - 1) / kThreads, kMaxRowBlocks);
  const size_t smem = (size_t)3 * (1 << cell_bits) * sizeof(int);
  prep_rows<<<(unsigned)blocks, kThreads, smem,
              (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)t_max,
      (const int32_t*)sorted_keys, (const int64_t*)perm,
      (const int32_t*)cells, (float4*)feats, (int64_t*)dest, B, total, Bp,
      cell_bits);
  return (int)cudaGetLastError();
}

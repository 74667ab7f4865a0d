// compact_cuda: rows of masked, ascending ids -> the dense prefix of the
// first `keep` survivors (sentinel-padded) plus the raw survivor count.
//
// Replaces the TPU kernel tracer/kernels/conecull.py:_compact_ids_kernel,
// reached through conecull.compact_ascending_rows (pallas_call at
// tracer/kernels/conecull.py:475). The TPU version shifts survivors left
// with a log-step butterfly of lane rolls over (64, M) VMEM blocks;
// survivors are already in order, so a rank per id and a scatter give the
// same output without it.
//
// Bound on this card: bytes -- one read of the (P, M) i32 ids and one
// write of the (P, keep) prefix and the (P,) counts; the rank is a few
// instructions per id. The first design gave each row a 256-thread CTA
// that loaded one id per thread per 256-id tile, each load issued after
// the previous tile's scan, with three barriers per tile: a chain of
// dependent memory latencies per row. This one:
//   * gives each row one warp, kWarps rows to a CTA, and no barrier; grid
//     ceil(P / kWarps);
//   * issues every load of a 1,024-id batch before any rank is taken:
//     8 int4 loads per lane (neighbouring lanes on neighbouring 16 bytes)
//     where M % 4 == 0 and the ids are 16-byte aligned, 16 int2 loads
//     where M % 2 == 0 and they are 8-byte aligned (the packet cull's 1102
//     tiles), else 32 scalar loads; masked-off loads read as the sentinel;
//   * ranks a batch in 32-lane slices: one __ballot_sync per id a lane
//     holds in the slice, survivors before an id = the __popc of the
//     ballots under its lane plus its lane's earlier survivors; survivor i
//     goes to out[row, carry + rank] while that is below keep, and the
//     carry grows by the slice's __popc total (warp-uniform, no shuffle);
//   * loops over batches with the carry on rows longer than one; once
//     carry >= keep the rest of the row is only counted;
//   * writes the sentinel tail as int4 stores where keep % 4 == 0, and the
//     count from one lane.
// Planes of few rows (the packet cull's 512 x 1102) leave the card mostly
// idle with a warp per row; splitting their rows over 2-8 warps of a CTA
// (a count, a barrier, a rank) measured no faster there, and is not done.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // warps per CTA
constexpr int kPerLane = 32;    // ids a lane holds per batch
constexpr int kBatch = 32 * kPerLane;   // ids a warp holds per batch
constexpr unsigned kFull = 0xffffffffu;

// Rank one 32-lane slice whose lane holds ids[0..V) in order (slice
// position lane * V + j) and store its survivors below keep; then add the
// slice's survivors to carry.
template <int V>
__device__ __forceinline__ void slice(const int* ids, int sentinel, int keep,
                                      int32_t* __restrict__ o, int& carry) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int before = 0, total = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const unsigned b = __ballot_sync(kFull, ids[j] != sentinel);
    before += __popc(b & below);
    total += __popc(b);
  }
  if (carry < keep) {               // warp-uniform
    int pos = carry + before;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (ids[j] != sentinel) {
        if (pos < keep) o[pos] = ids[j];
        ++pos;
      }
    }
  }
  carry += total;
}

// Load the ids [b0, b1) of a row (b1 - b0 <= kBatch; b0 and b1 multiples
// of V) into the lane's registers, V ids a load (int4, int2 or int; lane l
// takes load 32 k + l), every load issued before any is used; ids past b1
// read as the sentinel.
template <int V>
__device__ __forceinline__ void load_batch(const int32_t* __restrict__ in,
                                           int b0, int b1, int sentinel,
                                           int (&v)[kPerLane]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kPerLane / V; ++k) {
    const int i = b0 / V + k * 32 + lane;
    const bool in_row = i < b1 / V;
    if constexpr (V == 4) {
      const int4 x = in_row ? __ldcs(reinterpret_cast<const int4*>(in) + i)
                            : make_int4(sentinel, sentinel, sentinel,
                                        sentinel);
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    } else if constexpr (V == 2) {
      const int2 x = in_row ? __ldcs(reinterpret_cast<const int2*>(in) + i)
                            : make_int2(sentinel, sentinel);
      v[2 * k] = x.x;
      v[2 * k + 1] = x.y;
    } else {
      v[k] = in_row ? __ldcs(in + i) : sentinel;
    }
  }
}

// Rank the loaded batch [b0, b1) from carry and store its survivors below
// keep; returns the carry after it.
template <int V>
__device__ __forceinline__ int rank_batch(const int (&v)[kPerLane], int b0,
                                          int b1, int sentinel, int keep,
                                          int32_t* __restrict__ o,
                                          int carry) {
#pragma unroll
  for (int k = 0; k < kPerLane / V; ++k) {
    if (b0 + k * 32 * V < b1) slice<V>(v + k * V, sentinel, keep, o, carry);
  }
  return carry;
}

// Sentinels at out[first .. keep) of a row: int4 stores where
// keep % 4 == 0 (the row's output is then 16-byte aligned).
__device__ __forceinline__ void tail(int32_t* __restrict__ o, int first,
                                     int keep, int sentinel) {
  const int lane = threadIdx.x & 31;
  if ((keep & 3) == 0) {
    const int head = min((first + 3) & ~3, keep);
    if (first + lane < head) o[first + lane] = sentinel;
    int4* o4 = reinterpret_cast<int4*>(o);
    const int4 s4 = make_int4(sentinel, sentinel, sentinel, sentinel);
    for (int i = (head >> 2) + lane; i < (keep >> 2); i += 32) o4[i] = s4;
  } else {
    for (int p = first + lane; p < keep; p += 32) o[p] = sentinel;
  }
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
compact_rows(const int32_t* __restrict__ ids, int32_t* __restrict__ out,
             int32_t* __restrict__ counts, int P, int M, int keep,
             int sentinel) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= P) return;             // the whole warp
  const int32_t* in = ids + (size_t)row * M;
  int32_t* o = out + (size_t)row * keep;
  int v[kPerLane];
  int carry = 0;
  for (int b0 = 0; b0 < M; b0 += kBatch) {
    const int b1 = min(b0 + kBatch, M);
    load_batch<V>(in, b0, b1, sentinel, v);
    carry = rank_batch<V>(v, b0, b1, sentinel, keep, o, carry);
  }
  tail(o, min(carry, keep), keep, sentinel);
  if ((threadIdx.x & 31) == 0) counts[row] = carry;
}

}  // namespace

// ids (P, M) i32 -> out (P, keep) i32, counts (P,) i32; out 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int tracer_compact_rows(const void* ids, void* out, void* counts,
                                   int P, int M, int keep, int sentinel,
                                   void* stream) {
  if (P > 0) {
    const unsigned grid = (unsigned)((P + kWarps - 1) / kWarps);
    const uintptr_t at = (uintptr_t)ids;
    const int V = M % 4 == 0 && at % 16 == 0 ? 4
                  : M % 2 == 0 && at % 8 == 0 ? 2 : 1;
    auto kernel = V == 4 ? compact_rows<4>
                  : V == 2 ? compact_rows<2> : compact_rows<1>;
    kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (int32_t*)out, (int32_t*)counts, P, M, keep,
        sentinel);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tracer_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

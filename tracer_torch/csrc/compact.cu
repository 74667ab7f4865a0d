// compact_cuda: rows of masked, ascending ids -> the dense prefix of the
// first `keep` survivors (sentinel-padded) plus the raw survivor count.
//
// Replaces the TPU kernel tracer/kernels/conecull.py:_compact_ids_kernel,
// reached through conecull.compact_ascending_rows. The TPU version shifts
// survivors left with a log-step butterfly of lane rolls; survivors are
// already in order, so a block-wide exclusive scan of the mask plus a
// scatter gives the same output without it.
//   * one CTA per row; the row is walked in tiles of blockDim ids;
//   * per tile: warp-level inclusive scan with __shfl_up_sync, warp totals
//     scanned by warp 0 through shared memory, a running carry across
//     tiles; survivor i goes to out[row, carry + rank] when that is < keep;
//   * the rest of the row gets the sentinel and count[row] the total.
// Bound on this card: memory -- one read of the (P, M) i32 ids and one
// write of the (P, keep) i32 prefix; the scan is a few dozen instructions
// per id. Reads and writes are coalesced along the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void compact_kernel(const int32_t* __restrict__ ids,
                               int32_t* __restrict__ out,
                               int32_t* __restrict__ counts,
                               int M, int keep, int sentinel) {
  __shared__ int warp_sums[32];
  const int row = blockIdx.x;
  const int32_t* in = ids + (size_t)row * M;
  int32_t* o = out + (size_t)row * keep;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  int carry = 0;
  for (int base = 0; base < M; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int id = i < M ? in[i] : sentinel;
    const int flag = id != sentinel;
    int x = flag;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_sums[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;            // inclusive scan of warp totals
    }
    __syncthreads();
    const int pos = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - flag;
    if (flag && pos < keep) o[pos] = id;
    carry += warp_sums[nwarps - 1];
    __syncthreads();                  // warp_sums is rewritten next tile
  }
  for (int p = min(carry, keep) + threadIdx.x; p < keep; p += blockDim.x)
    o[p] = sentinel;
  if (threadIdx.x == 0) counts[row] = carry;
}

}  // namespace

// ids (P, M) i32 -> out (P, keep) i32, counts (P,) i32. Returns
// cudaGetLastError() after the launch.
extern "C" int tracer_compact_rows(const void* ids, void* out, void* counts,
                                   int P, int M, int keep, int sentinel,
                                   void* stream) {
  if (P > 0) {
    compact_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (int32_t*)out, (int32_t*)counts, M, keep,
        sentinel);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tracer_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

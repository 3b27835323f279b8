// frontier_compact: COMPACT's stable stream compaction, for Hopper (sm_90a).
//
// Replaces repro/kernels/frontier_compact/frontier_compact.py::
// frontier_compact_pallas (body _kernel).  Moves the rows whose mask byte is
// set into a dense prefix of the output, in their original order, and the
// other rows after them, also in order: the stable partition that the
// reference's argsort oracle gives.  The kept count is written as an int32
// on the device.  A row is one element of each of up to kMaxCols separate
// columns of 4-byte words or 1-byte flags, copied raw, so ids need no
// float32 packing and have no 2^24 limit, and the caller needs no packed
// copy of its columns.
//
// Bound on an H100: bytes.  The work is one read of the mask (m bytes) and
// of every column, and one write of every column, at 3.35 TB/s.  The TPU
// kernel walked its grid in order and carried the running offset in SMEM;
// blocks on a GPU run in no order, so the offset comes from a scan over
// per-block counts instead:
//
//   1. count:   one block of 1024 rows per 1024 threads, kept rows counted
//               with __syncthreads_count;
//   2. scan:    one block turns the per-block counts into exclusive offsets
//               (warp shuffles, in chunks of 1024) and writes the total;
//   3. scatter: a row's count of kept rows before it is its block's offset
//               plus its warp's offset (a shuffle scan of the 32 warp
//               counts) plus its rank in its warp (__ballot_sync/__popc).
//               A kept row goes to that position, any other row to
//               total + (its index - that count).
//
// Writing the rows that are not kept lets the caller use the whole output
// without masking a tail.  Three launches read the mask twice; a
// single-pass decoupled look-back scan is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // rows per block, one per thread
constexpr int kMaxCols = 4;

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int bytes[kMaxCols];  // 4 or 1
  int n;
};

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__global__ void count_kernel(const uint8_t* __restrict__ mask, int* __restrict__ block_counts,
                             long long m) {
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const int keep = (i < m) && mask[i];
  const int total = __syncthreads_count(keep);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void scan_kernel(int* __restrict__ block_counts, int n_blocks, int* __restrict__ count) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_blocks; base += kTile) {
    const int idx = base + threadIdx.x;
    const int v = idx < n_blocks ? block_counts[idx] : 0;
    const int x = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
    __syncthreads();
    const int excl = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
    if (idx < n_blocks) block_counts[idx] = excl;
    __syncthreads();
    if (threadIdx.x == kTile - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void scatter_kernel(Columns cols, const uint8_t* __restrict__ mask,
                               const int* __restrict__ block_offsets,
                               const int* __restrict__ count, long long m) {
  __shared__ int warp_offsets[32];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int keep = (i < m) && mask[i];
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_offsets[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int w = warp_offsets[lane];
    warp_offsets[lane] = warp_inclusive_scan(w, lane) - w;
  }
  __syncthreads();
  if (i >= m) return;
  const long long kept_before = (long long)block_offsets[blockIdx.x] + warp_offsets[warp] + rank;
  const long long pos = keep ? kept_before : (long long)*count + (i - kept_before);
  // unrolled, so every index into `cols` is a constant: a runtime index
  // into a by-value kernel parameter makes nvcc copy it to local memory
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j >= cols.n) break;
    if (cols.bytes[j] == 4) {
      static_cast<int*>(cols.out[j])[pos] = static_cast<const int*>(cols.in[j])[i];
    } else {
      static_cast<uint8_t*>(cols.out[j])[pos] = static_cast<const uint8_t*>(cols.in[j])[i];
    }
  }
}

}  // namespace

extern "C" int frontier_compact_launch(const void* const* ins, void* const* outs,
                                       const int* bytes, int c, const void* mask, void* count,
                                       void* block_scratch, long long m, void* stream) {
  if (c < 1 || c > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  cols.n = c;
  for (int j = 0; j < c; ++j) {
    cols.in[j] = ins[j];
    cols.out[j] = outs[j];
    cols.bytes[j] = bytes[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>((m + kTile - 1) / kTile);
  const uint8_t* mask_p = static_cast<const uint8_t*>(mask);
  int* scratch = static_cast<int*>(block_scratch);
  int* count_p = static_cast<int*>(count);
  count_kernel<<<n_blocks, kTile, 0, s>>>(mask_p, scratch, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kTile, 0, s>>>(scratch, n_blocks, count_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<n_blocks, kTile, 0, s>>>(cols, mask_p, scratch, count_p, m);
  return static_cast<int>(cudaGetLastError());
}

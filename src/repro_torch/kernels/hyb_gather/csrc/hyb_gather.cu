// hyb_gather: ZEROCOPY's per-request window gather, for Hopper (sm_90a).
//
// Replaces repro/kernels/hyb_gather/hyb_gather.py::hyb_gather_pallas (body
// _kernel).  For each of `a` requests and each of up to kMaxCols separate
// columns (4-byte words or 1-byte flags), copies the PAD=128 elements
// col[start : start+128] into out_col[r] and writes 0 for every lane at or
// past the request's degree, giving one (a, 128) output per column.
//
// Bound on an H100: bytes.  The work is one read of the requested rows
// (min(degree, 128) elements of each column, plus 8 bytes of start and
// degree) and one write of the (a, 128) outputs at 3.35 TB/s.  The TPU
// kernel issued one DMA descriptor per request from a scalar-prefetched
// start over one packed (m, c) array, padded by one window.  Here one
// block of 128 threads serves one request, one thread per lane: for each
// column, neighbouring threads touch neighbouring addresses (coalesced),
// the columns need no packed copy, and rows outside [0, m) read as 0 from
// a bounds check in the kernel instead of a padded copy of the edges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 128;  // lanes per request, one thread each
constexpr int kMaxCols = 4;

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int bytes[kMaxCols];  // 4 or 1
  int n;
};

__global__ void gather_kernel(Columns cols, const int* __restrict__ starts,
                              const int* __restrict__ degree, long long m) {
  const long long r = blockIdx.x;
  const int lane = threadIdx.x;
  const long long row = (long long)starts[r] + lane;
  const bool ok = lane < degree[r] && row >= 0 && row < m;
  const long long to = r * kPad + lane;
  // unrolled, so every index into `cols` is a constant: a runtime index
  // into a by-value kernel parameter makes nvcc copy it to local memory
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j >= cols.n) break;
    if (cols.bytes[j] == 4) {
      static_cast<int*>(cols.out[j])[to] = ok ? static_cast<const int*>(cols.in[j])[row] : 0;
    } else {
      static_cast<uint8_t*>(cols.out[j])[to] =
          ok ? static_cast<const uint8_t*>(cols.in[j])[row] : 0;
    }
  }
}

}  // namespace

extern "C" int hyb_gather_launch(const void* const* ins, void* const* outs, const int* bytes,
                                 int c, const void* starts, const void* degree, long long m,
                                 long long a, void* stream) {
  if (c < 1 || c > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  cols.n = c;
  for (int j = 0; j < c; ++j) {
    cols.in[j] = ins[j];
    cols.out[j] = outs[j];
    cols.bytes[j] = bytes[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_kernel<<<static_cast<unsigned int>(a), kPad, 0, s>>>(
      cols, static_cast<const int*>(starts), static_cast<const int*>(degree), m);
  return static_cast<int>(cudaGetLastError());
}

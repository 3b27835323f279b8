// segment_spmm: the FILTER engine's destination combine, for Hopper (sm_90a).
//
// Replaces repro/kernels/segment_spmm/segment_spmm.py::segment_spmm_pallas
// (bodies _kernel_sum and _kernel_min).  Combines (m, d) float32 messages
// into (n_segments, d) by seg_ids under an optional valid mask, by sum or
// min; empty segments, invalid lanes and ids outside [0, n_segments) give
// the identity (0 / +inf).
//
// Bound on an H100: bytes.  The work is one read of the messages and ids
// (m*d*4 + m*4 bytes) and one write of the output (n_segments*d*4 bytes)
// at 3.35 TB/s; on the FILTER path n_segments = n is larger than m, so
// the identity fill dominates.  The TPU kernel routed each tile through a
// one-hot MXU matmul (sum) or a masked select (min) because a TPU has no
// atomics and runs its grid in order.  Here a fill kernel writes the
// identity, then one thread per (edge, column) combines with one atomic:
//
// * min: the float order as an integer order.  A value with the sign bit
//   clear is combined with a signed atomicMin on its bits; one with the
//   sign bit set with an unsigned atomicMax on its bits.  Over the +inf
//   initial value this is the order of the "flip the negatives" int32
//   encoding (-inf < ... < -0 < +0 < ... < +inf), applied in place, so no
//   decode pass is needed.  min is order-free: the result is bit-exact.
// * sum: float32 atomicAdd.  The order of the additions varies, so values
//   are tolerance-bounded; 0/1 activity columns sum exactly.
//
// Lanes that carry the identity (+inf for min, +0 for sum) are skipped:
// combining them cannot change an output that starts at the identity and
// never becomes -0 under sum.  On FILTER most lanes of a block are
// inactive, so this removes most atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

inline int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

__global__ void fill_kernel(float* __restrict__ out, long long total, float value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = value;
  }
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <bool kMin>
__global__ void combine_kernel(const float* __restrict__ msg, const int* __restrict__ seg,
                               const uint8_t* __restrict__ valid, float* __restrict__ out,
                               long long m, int d, long long n_segments) {
  const long long total = m * d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i / d;
    const int j = static_cast<int>(i - e * d);
    if (valid != nullptr && !valid[e]) continue;
    const int s = seg[e];
    if (s < 0 || s >= n_segments) continue;
    const float v = msg[i];
    float* dst = out + (long long)s * d + j;
    if (kMin) {
      if (__float_as_uint(v) == 0x7f800000u) continue;  // +inf
      atomic_min_f32(dst, v);
    } else {
      if (__float_as_uint(v) == 0u) continue;  // +0
      atomicAdd(dst, v);
    }
  }
}

}  // namespace

extern "C" int segment_spmm_launch(const void* msg, const void* seg_ids, const void* valid,
                                   void* out, long long m, int d, long long n_segments,
                                   int combine_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const long long out_total = n_segments * d;
  const float identity = combine_min ? std::numeric_limits<float>::infinity() : 0.0f;
  fill_kernel<<<grid_for(out_total), kThreads, 0, s>>>(o, out_total, identity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  const float* msg_p = static_cast<const float*>(msg);
  const int* seg_p = static_cast<const int*>(seg_ids);
  const uint8_t* valid_p = static_cast<const uint8_t*>(valid);
  if (combine_min) {
    combine_kernel<true><<<grid_for(m * d), kThreads, 0, s>>>(msg_p, seg_p, valid_p, o, m, d,
                                                             n_segments);
  } else {
    combine_kernel<false><<<grid_for(m * d), kThreads, 0, s>>>(msg_p, seg_p, valid_p, o, m, d,
                                                              n_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

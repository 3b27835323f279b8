// embedding_bag: the fused embedding-bag lookup of DLRM, for Hopper (sm_90a).
//
// Replaces repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas
// (body _kernel), with the semantics of its oracle (the gather engine of
// repro/models/embedding.py: jnp.take, then a sum, mean or max over each
// bag).  From a (V, D) table (float32 or bfloat16) and (B, L) ids (int32 or
// int64), both contiguous, it writes the (B, D) bags in the table's type.
// Each bag accumulates in float32 and is cast once at the end; mean is a
// true division of that sum by L.  Ids follow jnp.take's default mode: an id
// in [-V, 0) wraps to id + V, and any other id outside [0, V) gives a NaN
// row, so its bag is NaN in every column.  Nothing outside the table is
// read.  max starts at -inf and carries a NaN through, as jnp.max does.
//
// Bound on an H100: bytes.  The work is one read of every looked-up row
// (B * L * D elements), one read of the ids and one write of the (B, D)
// bags, at 3.35 TB/s; there is one add per element read.  At DLRM's bulk
// serving shape (B = 262,144, L = 1, D = 128, float32) that is 0.0804 ms.
//
// The TPU kernel walks a grid of 8-bag tiles, issuing one row DMA per
// (bag, slot) from scalar-prefetched ids into a VMEM accumulator.  Here one
// warp owns one bag.  Its lanes read 32 of the bag's ids with one coalesced
// load and broadcast them one by one with shuffles, so each id is read once
// per pass over the columns.  For each id the lanes stride the row's D
// columns with 16-byte loads where D and the pointers allow it (scalar loads
// otherwise): at D = 128 in float32 a row is one 512-byte sweep of the
// warp.  A pass holds up to kChunks loads a lane in registers (512 columns
// in float32, 1024 in bfloat16); a wider row takes more passes.  Row
// offsets are 64-bit: id * D passes 2^31 at 16.8M rows of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // bags per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 4;  // loads a lane holds per pass over the columns
constexpr int kSum = 0, kMean = 1, kMax = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements moved by one load or store (16 bytes when VEC * sizeof(T) == 16)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, typename I, int VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ table, const I* __restrict__ ids, T* __restrict__ out,
               long long V, int D, long long B, int L) {
  const int lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= B) return;  // the whole warp leaves together
  const I* bag_ids = ids + bag * L;
  T* dst = out + bag * D;
  constexpr int kSpan = 32 * VEC;  // columns the warp covers with one load a lane
  for (int c0 = 0; c0 < D; c0 += kSpan * kChunks) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = MODE == kMax ? -__int_as_float(0x7f800000) : 0.0f;
    bool bad = false;  // an id outside [-V, V): the bag is NaN
    for (int s0 = 0; s0 < L; s0 += 32) {
      const I mine = s0 + lane < L ? bag_ids[s0 + lane] : I(0);
      const int n = min(32, L - s0);
      for (int j = 0; j < n; ++j) {
        long long r = static_cast<long long>(__shfl_sync(0xffffffffu, mine, j));
        if (r < 0) r += V;
        if (r < 0 || r >= V) {  // the same id on every lane: no divergence
          bad = true;
          continue;
        }
        const T* row = table + r * D;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int c = c0 + k * kSpan + lane * VEC;
          if (c < D) {  // VEC > 1 only when D % VEC == 0, so c + VEC <= D
            const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(row + c);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float x = to_float(p.v[e]);
              if (MODE == kMax) {
                acc[k][e] = (x > acc[k][e] || x != x) ? x : acc[k][e];
              } else {
                acc[k][e] += x;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = c0 + k * kSpan + lane * VEC;
      if (c < D) {
        Pack<T, VEC> p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float x = acc[k][e];
          if (MODE == kMean) x = __fdiv_rn(x, static_cast<float>(L));  // 0 / 0 = NaN at L = 0
          if (bad) x = __int_as_float(0x7fc00000);
          p.v[e] = from_float<T>(x);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dst + c) = p;
      }
    }
  }
}

template <typename T, typename I, int VEC>
cudaError_t launch(const void* table, const void* ids, void* out, long long V, int D,
                   long long B, int L, int mode, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((B + kWarps - 1) / kWarps));
  const T* t = static_cast<const T*>(table);
  const I* x = static_cast<const I*>(ids);
  T* o = static_cast<T*>(out);
  switch (mode) {
    case kSum:
      bag_kernel<T, I, VEC, kSum><<<grid, kThreads, 0, stream>>>(t, x, o, V, D, B, L);
      break;
    case kMean:
      bag_kernel<T, I, VEC, kMean><<<grid, kThreads, 0, stream>>>(t, x, o, V, D, B, L);
      break;
    case kMax:
      bag_kernel<T, I, VEC, kMax><<<grid, kThreads, 0, stream>>>(t, x, o, V, D, B, L);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t dispatch(const void* table, const void* ids, void* out, long long V, int D,
                     long long B, int L, int mode, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<T, I, kVec>(table, ids, out, V, D, B, L, mode, stream)
             : launch<T, I, 1>(table, ids, out, V, D, B, L, mode, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// has checked shapes, types, devices and contiguity, and that D >= 1,
// L >= 0 and ceil(B / 8) < 2^31; B == 0 launches nothing.
extern "C" int embedding_bag_launch(const void* table, const void* ids, void* out,
                                    int table_bf16, int ids_i64, long long V, int D,
                                    long long B, int L, int mode, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_bf16) {
    err = ids_i64 ? dispatch<__nv_bfloat16, long long>(table, ids, out, V, D, B, L, mode, st)
                  : dispatch<__nv_bfloat16, int>(table, ids, out, V, D, B, L, mode, st);
  } else {
    err = ids_i64 ? dispatch<float, long long>(table, ids, out, V, D, B, L, mode, st)
                  : dispatch<float, int>(table, ids, out, V, D, B, L, mode, st);
  }
  return static_cast<int>(err);
}

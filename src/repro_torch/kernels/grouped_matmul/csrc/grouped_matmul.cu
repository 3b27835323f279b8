// grouped_matmul: the expert-grouped matrix product of the MoE dispatch, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/grouped_matmul/grouped_matmul.py::
// grouped_matmul_pallas (body _kernel), with the function of its oracle
// grouped_matmul_ref.  x is (T, D) tokens sorted by expert, w is (E, D, F),
// starts and counts are (E,) int32, out is (T, F), all contiguous, x, w and
// out all float32 or all bfloat16.  Expert e owns rows [starts[e],
// starts[e] + rows_e) with rows_e = min(counts[e], max_rows): there
// out = x @ w[e], with the products summed in float32 (bfloat16 inputs are
// exact in float32) and cast once to out's type.  Only those rows are
// written; every other row keeps what the wrapper put there (zeros).  Rows
// outside [0, T) are neither read nor written.  max_rows is the row bound
// of the launch (the MoE capacity C): a group's rows past it count as
// outside the group.
//
// The TPU kernel stores a whole 128-row tile at start + ti * 128, zeroing up
// to 127 rows of the next group that only the ascending grid order then
// overwrites.  Blocks here run in no order, so each block writes only the
// rows of its own group.
//
// Bound on an H100: operations at the prefill shapes (gate or up at 4 x 2048
// tokens of deepseek-v2-lite: 2 * 49,152 * 2048 * 1408 = 283.5 GFLOP,
// 0.287 ms at the bf16 tensor-core rate, against 0.212 ms for its 709 MB),
// bytes at decode (24 rows: the active experts' weights, <= 138 MB, 0.041
// ms at 3.35 TB/s).
//
// Grid (ceil(F / 64), ceil(max_rows / 64), E): one block a 64 x 64 output
// tile of one expert.  A block reads its expert's start and count and leaves
// before it reads any weight if its row tile lies past the group, so a
// decode step reads only the active experts' weights (the reference's
// capacity-buffer einsum reads all E).  The depth D is walked in slabs
// staged in shared memory; rows past the group and columns past D or F load
// as zero.  Row and weight offsets are 64-bit.
//
// * bfloat16: 128 threads, four warps each own a 32 x 32 quarter of the
//   tile as 2 x 2 WMMA fragments (16 x 16 x 16, bf16 in, float32
//   accumulators); slabs of 64 loaded with 16-byte loads where D, F and the
//   pointers allow.  The accumulators go through shared memory (aliasing the
//   slabs) to the masked store.
// * float32: 256 threads each own 4 x 4 outputs, float32 FMAs on the CUDA
//   cores (no TF32), slabs of 16.
//
// Double buffering (cp.async or TMA) and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTm = 64;  // output rows per block
constexpr int kTn = 64;  // output columns per block

// ---- bfloat16: WMMA on the tensor cores
constexpr int kBk = 64;                // depth of one slab
constexpr int kThreadsBf = 128;        // 2 x 2 warps
constexpr int kLdA = kBk + 8;          // bf16 elements a row of the A slab
constexpr int kLdB = kTn + 8;          // bf16 elements a row of the B slab
constexpr int kLdC = kTn + 4;          // floats a row of the staged output
constexpr int kSlabBytes = (kTm * kLdA + kBk * kLdB) * 2;
constexpr int kOutBytes = kTm * kLdC * 4;
constexpr int kSmemBf = kSlabBytes > kOutBytes ? kSlabBytes : kOutBytes;

struct __align__(16) Bf8 {
  __nv_bfloat16 v[8];
};

__device__ __forceinline__ int group_rows(const int* counts, int e, int max_rows) {
  return min(max(counts[e], 0), max_rows);
}

__global__ void __launch_bounds__(kThreadsBf)
gmm_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
         const int* __restrict__ starts, const int* __restrict__ counts,
         __nv_bfloat16* __restrict__ out, long long T, int D, int F, int max_rows,
         int vec_x, int vec_w) {
  using namespace nvcuda;
  const int e = blockIdx.z;
  const int rows = group_rows(counts, e, max_rows);
  const int r0 = blockIdx.y * kTm;
  if (r0 >= rows) return;  // before any weight is read
  const long long start = starts[e];
  const int n0 = blockIdx.x * kTn;
  const __nv_bfloat16* we = w + static_cast<long long>(e) * D * F;

  __shared__ __align__(128) unsigned char smem[kSmemBf];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTm][kLdA]
  __nv_bfloat16* Bs = As + kTm * kLdA;                          // [kBk][kLdB]
  float* Cs = reinterpret_cast<float*>(smem);                   // [kTm][kLdC], after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // the warp's 32-row half
  const int wn = warp & 1;   // the warp's 32-column half
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < D; k0 += kBk) {
    for (int i = tid; i < kTm * kBk / 8; i += kThreadsBf) {
      const int r = i / (kBk / 8);
      const int c = (i % (kBk / 8)) * 8;
      const long long row = start + r0 + r;
      const int k = k0 + c;
      Bf8 p;
      if (r0 + r < rows && row >= 0 && row < T) {
        const __nv_bfloat16* src = x + row * D + k;
        if (vec_x && k + 8 <= D) {
          p = *reinterpret_cast<const Bf8*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) p.v[j] = k + j < D ? src[j] : zero;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) p.v[j] = zero;
      }
      *reinterpret_cast<Bf8*>(As + r * kLdA + c) = p;
    }
    for (int i = tid; i < kBk * kTn / 8; i += kThreadsBf) {
      const int kr = i / (kTn / 8);
      const int c = (i % (kTn / 8)) * 8;
      const int k = k0 + kr;
      const int n = n0 + c;
      Bf8 p;
      if (k < D) {
        const __nv_bfloat16* src = we + static_cast<long long>(k) * F + n;
        if (vec_w && n + 8 <= F) {
          p = *reinterpret_cast<const Bf8*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) p.v[j] = n + j < F ? src[j] : zero;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) p.v[j] = zero;
      }
      *reinterpret_cast<Bf8*>(Bs + kr * kLdB + c) = p;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn * 32 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the slabs are read: the next slab, or Cs, may overwrite them
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kTm * kTn; i += kThreadsBf) {
    const int r = i / kTn;
    const int c = i - r * kTn;
    const long long row = start + r0 + r;
    const int n = n0 + c;
    if (r0 + r < rows && row >= 0 && row < T && n < F)
      out[row * F + n] = __float2bfloat16_rn(Cs[r * kLdC + c]);
  }
}

// ---- float32: FMAs on the CUDA cores
constexpr int kBkF = 16;
constexpr int kThreadsF = 256;  // 16 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(kThreadsF)
gmm_f32(const float* __restrict__ x, const float* __restrict__ w,
        const int* __restrict__ starts, const int* __restrict__ counts,
        float* __restrict__ out, long long T, int D, int F, int max_rows) {
  const int e = blockIdx.z;
  const int rows = group_rows(counts, e, max_rows);
  const int r0 = blockIdx.y * kTm;
  if (r0 >= rows) return;  // before any weight is read
  const long long start = starts[e];
  const int n0 = blockIdx.x * kTn;
  const float* we = w + static_cast<long long>(e) * D * F;

  __shared__ float As[kBkF][kTm + 4];  // transposed: As[k][r]
  __shared__ float Bs[kBkF][kTn + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16 j
  const int ty = tid >> 4;  // rows ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBkF) {
    for (int i = tid; i < kTm * kBkF; i += kThreadsF) {
      const int r = i / kBkF;
      const int c = i - r * kBkF;
      const long long row = start + r0 + r;
      const int k = k0 + c;
      As[c][r] = (r0 + r < rows && row >= 0 && row < T && k < D) ? x[row * D + k] : 0.f;
    }
    for (int i = tid; i < kBkF * kTn; i += kThreadsF) {
      const int kr = i / kTn;
      const int c = i - kr * kTn;
      const int k = k0 + kr;
      const int n = n0 + c;
      Bs[kr][c] = (k < D && n < F) ? we[static_cast<long long>(k) * F + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBkF; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const long long row = start + r0 + r;
    if (r0 + r >= rows || row < 0 || row >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) out[row * F + n] = acc[i][j];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// has checked shapes, types, devices and contiguity, zero-filled out, and
// checked that 1 <= E < 2^16 and ceil(max_rows / 64) < 2^16; T == 0,
// F == 0 or max_rows == 0 launches nothing.
extern "C" int grouped_matmul_launch(const void* x, const void* w, const void* starts,
                                     const void* counts, void* out, int is_bf16,
                                     long long T, int D, int F, int E, int max_rows,
                                     void* stream) {
  if (T == 0 || F == 0 || E == 0 || max_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((F + kTn - 1) / kTn),
                  static_cast<unsigned>((max_rows + kTm - 1) / kTm), static_cast<unsigned>(E));
  const int* s = static_cast<const int*>(starts);
  const int* c = static_cast<const int*>(counts);
  if (is_bf16) {
    const int vec_x = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_w = F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    gmm_bf16<<<grid, kThreadsBf, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), s, c,
        static_cast<__nv_bfloat16*>(out), T, D, F, max_rows, vec_x, vec_w);
  } else {
    gmm_f32<<<grid, kThreadsF, 0, st>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w), s, c,
                                         static_cast<float*>(out), T, D, F, max_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

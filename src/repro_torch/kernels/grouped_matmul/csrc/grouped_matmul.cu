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
// ms at 3.35 TB/s).  So a prefill launch must keep the tensor cores busy,
// and a decode launch must keep enough weight bytes in flight to stream at
// the memory's rate.
//
// Grid (column tiles, row tiles, E): one block an output tile of one
// expert.  A block reads its expert's start and count and leaves before it
// loads anything if its row tile lies past the group, so a decode step
// reads only the active experts' weights (the reference's capacity-buffer
// einsum reads all E).  Row and weight offsets are 64-bit.
//
// * bfloat16 (the main path): wgmma on a TMA ring (hopper.cuh).  Warpgroup
//   0 is the producer; one thread issues, for each 64-deep slab of D, the A
//   tile from a 2D map over x at row starts[e] + row tile (rows of the next
//   group load and are never stored; rows past T and columns past D load as
//   zero) and the B tile from a 3D map over w (E, D, F), whose (D, F) rows
//   make it the MN-major B operand.  Consumer warpgroups run wgmma m64 n BN
//   k16 per 64 rows, keep one product group in flight and release a stage
//   when the group before it is done.
//   - Prefill tiles (max_rows > 64): 128 rows x 128 columns, two consumer
//     warpgroups (setmaxnreg 40 / 232), a 4-stage ring of 32 KB stages.
//   - Decode tiles (max_rows <= 64): 64 rows x 64 columns, one consumer
//     warpgroup, a 6-stage ring of 16 KB stages, two blocks an SM: 96 KB of
//     weights in flight an SM.  The A box holds only the launch's row bound
//     (rounded up to 8) rows; the rows of the 64-row product past it are
//     never stored.
//   The accumulators go through shared memory (the ring, once every
//   consumer is done with it) to 16-byte stores of the group's own rows.
//   The wrapper zero-pads x and w into a copy when D or F is not a multiple
//   of 8 or a pointer is not 16-byte aligned (TMA's rules); the main path's
//   shapes never need it.
// * float32 (tests and edge rows only; no main path runs it): 256 threads
//   each own 4 x 4 outputs of a 64 x 64 tile, float32 FMAs on the CUDA
//   cores (no TF32), slabs of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

constexpr int kTm = 64;  // output rows per float32 block
constexpr int kTn = 64;  // output columns per float32 block

__device__ __forceinline__ int group_rows(const int* counts, int e, int max_rows) {
  return min(max(counts[e], 0), max_rows);
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

// ---- bfloat16: wgmma on a TMA ring, one producer and kCons consumer warpgroups

constexpr int kBk = 64;  // depth of one stage

template <int kCons, int kBn, int kStages>
struct GmmShape {
  static constexpr int kRows = 64 * kCons;  // output rows per block
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kABytes = kRows * kBk * 2;
  static constexpr int kBBytes = kBk * kBn * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 16 * kStages + 1024;  // + barriers, + alignment
  static_assert(kCons * 64 * kBn * 2 <= kBarOffset, "the epilogue reuses the ring");
};
using Prefill = GmmShape<2, 128, 4>;
using Decode = GmmShape<1, 64, 6>;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int kCons, int kBn, int kStages>
__global__ void __launch_bounds__(128 * (kCons + 1), kCons == 1 ? 2 : 1)
gmm_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
         const int* __restrict__ starts, const int* __restrict__ counts,
         __nv_bfloat16* __restrict__ out, long long T, int D, int F, int max_rows,
         int a_bytes) {
  using namespace hopper;
  using Shape = GmmShape<kCons, kBn, kStages>;
  const int e = blockIdx.z;
  const int rows = group_rows(counts, e, max_rows);
  const int r0 = blockIdx.y * Shape::kRows;
  if (r0 >= rows) return;  // before any load
  const int start = starts[e];
  const int n0 = blockIdx.x * kBn;
  const int nk = (D + kBk - 1) / kBk;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);  // stage s: A [kRows][128 B], then B boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCons);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    if constexpr (kCons > 1) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        uint8_t* sa = smem + s * Shape::kStageBytes;
        uint8_t* sb = sa + Shape::kABytes;
        mbar_wait(empty + s, ((kb / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, a_bytes + Shape::kBBytes);
        tma_load_2d(sa, &tx, full + s, kb * kBk, start + r0);
#pragma unroll
        for (int j = 0; j < kBn / 64; ++j)
          tma_load_3d(sb + j * kBk * 128, &tw, full + s, n0 + 64 * j, kb * kBk, e);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows r0 + 64 c .. + 63 of the group
    if constexpr (kCons > 1) setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int quad = t % 4;

    float acc[kBn / 2];  // set by the first product (scale_d = 0)
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kStages;
      uint8_t* sa = smem + s * Shape::kStageBytes;
      uint8_t* sb = sa + Shape::kABytes;
      mbar_wait(full + s, (kb / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        const uint64_t da = desc_sw128(sa + c * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(sb + kk * 16 * 128, kBk * 128, 1024);
        wgmma_ss<kBn, 1>(acc, da, db, kb > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the slab before this one is read
      fence_regs(acc);
      if (kb > 0 && t == 0) mbar_arrive(empty + (kb - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: bf16 through the ring (every consumer is done with it)
    named_barrier(1, 128 * kCons);
    uint8_t* stage = smem + c * 64 * kBn * 2;  // kBn / 64 boxes of [64 rows][128 B]
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      uint8_t* box = stage + (j / 8) * 64 * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * warp + g + 8 * h;
        *reinterpret_cast<uint32_t*>(box + rl * 128 + (((j % 8) ^ (rl & 7)) * 16) + 4 * quad) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    named_barrier(2 + c, 128);
    constexpr int kChunks = kBn / 8;  // 16-byte chunks a row
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int rl = idx / kChunks;
      const int cc = idx % kChunks;
      const int gr = r0 + 64 * c + rl;  // row within the group
      if (gr >= rows) break;            // rows grow with idx
      const long long row = static_cast<long long>(start) + gr;
      const int col = n0 + 8 * cc;
      if (row < 0 || row >= T || col >= F) continue;
      *reinterpret_cast<uint4*>(out + row * F + col) = *reinterpret_cast<const uint4*>(
          stage + (cc / 8) * 64 * 128 + rl * 128 + (((cc % 8) ^ (rl & 7)) * 16));
    }
  }
}

template <int kCons, int kBn, int kStages>
cudaError_t launch_bf16(const void* x, const void* w, const int* starts, const int* counts,
                        void* out, long long T, int D, int F, int E, int max_rows,
                        cudaStream_t stream) {
  using Shape = GmmShape<kCons, kBn, kStages>;
  auto kernel = gmm_bf16<kCons, kBn, kStages>;
  // raised once, so that no call made while a CUDA graph is being captured has to
  static bool limit_raised = false;
  if (!limit_raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (err != cudaSuccess) return err;
    limit_raised = true;
  }
  // the A box: a block's rows, or fewer when the launch's row bound is smaller
  const int a_rows = max_rows < Shape::kRows ? (max_rows + 7) / 8 * 8 : Shape::kRows;
  CUtensorMap tx, tw;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(T)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(D) * 2};
  const uint32_t x_box[2] = {64, static_cast<uint32_t>(a_rows)};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                              static_cast<uint64_t>(E)};
  const uint64_t w_strides[2] = {static_cast<uint64_t>(F) * 2,
                                 static_cast<uint64_t>(D) * F * 2};
  const uint32_t w_box[3] = {64, kBk, 1};
  if (!hopper::encode_bf16_map(&tx, x, 2, x_dims, x_strides, x_box) ||
      !hopper::encode_bf16_map(&tw, w, 3, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((F + kBn - 1) / kBn),
                  static_cast<unsigned>((max_rows + Shape::kRows - 1) / Shape::kRows),
                  static_cast<unsigned>(E));
  kernel<<<grid, Shape::kThreads, Shape::kSmem, stream>>>(
      tx, tw, starts, counts, static_cast<__nv_bfloat16*>(out), T, D, F, max_rows,
      a_rows * 128);
  return cudaGetLastError();
}

// ---- one wgmma tile, for the card tests of the descriptors and layouts:
// c (64, 128) f32 = a (64, 64) @ b, b given as (128, 64) (K-major) or as
// (64, 128) (MN-major, kTransB = 1), all row-major.
template <int kTransB>
__global__ void __launch_bounds__(128)
wgmma_tile(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
           float* __restrict__ c) {
  using namespace hopper;
  __shared__ uint8_t raw[64 * 128 + 128 * 128 + 1024];
  __shared__ uint64_t bar;
  uint8_t* sa = align_1024(raw);
  uint8_t* sb = sa + 64 * 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * 128 + 128 * 128);
    tma_load_2d(sa, &ta, &bar, 0, 0);
    if (kTransB) {  // two boxes of 64 columns, 64 rows of K each
      tma_load_2d(sb, &tb, &bar, 0, 0);
      tma_load_2d(sb + 64 * 128, &tb, &bar, 64, 0);
    } else {        // one box of 128 rows of N
      tma_load_2d(sb, &tb, &bar, 0, 0);
    }
  }
  mbar_wait(&bar, 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc_sw128(sa + kk * 32, 16, 1024);
    const uint64_t db = kTransB ? desc_sw128(sb + kk * 16 * 128, 64 * 128, 1024)
                                : desc_sw128(sb + kk * 32, 16, 1024);
    wgmma_ss<128, kTransB>(acc, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int t = threadIdx.x;
  const int row = 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(row + 8 * (e >> 1)) * 128 + 8 * j + 2 * (t % 4) + (e & 1)] = acc[4 * j + e];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// has checked shapes, types, devices and contiguity, zero-filled out, and
// checked that 1 <= E < 2^16, T < 2^31 and ceil(max_rows / 64) < 2^16;
// for bfloat16 also that D and F are multiples of 8 and the pointers
// 16-byte aligned.  T == 0, F == 0 or max_rows == 0 launches nothing.
extern "C" int grouped_matmul_launch(const void* x, const void* w, const void* starts,
                                     const void* counts, void* out, int is_bf16,
                                     long long T, int D, int F, int E, int max_rows,
                                     void* stream) {
  if (T == 0 || F == 0 || E == 0 || max_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(starts);
  const int* c = static_cast<const int*>(counts);
  if (is_bf16) {
    if (max_rows > 64)
      return static_cast<int>(
          launch_bf16<2, 128, 4>(x, w, s, c, out, T, D, F, E, max_rows, st));
    return static_cast<int>(
        launch_bf16<1, 64, 6>(x, w, s, c, out, T, D, F, E, max_rows, st));
  }
  const dim3 grid(static_cast<unsigned>((F + kTn - 1) / kTn),
                  static_cast<unsigned>((max_rows + kTm - 1) / kTm), static_cast<unsigned>(E));
  gmm_f32<<<grid, kThreadsF, 0, st>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w), s, c,
                                       static_cast<float*>(out), T, D, F, max_rows);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's resources, prefill (decode = 0) or decode tiles: out =
// {registers a thread at launch (the prefill consumers raise theirs to 232
// with setmaxnreg), local memory a thread in bytes (spills), dynamic shared
// memory in bytes, threads}.
extern "C" int grouped_matmul_bf16_attributes(int decode, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = decode ? cudaFuncGetAttributes(&attr, gmm_bf16<1, 64, 6>)
                                 : cudaFuncGetAttributes(&attr, gmm_bf16<2, 128, 4>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = decode ? Decode::kSmem : Prefill::kSmem;
  out[3] = decode ? Decode::kThreads : Prefill::kThreads;
  return 0;
}

// One wgmma tile (wgmma_tile above) on bf16 a and b, 16-byte aligned,
// into float32 c (64, 128).
extern "C" int wgmma_tile_launch(const void* a, const void* b, void* c, int mn_major,
                                 void* stream) {
  CUtensorMap ta, tb;
  const uint64_t a_dims[2] = {64, 64};
  const uint64_t a_strides[1] = {128};
  const uint32_t a_box[2] = {64, 64};
  const uint64_t bk_dims[2] = {64, 128};   // (128, 64): rows of N, K contiguous
  const uint64_t bk_strides[1] = {128};
  const uint32_t bk_box[2] = {64, 128};
  const uint64_t bm_dims[2] = {128, 64};   // (64, 128): rows of K, N contiguous
  const uint64_t bm_strides[1] = {256};
  const uint32_t bm_box[2] = {64, 64};
  if (!hopper::encode_bf16_map(&ta, a, 2, a_dims, a_strides, a_box) ||
      !hopper::encode_bf16_map(&tb, b, 2, mn_major ? bm_dims : bk_dims,
                               mn_major ? bm_strides : bk_strides, mn_major ? bm_box : bk_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mn_major)
    wgmma_tile<1><<<1, 128, 0, st>>>(ta, tb, static_cast<float*>(c));
  else
    wgmma_tile<0><<<1, 128, 0, st>>>(ta, tb, static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}

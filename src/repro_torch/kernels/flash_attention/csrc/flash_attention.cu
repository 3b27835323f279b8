// flash_attention: the FlashAttention-2 forward pass, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (body _kernel).  q is (BH, S, dh), k and v are
// (BH / kv_groups, L, dh), all float32 or all bfloat16, contiguous; query
// head bh reads key/value head bh / kv_groups.  Query i and key j sit at
// positions i and j.  A pair is kept when j < L, and i >= j if causal, and
// i - j < window if window > 0.  Scores, the online softmax and the
// accumulator are float32 (q is scaled in float32 before the product); the
// output is in q's type.  The TPU kernel's semantics are kept: masked
// scores are NEG = -1e30 with p zeroed under the mask, and the output is
// acc / max(l, 1e-30) (a row with no key is 0).
//
// Bound on an H100: operations.  Per kept pair 4*dh flops (q.k and p.v);
// at gemma3-12b's prefill (B*H = 64, S = L = 2048, dh = 256, bf16) a causal
// layer is 137.5 GFLOP, 0.139 ms at the bf16 tensor-core rate, against 0.060
// ms for one read of q, k, v and one write of o at 3.35 TB/s.
//
// The TPU kernel walks a (BH, q-tile, kv-tile) grid whose kv axis runs in
// order, carrying m, l and acc in VMEM scratch from one grid step to the
// next.  GPU blocks run in no order and share nothing, so here one block
// owns one (bh, 64-row q tile) and loops over the kv tiles itself, with
// m and l in registers of the threads that own the row and acc in
// registers too.  Tiles wholly above the diagonal or wholly outside the
// window are skipped: the TPU kernel computes and masks them, which leaves
// m, l and acc as they were, so the result is the same.  This first
// version runs on the CUDA cores in float32:
//
// * 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns query rows
//   ty + 16 i (i < 4), the scores of keys tx + 16 j (j < 4) of those rows,
//   and output columns tx + 16 j (j < dh_max / 16).  A row's 16 owners are
//   16 neighbouring lanes of one warp, so its max and sum reduce by
//   shuffles.
// * Q (scaled), K and V tiles are converted to float32 in shared memory,
//   Q and K transposed (dh x 64, rows padded to 65 floats against bank
//   conflicts) so that the score loop reads one column of each per step;
//   the probabilities go through shared memory, transposed, to the P.V loop.
//   At dh = 256 that is 215,296 bytes of dynamic shared memory, above the
//   48 KB static limit, so the launch raises the limit first.
//
// Tensor cores (mma.sync / wgmma), TMA and bf16 tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTq = 64;        // query rows per block
constexpr int kTk = 64;        // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLd = 65;        // padded row of the transposed tiles
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(dh) * kLd * 2 + static_cast<size_t>(kTk) * dh
                          + static_cast<size_t>(kTk) * kLd);
}

template <typename T, int kDhMax>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, long long S, long long L, int dh, int kv_groups,
             float scale, int window, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;               // [dh][kLd]: qs[d * kLd + r] = scale * q[q0 + r][d]
  float* ks = qs + dh * kLd;      // [dh][kLd]: ks[d * kLd + c] = k[kt + c][d]
  float* vs = ks + dh * kLd;      // [kTk][dh]
  float* ps = vs + kTk * dh;      // [kTk][kLd]: ps[c * kLd + r] = p of row r, key c

  constexpr int kCols = kDhMax / 16;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.x;
  // the heaviest (last) causal tiles first
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kTq;
  const long long kvh = bh / kv_groups;
  const T* qb = q + bh * S * dh;
  const T* kb = k + kvh * L * dh;
  const T* vb = v + kvh * L * dh;
  T* ob = o + bh * S * dh;

  for (int i = tid; i < kTq * dh; i += kThreads) {
    const int r = i / dh;
    const int d = i - r * dh;
    const long long row = q0 + r;
    qs[d * kLd + r] = row < S ? to_f32(qb[row * dh + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // kv tiles that can hold a kept pair of this q tile
  long long k_end = L;
  if (causal && q0 + kTq < k_end) k_end = q0 + kTq;
  long long k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = (q0 - window + 1) / kTk * kTk;

  for (long long kt = k_begin; kt < k_end; kt += kTk) {
    __syncthreads();  // the previous tile's ks, vs and ps are read
    for (int i = tid; i < kTk * dh; i += kThreads) {
      const int c = i / dh;
      const int d = i - c * dh;
      const long long key = kt + c;
      float kx = 0.f, vx = 0.f;
      if (key < L) {
        kx = to_f32(kb[key * dh + d]);
        vx = to_f32(vb[key * dh + d]);
      }
      ks[d * kLd + c] = kx;
      vs[c * dh + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[d * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[d * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long key = kt + tx + 16 * j;
        bool ok = key < L;
        if (causal) ok = ok && row >= key;
        if (window > 0) ok = ok && row - key < window;
        keep[j] = ok;
        if (!ok) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(tx + 16 * j) * kLd + ty + 16 * i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kTk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[c * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        if (col < dh) {
          const float vv = vs[c * dh + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) store(ob + row * dh + col, acc[i][j] / denom);
    }
  }
}

template <typename T, int kDhMax>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long bh,
                   long long s, long long l, int dh, int kv_groups, float scale, int window,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto kernel = flash_kernel<T, kDhMax>;
  // raised once per instantiation to its largest need, so that no call made
  // while a CUDA graph is being captured has to
  static bool limit_raised = false;
  if (!limit_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes(kDhMax)));
    if (err != cudaSuccess) return err;
    limit_raised = true;
  }
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((s + kTq - 1) / kTq));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, l, dh, kv_groups, scale, window, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, long long bh,
                     long long s, long long l, int dh, int kv_groups, float scale,
                     int window, int causal, cudaStream_t stream) {
  if (dh <= 16) return launch<T, 16>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  if (dh <= 32) return launch<T, 32>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  if (dh <= 128) return launch<T, 128>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  return launch<T, 256>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// has checked shapes, types and contiguity, and that 1 <= dh <= 256,
// bh < 2^31 and ceil(s / 64) < 2^16; bh == 0 or s == 0 launches nothing.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int is_bf16, long long bh, long long s, long long l,
                                      int dh, int kv_groups, float scale, int window,
                                      int causal, void* stream) {
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, st)
              : dispatch<float>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, st);
  return static_cast<int>(err);
}

// flash_attention: the FlashAttention-2 forward pass, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (body _kernel).  q is (BH, S, dh), k is
// (BH / kv_groups, L, dh) and v is (BH / kv_groups, L, dv) with dv <= dh,
// all float32 or all bfloat16, contiguous; query head bh reads key/value
// head bh / kv_groups.  Query i and key j sit at positions i and j.  A pair
// is kept when j < L, and i >= j if causal, and i - j < window if
// window > 0.  Scores, the online softmax and the accumulator are float32;
// the output is (BH, S, dv) in q's type.  The TPU kernel's semantics are
// kept: masked scores are NEG = -1e30 with p zeroed under the mask, and the
// output is acc / max(l, 1e-30) (a row with no key is 0).
//
// Bound on an H100: operations.  Per kept pair 2 * (dh + dv) flops (q.k and
// p.v); at gemma3-12b's prefill (B*H = 64, S = L = 2048, dh = dv = 256,
// bf16) a causal layer is 137.5 GFLOP, 0.139 ms at the bf16 tensor-core
// rate, against 0.060 ms for one read of q, k, v and one write of o at
// 3.35 TB/s.  So the design is about keeping the tensor cores fed.
//
// The TPU kernel walks a (BH, q-tile, kv-tile) grid whose kv axis runs in
// order, carrying m, l and acc in VMEM scratch from one grid step to the
// next.  GPU blocks run in no order and share nothing, so here one block
// owns one (bh, q tile) and loops over the kv tiles itself.  Tiles wholly
// above the diagonal or wholly outside the window are never loaded: the TPU
// kernel computes and masks them, which leaves m, l and acc as they were,
// so the result is the same.
//
// bfloat16 (the main path): tensor cores, fed by TMA.
//
// * A block is 3 warpgroups over 128 query rows.  Warpgroup 0 is the
//   producer: it gives its registers back (setmaxnreg 40) and one thread
//   issues TMA loads, Q once, then the K and V tiles into a 2-stage ring
//   whose stages carry a "full" mbarrier for K, one for V, and an "empty"
//   barrier the consumers arrive on.  Warpgroups 1 and 2 are consumers
//   (setmaxnreg 232), 64 query rows each, the M of one wgmma; they share
//   the ring, so K and V are read once per 128 rows.  q tiles launch last
//   tile first, so that the longest causal rows start first on 132 SMs.
// * S = Q K^T: wgmma m64 n kTk k16 with both operands K-major in 128-byte
//   swizzle (dh / 64 TMA boxes a tile), float32 accumulators in registers.
//   kTk is 128 keys where shared memory allows (dh <= 128, and dh 192 with
//   dv 128), else 64.  At dh = dv = 256: Q 64 KB + 2 x (K 32 KB + V 32 KB)
//   = 192 KB of dynamic shared memory.
// * The online softmax runs on the accumulator fragment: a row's four
//   owners (one quad of lanes) reduce its max by shuffles; the sum stays per
//   thread until the end.  The softmax scale multiplies the float32 score,
//   folded with log2(e) into exp2f; the TPU kernel scales q in float32
//   before the product instead, and the two differ by rounding only.  Only
//   tiles that cross the diagonal, the window's edge or L apply the mask.
// * O += P V: P is rounded to bfloat16 in registers and is the register A
//   operand of wgmma m64 n dv k16 (the accumulator layout of S is the A
//   layout); V, (keys, dv) row-major, is the MN-major B operand.  Rounding
//   P to bfloat16 is what FlashAttention-2/3 and PyTorch's SDPA do (and the
//   reference's _sdpa, which rounds the probabilities to the value type);
//   the TPU kernel keeps P in float32.  O lives in registers: 128 floats a
//   thread at dv = 256.
// * Epilogue: O / l in bfloat16 goes through the consumer's own Q rows in
//   shared memory (swizzled against bank conflicts) to 16-byte coalesced
//   stores, masked at S.
// * Instantiated for (dh, dv) in {(64, 64), (128, 128), (192, 192), (192,
//   128), (256, 256)}; the wrapper zero-pads other widths up to one of
//   them, and checks the 16-byte alignment TMA needs.
//
// float32 (tests and edge rows only; no main path runs it): the CUDA cores,
// one block a (bh, 64-row q tile), 256 threads:
//
// * thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i
//   (i < 4), the scores of keys tx + 16 j (j < 4) of those rows, and output
//   columns tx + 16 j (j < dh_max / 16).  A row's 16 owners are 16
//   neighbouring lanes of one warp, so its max and sum reduce by shuffles.
// * Q (scaled), K and V tiles sit in shared memory, Q and K transposed (dh
//   x 64, rows padded to 65 floats against bank conflicts) so that the score
//   loop reads one column of each per step; the probabilities go through
//   shared memory, transposed, to the P.V loop.  At dh = 256 that is
//   215,296 bytes of dynamic shared memory.  No TF32.  Values as wide as the
//   keys (the wrapper pads narrower ones).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---- float32: FMAs on the CUDA cores
constexpr int kTq = 64;        // query rows per block
constexpr int kTk = 64;        // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLd = 65;        // padded row of the transposed tiles

size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(dh) * kLd * 2 + static_cast<size_t>(kTk) * dh
                          + static_cast<size_t>(kTk) * kLd);
}

template <int kDhMax>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, long long S, long long L,
             int dh, int kv_groups, float scale, int window, int causal) {
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
  const float* qb = q + bh * S * dh;
  const float* kb = k + kvh * L * dh;
  const float* vb = v + kvh * L * dh;
  float* ob = o + bh * S * dh;

  for (int i = tid; i < kTq * dh; i += kThreads) {
    const int r = i / dh;
    const int d = i - r * dh;
    const long long row = q0 + r;
    qs[d * kLd + r] = row < S ? qb[row * dh + d] * scale : 0.f;
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
        kx = kb[key * dh + d];
        vx = vb[key * dh + d];
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
      if (col < dh) ob[row * dh + col] = acc[i][j] / denom;
    }
  }
}

template <int kDhMax>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, long long bh,
                       long long s, long long l, int dh, int kv_groups, float scale, int window,
                       int causal, cudaStream_t stream) {
  auto kernel = flash_kernel<kDhMax>;
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
  kernel<<<grid, kThreads, smem_bytes(dh), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, l, dh, kv_groups, scale, window, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, long long bh,
                         long long s, long long l, int dh, int kv_groups, float scale,
                         int window, int causal, cudaStream_t stream) {
  if (dh <= 16) return launch_f32<16>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  if (dh <= 32) return launch_f32<32>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  if (dh <= 64) return launch_f32<64>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  if (dh <= 128) return launch_f32<128>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
  return launch_f32<256>(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, stream);
}

// ---- bfloat16: wgmma on a TMA ring, one producer and two consumer warpgroups

constexpr int kBfRows = 128;      // query rows per block
constexpr int kBfThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 2;

template <int kDh, int kDv>
struct BfShape {
  static constexpr int kKeys = (kDh <= 128 || kDh + kDv <= 320) ? 128 : 64;  // kTk
  static constexpr int kQBytes = kBfRows * kDh * 2;
  static constexpr int kKBytes = kKeys * kDh * 2;
  static constexpr int kVBytes = kKeys * kDv * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 7 barriers, + 1024 to align the base
  static constexpr int kSmem = kBarOffset + 64 + 1024;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int kDh, int kDv>
__global__ void __launch_bounds__(kBfThreads, 1)
flash_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S, int L,
           int kv_groups, float scale_log2, int window, int causal) {
  using namespace hopper;
  using Shape = BfShape<kDh, kDv>;
  constexpr int kKeys = Shape::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;  // kDh / 64 boxes of [128 rows][128 bytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;      // [kStages]
  uint64_t* v_full = bars + 3;      // [kStages]
  uint64_t* empty = bars + 5;       // [kStages]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBfRows;  // the heaviest tiles first
  const int kvh = bh / kv_groups;
  // kv tiles that can hold a kept pair of this q tile
  int k_end = L;
  if (causal && q0 + kBfRows < k_end) k_end = q0 + kBfRows;
  int k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = (q0 - window + 1) / kKeys * kKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, Shape::kQBytes);
#pragma unroll
      for (int b = 0; b < kDh / 64; ++b)
        tma_load_3d(sq + b * kBfRows * 128, &tq, q_full, 64 * b, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int kt = k_begin + i * kKeys;
        uint8_t* sk = smem + Shape::kQBytes + s * Shape::kStageBytes;
        uint8_t* sv = sk + Shape::kKBytes;
        mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + s, Shape::kKBytes);
#pragma unroll
        for (int b = 0; b < kDh / 64; ++b)
          tma_load_3d(sk + b * kKeys * 128, &tk, k_full + s, 64 * b, kt, kvh);
        mbar_arrive_expect_tx(v_full + s, Shape::kVBytes);
#pragma unroll
        for (int b = 0; b < kDv / 64; ++b)
          tma_load_3d(sv + b * kKeys * 128, &tv, v_full + s, 64 * b, kt, kvh);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows r0 .. r0 + 63
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int quad = t % 4;
    const int r0 = q0 + 64 * c;
    const int row_lo = r0 + 16 * warp + g;  // this thread's rows: row_lo and row_lo + 8
    const int r_last = min(r0 + 63, S - 1);

    float acc[kDv / 2];
#pragma unroll
    for (int i = 0; i < kDv / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int kt = k_begin + i * kKeys;
      uint8_t* sk = smem + Shape::kQBytes + s * Shape::kStageBytes;
      uint8_t* sv = sk + Shape::kKBytes;
      // does any pair of my rows and this tile survive the masks?
      const bool live = r0 < S && (!causal || kt <= r_last) &&
                        (window == 0 || kt + kKeys - 1 > r0 - window);
      mbar_wait(k_full + s, parity);
      if (!live) {  // the wait keeps the two consumers' arrivals in step
        if (t == 0) mbar_arrive(empty + s);
        continue;
      }
      const bool masked = kt + kKeys > L || (causal && kt + kKeys - 1 > r0) ||
                          (window > 0 && r0 + 63 - kt >= window);

      // S = Q K^T
      float sc[kKeys / 2];
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDh / 16; ++ks) {
        const uint64_t da = desc_sw128(sq + (ks / 4) * kBfRows * 128 + c * 64 * 128 + (ks % 4) * 32,
                                       16, 1024);
        const uint64_t db = desc_sw128(sk + (ks / 4) * kKeys * 128 + (ks % 4) * 32, 16, 1024);
        wgmma_ss<kKeys, 0>(sc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scores in log2 units; masked pairs -inf (m stays >= NEG, so their p is 0)
      if (masked) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + 8 * j + 2 * quad + (e & 1);
            const int row = row_lo + 8 * (e >> 1);
            const bool keep = key < L && (!causal || key <= row) &&
                              (window == 0 || row - key < window);
            sc[4 * j + e] = keep ? sc[4 * j + e] * scale_log2 : __int_as_float(0xff800000);  // -inf
          }
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 2; ++j) sc[j] *= scale_log2;
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float p0 = exp2f(sc[4 * j + 2 * h] - m_new);
          const float p1 = exp2f(sc[4 * j + 2 * h + 1] - m_new);
          sc[4 * j + 2 * h] = p0;
          sc[4 * j + 2 * h + 1] = p1;
          sum += p0 + p1;
        }
        l[h] = l[h] * corr[h] + sum;
      }
#pragma unroll
      for (int j = 0; j < kDv / 8; ++j) {
        acc[4 * j + 0] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V
      mbar_wait(v_full + s, parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t db = desc_sw128(sv + kk * 16 * 128, kKeys * 128, 1024);
        wgmma_rs<kDv, 1>(acc, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty + s);
    }

    // ---- epilogue: O / l in bf16, staged in my Q rows, 16-byte stores
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[h] = 1.f / fmaxf(sum, 1e-30f);
    }
    named_barrier(1 + c, 128);  // every warp of mine is past its last product
    uint8_t* stage = sq + c * 64 * 128;
#pragma unroll
    for (int j = 0; j < kDv / 8; ++j) {
      uint8_t* box = stage + (j / 8) * kBfRows * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * warp + g + 8 * h;
        *reinterpret_cast<uint32_t*>(box + rl * 128 + (((j % 8) ^ (rl & 7)) * 16) + 4 * quad) =
            pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    named_barrier(1 + c, 128);
    constexpr int kChunks = kDv / 8;  // 16-byte chunks a row
    __nv_bfloat16* ob = o + static_cast<long long>(bh) * S * kDv;
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int rl = idx / kChunks;
      const int cc = idx % kChunks;
      const int row = r0 + rl;
      if (row >= S) break;  // rows grow with idx
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage + (cc / 8) * kBfRows * 128 + rl * 128 + (((cc % 8) ^ (rl & 7)) * 16));
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(row) * kDv + cc * 8) = val;
    }
  }
}

template <int kDh, int kDv>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, long long bh,
                        long long s, long long l, int kv_groups, float scale, int window,
                        int causal, cudaStream_t stream) {
  using Shape = BfShape<kDh, kDv>;
  auto kernel = flash_bf16<kDh, kDv>;
  static bool limit_raised = false;  // before any capture, as above
  if (!limit_raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (err != cudaSuccess) return err;
    limit_raised = true;
  }
  const uint64_t bhk = static_cast<uint64_t>(bh / kv_groups);
  CUtensorMap tq, tk, tv;
  const uint64_t q_dims[3] = {kDh, static_cast<uint64_t>(s), static_cast<uint64_t>(bh)};
  const uint64_t q_strides[2] = {kDh * 2ull, static_cast<uint64_t>(s) * kDh * 2};
  const uint32_t q_box[3] = {64, kBfRows, 1};
  const uint64_t k_dims[3] = {kDh, static_cast<uint64_t>(l), bhk};
  const uint64_t k_strides[2] = {kDh * 2ull, static_cast<uint64_t>(l) * kDh * 2};
  const uint64_t v_dims[3] = {kDv, static_cast<uint64_t>(l), bhk};
  const uint64_t v_strides[2] = {kDv * 2ull, static_cast<uint64_t>(l) * kDv * 2};
  const uint32_t kv_box[3] = {64, Shape::kKeys, 1};
  if (!hopper::encode_bf16_map(&tq, q, 3, q_dims, q_strides, q_box) ||
      !hopper::encode_bf16_map(&tk, k, 3, k_dims, k_strides, kv_box) ||
      !hopper::encode_bf16_map(&tv, v, 3, v_dims, v_strides, kv_box))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((s + kBfRows - 1) / kBfRows));
  kernel<<<grid, kBfThreads, Shape::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<int>(s), static_cast<int>(l),
      kv_groups, scale * 1.4426950408889634f, window, causal);
  return cudaGetLastError();
}

#define FLASH_BF16_WIDTHS(X) X(64, 64) X(128, 128) X(192, 192) X(192, 128) X(256, 256)

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// has checked shapes, types and contiguity.  float32: dv == dh <= 256.
// bfloat16: (dh, dv) one of FLASH_BF16_WIDTHS, 16-byte aligned pointers,
// s and l < 2^31.  bh < 2^31 and ceil(s / 64) < 2^16; bh == 0 or s == 0
// launches nothing.  An unsupported width returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int is_bf16, long long bh, long long s, long long l,
                                      int dh, int dv, int kv_groups, float scale, int window,
                                      int causal, void* stream) {
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (dv != dh) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        dispatch_f32(q, k, v, o, bh, s, l, dh, kv_groups, scale, window, causal, st));
  }
#define FLASH_BF16_CASE(DH, DV)                                                              \
  if (dh == DH && dv == DV)                                                                  \
    return static_cast<int>(                                                                 \
        launch_bf16<DH, DV>(q, k, v, o, bh, s, l, kv_groups, scale, window, causal, st));
  FLASH_BF16_WIDTHS(FLASH_BF16_CASE)
#undef FLASH_BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 kernel's resources at (dh, dv): out = {registers a thread at
// launch (the consumers raise theirs to 232 with setmaxnreg), local memory
// a thread in bytes (spills), dynamic shared memory in bytes, threads}.
extern "C" int flash_attention_bf16_attributes(int dh, int dv, int* out) {
  cudaFuncAttributes attr;
#define FLASH_BF16_ATTR(DH, DV)                                                              \
  if (dh == DH && dv == DV) {                                                                \
    const cudaError_t err = cudaFuncGetAttributes(&attr, flash_bf16<DH, DV>);                \
    if (err != cudaSuccess) return static_cast<int>(err);                                    \
    out[0] = attr.numRegs;                                                                   \
    out[1] = static_cast<int>(attr.localSizeBytes);                                          \
    out[2] = BfShape<DH, DV>::kSmem;                                                         \
    out[3] = kBfThreads;                                                                     \
    return 0;                                                                                \
  }
  FLASH_BF16_WIDTHS(FLASH_BF16_ATTR)
#undef FLASH_BF16_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

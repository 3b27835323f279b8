// segment_spmm: the FILTER engine's destination combine, for Hopper (sm_90a).
//
// Replaces repro/kernels/segment_spmm/segment_spmm.py::segment_spmm_pallas
// (bodies _kernel_sum and _kernel_min).  Combines (m, d) float32 messages
// into (n_segments, d) by seg_ids under an optional valid mask, by sum or
// min; empty segments, invalid lanes and ids outside [0, n_segments) give
// the identity (0 / +inf).
//
// Bound on an H100: bytes.  The work is one read of the messages and ids
// (m*d*4 + m*4 bytes, plus m flags) and one write of the output
// (n_segments*d*4 bytes) at 3.35 TB/s; on the FILTER path n_segments = n
// is larger than m, so the identity fill dominates.  The TPU kernel routed
// each tile through a one-hot MXU matmul (sum) or a masked select (min)
// because a TPU has no atomics and runs its grid in order.  Here one launch
// writes the identity with 16-byte stores (grid-stride, 8 blocks an SM: as
// fast as a thread a float4 on the hub partition's block, faster on the
// others), and a second combines with one
// atomic per lane and column.  (One cooperative launch, the fill and the
// combine split by a grid sync, captured in a CUDA graph as well, but was
// no faster on the main path's blocks; nor was a programmatic dependent
// launch of the combine, slower for sum.)  The output (16.8 MB at min, 33.5 MB
// at sum d=2 on the main path) fits in the 50 MB L2 beside the messages, so
// the atomics resolve in L2:
//
// * No division.  d is a template parameter (1 or 2; any other d takes a
//   kernel with one lane a thread and a loop over its columns), and a thread
//   of the d = 1, 2 kernels takes kVec consecutive lanes: one or two float4
//   of messages, one uchar4 of valid flags and one int4 of ids.  Indices
//   are 64-bit throughout.
// * Streaming reads.  Messages, ids and flags are loaded with ld.global.cs
//   (evict-first), so they do not push the output out of L2.
// * Views.  Lanes are grouped from the messages' first 16-byte boundary;
//   the up to kVec-1 lanes before it and those after the last whole group
//   run one lane a thread.  The ids are often a view at another offset (on
//   the main path a slice of the edge array at the partition's first edge):
//   a thread then reads the two aligned int4 chunks around its ids and
//   shifts them into place.  Flags off their 4-byte boundary, or messages
//   off theirs, take scalar loads.
// * min: the float order as an integer order.  A value with the sign bit
//   clear is combined with a signed atomicMin on its bits; one with the
//   sign bit set with an unsigned atomicMax on its bits.  Over the +inf
//   initial value this is the order of the "flip the negatives" int32
//   encoding (-inf < ... < -0 < +0 < ... < +inf), applied in place, so no
//   decode pass is needed.  min is order-free: the result is bit-exact.
// * sum: float32 atomicAdd; at d = 2 one vector atomicAdd(float2*) a lane
//   (sm_90, global memory; the output from torch.empty is 8-byte
//   aligned).  In a warp whose lanes are all on the vector path, the lanes
//   bound for one segment add their values first (__match_any_sync), so the
//   segment takes one atomic: faster on the hub partition's block, as fast
//   elsewhere (for min it was slower, and min keeps one atomic a lane).  The
//   order of the additions varies, so values are tolerance-bounded; 0/1
//   activity columns sum exactly.
//
// Lanes that carry the identity (+inf for min; ±0 in every column for sum)
// are skipped: combining them cannot change an output that starts at the
// identity (a sum that starts at +0 never becomes -0).  On FILTER most lanes
// of a block are inactive, so this removes most atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // lanes a thread of the d = 1, 2 kernels: one int4 of ids
constexpr unsigned kFillBlocksPerSm = 8;
using Idx = long long;  // lane, segment and element indices

inline unsigned blocks_for(Idx items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

// The identity, grid-stride: 4 float4 a thread an iteration; block 0's
// first thread writes the (at most 3) floats past the last float4.
__global__ void __launch_bounds__(kThreads) fill_kernel(float* __restrict__ out, Idx total,
                                                        float value) {
  const Idx n4 = total / 4;
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  const float4 f = make_float4(value, value, value, value);
  float4* o = reinterpret_cast<float4*>(out);
  Idx i = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    o[i] = f;
    o[i + stride] = f;
    o[i + 2 * stride] = f;
    o[i + 3 * stride] = f;
  }
  for (; i < n4; i += stride) o[i] = f;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (Idx k = 4 * n4; k < total; ++k) out[k] = value;
  }
}

// kFillBlocksPerSm blocks on every SM (or fewer, for a small output).
unsigned fill_blocks(Idx total) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const unsigned need = blocks_for(total / 4 + 1);
  const unsigned cap = static_cast<unsigned>(sms > 0 ? sms : 1) * kFillBlocksPerSm;
  return need < cap ? need : cap;
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
__device__ __forceinline__ void combine_value(float* dst, float v) {
  if (kMin) {
    if (__float_as_uint(v) == 0x7f800000u) return;  // +inf
    atomic_min_f32(dst, v);
  } else {
    if ((__float_as_uint(v) << 1) == 0u) return;  // ±0
    atomicAdd(dst, v);
  }
}

// One lane's D values into its segment's row `dst`.
template <int D, bool kMin>
__device__ __forceinline__ void combine_lane(float* dst, const float* v) {
  if (D == 2 && !kMin) {
    if (((__float_as_uint(v[0]) | __float_as_uint(v[1])) << 1) == 0u) return;  // ±0, ±0
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) combine_value<kMin>(dst + j, v[j]);
  }
}

// Whether the messages and the flags are on their own vector boundary at
// every group's first lane (bits of `vec`); the ids always take vector loads.
constexpr int kVecMsg = 1, kVecValid = 2;

// The kVec ids at p, `shift` words past a 16-byte boundary: from the one or
// two aligned int4 chunks that hold them.  Every chunk read holds one of the
// kVec ids, so no load touches a chunk outside the array.
__device__ __forceinline__ void load_ids(const int* p, int shift, int (&s)[kVec]) {
  const int4* a = reinterpret_cast<const int4*>(p - shift);
  const int4 lo = __ldcs(a);
  if (shift == 0) {
    s[0] = lo.x;
    s[1] = lo.y;
    s[2] = lo.z;
    s[3] = lo.w;
    return;
  }
  const int4 hi = __ldcs(a + 1);
  // a switch, so every index is a constant (no local memory)
  switch (shift) {
    case 1: s[0] = lo.y; s[1] = lo.z; s[2] = lo.w; s[3] = hi.x; break;
    case 2: s[0] = lo.z; s[1] = lo.w; s[2] = hi.x; s[3] = hi.y; break;
    default: s[0] = lo.w; s[1] = hi.x; s[2] = hi.y; s[3] = hi.z; break;
  }
}

// Sum: the lanes of a warp that add into one segment add their values
// first (__match_any_sync groups them; the group's lowest lane gathers the
// others' values by shuffles and issues the one atomic).  Every lane of the
// warp must call it.
template <int D>
__device__ __forceinline__ void add_lane_warp(float* __restrict__ out, bool live, int s,
                                              const float* v) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, live ? s : -1 - lane);
  if (!live) return;
  const int leader = __ffs(peers) - 1;
  float acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = v[j];
  for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
    const int src = __ffs(rest) - 1;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float o = __shfl_sync(peers, v[j], src);
      if (lane == leader) acc[j] += o;
    }
  }
  if (lane == leader) combine_lane<D, false>(out + static_cast<Idx>(s) * D, acc);
}

// d = 1 or 2.  Thread t < n_groups takes lanes head + kVec*t .. +kVec-1:
// one (or two) vector loads of its ids, and of its messages and flags where
// `vec` says so, kVec scalar loads otherwise; thread n_groups + r takes lane
// r of the head (r < head) or of the tail.
template <int D, bool kMin>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ msg, const int* __restrict__ seg, const uint8_t* __restrict__ valid,
    float* __restrict__ out, Idx m, Idx n_segments, Idx head, Idx n_groups, int vec,
    int seg_shift) {
  const Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n_groups) {
    const Idx e0 = head + t * kVec;
    int s[kVec];
    load_ids(seg + e0, seg_shift, s);
    bool ok[kVec] = {true, true, true, true};
    if (valid != nullptr) {
      if (vec & kVecValid) {
        const uchar4 v4 = __ldcs(reinterpret_cast<const uchar4*>(valid + e0));
        ok[0] = v4.x != 0;
        ok[1] = v4.y != 0;
        ok[2] = v4.z != 0;
        ok[3] = v4.w != 0;
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) ok[k] = __ldcs(valid + e0 + k) != 0;
      }
    }
    float v[kVec * D];
    if (vec & kVecMsg) {
#pragma unroll
      for (int q = 0; q < D; ++q) {
        const float4 f = __ldcs(reinterpret_cast<const float4*>(msg + e0 * D) + q);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec * D; ++k) v[k] = __ldcs(msg + e0 * D + k);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      ok[k] = ok[k] && s[k] >= 0 && static_cast<Idx>(s[k]) < n_segments;
    }
    if (!kMin && (t | 31) < n_groups) {  // the whole warp is on the vector path
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        bool zero = true;  // ±0 in every column: nothing to add
#pragma unroll
        for (int j = 0; j < D; ++j) zero = zero && (__float_as_uint(v[k * D + j]) << 1) == 0u;
        add_lane_warp<D>(out, ok[k] && !zero, s[k], v + k * D);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (ok[k]) combine_lane<D, kMin>(out + static_cast<Idx>(s[k]) * D, v + k * D);
    }
    return;
  }
  const Idx r = t - n_groups;
  const Idx e = r < head ? r : r + n_groups * kVec;
  if (e >= m) return;
  if (valid != nullptr && !__ldcs(valid + e)) return;
  const int s = __ldcs(seg + e);
  if (s < 0 || static_cast<Idx>(s) >= n_segments) return;
  float v[D];
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = __ldcs(msg + e * D + j);
  combine_lane<D, kMin>(out + static_cast<Idx>(s) * D, v);
}

// Any other d: one lane a thread, its d columns in a loop.
template <bool kMin>
__global__ void __launch_bounds__(kThreads) combine_any_d_kernel(
    const float* __restrict__ msg, const int* __restrict__ seg, const uint8_t* __restrict__ valid,
    float* __restrict__ out, Idx m, int d, Idx n_segments) {
  const Idx e = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= m) return;
  if (valid != nullptr && !__ldcs(valid + e)) return;
  const int s = __ldcs(seg + e);
  if (s < 0 || static_cast<Idx>(s) >= n_segments) return;
  const float* src = msg + e * d;
  float* dst = out + static_cast<Idx>(s) * d;
  for (int j = 0; j < d; ++j) combine_value<kMin>(dst + j, __ldcs(src + j));
}

// The lanes grouped from the messages' first vector boundary (on the main
// path the messages are a fresh tensor and the ids a view into the edge
// array at the partition's offset); the ids and flags take vector loads
// when they are on their own boundary there.
struct Groups {
  long long head, n_groups;
  int vec, seg_shift;
};

template <int D>
Groups group_lanes(const float* msg, const int* seg, const uint8_t* valid, long long m) {
  const uintptr_t mp = reinterpret_cast<uintptr_t>(msg);
  Groups g{0, 0, 0, 0};
  if (mp % (4 * D) == 0) {
    g.head = static_cast<long long>(((16 - (mp & 15)) & 15) / (4 * D));
    if (g.head > m) g.head = m;
    g.vec |= kVecMsg;
  }
  g.n_groups = (m - g.head) / kVec;
  g.seg_shift = static_cast<int>((reinterpret_cast<uintptr_t>(seg + g.head) >> 2) & 3);
  if (valid != nullptr && (reinterpret_cast<uintptr_t>(valid + g.head) & 3) == 0) {
    g.vec |= kVecValid;
  }
  return g;
}

template <int D, bool kMin>
void launch_combine(const float* msg, const int* seg, const uint8_t* valid, float* out, Idx m,
                    Idx n_segments, cudaStream_t s) {
  const Groups g = group_lanes<D>(msg, seg, valid, m);
  const Idx head = static_cast<Idx>(g.head), n_groups = static_cast<Idx>(g.n_groups);
  const Idx items = m - n_groups * (kVec - 1);
  combine_kernel<D, kMin><<<blocks_for(items), kThreads, 0, s>>>(
      msg, seg, valid, out, m, n_segments, head, n_groups, g.vec, g.seg_shift);
}

template <bool kMin>
int launch(const float* msg, const int* seg, const uint8_t* valid, float* out, Idx m, int d,
           Idx n_segments, cudaStream_t s) {
  const Idx out_total = n_segments * d;
  const float identity = kMin ? std::numeric_limits<float>::infinity() : 0.0f;
  fill_kernel<<<fill_blocks(out_total), kThreads, 0, s>>>(out, out_total, identity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  if (d == 1) {
    launch_combine<1, kMin>(msg, seg, valid, out, m, n_segments, s);
  } else if (d == 2) {
    launch_combine<2, kMin>(msg, seg, valid, out, m, n_segments, s);
  } else {
    combine_any_d_kernel<kMin><<<blocks_for(m), kThreads, 0, s>>>(msg, seg, valid, out, m, d,
                                                                 n_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- The lane-batched entry (graph serving): L lanes' messages packed lane
// after lane (lane l's rows offsets[l] .. offsets[l+1]), lane l combined into
// row l of an (L, n_segments, d) output (64-bit offsets: L * n passes 2^31).
//
// Bound: bytes, as above, but the output is L rows: 134 MB at min and 268 MB
// at sum d=2 for graph serving's 8 lanes at RMAT scale 22, more than the 50 MB
// L2.  Filling every row and then combining every lane leaves most of a
// lane's row out of the L2 by the time its atomics run.  This body is one
// launch of one item a block, in blockIdx order: fill items (32 KB of a row
// each) and combine items (kLaneRows<D> packed rows a thread).  Where two
// rows fit in kL2SharePct of the L2 (min: 16.8 MB a row) the items go
// lane-major, lane l's fills then its combines, lane after lane; otherwise
// (sum d=2: 33.5 MB a row) every row's fills, then every lane's combines.
//
// * Dependencies.  A combine item of lane l loads its rows, then waits until
//   every fill item of row l has finished (a per-row count, read with acquire
//   loads; a fill block fences its stores before it counts), so its atomics
//   land on the filled row, which lane-major is still in the L2.  Lane-major,
//   a fill item of row l also waits until every combine item of lane
//   l - ahead has finished, `ahead` being the rows that fit (so row l+1 fills
//   while lane l combines).  An item waits only on items of lower blockIdx,
//   dispatched before it (the order CUB's decoupled look-back relies on too);
//   a wait traps after 10 s rather than hang the card.
// * The plan on the host.  The wrapper passes the lanes' lengths as host
//   ints; the launcher turns them into each lane's first row, first fill and
//   first combine item and fill count, passed by value in the kernel's
//   parameters (kMaxLanes lanes a launch; more lanes take more launches), so
//   a block finds its item by one binary search of its parameters.
// * Inside a lane: a thread's rows kThreads apart, so that each warp-wide
//   load and atomic covers 32 consecutive packed rows; loads stream
//   (ld.global.cs).  min keeps the float-as-int atomics and skips +inf; sum
//   skips ±0 and adds d = 2 with one float2 atomic.
// * Measured (profile_port.py --lane-sweep, NVIDIA H100 80GB HBM3 at 700 W,
//   PERF.md): filling the rows alone takes under a third of the time, the
//   rest goes to the atomics.  Rows grouped 4 a thread with int4 ids and
//   float4 messages (the solo body's layout), an atomic ticket a block, a
//   persistent grid walking a queue, warp aggregation of sum
//   (__match_any_sync) and reading the row before a min atomic were each
//   slower; lane-major at sum d=2 was slower than its fills first.
constexpr int kMaxLanes = 128;       // lanes a launch: its plan travels in the parameters
constexpr int kFillIters = 8;        // float4 a thread in a fill item: 32 KB
constexpr int kL2SharePct = 75;      // of the L2, for the rows in flight
constexpr int kMinBlocksPerSm = 4;   // __launch_bounds__' second argument: 64 registers
constexpr Idx kFillItem = static_cast<Idx>(kThreads) * kFillIters;  // float4 an item
constexpr unsigned long long kWaitTrapNs = 10ull * 1000 * 1000 * 1000;

constexpr int kRowsD2 = 16;          // packed rows a thread in a combine item at d = 2
constexpr int kRowsOther = 4;        // at any other d
constexpr int kLaneMajorRows = 2;    // lane-major when this many rows fit (`ahead`)

template <int D>
constexpr int kLaneRows = D == 2 ? kRowsD2 : kRowsOther;

template <int D>
constexpr Idx kCombineItem = static_cast<Idx>(kThreads) * kLaneRows<D>;  // rows an item

// A row of the output from its first 16-byte boundary: `head` floats before
// it, n4 float4, `tail` floats after.
struct RowSpan {
  Idx head, n4, tail;
};

__host__ __device__ inline RowSpan row_span(const float* row, Idx nd) {
  Idx head = static_cast<Idx>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4);
  if (head > nd) head = nd;
  const Idx n4 = (nd - head) / 4;
  return {head, n4, nd - head - 4 * n4};
}

// A launch's lanes, planned on the host from their lengths.  Lane-major,
// lane l's fill items, then its combine items, lane after lane; otherwise
// every row's fill items, then every lane's combine items.
struct LanePlan {
  long long start[kMaxLanes + 1];  // each lane's first packed row; the last: the end
  int fill_first[kMaxLanes + 1];   // each row's first fill item; the last: where fills end
  int comb_first[kMaxLanes + 1];   // each lane's first combine item; the last: the total
  int fills[kMaxLanes];            // fill items of each row
  int n_lanes, lane_major, ahead;
};

// The last l < n with first[l] <= t (first ascending).
__device__ __forceinline__ int last_at_or_before(const int* first, int n, int t) {
  int l = 0, hi = n;
  while (hi - l > 1) {
    const int mid = (l + hi) >> 1;
    if (first[mid] <= t) {
      l = mid;
    } else {
      hi = mid;
    }
  }
  return l;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 waits until *count reaches target, then the block goes on.
__device__ __forceinline__ void block_wait(const int* count, int target) {
  if (threadIdx.x == 0 && load_acquire(count) < target) {
    const unsigned long long t0 = global_ns();
    while (load_acquire(count) < target) {
      __nanosleep(128);
      if (global_ns() - t0 > kWaitTrapNs) __trap();
    }
  }
  __syncthreads();
}

// One item a block: D = 1, 2, or 0 for any other d.
template <int D, bool kMin>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) lanes_kernel(
    const float* __restrict__ msg, const int* __restrict__ seg, float* __restrict__ out, int d,
    Idx n_segments, const __grid_constant__ LanePlan plan, int* __restrict__ filled,
    int* __restrict__ combined) {
  const int tid = threadIdx.x, t = blockIdx.x, n = plan.n_lanes;
  // the item's lane, and whether it fills (item k of the row) or combines
  // (item k of the lane)
  const bool in_fills = t < plan.fill_first[n];
  const int l = last_at_or_before(in_fills ? plan.fill_first : plan.comb_first, n, t);
  const bool fill = in_fills && t < plan.fill_first[l] + plan.fills[l];
  const int k = t - (fill ? plan.fill_first[l] : plan.comb_first[l]);
  const Idx nd = n_segments * (D > 0 ? D : d);
  float* row = out + static_cast<Idx>(l) * nd;

  if (fill) {
    // -- fill item k of row l; lane-major, once lane l - ahead has combined
    if (plan.lane_major && l >= plan.ahead) {
      const int e = l - plan.ahead;
      block_wait(combined + e, plan.fill_first[e + 1] - plan.comb_first[e]);
    }
    const float value = kMin ? __int_as_float(0x7f800000) : 0.0f;
    const float4 fv = make_float4(value, value, value, value);
    const RowSpan rs = row_span(row, nd);
    float4* o = reinterpret_cast<float4*>(row + rs.head);
    const Idx i0 = static_cast<Idx>(k) * kFillItem + tid;
#pragma unroll
    for (int it = 0; it < kFillIters; ++it) {
      const Idx i = i0 + static_cast<Idx>(it) * kThreads;
      if (i < rs.n4) o[i] = fv;
    }
    if (k == 0 && tid < rs.head) row[tid] = value;
    if (k == 0 && tid < rs.tail) row[rs.head + 4 * rs.n4 + tid] = value;
    // the block's stores, then one fence and the count (as a grid sync does)
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicAdd(filled + l, 1);
    }
    return;
  }

  // -- combine item k of lane l: the loads, the wait for the row's fill, the
  // atomics
  constexpr int kRows = kLaneRows<D>;
  constexpr int kD = D > 0 ? D : 1;
  const Idx a = plan.start[l], len = plan.start[l + 1] - a;
  const Idx r0 = static_cast<Idx>(k) * kCombineItem<D> + tid;
  int sr[kRows];
  float vr[kRows][kD];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const Idx rel = r0 + static_cast<Idx>(r) * kThreads;
    sr[r] = -1;
#pragma unroll
    for (int j = 0; j < kD; ++j) vr[r][j] = 0.0f;
    if (rel < len) {
      sr[r] = __ldcs(seg + a + rel);
      if (D > 0) {
#pragma unroll
        for (int j = 0; j < kD; ++j) vr[r][j] = __ldcs(msg + (a + rel) * kD + j);
      }
    }
  }
  block_wait(filled + l, plan.fills[l]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (sr[r] < 0 || static_cast<Idx>(sr[r]) >= n_segments) continue;
    if constexpr (D > 0) {
      combine_lane<D, kMin>(row + static_cast<Idx>(sr[r]) * D, vr[r]);
    } else {
      const Idx e = a + r0 + static_cast<Idx>(r) * kThreads;
      float* dst = row + static_cast<Idx>(sr[r]) * d;
      for (int j = 0; j < d; ++j) combine_value<kMin>(dst + j, __ldcs(msg + e * d + j));
    }
  }
  __syncthreads();
  if (tid == 0) atomicAdd(combined + l, 1);
}

// Rows of the output whose fill and combine may be in flight together: as
// many as fit in kL2SharePct of the L2, at least one.
int lanes_ahead(Idx row_bytes) {
  static int l2 = 0;
  if (l2 == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (l2 <= 0) l2 = 1;
  }
  const Idx rows = (static_cast<Idx>(l2) * kL2SharePct / 100) / (row_bytes > 0 ? row_bytes : 1);
  return static_cast<int>(rows < 1 ? 1 : (rows > kMaxLanes ? kMaxLanes : rows));
}

// lengths: the lanes' row counts, on the host.  scratch: 2 * n_lanes ints
// (each lane's finished fill and combine items), zeroed here.  A launch has
// one block an item.
template <int D, bool kMin>
int launch_lanes(const float* msg, const int* seg, const long long* lengths, int n_lanes,
                 float* out, int d, Idx n_segments, int* scratch, cudaStream_t s) {
  const Idx nd = n_segments * d;
  if (nd == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * 2 * static_cast<size_t>(n_lanes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  LanePlan plan;
  plan.ahead = lanes_ahead(nd * 4);
  plan.lane_major = plan.ahead >= kLaneMajorRows;
  Idx start = 0;
  for (int lane0 = 0; lane0 < n_lanes; lane0 += kMaxLanes) {
    const int nl = n_lanes - lane0 < kMaxLanes ? n_lanes - lane0 : kMaxLanes;
    plan.n_lanes = nl;
    Idx fills = 0, combines = 0;  // over the lanes so far
    for (int i = 0; i < nl; ++i) {
      const Idx len = lengths[lane0 + i];
      const Idx f = (row_span(out + (lane0 + i) * nd, nd).n4 + kFillItem - 1) / kFillItem;
      if (len < 0) return static_cast<int>(cudaErrorInvalidValue);
      plan.start[i] = start;
      plan.fills[i] = static_cast<int>(f > 0 ? f : 1);
      plan.fill_first[i] = static_cast<int>(fills + (plan.lane_major ? combines : 0));
      fills += plan.fills[i];
      plan.comb_first[i] = static_cast<int>(combines + (plan.lane_major ? fills : 0));
      combines += (len + kCombineItem<D> - 1) / kCombineItem<D>;
      start += len;
    }
    const Idx items = fills + combines;
    if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    // every lane's combine items come after the fills, not lane-major
    if (!plan.lane_major) {
      for (int i = 0; i < nl; ++i) plan.comb_first[i] += static_cast<int>(fills);
    }
    plan.start[nl] = start;
    plan.fill_first[nl] = static_cast<int>(plan.lane_major ? items : fills);
    plan.comb_first[nl] = static_cast<int>(items);
    lanes_kernel<D, kMin><<<static_cast<unsigned>(items), kThreads, 0, s>>>(
        msg, seg, out + lane0 * nd, d, n_segments, plan, scratch + lane0,
        scratch + n_lanes + lane0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <bool kMin>
int launch_lanes_d(const float* msg, const int* seg, const long long* lengths, int n_lanes,
                   float* out, int d, Idx n_segments, int* scratch, cudaStream_t s) {
  if (d == 1) return launch_lanes<1, kMin>(msg, seg, lengths, n_lanes, out, 1, n_segments,
                                           scratch, s);
  if (d == 2) return launch_lanes<2, kMin>(msg, seg, lengths, n_lanes, out, 2, n_segments,
                                           scratch, s);
  return launch_lanes<0, kMin>(msg, seg, lengths, n_lanes, out, d, n_segments, scratch, s);
}

}  // namespace

extern "C" int segment_spmm_launch(const void* msg, const void* seg_ids, const void* valid,
                                   void* out, long long m, int d, long long n_segments,
                                   int combine_min, void* stream) {
  if (d < 1 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* msg_p = static_cast<const float*>(msg);
  const int* seg_p = static_cast<const int*>(seg_ids);
  const uint8_t* valid_p = static_cast<const uint8_t*>(valid);
  float* out_p = static_cast<float*>(out);
  return combine_min ? launch<true>(msg_p, seg_p, valid_p, out_p, m, d, n_segments, s)
                     : launch<false>(msg_p, seg_p, valid_p, out_p, m, d, n_segments, s);
}

// lengths: (n_lanes,) int64 on the host, lane after lane (their sum: the
// messages' rows); out: (n_lanes, n_segments, d) float32; scratch: 2 *
// n_lanes int32 on the device.
extern "C" int segment_spmm_lanes_launch(const void* msg, const void* seg_ids,
                                         const long long* lengths, int n_lanes, void* out,
                                         int d, long long n_segments, int combine_min,
                                         void* scratch, void* stream) {
  if (d < 1 || n_lanes < 1 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* msg_p = static_cast<const float*>(msg);
  const int* seg_p = static_cast<const int*>(seg_ids);
  float* out_p = static_cast<float*>(out);
  int* scratch_p = static_cast<int*>(scratch);
  return combine_min
             ? launch_lanes_d<true>(msg_p, seg_p, lengths, n_lanes, out_p, d, n_segments,
                                    scratch_p, s)
             : launch_lanes_d<false>(msg_p, seg_p, lengths, n_lanes, out_p, d, n_segments,
                                     scratch_p, s);
}

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
// blocks on a GPU run in no order, so each tile of kTile rows needs the
// kept count of the tiles before it.  Two launches:
//
//   1. count:   one block a tile, the mask read with 16-byte loads (kRows
//               rows a thread), the tile's kept rows summed into tile_counts;
//   2. scatter: one block a tile, launched as a programmatic dependent of
//               the count grid: it loads its rows while the counts run, then
//               waits for them (griddepcontrol; faster than a plain second
//               launch on the main path's blocks).  A thread's kRows rows
//               come from one 16-byte mask load and kRows/4 16-byte loads of
//               each column (one for a flag column).  The block sums the
//               tile counts (524 on the main path) into its own exclusive
//               offset and the total, so no scan launch is needed; block 0
//               writes the total as the count.  Its rows' ranks come from a
//               warp-shuffle scan of the threads' kept counts.  Each column
//               is then permuted through shared memory into the tile's two
//               runs (kept rows, then the others), and the runs are stored
//               with consecutive threads on consecutive addresses.
//
// A row that is not kept goes to total + (its index - kept rows before it),
// which needs the total before any such row is written: a one-pass
// decoupled look-back (CUB's DeviceSelect::Flagged) would have a tile wait
// for the last tile's count, and a tile that is not yet resident can then
// never run.  Writing the rows that are not kept lets the caller use the
// whole output without masking a tail.  Columns and a mask whose storage
// is not on a 16-byte boundary (on the main path the columns are slices of
// the edge arrays at the partition's first edge) are read with aligned
// 16-byte loads of the chunks around a thread's rows, shifted into place;
// the last tile's ragged end takes scalar loads.
//
// Lanes (graph serving, frontier_compact_lanes_launch): the rows hold L
// lanes' blocks packed lane after lane, and each lane's segment is
// partitioned by its own mask, in place of itself, with its own count.  The
// same two kernels run with tiles that never span two lanes: a block finds
// its lane and tile from the (L+1,) offsets (a loop over the lanes), and its
// ragged end is the lane's last row; an empty lane has no tile, and the
// scatter's block 0 writes its count of 0.  One launch pair serves all L
// lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 2048-row tiles: faster than 4096 or 8192 on the main path
constexpr int kRows = 16;                   // rows a thread: one 16-byte load of the mask
constexpr int kTile = kThreads * kRows;     // rows a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int bytes[kMaxCols];  // 4 or 1
  int n;
};

// Words K4 .. K4+3 of c, each shifted right by `shift` bits with the next
// word's low bits above it.
template <int K4>
__device__ __forceinline__ void shift_words(const uint32_t (&c)[8], int shift, uint32_t (&w)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = __funnelshift_r(c[K4 + q], c[K4 + q + 1], shift);
}

// The 16 bytes at p (any address) as 4 words, from the one or two 16-byte
// aligned chunks that hold them.  Every chunk read holds a byte of
// [p, p + 16), so no load touches a chunk outside the caller's array.
__device__ __forceinline__ void load_bytes16(const uint8_t* p, uint32_t (&w)[4]) {
  const int k = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const uint4* a = reinterpret_cast<const uint4*>(p - k);
  const uint4 lo = __ldcs(a);
  if (k == 0) {
    w[0] = lo.x;
    w[1] = lo.y;
    w[2] = lo.z;
    w[3] = lo.w;
    return;
  }
  const uint4 hi = __ldcs(a + 1);
  const uint32_t c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int shift = 8 * (k & 3);
  // a switch, so every index into c is a constant (no local memory)
  switch (k >> 2) {
    case 0: shift_words<0>(c, shift, w); break;
    case 1: shift_words<1>(c, shift, w); break;
    case 2: shift_words<2>(c, shift, w); break;
    default: shift_words<3>(c, shift, w); break;
  }
}

// The kRows words at p (4-byte aligned), from kRows/4 aligned 16-byte
// chunks, or kRows/4 + 1 when p is not on a 16-byte boundary; as above,
// every chunk holds a word of [p, p + kRows).
template <int K>
__device__ __forceinline__ void load_words_from(const uint32_t* p, uint32_t (&v)[kRows]) {
  const uint4* a = reinterpret_cast<const uint4*>(p - K);
  uint32_t c[kRows + 4];
#pragma unroll
  for (int q = 0; q < kRows / 4 + (K ? 1 : 0); ++q) {
    const uint4 x = __ldcs(a + q);
    c[4 * q] = x.x;
    c[4 * q + 1] = x.y;
    c[4 * q + 2] = x.z;
    c[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = c[r + K];
}

__device__ __forceinline__ void load_words16(const uint32_t* p, uint32_t (&v)[kRows]) {
  switch ((reinterpret_cast<uintptr_t>(p) >> 2) & 3) {
    case 0: load_words_from<0>(p, v); break;
    case 1: load_words_from<1>(p, v); break;
    case 2: load_words_from<2>(p, v); break;
    default: load_words_from<3>(p, v); break;
  }
}

// Bit r set when row row0 + r is kept (rows at or past m are not).
__device__ __forceinline__ unsigned keep_bits(const uint8_t* __restrict__ mask, long long row0,
                                              long long m) {
  unsigned bits = 0;
  if (row0 + kRows <= m) {
    uint32_t w[4];
    load_bytes16(mask + row0, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // 0x01 in each nonzero byte; the multiply gathers bytes 0..3's low
      // bits into bits 28..31 (no carries: every partial product lands on
      // its own bit)
      const unsigned nz = __vsetne4(w[q], 0u);
      bits |= ((nz * 0x10204080u) >> 28) << (4 * q);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r < m && mask[row0 + r]) bits |= 1u << r;
    }
  }
  return bits;
}

// The sum of x over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int x, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(0xffffffffu, x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// A block's tile: rows [row0, min(row0 + kTile, end)) of the segment
// [start, end) that it partitions, which is tiles first .. first + count - 1
// of the grid.  One segment (the whole array) unless there are lanes: then
// lane l's segment is [offsets[l], offsets[l+1]) and its tiles follow lane
// l - 1's, so no tile spans two lanes.  lane < 0: a block past the last
// lane's tiles (the grid is sized for the most tiles the lanes can need).
struct Tile {
  long long start, end, row0;
  int first, count, lane;
};

template <bool kLanes>
__device__ __forceinline__ Tile tile_of(long long m, int n_tiles,
                                        const long long* __restrict__ offsets, int n_lanes) {
  const int b = static_cast<int>(blockIdx.x);
  if (!kLanes) return Tile{0, m, (long long)b * kTile, 0, n_tiles, 0};
  int first = 0;
  for (int l = 0; l < n_lanes; ++l) {
    const long long s = __ldg(offsets + l), e = __ldg(offsets + l + 1);
    const int nt = static_cast<int>((e - s + kTile - 1) / kTile);
    if (b < first + nt) return Tile{s, e, s + (long long)(b - first) * kTile, first, nt, l};
    first += nt;
  }
  return Tile{0, 0, 0, 0, 0, -1};
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads) count_kernel(const uint8_t* __restrict__ mask,
                                                         int* __restrict__ tile_counts,
                                                         long long m, int n_tiles,
                                                         const long long* __restrict__ offsets,
                                                         int n_lanes) {
  __shared__ int scratch[kWarps];
  // let the scatter grid start (programmatic dependent launch): its blocks
  // load their rows while these count
  asm volatile("griddepcontrol.launch_dependents;");
  const Tile t = tile_of<kLanes>(m, n_tiles, offsets, n_lanes);
  if (t.lane < 0) return;
  const long long row0 = t.row0 + threadIdx.x * kRows;
  const int kept = block_sum(__popc(keep_bits(mask, row0, t.end)), scratch);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = kept;
}

// A thread's kRows rows of one column as 4-byte words (a flag column's 16
// bytes packed into words 0..3).
__device__ __forceinline__ void load_rows(const void* col, int bytes, long long row0,
                                          long long m, uint32_t (&v)[kRows]) {
  const bool whole = row0 + kRows <= m;
  if (bytes == 4) {
    const uint32_t* p = static_cast<const uint32_t*>(col) + row0;
    if (whole) {
      load_words16(p, v);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = row0 + r < m ? __ldcs(p + r) : 0u;
    }
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(col) + row0;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (whole) {
      load_bytes16(p, w);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < m) w[r / 4] |= static_cast<uint32_t>(__ldcs(p + r)) << (8 * (r % 4));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = w[q];
  }
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads) scatter_kernel(Columns cols,
                                                           const uint8_t* __restrict__ mask,
                                                           const int* __restrict__ tile_counts,
                                                           int n_tiles, int* __restrict__ count,
                                                           long long m,
                                                           const long long* __restrict__ offsets,
                                                           int n_lanes) {
  __shared__ int scratch[kWarps];
  __shared__ int warp_offsets[kWarps];
  __shared__ __align__(16) uint32_t stage[kTile];  // one column of the tile, permuted
  // With lanes, thread 0 finds the tile and the block reads its fields from
  // shared memory where it uses them (volatile: re-read, not held in
  // registers beside the 64 words of rows, which would spill); without, the
  // geometry is a few registers, as before.
  __shared__ Tile tile_s;
  const Tile own = tile_of<false>(m, n_tiles, offsets, n_lanes);
  if (kLanes) {
    if (threadIdx.x == 0) tile_s = tile_of<true>(m, n_tiles, offsets, n_lanes);
    __syncthreads();
  }
#define TILE(f) (kLanes ? static_cast<volatile Tile&>(tile_s).f : own.f)
  // an empty lane has no tile to write its count: block 0 writes it
  if (kLanes && blockIdx.x == 0) {
    for (int l = threadIdx.x; l < n_lanes; l += kThreads) {
      if (__ldg(offsets + l) == __ldg(offsets + l + 1)) count[l] = 0;
    }
  }
  if (TILE(lane) < 0) return;
  // -- the thread's rows and their keep bits, loaded first so that the
  // loads are in flight while the tile counts are summed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile0 = TILE(row0);
  const long long row0 = tile0 + threadIdx.x * kRows;
  const unsigned bits = keep_bits(mask, row0, TILE(end));
  uint32_t v[kMaxCols][kRows];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j < cols.n) load_rows(cols.in[j], cols.bytes[j], row0, TILE(end), v[j]);
  }

  // -- wait for the count grid to finish and its tile counts to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // -- the kept rows in the segment's tiles before this one, and in all of them
  int before = 0, all = 0;
  const int first = TILE(first), n_seg_tiles = TILE(count);
  for (int i = threadIdx.x; i < n_seg_tiles; i += kThreads) {
    const int c = tile_counts[first + i];
    all += c;
    before += first + i < (int)blockIdx.x ? c : 0;
  }
  const long long total = block_sum(all, scratch);
  const long long base = block_sum(before, scratch);
  if ((int)blockIdx.x == first && threadIdx.x == 0) count[TILE(lane)] = static_cast<int>(total);

  // -- the thread's kept rows' first rank in the tile
  const int kept = __popc(bits);
  const int incl = warp_inclusive_scan(kept, lane);
  if (lane == 31) warp_offsets[warp] = incl;
  __syncthreads();
  int kept_tile = 0, warp_before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_offsets[w];
    warp_before += w < warp ? c : 0;
    kept_tile += c;
  }
  const int kept_before = warp_before + incl - kept;   // in this tile, before this thread
  const int rest_before = threadIdx.x * kRows - kept_before;
  const long long tile_end = TILE(end);
  const int tile_rows = static_cast<int>(tile_end - tile0 < kTile ? tile_end - tile0 : kTile);
  // slot s of the tile goes to start + base + s (s < kept_tile) or, for the
  // rows that are not kept, to rest0 + s (rows of the segment before the
  // tile: tile0 - start, of which base kept)
  const long long kept0 = TILE(start) + base;
  const long long rest0 = total + (tile0 - base) - kept_tile;

  // unrolled, so every index into `cols` and `v` is a constant: a runtime
  // index into a by-value kernel parameter makes nvcc copy it to local memory
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j >= cols.n) break;
    const bool words = cols.bytes[j] == 4;
    uint8_t* stage8 = reinterpret_cast<uint8_t*>(stage);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned below = bits & ((1u << r) - 1u);
      const int slot = (bits >> r & 1u) ? kept_before + __popc(below)
                                        : kept_tile + rest_before + r - __popc(below);
      if (threadIdx.x * kRows + r < tile_rows) {
        if (words) {
          stage[slot] = v[j][r];
        } else {
          stage8[slot] = static_cast<uint8_t>(v[j][r / 4] >> (8 * (r % 4)));
        }
      }
    }
    __syncthreads();
    if (words) {
      uint32_t* out = static_cast<uint32_t*>(cols.out[j]);
      for (int s = threadIdx.x; s < tile_rows; s += kThreads) {
        out[s < kept_tile ? kept0 + s : rest0 + s] = stage[s];
      }
    } else {
      uint8_t* out = static_cast<uint8_t*>(cols.out[j]);
      for (int s = threadIdx.x; s < tile_rows; s += kThreads) {
        out[s < kept_tile ? kept0 + s : rest0 + s] = stage8[s];
      }
    }
    __syncthreads();
  }
#undef TILE
}

template <bool kLanes>
int launch(const Columns& cols, const uint8_t* mask_p, int* count, int* tile_counts, int n_tiles,
           long long m, const long long* offsets, int n_lanes, cudaStream_t s) {
  count_kernel<kLanes><<<n_tiles, kThreads, 0, s>>>(mask_p, tile_counts, m, n_tiles, offsets,
                                                    n_lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // programmatic dependent launch: the scatter may start before the count
  // grid ends, and waits for it (griddepcontrol.wait) only where it reads
  // the tile counts
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_tiles);
  config.blockDim = dim3(kThreads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, scatter_kernel<kLanes>, cols, mask_p,
                           static_cast<const int*>(tile_counts), n_tiles, count, m, offsets,
                           n_lanes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool fill_columns(const void* const* ins, void* const* outs, const int* bytes, int c,
                  Columns* cols) {
  if (c < 1 || c > kMaxCols) return false;
  cols->n = c;
  for (int j = 0; j < c; ++j) {
    cols->in[j] = ins[j];
    cols->out[j] = outs[j];
    cols->bytes[j] = bytes[j];
  }
  return true;
}

}  // namespace

// scratch: n_tiles = ceil(m / kTile) ints for the tile counts.
extern "C" int frontier_compact_launch(const void* const* ins, void* const* outs,
                                       const int* bytes, int c, const void* mask, void* count,
                                       void* scratch, long long m, void* stream) {
  Columns cols;
  if (!fill_columns(ins, outs, bytes, c, &cols) || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = static_cast<int>((m + kTile - 1) / kTile);
  return launch<false>(cols, static_cast<const uint8_t*>(mask), static_cast<int*>(count),
                       static_cast<int*>(scratch), n_tiles, m, nullptr, 1,
                       static_cast<cudaStream_t>(stream));
}

// The lane-batched entry (graph serving): lane l's rows [offsets[l],
// offsets[l+1]) are partitioned in place of themselves by their own mask
// bytes, and counts[l] is the lane's kept count.  offsets: (n_lanes + 1,)
// int64 on the device with offsets[0] = 0 and offsets[n_lanes] = m.
// scratch: ceil(m / kTile) + n_lanes ints, the most tiles the lanes can need
// (each lane's last tile may be partial).
extern "C" int frontier_compact_lanes_launch(const void* const* ins, void* const* outs,
                                             const int* bytes, int c, const void* mask,
                                             const void* offsets, int n_lanes, void* counts,
                                             void* scratch, long long m, void* stream) {
  Columns cols;
  if (!fill_columns(ins, outs, bytes, c, &cols) || m < 1 || n_lanes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = static_cast<int>((m + kTile - 1) / kTile) + n_lanes;
  return launch<true>(cols, static_cast<const uint8_t*>(mask), static_cast<int*>(counts),
                      static_cast<int*>(scratch), n_tiles, m,
                      static_cast<const long long*>(offsets), n_lanes,
                      static_cast<cudaStream_t>(stream));
}

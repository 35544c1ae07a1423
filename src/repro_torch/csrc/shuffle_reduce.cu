// Shuffle+Reduce (paper Fig. 7(c)) for Hopper: reduce a bin-sorted update
// stream into n_out bins with +, min or max over float32 or int32, or with
// bitwise | over int32; one stream or a batch of K streams (rows) that share
// the bin layout.
//
// Replaces the Pallas TPU kernel kernels/shuffle_reduce.py
// (shuffle_reduce_sorted), which ran a (partitions x tiles) grid with a
// VMEM-resident output block and a one-hot MXU contraction per tile.
//
// Bound on this card: bytes. Each update is read once (4 B) and each bin's
// two offsets and one result are touched once, against one add or compare
// per update; at 3.35 TB/s the stream is the whole cost.
//
// Design: the caller hands in the stream sorted by bin, offsets[n_out + 1]
// and a work list (kernels/shuffle_reduce.py, BinSplit) that names every
// bin longer than split_len (1,024) updates and cuts it into chunks of
// split_len, counted from the bin's own start. A warp's time is the number
// of dependent load rounds it walks one after another, so no warp may own
// a whole hub (an RMAT hub bin, a one-bin counter of the whole stream) or
// a run of empty bins:
//
// * The main kernel's work items are the list's chunks first, a warp each
//   (the heaviest items start first, on consecutive blocks that the block
//   scheduler spreads over all SMs), then the bins in groups of 32
//   consecutive bins, a warp each. A chunk's warp writes its partial to
//   its own slot of a scratch buffer.
// * In a group, lane l loads bin b0 + l's two offsets (coalesced). A bin
//   of at most kLaneLen updates is summed by its lane alone, in stream
//   order. The middle bins follow: up to kQuadLen updates, four at a time
//   with 8 lanes each; up to split_len, the whole warp one after another;
//   either way lanes side by side and a __shfl_down_sync tree. Bins longer
//   than split_len are left to their chunks. The group ends in one
//   coalesced store, which is all an empty bin costs.
// * A warp's time is set by its rounds of loads, each about one load
//   latency: a walk issues up to 16 (a lane alone) or 32 (lanes together)
//   loads a lane before it folds the first, so four middle bins of up to
//   kQuadLen updates, a longer middle bin, or a chunk take one round.
//   (R19's heaviest groups hold ~30,000 updates of middle bins.)
// * A second kernel, a warp per split bin, folds its chunks' partials in
//   chunk order from the identity into out[bin].
//
// Which lanes sum a bin, and in what order, follows from the bin's length
// alone, never from where it lies in the stream, and nothing is atomic: a
// float + gives the same bits on every run, and a bin gives the same bits
// wherever it sits.
//
// Batches: K rows of values (a query each) share the offsets and the work
// list, so the rows go on gridDim.y and each block walks one row's items
// exactly as a one-row launch walks them: row r reads its values at
// vals + r * vals_stride (a stride of 0 shares one row) and writes bins
// r * n_out .. and partials r * n_chunks ... Every row folds every bin in
// the one-row order, so a batched float + gives each row the bits of its
// own one-row launch. The graph's arrays are never copied K times, and the
// 32-bit guard below stays a bound on one row's stream.
//
// The list comes from the caller, so no launch reads a size back to the
// host: a bind builds one for its full stream once; a one-bin stream knows
// its chunks on the host; any other stream gets a fixed-shape list from
// shuffle_reduce_list_kernel below, sized by the stream's length alone.

#include "reduce_ops.cuh"

namespace repro {

constexpr int kLaneLen = 64;     // a bin of at most this many updates is one lane's alone
constexpr int kQuadLen = 256;    // a middle bin of at most this many takes 8 lanes, 4 at a time
constexpr int kLaneSteps = 16;   // loads in flight of a lane walking its own bin
constexpr int kWarpSteps = 32;   // loads in flight of each lane when lanes walk a run together
constexpr int kFoldTile = 1024;  // partials a warp of the fold stages in shared memory at a time

// Folding an identity changes no result: a float sum that starts from +0
// is never -0, so adding +0 keeps its bits; min and max keep theirs
// against +-inf, and integers against 0, INT32_MAX and INT32_MIN. So a
// lane past the end of its run loads the identity and folds it, and every
// load of a round is issued before its first fold.

// One lane's share of a run: elements i, i + STRIDE, ... below hi, folded
// in that order, STEPS loads in flight at a time.
template <typename T, int OP, int STRIDE, int STEPS>
__device__ __forceinline__ T walk(const T* __restrict__ vals, int32_t i, int32_t hi) {
  T acc = Reduce<T, OP>::identity();
  for (; i < hi; i += STRIDE * STEPS) {
    T v[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      v[u] = hi - i > STRIDE * u ? vals[i + STRIDE * u] : Reduce<T, OP>::identity();
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) acc = Reduce<T, OP>::apply(acc, v[u]);
  }
  return acc;
}

// The middle bins of one length class (mask m; lane j holds bin j's [lo,
// hi)): 32 / WIDTH of them a pass, WIDTH lanes each, side by side, then a
// __shfl_down_sync tree of WIDTH lanes. Returns acc with lane j's value
// replaced by bin j's result.
template <typename T, int OP, int WIDTH>
__device__ __forceinline__ T walk_bins(const T* __restrict__ vals, unsigned m, int32_t lo,
                                       int32_t hi, T acc) {
  constexpr int kPerPass = 32 / WIDTH;
  const int lane = threadIdx.x & 31;
  while (m) {
    int js[kPerPass];  // this pass's bins (-1: none)
#pragma unroll
    for (int q = 0; q < kPerPass; ++q) {
      js[q] = m ? __ffs(m) - 1 : -1;
      m &= m - 1;
    }
    int j = js[0];
#pragma unroll
    for (int q = 1; q < kPerPass; ++q) j = lane / WIDTH == q ? js[q] : j;
    const int32_t j_lo = __shfl_sync(0xffffffffu, lo, j < 0 ? 0 : j);
    const int32_t j_hi = __shfl_sync(0xffffffffu, hi, j < 0 ? 0 : j);
    const T r = warp_reduce<T, OP, WIDTH>(
        walk<T, OP, WIDTH, kWarpSteps>(vals, j_lo + lane % WIDTH, j < 0 ? j_lo : j_hi));
#pragma unroll
    for (int q = 0; q < kPerPass; ++q) {
      const T r_q = __shfl_sync(0xffffffffu, r, WIDTH * q);  // group q's first lane
      if (lane == js[q]) acc = r_q;
    }
  }
  return acc;
}

// ROWS: a batched launch, row blockIdx.y. A one-row launch (ROWS false)
// leaves the pointer parameters as they are (a row's offset pointers would
// live in registers, which the one-row kernel would pay for in time).
template <typename T, int OP, bool ROWS>
__global__ void __launch_bounds__(kThreads)
shuffle_reduce_kernel(const T* __restrict__ vals, int64_t vals_stride, int64_t n_vals,
                      const int32_t* __restrict__ offsets, T* __restrict__ out, int64_t n_out,
                      const int2* __restrict__ chunks, int64_t n_chunks, int32_t split_len,
                      T* __restrict__ partial) {
  if constexpr (ROWS) {
    const int64_t row = blockIdx.y;
    vals += row * vals_stride;
    out += row * n_out;
    partial += row * n_chunks;  // null with no chunks: row * 0
  }
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * warps_per_block;
  const int64_t n_items = n_chunks + (n_out + 31) / 32;
  for (int64_t item = blockIdx.x * warps_per_block + (threadIdx.x >> 5); item < n_items;
       item += n_warps) {
    if (item < n_chunks) {
      const int2 ch = chunks[item];  // (bin, chunk number); bin < 0: an unused slot
      if (ch.x < 0 || ch.x >= n_out || ch.y < 0) continue;
      const int32_t lo = clamp_offset(offsets[ch.x], n_vals);
      const int32_t hi = clamp_offset(offsets[ch.x + 1], n_vals);
      const int64_t c_lo = lo + static_cast<int64_t>(ch.y) * split_len;
      const int32_t a = c_lo < hi ? static_cast<int32_t>(c_lo) : hi;
      const int32_t z = c_lo + split_len < hi ? static_cast<int32_t>(c_lo + split_len) : hi;
      const T acc = warp_reduce<T, OP>(walk<T, OP, 32, kWarpSteps>(vals, a + lane, z));
      if (lane == 0) partial[item] = acc;
      continue;
    }
    const int64_t b = (item - n_chunks) * 32 + lane;
    int32_t lo = 0, hi = 0;
    if (b < n_out) {
      lo = clamp_offset(offsets[b], n_vals);
      hi = clamp_offset(offsets[b + 1], n_vals);
    }
    const int32_t n = hi > lo ? hi - lo : 0;
    T acc = Reduce<T, OP>::identity();
    if (n <= kLaneLen) acc = walk<T, OP, 1, kLaneSteps>(vals, lo, hi);
    acc = walk_bins<T, OP, 8>(vals, __ballot_sync(0xffffffffu, n > kLaneLen && n <= kQuadLen),
                              lo, hi, acc);
    acc = walk_bins<T, OP, 32>(vals, __ballot_sync(0xffffffffu, n > kQuadLen && n <= split_len),
                               lo, hi, acc);
    if (b < n_out && n <= split_len) out[b] = acc;
  }
}

// One warp per split bin: its chunks' partials, slots first .. first + k
// for a bin of ceil(n_b / split_len) chunks, folded in chunk order from the
// identity. The lanes stage up to kFoldTile partials at a time in shared
// memory, side by side, and lane 0 folds them one after another, so the
// order is the chunks' own. A listed bin that is not longer than split_len
// was written by the main kernel and is skipped.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
shuffle_reduce_fold_kernel(const T* __restrict__ partial, int64_t n_chunks,
                           const int32_t* __restrict__ offsets, int64_t n_vals,
                           const int32_t* __restrict__ split_bins,
                           const int32_t* __restrict__ split_first, int64_t n_split,
                           int32_t split_len, T* __restrict__ out, int64_t n_out) {
  __shared__ T staged[kThreads / 32][kFoldTile];
  partial += static_cast<int64_t>(blockIdx.y) * n_chunks;  // row blockIdx.y
  out += static_cast<int64_t>(blockIdx.y) * n_out;
  const int lane = threadIdx.x & 31;
  T* tile = staged[threadIdx.x >> 5];
  const int64_t j = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (j >= n_split) return;  // the whole warp
  const int32_t b = split_bins[j];
  if (b < 0 || b >= n_out) return;
  const int32_t lo = clamp_offset(offsets[b], n_vals);
  const int32_t hi = clamp_offset(offsets[b + 1], n_vals);
  if (hi - lo <= split_len) return;
  const int64_t k0 = clamp_offset(split_first[j], n_chunks);
  const int64_t k = (static_cast<int64_t>(hi - lo) + split_len - 1) / split_len;
  const int64_t k1 = k0 + k < n_chunks ? k0 + k : n_chunks;
  T acc = Reduce<T, OP>::identity();
  for (int64_t base = k0; base < k1; base += kFoldTile) {
    const int n = k1 - base < kFoldTile ? static_cast<int>(k1 - base) : kFoldTile;
#pragma unroll 8
    for (int i = lane; i < n; i += 32) tile[i] = partial[base + i];
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) acc = Reduce<T, OP>::apply(acc, tile[i]);
    }
    __syncwarp();
  }
  if (lane == 0) out[b] = acc;
}

// The fixed-shape work list of a stream of n_vals updates, by windows of
// split_len positions (W of them): a long bin B whose clamped start lies in
// window w = lo_B / split_len owns split slot w and chunk slots 2w ..
// 2w + k_B - 1, its chunk c in slot 2w + c. At most one long bin starts in
// a window, and B's next long neighbour starts k_B - 1 or more windows
// later (so 2 (k_B - 1) >= k_B slots on, as k_B >= 2), so the slots of two
// bins never meet, and all lie below 2W. The caller fills chunks and
// split_bins with -1; a thread per bin writes a long bin's entries (its
// chunks one after another), and the first W + 1 threads write
// split_first[v] = 2v. Nothing is read back to the host.
__global__ void __launch_bounds__(kThreads)
shuffle_reduce_list_kernel(const int32_t* __restrict__ offsets, int64_t n_out,
                           int64_t n_vals, int32_t split_len, int2* __restrict__ chunks,
                           int32_t* __restrict__ split_bins, int32_t* __restrict__ split_first,
                           int64_t n_windows) {
  const int64_t n = n_out > n_windows + 1 ? n_out : n_windows + 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i <= n_windows) split_first[i] = static_cast<int32_t>(2 * i);
    if (i >= n_out) continue;
    const int32_t lo = clamp_offset(offsets[i], n_vals);
    const int32_t hi = clamp_offset(offsets[i + 1], n_vals);
    if (hi - lo <= split_len) continue;
    const int64_t w = lo / split_len;
    const int64_t k = (static_cast<int64_t>(hi - lo) + split_len - 1) / split_len;
    if (2 * w + k > 2 * n_windows) continue;  // only decreasing offsets get here
    split_bins[w] = static_cast<int32_t>(i);
    for (int64_t c = 0; c < k; ++c) {
      chunks[2 * w + c] = make_int2(static_cast<int32_t>(i), static_cast<int32_t>(c));
    }
  }
}

struct Args {
  const void* vals;
  int64_t vals_stride;
  int64_t n_rows;
  int64_t n_vals;
  const void* offsets;
  void* out;
  int64_t n_out;
  const void* chunks;
  int64_t n_chunks;
  const void* split_bins;
  const void* split_first;
  int64_t n_split;
  int32_t split_len;
  void* partial;
  cudaStream_t stream;
};

template <typename T, int OP>
static cudaError_t launch(const Args& a) {
  const int64_t n_items = a.n_chunks + (a.n_out + 31) / 32;
  const dim3 grid(grid_for(n_items, a.n_rows), static_cast<unsigned>(a.n_rows));
  auto kernel = a.n_rows > 1 ? shuffle_reduce_kernel<T, OP, true>
                             : shuffle_reduce_kernel<T, OP, false>;
  kernel<<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.vals), a.vals_stride, a.n_vals,
      static_cast<const int32_t*>(a.offsets),
      static_cast<T*>(a.out), a.n_out, static_cast<const int2*>(a.chunks), a.n_chunks,
      a.split_len, static_cast<T*>(a.partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return err;
  const int64_t blocks = (a.n_split * 32 + kThreads - 1) / kThreads;
  shuffle_reduce_fold_kernel<T, OP><<<dim3(static_cast<unsigned>(blocks),
                                           static_cast<unsigned>(a.n_rows)),
                                      kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.partial), a.n_chunks, static_cast<const int32_t*>(a.offsets),
      a.n_vals, static_cast<const int32_t*>(a.split_bins),
      static_cast<const int32_t*>(a.split_first), a.n_split, a.split_len,
      static_cast<T*>(a.out), a.n_out);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t by_op(int op, const Args& a) {
  switch (op) {
    case kSum: return launch<T, kSum>(a);
    case kMin: return launch<T, kMin>(a);
    case kMax: return launch<T, kMax>(a);
    case kOr:
      if constexpr (std::is_same<T, int32_t>::value) return launch<T, kOr>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// n_rows rows of vals[n_vals] sorted by bin, row r at vals + r *
// vals_stride (0: one row shared); offsets[n_out + 1] int32 (offsets
// outside [0, n_vals] are clamped into it, so no bin reads past the
// stream), out[n_rows, n_out]. The work list over the same offsets:
// chunks[n_chunks] int32 pairs (bin, chunk number), a bin < 0 marking an
// unused slot; split_bins[n_split] (-1: unused) and split_first[n_split]:
// split bin j's chunk c sits in slot split_first[j] + c;
// partial[n_rows, n_chunks] is scratch of out's type. Offsets and list
// serve every row. Every bin longer than split_len must be listed with all its
// chunks; the list's indices are clamped, so a wrong list gives wrong bins
// but touches nothing out of bounds. dtype and op are the codes of
// reduce_ops.cuh (| takes int32 only). Launches one kernel, two when the list names a bin;
// returns cudaGetLastError() after the launches (0 on success).
extern "C" int repro_shuffle_reduce(const void* vals, int64_t n_rows, int64_t vals_stride,
                                    int64_t n_vals, const void* offsets,
                                    void* out, int64_t n_out, const void* chunks,
                                    int64_t n_chunks, const void* split_bins,
                                    const void* split_first, int64_t n_split, int split_len,
                                    void* partial, int dtype, int op, void* stream) {
  using namespace repro;
  if (n_out <= 0) return cudaSuccess;
  if (split_len <= 0 || n_chunks < 0 || n_split < 0 || (n_chunks > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  if (n_rows < 1 || n_rows > kMaxRows || vals_stride < 0) return cudaErrorInvalidValue;
  if (n_vals > INT32_MAX - 32 * kWarpSteps) return cudaErrorInvalidValue;  // 32-bit indices
  const Args a{vals,   vals_stride, n_rows,     n_vals,      offsets, out,
               n_out,  chunks,      n_chunks,   split_bins,  split_first,
               n_split, split_len,  partial,    static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return by_op<float>(op, a);
    case kI32: return by_op<int32_t>(op, a);
    default: return cudaErrorInvalidValue;
  }
}

// The fixed-shape work list of shuffle_reduce_list_kernel for a stream of
// n_vals updates over offsets[n_out + 1] (non-decreasing; clamped into [0,
// n_vals]), with n_windows = ceil(n_vals / split_len): chunks[2 *
// n_windows] int32 pairs and split_bins[n_windows], both filled with -1 by
// the caller, and split_first[n_windows + 1]. Returns cudaGetLastError()
// after the launch.
extern "C" int repro_shuffle_reduce_split_list(const void* offsets, int64_t n_out,
                                               int64_t n_vals, int split_len, void* chunks,
                                               void* split_bins, void* split_first,
                                               int64_t n_windows, void* stream) {
  using namespace repro;
  if (n_windows <= 0) return cudaSuccess;
  if (split_len <= 0 || n_out < 0 || 2 * n_windows > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t n = n_out > n_windows + 1 ? n_out : n_windows + 1;
  const int blocks = grid_for((n + 31) / 32);  // a thread per bin, at most 16 blocks an SM
  shuffle_reduce_list_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), n_out, n_vals, split_len,
      static_cast<int2*>(chunks), static_cast<int32_t*>(split_bins),
      static_cast<int32_t*>(split_first), n_windows);
  return cudaGetLastError();
}

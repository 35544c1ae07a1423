// Fused edge pipeline (paper Fig. 4: Burst Read -> Frontier Check -> Edge
// Operation -> Shuffle -> Reduce -> Burst Write) for Hopper.
//
// Replaces the Pallas TPU kernel kernels/edge_stream.py (edge_stream_call),
// which streamed pre-gathered (src_vals, weights, dst, active) tiles into a
// VMEM-resident destination partition and reduced them by a one-hot
// contraction. Here the source gather is fused into the kernel.
//
// Bound on this card: bytes. Per edge the kernel reads its source id (4 B),
// for weighted applies its edge id and weight (8 B), and gathers one
// vertex flag and one vertex value; the vertex arrays are |V|-sized and
// stay in the 50 MB L2 at the paper's graph sizes, so the edge-sized
// streams set the time.
//
// Design: the edges come sorted by destination (src_s, eid_s) with
// offsets[n_out + 1], precomputed once per bind. Warps walk work items; in
// each, lanes walk a run of edges side by side (coalesced src_s / eid_s
// reads, four edges a lane in flight), gather vact[s] and vval[s], skip the
// weight load for inactive sources, apply add/mul/src, and a
// __shfl_down_sync tree reduces the run. Each edge's update is a chain of
// dependent loads (src_s[i] -> vact[s] -> vval[s], eid_s[i] -> w[eid]), so
// a warp's time is the number of such chains it walks one after another:
// with one warp per bin, an RMAT hub's bin (91,031 edges at R19: 2,845
// steps of one warp) set the whole kernel's time.
//
// So the work list (kernels/shuffle_reduce.py, split_bins, built once per
// bind) cuts every bin longer than chunk_len (1,024 edges) into chunks.
// The items are the chunks first, one warp each, then the bins in quads of
// four consecutive bins. The grid strides over the items, so the chunks,
// the heaviest items, start first, on the first warps of the grid:
// consecutive blocks, which the block scheduler spreads over all SMs. No
// warp walks more than chunk_len edges of one bin. Most bins of a power-law
// graph are short (469,010 of R19's 524,288 hold at most 32 edges), and the
// degree relabel puts bins of like length side by side: a quad whose bins
// all hold at most 32 edges gives each bin a group of 8 lanes, so one warp
// does in one chain of loads what took four; any other quad walks its bins
// with all 32 lanes one after another, skipping the split ones. A bin's
// warp or group writes out[b] (the identity if no active edge reaches
// it); a chunk's warp writes its partial to slot k of a scratch buffer,
// and a second kernel (a warp per split bin) folds each split bin's
// partials, in chunk order, into out[bin]. Which lanes sum a bin, and in
// what order, is fixed by the offsets alone and nothing is atomic, so a
// float + gives the same bits on every run.

#include "reduce_ops.cuh"

namespace repro {

template <typename T, int APPLY>
__device__ __forceinline__ T apply_w(T v, const T* __restrict__ w, int32_t eid) {
  if constexpr (APPLY == kAdd) return Arith<T>::add(v, w[eid]);
  if constexpr (APPLY == kMul) return Arith<T>::mul(v, w[eid]);
  return v;
}

// One lane's share of a run: edges i, i + STRIDE, ... below hi, folded in
// that order. The lane takes kSteps of them at a time and issues every
// load of a stage for all of them before the first use, so kSteps chains
// are in flight instead of one; the fold order is that of a one-edge loop.
constexpr int kSteps = 4;

template <typename T, int APPLY, int OP, int STRIDE>
__device__ __forceinline__ T walk(const T* __restrict__ vval, const uint8_t* __restrict__ vact,
                                  const int32_t* __restrict__ src_s,
                                  const int32_t* __restrict__ eid_s, const T* __restrict__ w,
                                  int32_t i, int32_t hi) {
  T acc = Reduce<T, OP>::identity();
  for (; i < hi; i += STRIDE * kSteps) {
    int32_t s[kSteps], eid[kSteps] = {};
    bool on[kSteps];
    T v[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      on[u] = hi - i > STRIDE * u;
      if (on[u]) {
        s[u] = src_s[i + STRIDE * u];
        if constexpr (APPLY != kSrc) eid[u] = eid_s[i + STRIDE * u];
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) on[u] = on[u] && vact[s[u]];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (on[u]) v[u] = apply_w<T, APPLY>(vval[s[u]], w, eid[u]);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (on[u]) acc = Reduce<T, OP>::apply(acc, v[u]);
    }
  }
  return acc;
}

// A quad whose four bins all hold at most kShort edges walks them side by
// side, one group of kGroup lanes a bin (kShort / kGroup = kSteps: a single
// stage of loads); any other quad walks its bins one after another with
// all 32 lanes.
constexpr int kGroup = 8;
constexpr int kQuad = 32 / kGroup;
constexpr int kShort = kGroup * kSteps;

template <typename T, int APPLY, int OP>
__global__ void __launch_bounds__(kThreads)
edge_stream_kernel(const T* __restrict__ vval, const uint8_t* __restrict__ vact,
                   const int32_t* __restrict__ src_s, const int32_t* __restrict__ eid_s,
                   int64_t n_edges, const T* __restrict__ w,
                   const int32_t* __restrict__ offsets, T* __restrict__ out, int64_t n_out,
                   const int2* __restrict__ chunks, int64_t n_chunks, int32_t chunk_len,
                   T* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * warps_per_block;
  const int64_t n_items = n_chunks + (n_out + kQuad - 1) / kQuad;
  for (int64_t item = blockIdx.x * warps_per_block + (threadIdx.x >> 5); item < n_items;
       item += n_warps) {
    if (item < n_chunks) {
      const int2 ch = chunks[item];  // (bin, chunk number)
      // clamped, so a list built from other offsets cannot read past these
      const int64_t b = ch.x < 0 ? 0 : (ch.x >= n_out ? n_out - 1 : ch.x);
      int32_t lo = clamp_offset(offsets[b], n_edges);
      int32_t hi = clamp_offset(offsets[b + 1], n_edges);
      const int64_t c_lo = lo + static_cast<int64_t>(ch.y) * chunk_len;
      lo = c_lo < hi ? static_cast<int32_t>(c_lo) : hi;
      hi = c_lo + chunk_len < hi ? static_cast<int32_t>(c_lo + chunk_len) : hi;
      T acc = walk<T, APPLY, OP, 32>(vval, vact, src_s, eid_s, w, lo + lane, hi);
      acc = warp_reduce<T, OP>(acc);
      if (lane == 0) partial[item] = acc;
      continue;
    }
    // bins b0 .. b0 + 3: lane j <= 4 holds offsets[b0 + j] (past the last
    // bin, offsets[n_out]: an empty bin that is never written)
    const int64_t b0 = (item - n_chunks) * kQuad;
    const int64_t k = b0 + (lane <= kQuad ? lane : 0);
    const int32_t off = clamp_offset(offsets[k < n_out ? k : n_out], n_edges);
    const int g = lane / kGroup;
    const int32_t g_lo = __shfl_sync(0xffffffffu, off, g);
    const int32_t g_hi = __shfl_sync(0xffffffffu, off, g + 1);
    if (__all_sync(0xffffffffu, g_hi - g_lo <= kShort)) {
      T acc = walk<T, APPLY, OP, kGroup>(vval, vact, src_s, eid_s, w, g_lo + lane % kGroup, g_hi);
      acc = warp_reduce<T, OP, kGroup>(acc);
      if (lane % kGroup == 0 && b0 + g < n_out) out[b0 + g] = acc;
      continue;
    }
    for (int j = 0; j < kQuad && b0 + j < n_out; ++j) {
      const int32_t lo = __shfl_sync(0xffffffffu, off, j);
      const int32_t hi = __shfl_sync(0xffffffffu, off, j + 1);
      if (hi - lo > chunk_len) continue;  // split: its chunks are items of their own
      T acc = walk<T, APPLY, OP, 32>(vval, vact, src_s, eid_s, w, lo + lane, hi);
      acc = warp_reduce<T, OP>(acc);
      if (lane == 0) out[b0 + j] = acc;
    }
  }
}

// One warp per split bin: its chunks' partials folded in chunk order. The
// lanes load 32 partials at a time side by side, and every lane folds them
// from the broadcast one after another, so the order is the chunks' own.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ partial, int64_t n_chunks,
               const int32_t* __restrict__ split_bins, const int32_t* __restrict__ split_first,
               int64_t n_split, T* __restrict__ out, int64_t n_out) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (j >= n_split) return;  // the whole warp
  // clamped like the chunks' bins: slots into the scratch, the bin into out
  const int32_t k1 = clamp_offset(split_first[j + 1], n_chunks);
  const int32_t b = split_bins[j];
  T acc = Reduce<T, OP>::identity();
  for (int32_t base = clamp_offset(split_first[j], n_chunks); base < k1; base += 32) {
    const T p = base + lane < k1 ? partial[base + lane] : Reduce<T, OP>::identity();
    const int n = k1 - base < 32 ? k1 - base : 32;
    for (int l = 0; l < n; ++l) acc = Reduce<T, OP>::apply(acc, __shfl_sync(0xffffffffu, p, l));
  }
  if (lane == 0) out[b < 0 ? 0 : (b >= n_out ? n_out - 1 : b)] = acc;
}

struct Args {
  const void* vval;
  const void* vact;
  const void* src_s;
  const void* eid_s;
  int64_t n_edges;
  const void* w;
  const void* offsets;
  void* out;
  int64_t n_out;
  const void* chunks;
  int64_t n_chunks;
  int32_t chunk_len;
  const void* split_bins;
  const void* split_first;
  int64_t n_split;
  void* partial;
  cudaStream_t stream;
};

template <typename T, int APPLY, int OP>
static cudaError_t launch(const Args& a) {
  const int64_t n_items = a.n_chunks + (a.n_out + kQuad - 1) / kQuad;
  edge_stream_kernel<T, APPLY, OP><<<grid_for(n_items), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.vval), static_cast<const uint8_t*>(a.vact),
      static_cast<const int32_t*>(a.src_s), static_cast<const int32_t*>(a.eid_s), a.n_edges,
      static_cast<const T*>(a.w), static_cast<const int32_t*>(a.offsets),
      static_cast<T*>(a.out), a.n_out, static_cast<const int2*>(a.chunks), a.n_chunks,
      a.chunk_len, static_cast<T*>(a.partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return err;
  const int64_t blocks = (a.n_split * 32 + kThreads - 1) / kThreads;
  combine_kernel<T, OP><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.partial), a.n_chunks, static_cast<const int32_t*>(a.split_bins),
      static_cast<const int32_t*>(a.split_first), a.n_split, static_cast<T*>(a.out), a.n_out);
  return cudaGetLastError();
}

template <typename T, int APPLY>
static cudaError_t by_op(int op, const Args& a) {
  switch (op) {
    case kSum: return launch<T, APPLY, kSum>(a);
    case kMin: return launch<T, APPLY, kMin>(a);
    case kMax: return launch<T, APPLY, kMax>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t by_apply(int apply, int op, const Args& a) {
  switch (apply) {
    case kAdd: return by_op<T, kAdd>(op, a);
    case kMul: return by_op<T, kMul>(op, a);
    case kSrc: return by_op<T, kSrc>(op, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// vval[V] and vact[V] (bool as bytes) are the vertex side; src_s[n_edges]
// and eid_s[n_edges] list the edges sorted by destination bin, w[E] holds
// weights by edge id (eid_s and w may be null for apply 'src');
// offsets[n_out + 1] int32 (clamped into [0, n_edges]); out[n_out]. The
// work list of split_bins over the same offsets: chunks[n_chunks] int32
// pairs (bin, chunk number), split_bins[n_split], split_first[n_split + 1];
// partial[n_chunks] is scratch of out's type. The bins longer than
// chunk_len must be exactly the split bins; the list's indices are clamped,
// so a list built from other offsets gives wrong bins but touches nothing
// out of bounds. Launches one kernel, two when a bin is split; returns
// cudaGetLastError() after the launches.
extern "C" int repro_edge_stream(const void* vval, const void* vact, const void* src_s,
                                 const void* eid_s, int64_t n_edges, const void* w,
                                 const void* offsets, void* out, int64_t n_out,
                                 const void* chunks, int64_t n_chunks, int chunk_len,
                                 const void* split_bins, const void* split_first,
                                 int64_t n_split, void* partial, int dtype, int apply, int op,
                                 void* stream) {
  using namespace repro;
  if (n_out <= 0) return cudaSuccess;
  if (apply != kSrc && (eid_s == nullptr || w == nullptr)) return cudaErrorInvalidValue;
  if (chunk_len <= 0 || n_chunks < 0 || n_split < 0 || (n_chunks > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  if (n_edges > INT32_MAX - 32 * kSteps) return cudaErrorInvalidValue;  // 32-bit edge indices
  const Args a{vval,   vact,  src_s,  eid_s,    n_edges,   w,          offsets,
               out,    n_out, chunks, n_chunks, chunk_len, split_bins, split_first,
               n_split, partial, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return by_apply<float>(apply, op, a);
    case kI32: return by_apply<int32_t>(apply, op, a);
    default: return cudaErrorInvalidValue;
  }
}

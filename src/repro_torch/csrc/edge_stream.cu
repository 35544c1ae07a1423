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
//
// Batches: K rows of the vertex side (a query each, or the 32-source words
// of multi-source BFS) share the sorted edges, the offsets and the work
// list. Walking the edges once a row would repeat, K times, the reads of
// src_s, eid_s and w[eid], and would gather each row's vact[s] and vval[s]
// apart: K sectors an edge from K rows V apart. So a batched launch walks
// the items once for a group of R rows (R = 2, 8 or 16, the last group
// partial). First a pack kernel writes each group's rows as a [V, R] tile
// (the R values of a vertex side by side, one cache line) and, for weighted
// applies, the group's R flags of a vertex as one bit-word; for apply src
// it writes the identity where a row's flag is off, and the walk reads no
// flags. Then a warp walks each item as the one-row kernel does, reading
// each edge's src_s[i] (and eid_s[i], its flag word and a shared w[eid])
// once for the group. R / 4 lanes load an edge's R values together, 16
// bytes each, so one load instruction reaches 32 / (R / 4) edges in as
// many cache lines: the gather's rate is one line a lane-load, and a lane
// loading all R values of its own edge would take R / 4 times as many.
// Each lane keeps R accumulators, each the fold of one row over one lane
// of the one-row walk: the edges that lane would take, in its order (an
// inactive edge skipped, or its identity folded: the same bits, since an
// accumulator that starts at the identity never holds -0.0 under
// round-to-nearest, and +0.0, +inf, -inf, 0 leave every other value as it
// is). The one-row shuffle tree, over those virtual lanes, and the same
// chunk order give each row the bits of its own one-row launch, float +
// too. The groups of one item sit side by side on blockIdx.x (block b
// serves group b % n_groups), so the edge streams come from DRAM about
// once. Reduce | (int32) ORs the gathered words.

#include <cstring>

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

// ---- the batched route: one walk for a group of R rows -------------------

// The same 4 bytes as another 4-byte type.
template <typename To, typename From>
__device__ __forceinline__ To bits_as(From x) {
  static_assert(sizeof(To) == 4 && sizeof(From) == 4, "4-byte values");
  To y;
  memcpy(&y, &x, 4);
  return y;
}

// A tile holds a vertex's R values side by side (4-byte values, R * 4 bytes
// aligned to their size). A lane loads C of them at once, one 8- or
// 16-byte load, and P = R / C lanes load one vertex's R together.
template <int R> constexpr int kPerLane = R < 4 ? R : 4;
template <int R> constexpr int kLanesPerEdge = R / kPerLane<R>;

template <typename T, int C>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, T (&v)[C]) {
  static_assert(sizeof(T) == 4 && (C == 2 || C == 4), "4-byte values, 2 or 4 a load");
  if constexpr (C == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bits_as<T>(q.x);
    v[1] = bits_as<T>(q.y);
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = bits_as<T>(q.x);
    v[1] = bits_as<T>(q.y);
    v[2] = bits_as<T>(q.z);
    v[3] = bits_as<T>(q.w);
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_tile(T* __restrict__ p, const T (&v)[R]) {
  if constexpr (R == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bits_as<uint32_t>(v[0]), bits_as<uint32_t>(v[1]));
  } else {
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      reinterpret_cast<uint4*>(p)[j] =
          make_uint4(bits_as<uint32_t>(v[4 * j]), bits_as<uint32_t>(v[4 * j + 1]),
                     bits_as<uint32_t>(v[4 * j + 2]), bits_as<uint32_t>(v[4 * j + 3]));
    }
  }
}

// The flags of a vertex's R rows in a group: bit r for row r.
template <int R> using FlagWord = std::conditional_t<(R > 8), uint16_t, uint8_t>;

// Group blockIdx.y's rows of vval[V] and vact[V] as a [V, R] tile and, for
// weighted applies (MASK false), one flag word a vertex (bit r: row r's
// flag); with MASK (apply src) an inactive row's value is the identity and
// no flags are written (OP's identity; a weighted pack takes kSum's, which
// no row folds). Rows past the last hold the identity, flag 0.
template <typename T, int OP, int R, bool MASK>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ vval, int64_t vval_stride, const uint8_t* __restrict__ vact,
            int64_t vact_stride, int64_t n_rows, int64_t n_vertices, T* __restrict__ tile,
            FlagWord<R>* __restrict__ bits) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n_vertices) return;
  const T identity = Reduce<T, OP>::identity();
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * R;
  T x[R];
  uint32_t word = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = identity;
    if (row0 + r < n_rows) {
      const bool on = vact[(row0 + r) * vact_stride + v] != 0;
      const T val = vval[(row0 + r) * vval_stride + v];
      x[r] = MASK && !on ? identity : val;
      word |= static_cast<uint32_t>(on) << r;
    }
  }
  const int64_t at = static_cast<int64_t>(blockIdx.y) * n_vertices + v;
  store_tile<T, R>(tile + at * R, x);
  if constexpr (!MASK) bits[at] = static_cast<FlagWord<R>>(word);
}

// One lane group's walk of a run lo .. hi for the group's R rows, W lanes
// wide (32, or kGroup in a quad of short bins), with the one-row walk's
// fold order: virtual lane v (what lane v of a one-row walk is) folds
// edges lo + v, lo + v + W, ... in that order. The P lanes that load a
// vertex's R values together share an edge, so one load instruction
// reaches W / P edges, each of whose R * 4 bytes lie in one cache line,
// rather than W edges P times over. Lane P * a + q of the group holds
// virtual lanes A * j + a (A = W / P, j < P) for rows q * C .. q * C + C - 1:
// acc[j][c]. Each edge's source and edge id are read once for the group's
// rows (the P lanes of an edge read one address), and a shared w[eid]
// once (w_stride 0; else each row its own at r * w_stride). Row r folds
// the edges whose flag bit r is set (apply src: every edge, the pack
// having put the identity where a row's flag is off).
template <typename T, int APPLY, int OP, int W, int R>
__device__ __forceinline__ void walk_rows(T (&acc)[kLanesPerEdge<R>][kPerLane<R>],
                                          const T* __restrict__ tile,
                                          const FlagWord<R>* __restrict__ bits,
                                          const int32_t* __restrict__ src_s,
                                          const int32_t* __restrict__ eid_s,
                                          const T* __restrict__ w, int64_t w_stride,
                                          int32_t lo, int32_t hi, int group_lane) {
  constexpr int C = kPerLane<R>, P = kLanesPerEdge<R>, A = W / P;
  constexpr int S = kSteps / P;  // steps in flight: kSteps edges a lane, as walk has
  const int a = group_lane / P, q = group_lane % P;
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = Reduce<T, OP>::identity();
  }
  for (int32_t i = lo + a; i < hi; i += W * S) {
    int32_t s[S][P], eid[S][P] = {};
    uint32_t on[S][P];  // apply src: the edge is in the run; else its C rows' flag bits
    T v[S][P][C];
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        on[u][j] = hi - i > W * u + A * j;
        if (on[u][j]) {
          s[u][j] = src_s[i + W * u + A * j];
          if constexpr (APPLY != kSrc) eid[u][j] = eid_s[i + W * u + A * j];
        }
      }
    }
    if constexpr (APPLY != kSrc) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          on[u][j] = on[u][j] ? (bits[s[u][j]] >> (q * C)) & ((1u << C) - 1u) : 0u;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (on[u][j]) load_vals<T, C>(tile + static_cast<int64_t>(s[u][j]) * R + q * C, v[u][j]);
      }
    }
    if constexpr (APPLY != kSrc) {
      if (w_stride == 0) {
        T wu[S][P];
#pragma unroll
        for (int u = 0; u < S; ++u) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
            if (on[u][j]) wu[u][j] = w[eid[u][j]];
          }
        }
#pragma unroll
        for (int u = 0; u < S; ++u) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (on[u][j] >> c & 1u) {
                v[u][j][c] = APPLY == kAdd ? Arith<T>::add(v[u][j][c], wu[u][j])
                                           : Arith<T>::mul(v[u][j][c], wu[u][j]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < S; ++u) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (on[u][j] >> c & 1u) {
                v[u][j][c] = apply_w<T, APPLY>(v[u][j][c], w + (q * C + c) * w_stride,
                                               eid[u][j]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool fold = APPLY == kSrc ? on[u][j] != 0u : (on[u][j] >> c & 1u) != 0u;
          if (fold) acc[j][c] = Reduce<T, OP>::apply(acc[j][c], v[u][j][c]);
        }
      }
    }
  }
}

// The one-row tree (offsets W/2 .. 1, acc[v] = op(acc[v], acc[v + o])) over
// the virtual lanes of walk_rows, from offset O down: an offset of at least
// A pairs registers j and j + O / A of one lane, a smaller one lanes P * O
// apart. Only virtual lane 0's result is kept, and below A it depends on
// register 0 alone, so only that is shuffled. Lanes q < P of the group end
// with rows q * C .. q * C + C - 1 in acc[0].
template <typename T, int OP, int W, int R, int O = W / 2>
__device__ __forceinline__ void reduce_rows(T (&acc)[kLanesPerEdge<R>][kPerLane<R>]) {
  constexpr int C = kPerLane<R>, P = kLanesPerEdge<R>, A = W / P;
  if constexpr (O > 0) {
    if constexpr (O >= A) {
#pragma unroll
      for (int j = 0; j + O / A < P; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] = Reduce<T, OP>::apply(acc[j][c], acc[j + O / A][c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[0][c] = Reduce<T, OP>::apply(acc[0][c], __shfl_down_sync(0xffffffffu, acc[0][c],
                                                                      P * O, W));
      }
    }
    reduce_rows<T, OP, W, R, O / 2>(acc);
  }
}

// Lane q < P of a group stores its C rows' results (of the first `rows`),
// row r at dst + r * row_stride.
template <typename T, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int64_t row_stride, int rows,
                                           int group_lane,
                                           const T (&acc)[kLanesPerEdge<R>][kPerLane<R>]) {
  constexpr int C = kPerLane<R>;
  if (group_lane >= kLanesPerEdge<R>) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int r = group_lane * C + c;
    if (r < rows) dst[r * row_stride] = acc[0][c];
  }
}

// The items of edge_stream_kernel, walked once for each group of R rows of
// the packed tiles: block b serves group b % n_groups as block
// b / n_groups of that group; row r of group g writes out[g * R + r] and
// partial[g * R + r].
// The blocks an SM must hold, given to ptxas: 4 for apply src and 3
// weighted made the 16-row walks faster on an H100 than no minimum did, at
// the same register counts; a minimum of 1 let the weighted walk take far
// more registers and run slower.
template <typename T, int APPLY, int OP, int R>
__global__ void __launch_bounds__(kThreads, APPLY == kSrc ? 4 : 3)
edge_stream_rows_kernel(const T* __restrict__ tile, const FlagWord<R>* __restrict__ bits,
                        int64_t n_vertices, const int32_t* __restrict__ src_s,
                        const int32_t* __restrict__ eid_s, int64_t n_edges,
                        const T* __restrict__ w, int64_t w_stride,
                        const int32_t* __restrict__ offsets, T* __restrict__ out, int64_t n_out,
                        const int2* __restrict__ chunks, int64_t n_chunks, int32_t chunk_len,
                        T* __restrict__ partial, int64_t n_rows) {
  const int64_t n_groups = (n_rows + R - 1) / R;
  const int64_t group = blockIdx.x % n_groups;
  const int64_t row0 = group * R;
  const int rows = n_rows - row0 < R ? static_cast<int>(n_rows - row0) : R;
  tile += group * n_vertices * R;
  if constexpr (APPLY != kSrc) {
    bits += group * n_vertices;
    w += row0 * w_stride;
  }
  out += row0 * n_out;
  partial += row0 * n_chunks;  // null with no chunks: row0 * 0
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x / n_groups) * warps_per_block;
  const int64_t n_items = n_chunks + (n_out + kQuad - 1) / kQuad;
  T acc[kLanesPerEdge<R>][kPerLane<R>];
  for (int64_t item = blockIdx.x / n_groups * warps_per_block + (threadIdx.x >> 5);
       item < n_items; item += n_warps) {
    if (item < n_chunks) {
      const int2 ch = chunks[item];  // (bin, chunk number)
      const int64_t b = ch.x < 0 ? 0 : (ch.x >= n_out ? n_out - 1 : ch.x);
      int32_t lo = clamp_offset(offsets[b], n_edges);
      int32_t hi = clamp_offset(offsets[b + 1], n_edges);
      const int64_t c_lo = lo + static_cast<int64_t>(ch.y) * chunk_len;
      lo = c_lo < hi ? static_cast<int32_t>(c_lo) : hi;
      hi = c_lo + chunk_len < hi ? static_cast<int32_t>(c_lo + chunk_len) : hi;
      walk_rows<T, APPLY, OP, 32, R>(acc, tile, bits, src_s, eid_s, w, w_stride, lo, hi, lane);
      reduce_rows<T, OP, 32, R>(acc);
      store_rows<T, R>(partial + item, n_chunks, rows, lane, acc);
      continue;
    }
    const int64_t b0 = (item - n_chunks) * kQuad;
    const int64_t k = b0 + (lane <= kQuad ? lane : 0);
    const int32_t off = clamp_offset(offsets[k < n_out ? k : n_out], n_edges);
    const int g = lane / kGroup;
    const int32_t g_lo = __shfl_sync(0xffffffffu, off, g);
    const int32_t g_hi = __shfl_sync(0xffffffffu, off, g + 1);
    if (__all_sync(0xffffffffu, g_hi - g_lo <= kShort)) {
      walk_rows<T, APPLY, OP, kGroup, R>(acc, tile, bits, src_s, eid_s, w, w_stride, g_lo, g_hi,
                                         lane % kGroup);
      reduce_rows<T, OP, kGroup, R>(acc);
      if (b0 + g < n_out) store_rows<T, R>(out + b0 + g, n_out, rows, lane % kGroup, acc);
      continue;
    }
    for (int j = 0; j < kQuad && b0 + j < n_out; ++j) {
      const int32_t lo = __shfl_sync(0xffffffffu, off, j);
      const int32_t hi = __shfl_sync(0xffffffffu, off, j + 1);
      if (hi - lo > chunk_len) continue;  // split: its chunks are items of their own
      walk_rows<T, APPLY, OP, 32, R>(acc, tile, bits, src_s, eid_s, w, w_stride, lo, hi, lane);
      reduce_rows<T, OP, 32, R>(acc);
      store_rows<T, R>(out + b0 + j, n_out, rows, lane, acc);
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
  partial += static_cast<int64_t>(blockIdx.y) * n_chunks;  // row blockIdx.y
  out += static_cast<int64_t>(blockIdx.y) * n_out;
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
  int64_t n_vertices;
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
  int64_t n_rows;
  int64_t vval_stride;
  int64_t vact_stride;
  int64_t w_stride;
  int group_rows;
  void* tile;
  void* bits;
  cudaStream_t stream;
};

// The batched route's two kernels: the pack into the groups' tiles, then
// the walk, the groups of an item side by side on the grid.
template <typename T, int APPLY, int OP, int R>
static cudaError_t launch_rows(const Args& a, int64_t n_items) {
  const int64_t n_groups = (a.n_rows + R - 1) / R;
  const dim3 pack_grid(static_cast<unsigned>((a.n_vertices + kThreads - 1) / kThreads),
                       static_cast<unsigned>(n_groups));
  if (a.n_vertices > 0) {
    constexpr bool kMask = APPLY == kSrc;
    pack_kernel<T, kMask ? OP : kSum, R, kMask><<<pack_grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.vval), a.vval_stride, static_cast<const uint8_t*>(a.vact),
        a.vact_stride, a.n_rows, a.n_vertices, static_cast<T*>(a.tile),
        static_cast<FlagWord<R>*>(a.bits));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t grid = grid_for(n_items, n_groups) * n_groups;  // groups interleaved
  edge_stream_rows_kernel<T, APPLY, OP, R><<<static_cast<unsigned>(grid), kThreads, 0,
                                             a.stream>>>(
      static_cast<const T*>(a.tile), static_cast<const FlagWord<R>*>(a.bits), a.n_vertices,
      static_cast<const int32_t*>(a.src_s), static_cast<const int32_t*>(a.eid_s), a.n_edges,
      static_cast<const T*>(a.w), a.w_stride, static_cast<const int32_t*>(a.offsets),
      static_cast<T*>(a.out), a.n_out, static_cast<const int2*>(a.chunks), a.n_chunks,
      a.chunk_len, static_cast<T*>(a.partial), a.n_rows);
  return cudaGetLastError();
}

template <typename T, int APPLY, int OP>
static cudaError_t launch(const Args& a) {
  const int64_t n_items = a.n_chunks + (a.n_out + kQuad - 1) / kQuad;
  cudaError_t err = cudaSuccess;
  switch (a.n_rows > 1 ? a.group_rows : 1) {
    case 1:
      edge_stream_kernel<T, APPLY, OP><<<grid_for(n_items), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.vval), static_cast<const uint8_t*>(a.vact),
          static_cast<const int32_t*>(a.src_s), static_cast<const int32_t*>(a.eid_s),
          a.n_edges, static_cast<const T*>(a.w), static_cast<const int32_t*>(a.offsets),
          static_cast<T*>(a.out), a.n_out, static_cast<const int2*>(a.chunks), a.n_chunks,
          a.chunk_len, static_cast<T*>(a.partial));
      err = cudaGetLastError();
      break;
    case 2: err = launch_rows<T, APPLY, OP, 2>(a, n_items); break;
    case 8: err = launch_rows<T, APPLY, OP, 8>(a, n_items); break;
    case 16: err = launch_rows<T, APPLY, OP, 16>(a, n_items); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.n_split == 0) return err;
  const int64_t blocks = (a.n_split * 32 + kThreads - 1) / kThreads;
  combine_kernel<T, OP><<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(a.n_rows)),
                          kThreads, 0, a.stream>>>(
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
    case kOr:
      if constexpr (std::is_same<T, int32_t>::value) return launch<T, APPLY, kOr>(a);
      return cudaErrorInvalidValue;
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

// n_rows rows of the vertex side vval[V] and vact[V] (bool as bytes) and
// of the weights w[E] by edge id, row r at r * vval_stride, vact_stride,
// w_stride (0: one row shared by all); src_s[n_edges] and eid_s[n_edges]
// list the edges sorted by destination bin (eid_s and w may be null for
// apply 'src'); offsets[n_out + 1] int32 (clamped into [0, n_edges]);
// out[n_rows, n_out]. The work list of split_bins over the same offsets:
// chunks[n_chunks] int32 pairs (bin, chunk number), split_bins[n_split],
// split_first[n_split + 1]; partial[n_rows, n_chunks] is scratch of out's
// type. Edges, offsets and list serve every row; op | takes int32 only.
// The bins longer than chunk_len must be exactly the split bins; the
// list's indices are clamped, so a list built from other offsets gives
// wrong bins but touches nothing out of bounds. With more than one row the
// rows go in groups of group_rows (2, 8 or 16) over the scratch tile[G,
// n_vertices, group_rows] of out's type (G = ceil(n_rows / group_rows),
// aligned to group_rows * 4 bytes, at most 16) and, for weighted applies,
// bits[G, n_vertices] words of group_rows bits (one byte, two for 16);
// the sources must lie in [0, n_vertices).
// Launches the walk (after the pack, with rows) and, when a bin is split,
// the combine; returns cudaGetLastError() after the launches.
extern "C" int repro_edge_stream(const void* vval, const void* vact, int64_t n_vertices,
                                 const void* src_s, const void* eid_s, int64_t n_edges,
                                 const void* w, const void* offsets, void* out, int64_t n_out,
                                 const void* chunks, int64_t n_chunks, int chunk_len,
                                 const void* split_bins, const void* split_first,
                                 int64_t n_split, void* partial, int64_t n_rows,
                                 int64_t vval_stride, int64_t vact_stride, int64_t w_stride,
                                 int group_rows, void* tile, void* bits, int dtype, int apply,
                                 int op, void* stream) {
  using namespace repro;
  if (n_out <= 0) return cudaSuccess;
  if (n_rows < 1 || n_rows > kMaxRows || vval_stride < 0 || vact_stride < 0 || w_stride < 0)
    return cudaErrorInvalidValue;
  if (apply != kSrc && (eid_s == nullptr || w == nullptr)) return cudaErrorInvalidValue;
  if (chunk_len <= 0 || n_chunks < 0 || n_split < 0 || (n_chunks > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  if (n_edges > INT32_MAX - 32 * kSteps) return cudaErrorInvalidValue;  // 32-bit edge indices
  if (n_rows > 1) {
    const uintptr_t align = group_rows == 2 ? 8 : 16;
    if ((group_rows != 2 && group_rows != 8 && group_rows != 16) ||
        n_vertices < 0 ||
        tile == nullptr || reinterpret_cast<uintptr_t>(tile) % align != 0 ||
        (apply != kSrc && bits == nullptr))
      return cudaErrorInvalidValue;
  }
  const Args a{vval,        vact,       n_vertices, src_s,   eid_s,   n_edges,
               w,           offsets,    out,        n_out,   chunks,  n_chunks,
               chunk_len,   split_bins, split_first, n_split, partial, n_rows,
               vval_stride, vact_stride, w_stride,  group_rows, tile, bits,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return by_apply<float>(apply, op, a);
    case kI32: return by_apply<int32_t>(apply, op, a);
    default: return cudaErrorInvalidValue;
  }
}

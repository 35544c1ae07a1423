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
// offsets[n_out + 1], precomputed once per bind. One warp owns one
// destination bin at a time; the lanes walk its edges side by side
// (coalesced src_s / eid_s reads), gather vact[s] and vval[s], skip the
// weight load for inactive sources, apply add/mul/src, and a
// __shfl_down_sync tree reduces the bin without atomics, so a float sum
// is the same bits on every run. Lane 0 writes the bin, or the identity
// if no active edge reaches it. Hub bins are walked by one warp alone.

#include "reduce_ops.cuh"

namespace repro {

template <typename T, int APPLY, int OP>
__global__ void __launch_bounds__(kThreads)
edge_stream_kernel(const T* __restrict__ vval, const uint8_t* __restrict__ vact,
                   const int32_t* __restrict__ src_s, const int32_t* __restrict__ eid_s,
                   int64_t n_edges, const T* __restrict__ w,
                   const int32_t* __restrict__ offsets, T* __restrict__ out, int64_t n_out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * warps_per_block;
  for (int64_t b = blockIdx.x * warps_per_block + (threadIdx.x >> 5); b < n_out;
       b += n_warps) {
    const int32_t lo = clamp_offset(offsets[b], n_edges);
    const int32_t hi = clamp_offset(offsets[b + 1], n_edges);
    T acc = Reduce<T, OP>::identity();
    for (int32_t i = lo + lane; i < hi; i += 32) {
      const int32_t s = src_s[i];
      if (vact[s]) {
        T upd = vval[s];
        if constexpr (APPLY == kAdd) upd = Arith<T>::add(upd, w[eid_s[i]]);
        if constexpr (APPLY == kMul) upd = Arith<T>::mul(upd, w[eid_s[i]]);
        acc = Reduce<T, OP>::apply(acc, upd);
      }
    }
    acc = warp_reduce<T, OP>(acc);
    if (lane == 0) out[b] = acc;
  }
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
  cudaStream_t stream;
};

template <typename T, int APPLY, int OP>
static cudaError_t launch(const Args& a) {
  edge_stream_kernel<T, APPLY, OP><<<grid_for(a.n_out), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.vval), static_cast<const uint8_t*>(a.vact),
      static_cast<const int32_t*>(a.src_s), static_cast<const int32_t*>(a.eid_s), a.n_edges,
      static_cast<const T*>(a.w), static_cast<const int32_t*>(a.offsets),
      static_cast<T*>(a.out), a.n_out);
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
// offsets[n_out + 1] int32 (clamped into [0, n_edges]); out[n_out]. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_edge_stream(const void* vval, const void* vact, const void* src_s,
                                 const void* eid_s, int64_t n_edges, const void* w,
                                 const void* offsets, void* out, int64_t n_out, int dtype,
                                 int apply, int op, void* stream) {
  using namespace repro;
  if (n_out <= 0) return cudaSuccess;
  if (apply != kSrc && (eid_s == nullptr || w == nullptr)) return cudaErrorInvalidValue;
  const Args a{vval, vact, src_s, eid_s, n_edges, w, offsets, out, n_out,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return by_apply<float>(apply, op, a);
    case kI32: return by_apply<int32_t>(apply, op, a);
    default: return cudaErrorInvalidValue;
  }
}

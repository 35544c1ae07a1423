// Shuffle+Reduce (paper Fig. 7(c)) for Hopper: reduce a bin-sorted update
// stream into n_out bins with +, min or max, over float32 or int32.
//
// Replaces the Pallas TPU kernel kernels/shuffle_reduce.py
// (shuffle_reduce_sorted), which ran a (partitions x tiles) grid with a
// VMEM-resident output block and a one-hot MXU contraction per tile.
//
// Bound on this card: bytes. Each update is read once (4 B) and each bin's
// two offsets and one result are touched once, against one add or compare
// per update; at 3.35 TB/s the stream is the whole cost.
//
// Design: the caller hands in the stream sorted by bin plus
// offsets[n_out + 1] (the routing, precomputed once per bind on the
// engine's full-stream path). One warp owns one bin at a time and walks its
// range with the 32 lanes side by side, so the loads are coalesced; a
// __shfl_down_sync tree finishes the bin and lane 0 writes it, or the
// identity if the bin is empty. Warps grid-stride over the bins. There are
// no atomics: every bin is summed in one fixed order, so a float + gives
// the same bits on every run. A hub bin with many updates is walked by one
// warp alone, which is a known imbalance on power-law graphs.

#include "reduce_ops.cuh"

namespace repro {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
shuffle_reduce_kernel(const T* __restrict__ vals, int64_t n_vals,
                      const int32_t* __restrict__ offsets, T* __restrict__ out,
                      int64_t n_out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * warps_per_block;
  for (int64_t b = blockIdx.x * warps_per_block + (threadIdx.x >> 5); b < n_out;
       b += n_warps) {
    const int32_t lo = clamp_offset(offsets[b], n_vals);
    const int32_t hi = clamp_offset(offsets[b + 1], n_vals);
    T acc = Reduce<T, OP>::identity();
    for (int32_t i = lo + lane; i < hi; i += 32) {
      acc = Reduce<T, OP>::apply(acc, vals[i]);
    }
    acc = warp_reduce<T, OP>(acc);
    if (lane == 0) out[b] = acc;
  }
}

template <typename T, int OP>
static cudaError_t launch(const void* vals, int64_t n_vals, const void* offsets, void* out,
                          int64_t n_out, cudaStream_t stream) {
  shuffle_reduce_kernel<T, OP><<<grid_for(n_out), kThreads, 0, stream>>>(
      static_cast<const T*>(vals), n_vals, static_cast<const int32_t*>(offsets),
      static_cast<T*>(out), n_out);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t by_op(int op, const void* vals, int64_t n_vals, const void* offsets,
                         void* out, int64_t n_out, cudaStream_t stream) {
  switch (op) {
    case kSum: return launch<T, kSum>(vals, n_vals, offsets, out, n_out, stream);
    case kMin: return launch<T, kMin>(vals, n_vals, offsets, out, n_out, stream);
    case kMax: return launch<T, kMax>(vals, n_vals, offsets, out, n_out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// vals[n_vals] sorted by bin, offsets[n_out + 1] int32 (offsets outside
// [0, n_vals] are clamped into it, so no bin reads past the stream),
// out[n_out]; dtype and op are the codes of reduce_ops.cuh. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_shuffle_reduce(const void* vals, int64_t n_vals, const void* offsets,
                                    void* out, int64_t n_out, int dtype, int op,
                                    void* stream) {
  using namespace repro;
  if (n_out <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return by_op<float>(op, vals, n_vals, offsets, out, n_out, s);
    case kI32: return by_op<int32_t>(op, vals, n_vals, offsets, out, n_out, s);
    default: return cudaErrorInvalidValue;
  }
}

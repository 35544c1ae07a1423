// Capacity-binned MoE expert gather for Hopper: the dispatch step that
// turns expert-sorted token assignments into dense [G, E, C, D] bins.
//
// Replaces the Pallas TPU kernel kernels/moe_dispatch.py (moe_gather_call),
// which copied (block_c, D) token blocks at block-aligned group offsets
// carried by scalar prefetch: a static DMA schedule. Here
//
//   out[g, e, c, :] = x[g, rows[g, off[g, e] + c], :]   if c < size[g, e]
//                     0                                  otherwise
//
// with rows = NULL meaning rows[g, s] = s (exactly moe_gather_call on
// tokens_sorted). The row indirection lets the MoE layer gather straight
// from its token table through the expert-sorted assignment order, so the
// [T*k, D] sorted-token tensor is never written. Offsets need not be block
// aligned: that was a TPU DMA constraint. Stream slots are clamped into
// [0, R) and token rows into [0, T), so a bad offset cannot read past
// either array.
//
// Bound on this card: bytes. Each output row is written once and each live
// slot reads one token row; there is no arithmetic.
//
// Design: one block per output row (g, e, c), copying the row with 16-byte
// vectors along D (4-byte or 2-byte words when the row size or alignment
// does not allow 16). The copy is of bytes, so it is exact for any dtype.

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_moe {

constexpr int kThreads = 128;

template <typename V>
__global__ void __launch_bounds__(kThreads)
moe_gather_kernel(const V* __restrict__ x, const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ offsets, const int32_t* __restrict__ sizes,
                  V* __restrict__ out, int64_t n_tokens, int64_t n_stream, int64_t n_experts,
                  int64_t capacity, int64_t vecs) {
  const int64_t slot = blockIdx.x;
  const int64_t c = slot % capacity;
  const int64_t ge = slot / capacity;  // g * n_experts + e
  const int64_t g = ge / n_experts;
  V* dst = out + slot * vecs;
  if (c < sizes[ge] && n_stream > 0 && n_tokens > 0) {
    int64_t s = static_cast<int64_t>(offsets[ge]) + c;
    s = s < 0 ? 0 : (s >= n_stream ? n_stream - 1 : s);
    int64_t row = rows != nullptr ? static_cast<int64_t>(rows[g * n_stream + s]) : s;
    row = row < 0 ? 0 : (row >= n_tokens ? n_tokens - 1 : row);
    const V* src = x + (g * n_tokens + row) * vecs;
    for (int64_t i = threadIdx.x; i < vecs; i += kThreads) dst[i] = src[i];
  } else {
    const V zero{};
    for (int64_t i = threadIdx.x; i < vecs; i += kThreads) dst[i] = zero;
  }
}

template <typename V>
static cudaError_t launch(const void* x, const void* rows, const void* offsets,
                          const void* sizes, void* out, int64_t n_rows_out, int64_t n_tokens,
                          int64_t n_stream, int64_t n_experts, int64_t capacity,
                          int64_t row_bytes, cudaStream_t stream) {
  moe_gather_kernel<V><<<static_cast<unsigned>(n_rows_out), kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(sizes),
      static_cast<V*>(out), n_tokens, n_stream, n_experts, capacity,
      row_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace repro_moe

// x [G, T, row_bytes] contiguous; rows [G, R] int32 or NULL (then R = T);
// offsets, sizes [G, E] int32; out [G, E, C, row_bytes] contiguous. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_moe_gather(const void* x, const void* rows, const void* offsets,
                                const void* sizes, void* out, int64_t n_groups,
                                int64_t n_tokens, int64_t n_stream, int64_t n_experts,
                                int64_t capacity, int64_t row_bytes, void* stream) {
  using namespace repro_moe;
  const int64_t n_rows_out = n_groups * n_experts * capacity;
  if (n_rows_out <= 0 || row_bytes <= 0) return cudaSuccess;
  if (n_rows_out > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(x, rows, offsets, sizes, out, n_rows_out, n_tokens, n_stream,
                         n_experts, capacity, row_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(x, rows, offsets, sizes, out, n_rows_out, n_tokens, n_stream,
                            n_experts, capacity, row_bytes, s);
  if (align % 2 == 0)
    return launch<uint16_t>(x, rows, offsets, sizes, out, n_rows_out, n_tokens, n_stream,
                            n_experts, capacity, row_bytes, s);
  return launch<uint8_t>(x, rows, offsets, sizes, out, n_rows_out, n_tokens, n_stream,
                         n_experts, capacity, row_bytes, s);
}

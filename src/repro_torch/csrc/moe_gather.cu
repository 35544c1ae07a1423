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
// Design: one block per output row (g, e, c), consecutive blocks on
// consecutive rows. The block loads sizes[ge] and offsets[ge] together
// (neither waits for the other); a live slot then loads its token row
// (one broadcast load per warp) and copies it, each thread issuing all of
// its loads of a pass, kUnroll vectors of 16 bytes (4, 2 or 1 bytes when
// the row size or alignment does not allow 16), before the first of its
// stores; a slot past sizes[ge] is written with vector stores of zeros
// and no load. The copy is of bytes, so it is exact for any dtype.
//
// At Kimi-K2's prefill dispatch ([32, 384, 4, 7168] bf16) one block for
// a group's four rows, sharing the index loads, was measured slower than a
// block per row (PERF.md), so blocks do not share them.
//
// The gather's transpose (repro_moe_gather_bwd), for the gradient: replaces
// no TPU kernel (the reference differentiates its gather through XLA).
//
//   dx[g, t, :] = sum of dout[g, e, c, :] over the live slots (c < size[g, e])
//                 whose token row is t, in slot order
//
// The wrapper sorts the live slots of each group by token, stably, with
// torch (index bookkeeping): perm[g, :] lists the slots (e * C + c) token by
// token, tok_off[g, t] .. tok_off[g, t + 1] those of token t. One block per
// token row sums its slots' rows in that order in float32 and writes the
// row once in the input's dtype: no atomics, whose order in bf16 would
// change the bits from run to run. Bound on this card: bytes, each live
// slot's row read once and each token row written once; the index reads
// are a few bytes a slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_moe {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;  // vectors a thread loads before it stores

template <typename V>
__global__ void __launch_bounds__(kThreads)
moe_gather_kernel(const V* __restrict__ x, const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ offsets, const int32_t* __restrict__ sizes,
                  V* __restrict__ out, int64_t n_tokens, int64_t n_stream, int64_t n_experts,
                  int64_t capacity, int64_t vecs) {
  const int64_t slot = blockIdx.x;
  const int64_t c = slot % capacity;
  const int64_t ge = slot / capacity;  // g * n_experts + e
  const int64_t size = sizes[ge];
  const int64_t off = offsets[ge];
  V* dst = out + slot * vecs;
  if (c < size && n_stream > 0 && n_tokens > 0) {
    const int64_t g = ge / n_experts;
    int64_t s = off + c;
    s = s < 0 ? 0 : (s >= n_stream ? n_stream - 1 : s);
    int64_t row = rows != nullptr ? static_cast<int64_t>(rows[g * n_stream + s]) : s;
    row = row < 0 ? 0 : (row >= n_tokens ? n_tokens - 1 : row);
    const V* src = x + (g * n_tokens + row) * vecs;
    for (int64_t base = threadIdx.x; base < vecs; base += kThreads * kUnroll) {
      V r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kThreads < vecs) r[u] = src[base + u * kThreads];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kThreads < vecs) dst[base + u * kThreads] = r[u];
      }
    }
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

// ---------------------------------------------------------------------------
// the transpose: token rows summed over their slots
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add_vec(float* acc, float4 raw, float) {
  acc[0] += raw.x;
  acc[1] += raw.y;
  acc[2] += raw.z;
  acc[3] += raw.w;
}

__device__ __forceinline__ void add_vec(float* acc, float4 raw, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ float4 pack_vec(const float* acc, float) {
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ float4 pack_vec(const float* acc, __nv_bfloat16) {
  float4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  return raw;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one block per token row (g, t); VEC: 16-byte vectors (16 / sizeof(T)
// elements each) when the rows allow them, else one element a thread
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_gather_bwd_kernel(const T* __restrict__ dout, const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ tok_off, T* __restrict__ dx, int64_t n_tokens,
                      int64_t n_slots, int64_t d) {
  constexpr int kElems = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int64_t gt = blockIdx.x;  // g * n_tokens + t
  const int64_t g = gt / n_tokens;
  const int64_t lo = tok_off[gt + g], hi = tok_off[gt + g + 1];  // tok_off is [G, T + 1]
  const int32_t* slots = perm + g * n_slots;
  const T* base = dout + g * n_slots * d;
  T* dst = dx + gt * d;
  for (int64_t x = threadIdx.x; x * kElems < d; x += kThreads) {
    float acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = 0.f;
    for (int64_t s = lo; s < hi; ++s) {
      const T* row = base + static_cast<int64_t>(slots[s]) * d;
      if constexpr (VEC) {
        add_vec(acc, reinterpret_cast<const float4*>(row)[x], T{});
      } else {
        acc[0] += to_float(row[x]);
      }
    }
    if constexpr (VEC) {
      reinterpret_cast<float4*>(dst)[x] = pack_vec(acc, T{});
    } else {
      from_float(dst + x, acc[0]);
    }
  }
}

template <typename T>
static cudaError_t launch_bwd(const void* dout, const void* perm, const void* tok_off, void* dx,
                             int64_t n_groups, int64_t n_tokens, int64_t n_slots, int64_t d,
                             cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(n_groups * n_tokens);
  const uintptr_t align = reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dx) |
                          static_cast<uintptr_t>(d * sizeof(T));
  const T* src = static_cast<const T*>(dout);
  const int32_t* p = static_cast<const int32_t*>(perm);
  const int32_t* o = static_cast<const int32_t*>(tok_off);
  if (align % 16 == 0)
    moe_gather_bwd_kernel<T, true><<<blocks, kThreads, 0, stream>>>(src, p, o, static_cast<T*>(dx),
                                                                    n_tokens, n_slots, d);
  else
    moe_gather_bwd_kernel<T, false><<<blocks, kThreads, 0, stream>>>(src, p, o, static_cast<T*>(dx),
                                                                     n_tokens, n_slots, d);
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

// dout [G, n_slots, d] contiguous (n_slots = E * C, the gather's output);
// perm [G, n_slots] int32, each group's slots sorted by token (its live
// slots first); tok_off [G, n_tokens + 1] int32, token t's slots at
// perm[g, tok_off[g, t] .. tok_off[g, t + 1]); dx [G, n_tokens, d]
// contiguous, written in full. dtype 0: float32, 1: bfloat16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_moe_gather_bwd(const void* dout, const void* perm, const void* tok_off,
                                    void* dx, int64_t n_groups, int64_t n_tokens,
                                    int64_t n_slots, int64_t d, int dtype, void* stream) {
  using namespace repro_moe;
  if (n_groups <= 0 || n_tokens <= 0 || d <= 0) return cudaSuccess;
  if (n_groups * n_tokens > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(dout, perm, tok_off, dx, n_groups, n_tokens, n_slots, d, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(dout, perm, tok_off, dx, n_groups, n_tokens, n_slots, d, s);
  return cudaErrorInvalidValue;
}

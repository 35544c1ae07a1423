// Blocked online-softmax attention (FlashAttention) for Hopper in float32:
// float32 in, float32 products on the CUDA cores, float32 out. Every
// float32 attention of the port runs here; bfloat16 runs the tensor-core
// kernel csrc/flash_attention_sm90.cu. It has no bfloat16 instantiation:
// the wrapper routes by dtype and sends bfloat16 to the tensor-core kernel.
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py
// (flash_attention_call), which ran a (B*H, q blocks, k blocks) grid with
// the running max, sum and output block in VMEM scratch, and repeated the
// KV heads in memory for GQA before the call.
//
// What it computes, as the TPU kernel does: scale 1/sqrt(Dh); query i sits
// at position Lk - Lq + i (decode alignment); keys k < Lk, causal k <= the
// query position, sliding window k > position - window; float32 running
// max, sum and accumulator; the denominator clamped at 1e-30, so a row
// whose keys are all masked comes out 0, not NaN.
//
// Bound on this card: at decode (Lq = 1) bytes, the KV cache read once; at
// prefill operations, 4 * Lq * Lk * Dh per head (halved when causal), at
// 67 TFLOP/s for float32 outside the tensor cores. It keeps the plain
// version's float32 arithmetic (qwen3-0.6b's float32 decode-vs-forward
// check relies on it), so it does not use the tensor cores.
//
// Design: one block per (b, kv head, tile of 64 query rows). The rows of a
// tile enumerate (query head of the kv head's group, query position), so
// GQA shares each staged K/V tile between the group's heads and no KV head
// is repeated in memory; at decode the group's 8 heads fill one tile.
// Each query row is owned by Dh/32 threads, each holding 32 of its dims
// (q and the accumulator in registers); a score is their partial dots
// summed with __shfl_xor_sync. K and V tiles (32 keys, 16 at Dh = 256) are
// staged in shared memory as float4s. Each tile's scores are taken first,
// then the running max, sum and accumulator are rescaled once per tile.
// Strides are passed for q, k, v and out (the last dim contiguous), so the
// [B, L, H, Dh] activations and the [B, buf, Hkv, Dh] KV cache are read in
// place.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace repro_fa {

constexpr int kRows = 64;    // query rows per block
constexpr int kDimsPer = 32;  // head dims per thread
constexpr int kChunks = kDimsPer / 4;

struct Strides {
  int64_t b, h, l;  // element strides of the batch, head and position dims
};

// four consecutive floats in one 16-byte load (the wrapper checks the alignment)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DH>
__global__ void __launch_bounds__(kRows * (DH / kDimsPer))
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int n_heads,
                       int n_kv_heads, int lq, int lk, Strides sq, Strides sk, Strides sv,
                       Strides so, int causal, int window, float scale) {
  constexpr int kTpr = DH / kDimsPer;         // threads per query row
  constexpr int kKeys = DH <= 128 ? 32 : 16;  // keys per staged tile
  constexpr int kVecs = DH / 4;               // float4 chunks per key row
  __shared__ float4 ks[kKeys][kVecs];
  __shared__ float4 vs[kKeys][kVecs];
  __shared__ int s_lo, s_hi;

  const int group = n_heads / n_kv_heads;
  const int rows_total = group * lq;
  const int tiles = (rows_total + kRows - 1) / kRows;
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int kvh = bid % n_kv_heads;
  const int b = bid / n_kv_heads;

  const int tid = threadIdx.x;
  const int lane = tid % kTpr;
  const int r = tile * kRows + tid / kTpr;
  const bool active = r < rows_total;
  const int i = active ? r % lq : 0;
  const int h = kvh * group + (active ? r / lq : 0);
  const int q_pos = lk - lq + i;
  int lo = 0, hi = lk;  // this row's keys: [lo, hi)
  if (causal) hi = min(hi, q_pos + 1);
  if (window > 0) lo = max(lo, q_pos - window + 1);
  if (!active) hi = lo;

  if (tid == 0) {
    s_lo = lk;
    s_hi = 0;
  }
  __syncthreads();
  if (lane == 0 && hi > lo) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int k_begin = s_lo, k_end = s_hi;

  float4 qr[kChunks], acc[kChunks];
  const float* q_row = q + b * sq.b + h * sq.h + static_cast<int64_t>(i) * sq.l;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    qr[c] = active ? load4(q_row + 4 * (lane + kTpr * c)) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  const float* k_head = k + b * sk.b + kvh * sk.h;
  const float* v_head = v + b * sv.b + kvh * sv.h;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    const int n = min(kKeys, k_end - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKeys * kVecs; idx += blockDim.x) {
      const int j = idx / kVecs, c = idx % kVecs;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < n) {
        kv = load4(k_head + static_cast<int64_t>(k0 + j) * sk.l + 4 * c);
        vv = load4(v_head + static_cast<int64_t>(k0 + j) * sv.l + 4 * c);
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) d = dot4(qr[c], ks[j][lane + kTpr * c], d);
#pragma unroll
      for (int o = kTpr / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      const int kp = k0 + j;
      s[j] = (j < n && kp >= lo && kp < hi) ? d * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    if (tile_max == -INFINITY) continue;  // no key of this tile reaches this row
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first live tile (m = -inf)
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vs[j][lane + kTpr * c];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float denom = fmaxf(l, 1e-30f);
  float* o_row = out + b * so.b + h * so.h + static_cast<int64_t>(i) * so.l;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 a = acc[c];
    *reinterpret_cast<float4*>(o_row + 4 * (lane + kTpr * c)) =
        make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
  }
}

static cudaError_t launch(int dh, const float* q, const float* k, const float* v, float* out,
                          int batch, int n_heads, int n_kv_heads, int lq, int lk,
                          const Strides* st, int causal, int window, float scale,
                          cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(n_heads / n_kv_heads) * lq;
  const int64_t blocks = static_cast<int64_t>(batch) * n_kv_heads * ((rows + kRows - 1) / kRows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (dh) {
#define REPRO_FA_CASE(D)                                                                   \
  case D:                                                                                  \
    flash_attention_kernel<D><<<grid, kRows * (D / kDimsPer), 0, stream>>>(                \
        q, k, v, out, n_heads, n_kv_heads, lq, lk, st[0], st[1], st[2], st[3], causal,     \
        window, scale);                                                                    \
    break;
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
#undef REPRO_FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace repro_fa

// q [B, H, Lq, Dh], k/v [B, Hkv, Lk, Dh], out [B, H, Lq, Dh], all float32,
// given by their data pointers and strides[12] = (batch, head, position)
// element strides of q, k, v, out in that order, the last dim contiguous
// and every row aligned for a 16-byte load. Dh is 32, 64, 128 or 256; H is
// a multiple of Hkv. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int batch, int n_heads, int n_kv_heads, int lq, int lk,
                                     int dh, const int64_t* strides, int causal, int window,
                                     float scale, void* stream) {
  using namespace repro_fa;
  if (batch <= 0 || lq <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lk < 0) return cudaErrorInvalidValue;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  return launch(dh, static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out), batch, n_heads,
                n_kv_heads, lq, lk, st, causal, window, scale, static_cast<cudaStream_t>(stream));
}

// Backward pass of blocked softmax attention (FlashAttention-2 order) for
// Hopper, float32 in and out, float32 arithmetic on the CUDA cores. Every
// float32 attention backward of the port runs here; bfloat16 runs
// csrc/flash_attention_bwd_sm90.cu on the tensor cores.
//
// Replaces no TPU kernel: the reference trains through plain JAX, where
// XLA differentiates its naive attention (models/attention.py, _sdpa). The
// port's forward runs every float32 attention through the hand-written
// flash_attention.cu, which autograd cannot see into, so
// kernels/flash_attention.py wraps it in FlashAttentionFn and its backward
// launches this source.
//
// What it computes, for the forward's semantics (scale, causal mask,
// sliding window, query i at position Lk - Lq + i, GQA with H a multiple
// of Hkv, values of Dv <= Dqk columns):
//   P  = softmax(scale * Q K^T) over the keys a row sees (recomputed),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// with the query heads of a kv head summed into its dK and dV. Masked
// pairs have P = 0. A row that sees no key has no gradient.
//
// Bound on this card: operations. The least work is the three products of
// a visible (query, key) pair that the backward cannot avoid, 2 * (3 Dqk +
// 2 Dv) FLOPs (S, dP, dV, dQ, dK); this source recomputes S three times
// and dP twice, 2 * (5 Dqk + 3 Dv) FLOPs a pair, on the CUDA cores
// (67 TFLOP/s in float32).
//
// Three kernels, launched in order on the caller's stream:
// (a) row_stats: one block per (batch, head, 64 query rows). It walks the
//     key tiles its rows see and keeps each row's running max and sum of
//     exp (the sum as per-thread partials, rescaled with the shared max,
//     reduced over the row's 16 threads at the end), writing
//     lse = max + log(sum) and delta = rowsum(dO o O), both float32, into
//     scratch the wrapper allocated.
// (b) dkdv: one block per (batch, kv head, 64 keys). K and V of its keys
//     stay in shared memory; it walks every query head of the group, and
//     in each the query tiles that see any of its keys, recomputes S and
//     dP for the tile, stores P^T and dS^T in shared memory and adds
//     P^T dO and dS^T Q into its keys' dV and dK, kept in registers. No
//     atomics: the group is summed inside the block.
// (c) dq: one block per (batch, head, 64 query rows), walking the key
//     tiles its rows see: S and dP again, dS into shared memory, dQ +=
//     dS K in registers.
// A block's 256 threads are 16 x 16: thread (ty, tx) scores rows ty + 16 i
// against keys tx + 16 j (i, j < 4) of a tile, and in the products it
// holds rows (or keys) ty + 16 i and columns tx + 16 c. Tiles lie in
// shared memory as float32 rows padded by one float, so the 16 keys (or
// rows) a half warp reads at one column fall in 16 banks. Every sum is
// taken in an order the shape alone fixes (the head, tile, key and column
// loops run in order; the two 16-lane shuffles always pair the same
// lanes), so the same inputs give the same bits on every call.
//
// Widths. The kernels are instantiated, in float32 only, at the (DK, DV) of
// REPRO_FA_BWD_WIDTHS; a call takes the narrowest that holds its
// (Dqk, Dv) (pick, asked through repro_flash_attention_bwd_widths). The
// dot products run over the real Dqk and Dv; the padding columns are
// zeros and are not stored.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace repro_fa_bwd {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows of a row tile, keys of a key tile
constexpr int kFrag = 4;   // rows (keys) a thread scores: kTile / 16

struct Strides {
  int64_t b, h, l;  // element strides of the batch, head and position dims
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows [r0, r0 + kTile) of one (batch, head) slice into shared memory as
// float32, kTile x (D + 1): columns past `width` and rows past `n` are zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride_l, int r0,
                                          int n, int width) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r0 + r < n && d < width) x = to_f(src[(r0 + r) * stride_l + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// the position window [lo, hi) of keys that some query of rows [r0, r1) sees
__device__ __forceinline__ void key_range(int r0, int r1, int lq, int lk, int causal, int window,
                                          int* lo, int* hi) {
  const int off = lk - lq;
  *lo = window > 0 ? max(0, off + r0 - window + 1) : 0;
  *hi = causal ? min(lk, off + r1) : lk;
}

__device__ __forceinline__ bool visible(int qpos, int key, int causal, int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// (a) row statistics: lse and delta of every query row
// ---------------------------------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                 const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
                 int n_heads, int n_kv_heads, int lq, int lk, int dqk, int dv, Strides sq,
                 Strides sk, Strides so, Strides sdo, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][DK + 1]
  float* ks = qs + kTile * (DK + 1);      // [kTile][DK + 1]
  const int tiles = (lq + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int b = bh / n_heads, h = bh % n_heads, hk = h / (n_heads / n_kv_heads);
  const int r0 = tile * kTile, r1 = min(lq, r0 + kTile);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const int off = lk - lq;

  // delta: four threads a row, each summing every fourth column
  {
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.f;
    if (r0 + r < lq) {
      const T* orow = o + b * so.b + h * so.h + (r0 + r) * so.l;
      const T* grow = dout + b * sdo.b + h * sdo.h + (r0 + r) * sdo.l;
      for (int d = part; d < dv; d += 4) acc = fmaf(to_f(grow[d]), to_f(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && r0 + r < lq) delta[static_cast<int64_t>(bh) * lq + r0 + r] = acc;
  }

  load_tile<DK>(qs, qb, sq.l, r0, lq, dqk);
  float m[kFrag], l[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int lo, hi;
  key_range(r0, r1, lq, lk, causal, window, &lo, &hi);
  for (int kt = lo / kTile; kt * kTile < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<DK>(ks, kb, sk.l, k0, lk, dqk);
    __syncthreads();
    float s[kFrag][kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i)
#pragma unroll
      for (int j = 0; j < kFrag; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dqk; ++d) {
      float a[kFrag], c[kFrag];
#pragma unroll
      for (int i = 0; i < kFrag; ++i) a[i] = qs[(ty + 16 * i) * (DK + 1) + d];
#pragma unroll
      for (int j = 0; j < kFrag; ++j) c[j] = ks[(tx + 16 * j) * (DK + 1) + d];
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kFrag; ++i) {
      const int qpos = off + r0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFrag; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = (key < lk && visible(qpos, key, causal, window)) ? s[i][j] * scale
                                                                     : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(tmax));
      if (m_new == -INFINITY) continue;  // the row has seen no key yet
      float part = l[i] * expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < kFrag; ++j)
        if (s[i][j] != -INFINITY) part += expf(s[i][j] - m_new);
      l[i] = part;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const float total = sum16(l[i]);
    const int r = r0 + ty + 16 * i;
    if (tx == 0 && r < lq)
      lse[static_cast<int64_t>(bh) * lq + r] = total > 0.f ? m[i] + logf(total) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// S and dP of one (row tile, key tile) pair, for thread (ty, tx): rows
// a-side ty + 16 i, b-side tx + 16 j, from two [kTile][D + 1] tiles each
// ---------------------------------------------------------------------------

template <int DK, int DV>
__device__ __forceinline__ void scores(const float* a_qk, const float* b_qk, const float* a_v,
                                       const float* b_v, int dqk, int dv, int ty, int tx,
                                       float (&s)[kFrag][kFrag], float (&dp)[kFrag][kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i)
#pragma unroll
    for (int j = 0; j < kFrag; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  for (int d = 0; d < dqk; ++d) {
    float a[kFrag], c[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i) a[i] = a_qk[(ty + 16 * i) * (DK + 1) + d];
#pragma unroll
    for (int j = 0; j < kFrag; ++j) c[j] = b_qk[(tx + 16 * j) * (DK + 1) + d];
#pragma unroll
    for (int i = 0; i < kFrag; ++i)
#pragma unroll
      for (int j = 0; j < kFrag; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
  }
  for (int d = 0; d < dv; ++d) {
    float a[kFrag], c[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i) a[i] = a_v[(ty + 16 * i) * (DV + 1) + d];
#pragma unroll
    for (int j = 0; j < kFrag; ++j) c[j] = b_v[(tx + 16 * j) * (DV + 1) + d];
#pragma unroll
    for (int i = 0; i < kFrag; ++i)
#pragma unroll
      for (int j = 0; j < kFrag; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
  }
}

// ---------------------------------------------------------------------------
// (b) dK and dV of one key tile of one kv head
// ---------------------------------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dvo,
            int n_heads, int n_kv_heads, int lq, int lk, int dqk, int dv, Strides sq, Strides sk,
            Strides sv, Strides sdo, Strides sdk, Strides sdv, int causal, int window,
            float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [kTile][DK + 1] the block's keys
  float* vs = ks + kTile * (DK + 1);     // [kTile][DV + 1] their values
  float* qs = vs + kTile * (DV + 1);     // [kTile][DK + 1] a query tile
  float* dos = qs + kTile * (DK + 1);    // [kTile][DV + 1] its dO
  float* pt = dos + kTile * (DV + 1);    // [kTile keys][kTile + 1] P^T
  float* dst = pt + kTile * (kTile + 1);  // [kTile keys][kTile + 1] dS^T
  float* lse_s = dst + kTile * (kTile + 1);  // [kTile]
  float* delta_s = lse_s + kTile;            // [kTile]
  constexpr int CK = DK / 16, CV = DV / 16;  // columns a thread accumulates
  const int tiles = (lk + kTile - 1) / kTile;
  const int bhk = blockIdx.x / tiles, kt = blockIdx.x % tiles;
  const int b = bhk / n_kv_heads, hk = bhk % n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const int k0 = kt * kTile, k1 = min(lk, k0 + kTile);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = lk - lq;

  load_tile<DK>(ks, k + b * sk.b + hk * sk.h, sk.l, k0, lk, dqk);
  load_tile<DV>(vs, v + b * sv.b + hk * sv.h, sv.l, k0, lk, dv);
  float acc_k[kFrag][CK], acc_v[kFrag][CV];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
#pragma unroll
    for (int c = 0; c < CK; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc_v[i][c] = 0.f;
  }
  // the query rows that see some key of [k0, k1)
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(lq, k1 - 1 + window - off) : lq;
  for (int gi = 0; gi < group && i_lo < i_hi; ++gi) {
    const int h = hk * group + gi;
    const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h) * lq;
    for (int t = i_lo / kTile; t * kTile < i_hi; ++t) {
      const int r0 = t * kTile;
      __syncthreads();  // the previous tile's reads are done
      load_tile<DK>(qs, q + b * sq.b + h * sq.h, sq.l, r0, lq, dqk);
      load_tile<DV>(dos, dout + b * sdo.b + h * sdo.h, sdo.l, r0, lq, dv);
      if (threadIdx.x < kTile) {
        const int r = r0 + threadIdx.x;
        lse_s[threadIdx.x] = r < lq ? lse[row_base + r] : INFINITY;
        delta_s[threadIdx.x] = r < lq ? delta[row_base + r] : 0.f;
      }
      __syncthreads();
      float s[kFrag][kFrag], dp[kFrag][kFrag];
      // keys ty + 16 i against queries tx + 16 j
      scores<DK, DV>(ks, qs, vs, dos, dqk, dv, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < kFrag; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kFrag; ++j) {
          const int qi = tx + 16 * j, row = r0 + qi;
          float p = 0.f;
          if (key < lk && row < lq && visible(off + row, key, causal, window))
            p = expf(s[i][j] * scale - lse_s[qi]);
          pt[(ty + 16 * i) * (kTile + 1) + qi] = p;
          dst[(ty + 16 * i) * (kTile + 1) + qi] = p * (dp[i][j] - delta_s[qi]);
        }
      }
      __syncthreads();
      for (int qi = 0; qi < kTile; ++qi) {
        float pv[kFrag], ds[kFrag];
#pragma unroll
        for (int i = 0; i < kFrag; ++i) {
          pv[i] = pt[(ty + 16 * i) * (kTile + 1) + qi];
          ds[i] = dst[(ty + 16 * i) * (kTile + 1) + qi];
        }
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          const float g = dos[qi * (DV + 1) + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kFrag; ++i) acc_v[i][c] = fmaf(pv[i], g, acc_v[i][c]);
        }
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const float x = qs[qi * (DK + 1) + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kFrag; ++i) acc_k[i][c] = fmaf(ds[i], x, acc_k[i][c]);
        }
      }
    }
  }
  T* dkb = dk + b * sdk.b + hk * sdk.h;
  T* dvb = dvo + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= lk) continue;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int d = tx + 16 * c;
      if (d < dqk) store(dkb + key * sdk.l + d, acc_k[i][c] * scale);
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int d = tx + 16 * c;
      if (d < dv) store(dvb + key * sdv.l + d, acc_v[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dQ of one query tile of one head
// ---------------------------------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int n_heads, int n_kv_heads,
          int lq, int lk, int dqk, int dv, Strides sq, Strides sk, Strides sv, Strides sdo,
          Strides sdq, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][DK + 1] the block's rows
  float* dos = qs + kTile * (DK + 1);     // [kTile][DV + 1] their dO
  float* ks = dos + kTile * (DV + 1);     // [kTile][DK + 1] a key tile
  float* vs = ks + kTile * (DK + 1);      // [kTile][DV + 1] its values
  float* dss = vs + kTile * (DV + 1);     // [kTile rows][kTile + 1] dS
  float* lse_s = dss + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;
  constexpr int CK = DK / 16;
  const int tiles = (lq + kTile - 1) / kTile;
  // the last row tiles (under a causal mask, the most keys) first
  const int bh = blockIdx.x % (gridDim.x / tiles);
  const int tile = tiles - 1 - blockIdx.x / (gridDim.x / tiles);
  const int b = bh / n_heads, h = bh % n_heads, hk = h / (n_heads / n_kv_heads);
  const int r0 = tile * kTile, r1 = min(lq, r0 + kTile);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = lk - lq;
  const int64_t row_base = static_cast<int64_t>(bh) * lq;

  load_tile<DK>(qs, q + b * sq.b + h * sq.h, sq.l, r0, lq, dqk);
  load_tile<DV>(dos, dout + b * sdo.b + h * sdo.h, sdo.l, r0, lq, dv);
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    lse_s[threadIdx.x] = r < lq ? lse[row_base + r] : INFINITY;
    delta_s[threadIdx.x] = r < lq ? delta[row_base + r] : 0.f;
  }
  float acc[kFrag][CK];
#pragma unroll
  for (int i = 0; i < kFrag; ++i)
#pragma unroll
    for (int c = 0; c < CK; ++c) acc[i][c] = 0.f;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  int lo, hi;
  key_range(r0, r1, lq, lk, causal, window, &lo, &hi);
  for (int kt = lo / kTile; kt * kTile < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<DK>(ks, kb, sk.l, k0, lk, dqk);
    load_tile<DV>(vs, vb, sv.l, k0, lk, dv);
    __syncthreads();
    float s[kFrag][kFrag], dp[kFrag][kFrag];
    // rows ty + 16 i against keys tx + 16 j
    scores<DK, DV>(qs, ks, dos, vs, dqk, dv, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kFrag; ++i) {
      const int ri = ty + 16 * i, row = r0 + ri;
#pragma unroll
      for (int j = 0; j < kFrag; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;
        if (key < lk && row < lq && visible(off + row, key, causal, window))
          ds = expf(s[i][j] * scale - lse_s[ri]) * (dp[i][j] - delta_s[ri]);
        dss[ri * (kTile + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float ds[kFrag];
#pragma unroll
      for (int i = 0; i < kFrag; ++i) ds[i] = dss[(ty + 16 * i) * (kTile + 1) + j];
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float x = ks[j * (DK + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kFrag; ++i) acc[i][c] = fmaf(ds[i], x, acc[i][c]);
      }
    }
  }
  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= lq) continue;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int d = tx + 16 * c;
      if (d < dqk) store(dqb + row * sdq.l + d, acc[i][c] * scale);
    }
  }
}

// dynamic shared memory of each kernel at widths (DK, DV), bytes
template <int DK, int DV>
struct Smem {
  static constexpr int stats = 4 * 2 * kTile * (DK + 1);
  static constexpr int dkdv =
      4 * (2 * kTile * (DK + 1) + 2 * kTile * (DV + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
  static constexpr int dq =
      4 * (2 * kTile * (DK + 1) + 2 * kTile * (DV + 1) + kTile * (kTile + 1) + 2 * kTile);
  static_assert(dkdv <= 232448 && dq <= 232448, "shared memory of a block");
};

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>& done) {
  if (done.load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.store(true, std::memory_order_release);
  return err;
}

template <typename T, int DK, int DV>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* dk, void* dv_out, float* lse,
                          float* delta, int batch, int n_heads, int n_kv_heads, int lq, int lk,
                          int dqk, int dv, const Strides* st, int causal, int window,
                          float scale, cudaStream_t stream) {
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DV <= DK, "widths");
  using S = Smem<DK, DV>;
  static std::atomic<bool> set_a{false}, set_b{false}, set_c{false};
  cudaError_t err;
  if ((err = allow_smem(row_stats_kernel<T, DK, DV>, S::stats, set_a)) != cudaSuccess) return err;
  if ((err = allow_smem(dkdv_kernel<T, DK, DV>, S::dkdv, set_b)) != cudaSuccess) return err;
  if ((err = allow_smem(dq_kernel<T, DK, DV>, S::dq, set_c)) != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* gt = static_cast<const T*>(dout);
  // st: q, k, v, o, dout, dq, dk, dv
  const int64_t q_tiles = static_cast<int64_t>(batch) * n_heads * ((lq + kTile - 1) / kTile);
  const int64_t k_tiles = static_cast<int64_t>(batch) * n_kv_heads * ((lk + kTile - 1) / kTile);
  if (q_tiles > 0x7fffffff || k_tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (q_tiles > 0) {
    row_stats_kernel<T, DK, DV><<<static_cast<unsigned>(q_tiles), kThreads, S::stats, stream>>>(
        qt, kt, ot, gt, lse, delta, n_heads, n_kv_heads, lq, lk, dqk, dv, st[0], st[1], st[3],
        st[4], causal, window, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (k_tiles > 0) {
    dkdv_kernel<T, DK, DV><<<static_cast<unsigned>(k_tiles), kThreads, S::dkdv, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv_out), n_heads,
        n_kv_heads, lq, lk, dqk, dv, st[0], st[1], st[2], st[4], st[6], st[7], causal, window,
        scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (q_tiles > 0) {
    dq_kernel<T, DK, DV><<<static_cast<unsigned>(q_tiles), kThreads, S::dq, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), n_heads, n_kv_heads, lq, lk, dqk, dv,
        st[0], st[1], st[2], st[4], st[5], causal, window, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The instantiations (DK, DV), narrowest first: the smoke configs (32, and
// MLA's (48, 32) at 64), the full configs' 128 (hubert's and zamba2's 80,
// h2o-danube's 120), deepseek-v2's MLA (192, 128).
#define REPRO_FA_BWD_WIDTHS(X) \
  X(32, 32)                    \
  X(64, 64)                    \
  X(128, 128)                  \
  X(192, 128)

// The instantiation that takes (dqk, dv): the first of REPRO_FA_BWD_WIDTHS
// at least as wide in both, into widths[0..1]; false when none is or dv > dqk.
static bool pick(int dqk, int dv, int* widths) {
  if (dqk <= 0 || dv <= 0 || dv > dqk) return false;
#define REPRO_FA_BWD_PICK(DK, DV) \
  if (dqk <= DK && dv <= DV) {    \
    widths[0] = DK;               \
    widths[1] = DV;               \
    return true;                  \
  }
  REPRO_FA_BWD_WIDTHS(REPRO_FA_BWD_PICK)
#undef REPRO_FA_BWD_PICK
  return false;
}

}  // namespace repro_fa_bwd

// q [B, H, Lq, Dqk], k [B, Hkv, Lk, Dqk], v [B, Hkv, Lk, Dv], o and dout
// [B, H, Lq, Dv] (the forward's output and its gradient); dq, dk, dv the
// gradients, each the shape of its input. All float32, given by their
// data pointers and strides[24] =
// (batch, head, position) element strides of q, k, v, o, dout, dq, dk, dv
// in that order, the last dim contiguous. lse and delta: float32 scratch
// of B * H * Lq each, which the kernels write and read. (Dqk, Dv) is a pair
// repro_flash_attention_bwd_widths takes; H is a multiple of Hkv. Launches
// the row-statistics, dK/dV and dQ kernels in order; returns the first
// CUDA error (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv_out, void* lse, void* delta, int batch, int n_heads, int n_kv_heads, int lq, int lk,
                                         int dqk, int dv, const int64_t* strides, int causal,
                                         int window, float scale, void* stream) {
  using namespace repro_fa_bwd;
  if (batch <= 0 || n_heads <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lq < 0 || lk < 0)
    return cudaErrorInvalidValue;
  int w[2];
  if (!pick(dqk, dv, w)) return cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
#define REPRO_FA_BWD_CASE(DK, DV)                                                            \
  if (w[0] == DK && w[1] == DV)                                                              \
    return launch<float, DK, DV>(q, k, v, o, dout, dq, dk, dv_out, lse_f, delta_f, batch,    \
                                 n_heads, n_kv_heads, lq, lk, dqk, dv, st, causal, window,   \
                                 scale, s);
  REPRO_FA_BWD_WIDTHS(REPRO_FA_BWD_CASE)
#undef REPRO_FA_BWD_CASE
  return cudaErrorInvalidValue;
}

// The widths (DK, DV) of the instantiation a (dqk, dv) backward runs at,
// into widths[2]: 0, or -1 for a pair no instantiation takes.
extern "C" int repro_flash_attention_bwd_widths(int dqk, int dv, int* widths) {
  return repro_fa_bwd::pick(dqk, dv, widths) ? 0 : -1;
}

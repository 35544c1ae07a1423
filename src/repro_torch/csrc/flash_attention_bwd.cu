// Backward pass of blocked softmax attention (FlashAttention-2 order) for
// Hopper, float32 in and out, float32 FFMA on the CUDA cores (no TF32, no
// tensor cores, no library product). Every float32 attention backward of
// the port runs here; bfloat16 runs csrc/flash_attention_bwd_sm90.cu on
// the tensor cores.
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
//   P  = exp2(scale * log2(e) * Q K^T - lse) over the keys a row sees,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// with the query heads of a kv head summed into its dK and dV. lse is each
// query row's log-sum-exp in the log2 domain of the scaled scores, m +
// log2(sum(exp2(x - m))) with x = scale * log2(e) * q.k, +inf for a row
// that sees no key: what the forward's tile route writes beside its output
// (csrc/flash_attention.cu, repro_flash_attention with lse). Masked pairs
// have P = 0; a row that sees no key has no gradient.
//
// Bound on this card: operations. The least work is the five products of
// a visible (query, key) pair, 2 * (3 Dqk + 2 Dv) FLOPs (S, dP, dV, dQ,
// dK), at 67 TFLOP/s in float32 FFMA; this source does exactly that work
// (S and dP once a pair) and moves dQ's parts through device memory once.
//
// The first design ran at 17% of the bound at qwen3's shape. What
// held it back, and what this one does about each:
// 1. S three times and dP twice, 1.6x the least work at 128: a first
//    kernel walked every key tile to rebuild the log-sum-exp the forward
//    already had, and dQ's kernel computed S and dP again. Here the forward
//    gives the lse (the wrapper runs the forward's tile route with it where
//    a caller has none), the first kernel only sums delta = rowsum(dO o O)
//    (bound by bytes), and dQ is computed beside dK and dV: each key tile
//    writes its part dS K of every query row it meets to scratch, and a
//    last kernel sums the parts in key-tile order (no atomics). On the
//    H100 this ran faster than a separate dQ kernel that computed S and dP
//    again (PERF.md section 6); the scratch is [key tiles][B H Lq][Dqk]
//    floats, 2.15 GB at qwen3's [4, 16, 2048, 128].
// 2. Small register fragments and scalar shared loads (4 x 4 scores a
//    thread, about 2.7 FMA a load). Here a block's 256 threads are a 16 x
//    16 grid (a, b); thread (a, b) holds R = 4 keys a + 16 i against C = 4
//    (2 at Dqk 192) query rows b + 16 j: 4 R C FMAs for R + C 16-byte
//    shared loads in the score products, and in the gradient products 4 R
//    (kDK + kDV) FMAs for R / 2 + (kDK + kDV) / 4 loads a query row. Its
//    times on the H100 fit a warp's 16-byte shared load taking 4 cycles of
//    the SM's shared memory (512 bytes at 128 a cycle), what 16 FFMAs a
//    thread take on its CUDA cores; at 8-10.7 FMAs a load these loops are
//    then bound by shared memory, not by the FFMA pipes. Larger
//    fragments need larger tiles, and the resident K and V, two stages of
//    Q and dO, and P^T and dS^T already fill 227 KB at 128. Q,
//    K, V and dO tiles lie row by row with their 16-byte chunks swizzled
//    (chunk c of row r at c ^ (r & 7)), P^T and dS^T with theirs (chunk a
//    of row r at a ^ (r & 7)), so no load or transposing store meets a
//    bank conflict.
// 3. Synchronous loads, one 8-warp block an SM, nothing ahead. Here the
//    streamed operand (Q, dO and their rows' lse and delta) arrives by
//    cp.async in two stages: tile t + 1 is in flight while tile t is
//    computed. Shared memory still holds one block an SM (230,400 bytes at
//    128), so the stages are what hides the loads.
// 4. Work order and masks. The blocks take the key tiles in order (under a
//    causal mask the first keys see the most queries); each walks only the
//    query tiles that see some key of its own, and tests key by key only
//    on a pair of tiles not inside every row's keys (a warp-uniform branch:
//    the 16 tests of a thread cost nothing beside its 4,096 FMAs of a tile
//    pair, so the masked and unmasked tiles share one loop).
//
// Three kernels, launched in order on the caller's stream:
// (a) delta: one warp per query row, 16-byte loads of dO and O, a sum the
//     shape fixes (lanes' partials in column order, then five shuffles).
// (b) dkdv: one block per (batch, kv head, 64 keys). K and V of its keys
//     stay in shared memory; it streams the query tiles of every query head
//     of the group that see any of its keys. Per tile: S^T and dP^T (keys x
//     queries) in registers, P^T and dS^T into shared memory, then dV +=
//     P^T dO and dK += dS^T Q in registers (thread (a, b) holds keys a + 16
//     i and the columns of dK and dV that b names), then the tile's rows'
//     part of dQ, dS K over the block's keys, into dq_part. No atomics: the
//     group is summed inside the block.
// (c) dq_reduce: dQ of a query row is scale times the sum of the parts of
//     the key tiles its query tile meets, in key-tile order.
// Every sum is taken in an order the shape alone fixes (the head, tile,
// key, query and column loops run in order; the shuffles always pair the
// same lanes), so the same inputs give the same bits on every call.
//
// Widths. The kernels are instantiated, in float32 only, at the (DK, DV) of
// REPRO_FA_BWD_WIDTHS; a call takes the narrowest that holds its (Dqk,
// Dv), both multiples of 4 (16-byte rows, as the forward takes them; pick,
// asked through repro_flash_attention_bwd_widths). Columns past Dqk and Dv
// are loaded as zeros and add nothing; they are not stored.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace repro_fa_bwd {

constexpr int kThreads = 256;
constexpr int kGroups = 16;  // values of a and of b: a block is a 16 x 16 grid
constexpr int kR = 4;        // rows of the resident tile a thread holds
constexpr int kStages = 2;   // cp.async stages of the streamed tile

struct Strides {
  int64_t b, h, l;  // element strides of the batch, head and position dims
};

// Tiles and per-thread fragments of an instantiation (DK, DV): a block keeps
// kA = 16 R keys resident and streams query tiles of kB = 16 C rows.
template <int DK, int DV>
struct Shape {
  static_assert(DK % 32 == 0 && DV % 32 == 0 && DV <= DK, "widths");
  static constexpr int R = kR;
  static constexpr int C = DK <= 128 ? 4 : 2;  // streamed rows a thread scores
  static constexpr int kA = kGroups * R;       // resident rows of a block
  static constexpr int kB = kGroups * C;       // rows of a streamed tile
  static constexpr int kDK = DK / kGroups;     // dK (dQ) columns a thread holds
  static constexpr int kDV = DV / kGroups;     // dV columns a thread holds
  static constexpr int kWK = kDK < 4 ? kDK : 4;  // ... loaded kWK at a time
  static constexpr int kWV = kDV < 4 ? kDV : 4;
  // floats of a block's shared memory: K and V, the stages of Q, dO and
  // their rows' lse and delta, P^T and dS^T
  static constexpr int kSmemFloats =
      kA * (DK + DV) + kStages * (kB * (DK + DV) + 2 * kB) + 2 * kB * kA;
  static constexpr int kSmemBytes = 4 * kSmemFloats;
  static_assert(kSmemBytes <= 232448, "shared memory of a block");
};

// thread (a, b) of the 16 x 16 grid: warp w holds a in {2 w, 2 w + 1} and
// every b
__device__ __forceinline__ int grid_a(int tid) { return tid / kGroups; }
__device__ __forceinline__ int grid_b(int tid) { return tid % kGroups; }

// the float at column col of row r of a swizzled [rows][DH] tile (DH >= 32)
template <int DH>
__device__ __forceinline__ int swz(int r, int col) {
  return r * DH + 4 * ((col >> 2) ^ (r & 7)) + (col & 3);
}

// N consecutive floats (N = 1, 2 or 4) in one shared-memory access
template <int N>
__device__ __forceinline__ void ld_vec(float* x, const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros
// where !valid (src is then not read, but must still be a device address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + n) of one (batch, head) slice, `width` of their DH columns
// (a multiple of 4), into a swizzled [n][DH] tile; zeros past `rows` and
// past `width`
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride_l, int r0,
                                          int n, int rows, int width, const float* any) {
  constexpr int kC4 = DH / 4;
  for (int e = threadIdx.x; e < n * kC4; e += kThreads) {
    const int r = e / kC4, c = e % kC4;
    const bool ok = r0 + r < rows && 4 * c < width;
    cp_async16(dst + swz<DH>(r, 4 * c), ok ? src + static_cast<int64_t>(r0 + r) * stride_l + 4 * c
                                           : any,
               ok);
  }
}

// n floats of a row statistic (lse or delta) from [r0, r0 + n), zeros past `rows`
__device__ __forceinline__ void load_stat(float* dst, const float* src, int r0, int n, int rows) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const bool ok = r0 + e < rows;
    cp_async4(dst + e, ok ? src + r0 + e : src, ok);
  }
}

__device__ __forceinline__ bool visible(int qpos, int key, int causal, int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// Every query row of [r0, r0 + nr) sees every key of [k0, k0 + nk): the
// rows and keys all exist, and the mask spares every pair.
__device__ __forceinline__ bool inside(int r0, int nr, int k0, int nk, int lq, int lk, int off,
                                       int causal, int window) {
  const int r_last = r0 + nr - 1, k_last = k0 + nk - 1;
  return r_last < lq && k_last < lk && (!causal || k_last <= off + r0) &&
         (window <= 0 || k0 > off + r_last - window);
}

// X[i][j] += (row a + 16 i of ta) . (row b + 16 j of tb), two swizzled
// tiles of width DH (zeros past the call's width): R + C float4 loads and
// 4 R C FMAs a chunk of 4 columns
template <int DH, int R, int C>
__device__ __forceinline__ void products(const float* ta, const float* tb, int a, int b,
                                         float (&x)[R][C]) {
#pragma unroll 8
  for (int c = 0; c < DH / 4; ++c) {
    float bf[C][4];
#pragma unroll
    for (int j = 0; j < C; ++j) ld_vec<4>(bf[j], tb + swz<DH>(b + kGroups * j, 4 * c));
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float af[4];
      ld_vec<4>(af, ta + swz<DH>(a + kGroups * i, 4 * c));
#pragma unroll
      for (int j = 0; j < C; ++j) {
        x[i][j] = fmaf(af[0], bf[j][0], x[i][j]);
        x[i][j] = fmaf(af[1], bf[j][1], x[i][j]);
        x[i][j] = fmaf(af[2], bf[j][2], x[i][j]);
        x[i][j] = fmaf(af[3], bf[j][3], x[i][j]);
      }
    }
  }
}

// the resident row slots of thread a in a [rows][kA] tile of P^T, dS^T or
// dS: chunk a of row r, swizzled
template <int KA>
__device__ __forceinline__ int slot(int r, int a) {
  return r * KA + 4 * (a ^ (r & 7));
}

// ---------------------------------------------------------------------------
// (a) delta = rowsum(dO o O) of every query row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int n_heads, int lq, int dv, Strides so, Strides sdo,
             int64_t n_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int i = static_cast<int>(row % lq);
  const int64_t bh = row / lq;
  const int h = static_cast<int>(bh % n_heads), b = static_cast<int>(bh / n_heads);
  const float* orow = o + b * so.b + h * so.h + i * so.l;
  const float* grow = dout + b * sdo.b + h * sdo.h + i * sdo.l;
  float acc = 0.f;
  for (int c = lane; 4 * c < dv; c += 32) {
    const float4 x = *reinterpret_cast<const float4*>(orow + 4 * c);
    const float4 g = *reinterpret_cast<const float4*>(grow + 4 * c);
    acc = fmaf(g.x, x.x, acc);
    acc = fmaf(g.y, x.y, acc);
    acc = fmaf(g.z, x.z, acc);
    acc = fmaf(g.w, x.w, acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// (b) dK and dV of one key tile of one kv head, and its part of dQ
// ---------------------------------------------------------------------------

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dvo,
            int n_heads, int n_kv_heads, int n_bhk, int lq, int lk, int dqk, int dv, Strides sq,
            Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int causal,
            int window, float scale, float scale_log2, float* __restrict__ dq_part) {
  using S = Shape<DK, DV>;
  constexpr int R = S::R, C = S::C, KA = S::kA, KB = S::kB;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [KA][DK] the block's keys
  float* v_s = k_s + KA * DK;                    // [KA][DV] their values
  float* q_s = v_s + KA * DV;                    // [2][KB][DK] a query tile
  float* g_s = q_s + kStages * KB * DK;          // [2][KB][DV] its dO
  float* lse_s = g_s + kStages * KB * DV;        // [2][KB] its rows' lse
  float* dl_s = lse_s + kStages * KB;            // [2][KB] ... and delta
  float* pt_s = dl_s + kStages * KB;             // [KB][KA] P^T, slots swizzled
  float* dst_s = pt_s + KB * KA;                 // [KB][KA] dS^T

  const int kt = static_cast<int>(blockIdx.x / n_bhk);  // the first keys (most queries) first
  const int bhk = static_cast<int>(blockIdx.x % n_bhk);
  const int b = bhk / n_kv_heads, hk = bhk % n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const int k0 = kt * KA, k1 = min(lk, k0 + KA);
  const int off = lk - lq;
  const int tid = threadIdx.x, a = grid_a(tid), bb = grid_b(tid);

  float acc_k[R][S::kDK], acc_v[R][S::kDV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int d = 0; d < S::kDK; ++d) acc_k[i][d] = 0.f;
#pragma unroll
    for (int d = 0; d < S::kDV; ++d) acc_v[i][d] = 0.f;
  }

  // the query rows that see some key of [k0, k1), in tiles of KB
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(lq, k1 - 1 + window - off) : lq;
  const int t_lo = i_lo / KB;
  const int n_t = i_lo < i_hi ? (i_hi - 1) / KB - t_lo + 1 : 0;
  const int n_iter = group * n_t;  // (head of the group, query tile), head-major

  if (n_iter > 0) {
    load_rows<DK>(k_s, k + b * sk.b + hk * sk.h, sk.l, k0, KA, lk, dqk, k);
    load_rows<DV>(v_s, v + b * sv.b + hk * sv.h, sv.l, k0, KA, lk, dv, v);
    auto load_tile = [&](int it, int st) {
      const int h = hk * group + it / n_t, r0 = (t_lo + it % n_t) * KB;
      const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h) * lq;
      load_rows<DK>(q_s + st * KB * DK, q + b * sq.b + h * sq.h, sq.l, r0, KB, lq, dqk, q);
      load_rows<DV>(g_s + st * KB * DV, dout + b * sdo.b + h * sdo.h, sdo.l, r0, KB, lq, dv,
                    dout);
      load_stat(lse_s + st * KB, lse + row_base, r0, KB, lq);
      load_stat(dl_s + st * KB, delta + row_base, r0, KB, lq);
      cp_async_commit();
    };
    load_tile(0, 0);  // in one group with K and V
    for (int it = 0; it < n_iter; ++it) {
      const int st = it & 1;
      const int r0 = (t_lo + it % n_t) * KB;
      cp_async_wait_all();
      __syncthreads();  // tile it has landed; every thread is done with tile it - 1
      if (it + 1 < n_iter) load_tile(it + 1, st ^ 1);
      const float* qt = q_s + st * KB * DK;
      const float* gt = g_s + st * KB * DV;

      // S^T and dP^T: keys a + 16 i against queries b + 16 j
      float s[R][C], dp[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
      products<DK, R, C>(k_s, qt, a, bb, s);
      products<DV, R, C>(v_s, gt, a, bb, dp);

      // P^T and dS^T into shared memory: query row b + 16 j, the thread's keys as one chunk
      const bool all_seen = inside(r0, KB, k0, KA, lq, lk, off, causal, window);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int qi = bb + kGroups * j;
        const float l2 = lse_s[st * KB + qi], dl = dl_s[st * KB + qi];
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int key = k0 + a + kGroups * i, row = r0 + qi;
          const bool seen =
              all_seen || (key < lk && row < lq && visible(off + row, key, causal, window));
          p[i] = seen ? exp2f(fmaf(s[i][j], scale_log2, -l2)) : 0.f;
          ds[i] = p[i] * (dp[i][j] - dl);
        }
        st_vec<4>(pt_s + slot<KA>(qi, a), p);
        st_vec<4>(dst_s + slot<KA>(qi, a), ds);
      }
      __syncthreads();  // P^T and dS^T of the tile are in shared memory

      // dV += P^T dO and dK += dS^T Q: one query row at a time
#pragma unroll 4
      for (int qi = 0; qi < KB; ++qi) {
        float p[R], ds[R], g[S::kDV], x[S::kDK];
        ld_vec<4>(p, pt_s + slot<KA>(qi, a));
        ld_vec<4>(ds, dst_s + slot<KA>(qi, a));
#pragma unroll
        for (int u = 0; u < S::kDV / S::kWV; ++u)
          ld_vec<S::kWV>(g + S::kWV * u,
                         gt + swz<DV>(qi, S::kWV * bb + kGroups * S::kWV * u));
#pragma unroll
        for (int u = 0; u < S::kDK / S::kWK; ++u)
          ld_vec<S::kWK>(x + S::kWK * u,
                         qt + swz<DK>(qi, S::kWK * bb + kGroups * S::kWK * u));
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int d = 0; d < S::kDV; ++d) acc_v[i][d] = fmaf(p[i], g[d], acc_v[i][d]);
#pragma unroll
          for (int d = 0; d < S::kDK; ++d) acc_k[i][d] = fmaf(ds[i], x[d], acc_k[i][d]);
        }
      }

      // this key tile's part of dQ: dS K over the block's keys, for query
      // rows a + 16 i of the tile and the columns b names
      {
        const int h = hk * group + it / n_t;
        float acc_q[C][S::kDK];
#pragma unroll
        for (int i = 0; i < C; ++i)
#pragma unroll
          for (int d = 0; d < S::kDK; ++d) acc_q[i][d] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < KA; ++kk) {
          const int a2 = kk % kGroups, i2 = kk / kGroups;  // key a2 + 16 i2: chunk a2, float i2
          float x[S::kDK], ds[C];
#pragma unroll
          for (int u = 0; u < S::kDK / S::kWK; ++u)
            ld_vec<S::kWK>(x + S::kWK * u,
                           k_s + swz<DK>(kk, S::kWK * bb + kGroups * S::kWK * u));
#pragma unroll
          for (int i = 0; i < C; ++i) ds[i] = dst_s[slot<KA>(a + kGroups * i, a2) + i2];
#pragma unroll
          for (int i = 0; i < C; ++i)
#pragma unroll
            for (int d = 0; d < S::kDK; ++d) acc_q[i][d] = fmaf(ds[i], x[d], acc_q[i][d]);
        }
        const int64_t part_rows = static_cast<int64_t>(n_bhk / n_kv_heads) * n_heads * lq;
        float* pb = dq_part + (static_cast<int64_t>(kt) * part_rows +
                               (static_cast<int64_t>(b) * n_heads + h) * lq) * dqk;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int row = r0 + a + kGroups * i;
          if (row >= lq) continue;
#pragma unroll
          for (int u = 0; u < S::kDK / S::kWK; ++u) {
            const int col = S::kWK * bb + kGroups * S::kWK * u;
            if (col >= dqk) continue;
            float x[S::kWK];
#pragma unroll
            for (int e = 0; e < S::kWK; ++e) x[e] = acc_q[i][S::kWK * u + e];
            st_vec<S::kWK>(pb + static_cast<int64_t>(row) * dqk + col, x);
          }
        }
      }
    }
  }

  float* dkb = dk + b * sdk.b + hk * sdk.h;
  float* dvb = dvo + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + a + kGroups * i;
    if (key >= lk) continue;
#pragma unroll
    for (int u = 0; u < S::kDK / S::kWK; ++u) {
      const int col = S::kWK * bb + kGroups * S::kWK * u;
      if (col >= dqk) continue;
      float x[S::kWK];
#pragma unroll
      for (int e = 0; e < S::kWK; ++e) x[e] = acc_k[i][S::kWK * u + e] * scale;
      st_vec<S::kWK>(dkb + static_cast<int64_t>(key) * sdk.l + col, x);
    }
#pragma unroll
    for (int u = 0; u < S::kDV / S::kWV; ++u) {
      const int col = S::kWV * bb + kGroups * S::kWV * u;
      if (col >= dv) continue;
      float x[S::kWV];
#pragma unroll
      for (int e = 0; e < S::kWV; ++e) x[e] = acc_v[i][S::kWV * u + e];
      st_vec<S::kWV>(dvb + static_cast<int64_t>(key) * sdv.l + col, x);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dQ: the key tiles' parts summed in order
// ---------------------------------------------------------------------------

// dQ of one group of 4 columns of one query row: the parts of the key
// tiles its query tile visits, summed in key-tile order, times scale
__global__ void __launch_bounds__(kThreads)
dq_reduce_kernel(const float* __restrict__ part, float* __restrict__ dq, int n_heads, int lq,
                 int lk, int dqk, Strides sdq, int64_t part_rows, int causal, int window,
                 float scale, int kA, int kB) {
  const int c4 = dqk / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= part_rows * c4) return;
  const int64_t row = idx / c4;
  const int c = static_cast<int>(idx % c4);
  const int i = static_cast<int>(row % lq);
  const int64_t bh = row / lq;
  const int h = static_cast<int>(bh % n_heads), b = static_cast<int>(bh / n_heads);
  const int off = lk - lq;
  const int r0 = i / kB * kB, r_last = min(lq, r0 + kB) - 1;
  const int lo = window > 0 ? max(0, off + r0 - window + 1) : 0;
  const int hi = causal ? min(lk, off + r_last + 1) : lk;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = lo / kA; lo < hi && kt * kA < hi; ++kt) {
    const float4 x =
        *reinterpret_cast<const float4*>(part + (kt * part_rows + row) * dqk + 4 * c);
    acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
  }
  *reinterpret_cast<float4*>(dq + b * sdq.b + h * sdq.h + i * sdq.l + 4 * c) =
      make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& raised) {
  // the shared-memory limit, raised once per kernel and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DK, int DV>
static cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                          const float* dout, float* dq, float* dk, float* dv_out,
                          const float* lse, float* delta, float* dq_part, int batch,
                          int n_heads, int n_kv_heads,
                          int lq, int lk, int dqk, int dv, const Strides* st, int causal,
                          int window, float scale, cudaStream_t stream) {
  using S = Shape<DK, DV>;
  static std::atomic<uint64_t> raised{0};
  cudaError_t err;
  if ((err = allow_smem(dkdv_kernel<DK, DV>, S::kSmemBytes, raised)) != cudaSuccess) return err;
  const float scale_log2 = scale * 1.4426950408889634f;  // as the forward scales its logits
  // st: q, k, v, o, dout, dq, dk, dv
  const int64_t rows = static_cast<int64_t>(batch) * n_heads * lq;
  const int64_t n_bhk = static_cast<int64_t>(batch) * n_kv_heads;
  const int64_t k_blocks = n_bhk * ((lk + S::kA - 1) / S::kA);
  const int64_t d_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t r_blocks = (rows * (dqk / 4) + kThreads - 1) / kThreads;
  if (k_blocks > 0x7fffffff || d_blocks > 0x7fffffff || r_blocks > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  if (d_blocks > 0) {
    delta_kernel<<<static_cast<unsigned>(d_blocks), kThreads, 0, stream>>>(
        o, dout, delta, n_heads, lq, dv, st[3], st[4], rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (k_blocks > 0) {
    dkdv_kernel<DK, DV><<<static_cast<unsigned>(k_blocks), kThreads, S::kSmemBytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv_out, n_heads, n_kv_heads, static_cast<int>(n_bhk), lq,
        lk, dqk, dv, st[0], st[1], st[2], st[4], st[6], st[7], causal, window, scale,
        scale_log2, dq_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (r_blocks > 0) {
    dq_reduce_kernel<<<static_cast<unsigned>(r_blocks), kThreads, 0, stream>>>(
        dq_part, dq, n_heads, lq, lk, dqk, st[5], rows, causal, window, scale, S::kA, S::kB);
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
// at least as wide in both, into widths[0..1]; false when none is, when a
// width is no multiple of 4 (16-byte rows) or dv > dqk.
static bool pick(int dqk, int dv, int* widths) {
  if (dqk <= 0 || dv <= 0 || dv > dqk || dqk % 4 != 0 || dv % 4 != 0) return false;
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
// data pointers and strides[24] = (batch, head, position) element strides
// of q, k, v, o, dout, dq, dk, dv in that order, the last dim contiguous,
// every base and stride a multiple of 16 bytes. lse: float32 [B, H, Lq]
// contiguous, each row's log-sum-exp in the log2 domain of the scaled
// scores (+inf for a row that sees no key), as the forward's tile route
// writes it. delta (B * H * Lq floats) and dq_part
// (repro_flash_attention_bwd_part_floats) are float32 scratch, which the
// kernels write and read. (Dqk, Dv) is a pair
// repro_flash_attention_bwd_widths takes; H is a multiple of Hkv. Launches
// the delta, dK/dV and dQ kernels in order; returns the first CUDA error
// (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv_out, const void* lse, void* delta,
                                         void* dq_part, int batch, int n_heads, int n_kv_heads,
                                         int lq, int lk, int dqk, int dv, const int64_t* strides,
                                         int causal, int window, float scale, void* stream) {
  using namespace repro_fa_bwd;
  if (batch <= 0 || n_heads <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lq < 0 || lk < 0)
    return cudaErrorInvalidValue;
  int w[2];
  if (!pick(dqk, dv, w)) return cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
#define REPRO_FA_BWD_CASE(DK, DV)                                                          \
  if (w[0] == DK && w[1] == DV)                                                            \
    return launch<DK, DV>(f(q), f(k), f(v), f(o), f(dout), g(dq), g(dk), g(dv_out), f(lse), \
                          g(delta), g(dq_part), batch, n_heads, n_kv_heads, lq, lk, dqk,  \
                          dv, st, causal, window, scale, s);
  REPRO_FA_BWD_WIDTHS(REPRO_FA_BWD_CASE)
#undef REPRO_FA_BWD_CASE
  return cudaErrorInvalidValue;
}

// The widths (DK, DV) of the instantiation a (dqk, dv) backward runs at,
// into widths[2]: 0, or -1 for a pair no instantiation takes.
extern "C" int repro_flash_attention_bwd_widths(int dqk, int dv, int* widths) {
  return repro_fa_bwd::pick(dqk, dv, widths) ? 0 : -1;
}

// Dynamic shared memory of the dK/dV kernel at the instantiation of
// (dqk, dv), bytes; -1 for a pair none takes.
extern "C" int repro_flash_attention_bwd_smem_bytes(int dqk, int dv) {
  using namespace repro_fa_bwd;
  int w[2];
  if (!pick(dqk, dv, w)) return -1;
#define REPRO_FA_BWD_SMEM(DK, DV) \
  if (w[0] == DK && w[1] == DV) return Shape<DK, DV>::kSmemBytes;
  REPRO_FA_BWD_WIDTHS(REPRO_FA_BWD_SMEM)
#undef REPRO_FA_BWD_SMEM
  return -1;
}

// Floats of dq_part for a backward of B * H * Lq query rows over Lk keys at
// (dqk, dv): each key tile's part of every query row's dQ, [key tiles][B *
// H * Lq][Dqk] (a part is written where the key tile and the row's query
// tile meet); -1 for a pair none takes.
extern "C" int64_t repro_flash_attention_bwd_part_floats(int batch, int n_heads, int lq, int lk,
                                                         int dqk, int dv) {
  using namespace repro_fa_bwd;
  int w[2];
  if (!pick(dqk, dv, w)) return -1;
  const int64_t key_tiles = (lk + kR * kGroups - 1) / (kR * kGroups);
  return key_tiles * batch * n_heads * lq * dqk;
}

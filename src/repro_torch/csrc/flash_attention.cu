// Blocked online-softmax attention (FlashAttention) for Hopper in float32:
// float32 in, float32 products on the CUDA cores, float32 out. Every
// float32 attention of the port runs here, on one of two routes the
// wrapper (kernels/flash_attention.py::_route) picks by shape; bfloat16
// runs the tensor-core kernel csrc/flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py
// (flash_attention_call), which ran a (B*H, q blocks, k blocks) grid with
// the running max, sum and output block in VMEM scratch, and repeated the
// KV heads in memory for GQA before the call.
//
// What it computes, as the TPU kernel does: the scale the caller gives
// (1/sqrt(Dqk) by default); keys of Dqk columns, values of Dv <= Dqk
// (MLA; the values may be a view of the keys' first Dv columns); query i sits
// at position Lk - Lq + i (decode alignment); keys k < Lk, causal k <= the
// query position, sliding window k > position - window; float32 running
// max, sum and accumulator; the denominator clamped at 1e-30, so a row
// whose keys are all masked comes out 0, not NaN. No sum uses atomics (the
// decode route's one atomic counts a row tile's finished splits), and each
// route fixes its order of summation by the shape alone, so a shape gives
// the same bits on every call.
//
// Bound on this card: at decode (Lq = 1) bytes, the KV cache read once; at
// prefill operations, 2 * Lq * Lk * (Dqk + Dv) per head (halved when causal), at
// 67 TFLOP/s for float32 outside the tensor cores, or at a short prefill
// bytes again. Both routes keep the plain version's float32 arithmetic, FFMA
// only, no TF32 (qwen3-0.6b's float32 decode-vs-forward check relies on it).
//
// Tile route (repro_flash_attention), FA2 order: a block holds a tile of
// BM query rows of one (batch, kv head) and streams that head's key tiles
// of BN keys through shared memory. The first design (one block per 64
// rows, Dh/32 threads a row, each holding 32 of its dims) ran at 17% of the
// bound on a 2048-token causal prefill. What held it back, and what this
// design does about each:
// 1. No register reuse: every FFMA read its K or V operand from shared
//    memory (one LDS.128 per 4 FFMAs), so shared-memory bandwidth set the
//    pace. Here a block's threads are RG row groups x 16 key groups.
//    Thread (rg, cg) holds R query rows (rg + RG i) and scores C keys
//    (cg + 16 j) of a key tile: for every 4 head dims it loads R + C
//    float4s and does 4 R C FFMAs (R = 8, C = 4: 128 FFMAs for 12 loads).
//    For O += P V it holds the same R rows x Dv/16 head dims: per key R/4
//    float4s of P and Dv/64 of V for R Dv/16 FFMAs (64 for 4 loads at Dv
//    128). Q and K lie in shared memory row by row, their 16-byte chunks
//    swizzled (chunk c of row r at c ^ (r & 7)) where a row has a multiple
//    of 8 chunks, else in rows padded to an odd number of chunks (80: 21),
//    so a warp's Q loads (two rows) and K loads (16 keys) meet no bank
//    conflict. P goes through shared memory once a tile, as [key][rg * R +
//    i], so a thread's rows are one vector.
// 2. Loads were not overlapped: each tile was loaded, stored and used
//    between two barriers. Here K and V tiles arrive by cp.async (16-byte
//    copies, zeros past Lk) in two stages: tile j + 1 is in flight while
//    tile j is computed (commit_group, then wait_group and one barrier at
//    the top of the next tile).
// 3. Redundant softmax work: the max, expf and shuffles of each score were
//    done by all Dh/32 threads of its row. Here each score has one owner
//    and one exp2f (on logits scaled by log2 e); a row's tile max is
//    reduced over the 16 threads that share the row, in one warp, by four
//    shuffles; the running sum stays a per-thread partial, reduced once at
//    the end; and the rescale by exp(m_old - m_new) stays in registers, as
//    a thread's rows are the same in both products.
// 4. Causal skipping used atomics and masked key by key, and blocks ran in
//    row order, so the longest tiles of the causal triangle started last.
//    Here a kv head's rows are numbered position-major (row g: position
//    g / group, head g % group of the group), so a tile's rows hold
//    consecutive positions. Every thread computes from the shape alone the
//    keys any row of the tile sees and those every row sees; the block
//    visits the key tiles of the first and checks key by key only in those
//    not inside the second. The first B x Hkv blocks take the last query
//    tile of each kv head, and so on down, so the tiles with the most keys
//    start first.
// Asked for it (FlashAttentionFn under a gradient), the tile route also
// writes each row's log-sum-exp for the backward (csrc/flash_attention_bwd.cu)
// in the log2 domain its softmax runs in: m + log2(l) of the row's running
// max and sum, +inf for a row that saw no key. The output's arithmetic is
// the same either way, and so are its bits.
// Forms (Tile<DK, DV, F>), their shared memory (floats: BM rows of Q, two
// stages x BN rows each of K and V, BN (BM + 4) of P; Q/K rows as laid out
// above) and the wrapper's choice (tile_plan), from the shape and the card:
// - large, 256 threads (RG 16): up to Dh 128 BM = 128, BN = 64 (R = 8,
//   C = 4; 230,400 bytes at Dh 128, one block an SM); at Dh 256 BM = 64,
//   BN = 32 (R = 4, C = 2; its Q tile alone is 64 KB; 205,312 bytes);
//   wider (MLA's latent, Dqk 576 and Dv 512) BM = 32, BN = 16 (R = 2, C =
//   1; 215,296 bytes). Taken while its blocks give every SM one.
// - mid, 128 threads (RG 8), up to Dh 256: BM = BN = 32 (R = 4, C = 2;
//   111,104 bytes at (192, 128), two blocks an SM). Taken where the large
//   tile's blocks would leave SMs idle but the mid's reach at least half
//   of them: MLA's float32 layer forward (128 kv heads of 64 rows: 256
//   blocks where the large tile gave 128) and zamba2's (2 x 32 kv heads of
//   64 rows: 128). The small tile ran these with 1 x 1 fragments (8
//   shared-memory floats for 4 FFMAs in the scores); the mid does 32 FFMAs
//   for 24 floats, 2.7x the reuse, over 1.2x the pairs (the causal
//   diagonal tile computed whole).
// - small, 256 threads: BM = BN = 16 (R = C = 1) for the fewest blocks
//   (qwen3-0.6b's 16-token forward: 2 x 8 kv heads of 32 rows, 32 blocks),
//   each doing a small part of the work.
//
// Decode route (repro_flash_attention_decode), for few query rows per kv
// head (a decode step: group x Lq rows, 2 for qwen3-0.6b, 4 for h2o-danube's
// ring, 8 for Kimi-K2). On the tile route such a block has only those rows'
// threads live walking every key in series, and the grid has B x Hkv
// blocks (32 on 132 SMs). Here:
// - a block holds a tile of R of a kv head's rows (1, 2 or 4) and one
//   split of the keys, both chosen by the wrapper (decode_plan): Lk cut
//   into n_splits splits of `chunk` keys (at most DECODE_WAVES blocks an
//   SM, no split under DECODE_SPLIT_BYTES of K/V), so that B x Hkv x row
//   tiles x n_splits blocks fill the card at a long cache in one wave, and
//   R made smaller while the blocks would reach fewer than half the SMs at
//   a short cache (h2o's ring: 4 rows, 16 splits of 256 keys, 128 blocks);
// - in a block, a team of 8, 16 or 32 lanes (the least that holds DK/4
//   16-byte chunks in at most 4 a lane, 32 at most: 8 lanes up to DK 128,
//   16 at 192 and 256, 32 at MLA's 576, 5 chunks a lane) reads one key row
//   and its value row (Dv <= Dqk, the same lanes), and the block's 256 /
//   lanes teams take the split's keys in turn (team t: keys t, t + teams,
//   ...), kUnit keys at a time (4 / the lane's float4s of a key row). The
//   first design gave a key row 32 lanes from DK 128 up, so that every dot
//   took 5 shuffles and a warp scored one key at a time; at 8 lanes it
//   takes 3 and a warp scores 4. A team loads unit u + 1 into registers
//   before it folds unit u, so one unit of K and V is in flight while it
//   computes (the first design loaded a unit and then waited for it).
//   Each team scores its keys against all R rows (q from shared memory,
//   the dots summed over the team's lanes with shuffles, every row's and
//   key's at once) and folds them into its own running (m, l, acc) per
//   row, rescaling only where a unit raises the max (a factor of exactly
//   1 is skipped; the first design's branch past a row that no key of the
//   unit reaches kept the rows' shuffle chains from overlapping). Only a
//   split's last unit checks which of its slots hold a key
//   (fold_unit<..., false>);
// - the teams' states meet in shared memory and are folded in team order,
//   each team's weight exp(m_team - m) taken once a row; with one split
//   the block writes the output, else each row's partial
//   (acc, m, l) goes to scratch the wrapper allocated, and the last block of
//   a row tile to finish (a counter a row tile, which it sets back to 0)
//   folds the splits in split order, their partials brought into shared
//   memory kTeams splits at a time by all its threads at once. The first
//   design folded them in a second kernel, one thread a float4 of a row
//   walking the splits one load after another.
//
// Widths. Both routes are instantiated at the (DK, DV) of REPRO_FA_WIDTHS;
// a call takes the narrowest that holds its (Dqk, Dv) (pick, which the
// wrapper asks through repro_flash_attention_widths). Columns past Dqk
// and Dv are loaded as zeros and add nothing; those past Dv are not
// stored. zamba2's and hubert's 80 run at (80, 80) (20 chunks a row: the
// padded layout; 5 output dims a thread, loaded one at a time); h2o-danube's
// 120 runs at 128, since 120 / 16 key groups leaves no whole number of
// output dims a thread; the smoke MLA's (48, 32) at 64.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace repro_fa {

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

// -------------------------------------------------------------------------
// tile route
// -------------------------------------------------------------------------

constexpr int kGroups = 16;  // key groups of a tile block: the 16 threads of a row share a half-warp

// The three forms of a tile-route block, chosen by the wrapper (tile_plan)
// from the shape and the card: large while its blocks give every SM one,
// else mid while its blocks reach half the SMs, else small.
enum Form { kLarge = 0, kMid = 1, kSmall = 2 };

// A Q/K row of DH floats in shared memory: where its 16-byte chunks are a
// multiple of 8, DH floats with chunk c of row r at c ^ (r & 7); else
// (DH 80: 20 chunks) padded to an odd number of chunks, chunk c at c. Either
// way the 8 threads of a quarter-warp that load chunk c of 8 consecutive
// rows meet 8 different 16-byte bank groups.
template <int DH>
struct QkRow {
  static constexpr int kChunks = DH / 4;
  static constexpr bool kSwizzle = kChunks % 8 == 0;
  static constexpr int kStride = kSwizzle ? DH : 4 * (kChunks | 1);  // floats a row
};

// The tile of an instantiation's widths DK (Q and K) and DV (V) in form F.
// RG row groups x 16 key groups of threads; thread (rg, cg) holds R query
// rows (rg + RG i) and scores C keys (cg + 16 j) of a key tile.
template <int DK, int DV, int F>
struct Tile {
  static_assert(DK % 4 == 0 && DV % kGroups == 0 && DV <= DK, "widths");
  static_assert(F != kMid || DK <= 256, "the mid form's shared memory above 256");
  static constexpr int RG = F == kMid ? 8 : 16;  // row groups
  static constexpr int kThreads = RG * kGroups;
  static constexpr int R = F == kSmall ? 1 : F == kMid ? 4 : (DK <= 128 ? 8 : DK <= 256 ? 4 : 2);
  static constexpr int C = F == kSmall ? 1 : F == kMid ? 2 : (DK <= 128 ? 4 : DK <= 256 ? 2 : 1);
  static constexpr int BM = RG * R;               // query rows of a block
  static constexpr int BN = kGroups * C;          // keys of a tile
  static constexpr int PS = BM + 4;               // floats a key of the P tile
  static constexpr int D = DV / kGroups;          // output dims of a thread
  static constexpr int W = D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1;  // ... loaded W at a time
  static constexpr int kK4 = DK / 4;              // 16-byte chunks of a Q/K row
  static constexpr int kV4 = DV / 4;              // ... of a V row
  static constexpr int QS = QkRow<DK>::kStride;   // floats a Q/K row in shared memory
  static constexpr int kSmemFloats = BM * QS + 2 * BN * QS + 2 * BN * DV + BN * PS;
  static constexpr int kMinBlocks = F == kMid ? 2 : 1;  // blocks an SM holds (launch bounds)
};

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

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (src is then not read, but must still be a device address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the 16-byte chunk c of row r of a [rows][DH] Q/K tile (QkRow's layout)
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (QkRow<DH>::kSwizzle) return r * DH + 4 * (c ^ (r & 7));
  return r * QkRow<DH>::kStride + 4 * c;
}

// keys [lo, hi) that a query at position off + p sees
__device__ __forceinline__ int keys_lo(int p, int off, int window) {
  return window > 0 ? max(0, off + p - window + 1) : 0;
}
__device__ __forceinline__ int keys_hi(int p, int off, int lk, int causal) {
  return causal ? min(lk, off + p + 1) : lk;
}

// Block: tile `tile` of BM rows of (b, kvh); row g of a kv head is query
// head kvh * group + g % group at position g / group (position-major).
template <int DK, int DV, int F>
__global__ void __launch_bounds__(Tile<DK, DV, F>::kThreads, Tile<DK, DV, F>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int n_heads,
                       int n_kv_heads, int n_bh, int lq, int lk, Strides sq, Strides sk,
                       Strides sv, Strides so, int dqk, int dv, int causal, int window,
                       float scale_log2) {
  using T = Tile<DK, DV, F>;
  constexpr int R = T::R, C = T::C, BM = T::BM, BN = T::BN, D = T::D, W = T::W, RG = T::RG;
  constexpr int NT = T::kThreads;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BM][QS], swizzled or padded
  float* k_s = q_s + BM * T::QS;                 // [2][BN][QS], likewise
  float* v_s = k_s + 2 * BN * T::QS;             // [2][BN][DV]
  float* p_s = v_s + 2 * BN * DV;                // [BN][PS]: P[key][rg * R + i]

  const int group = n_heads / n_kv_heads;
  const int rows_total = group * lq;
  const int tiles = (rows_total + BM - 1) / BM;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / n_bh);  // most keys first
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int kvh = bh % n_kv_heads, b = bh / n_kv_heads;
  const int g0 = tile * BM, g1 = min(g0 + BM, rows_total);
  const int off = lk - lq;

  // the keys any row of the tile sees, and those every row sees
  const int p_min = g0 / group, p_max = (g1 - 1) / group;
  const int k_lo = keys_lo(p_min, off, window), k_hi = keys_hi(p_max, off, lk, causal);
  const int full_lo = keys_lo(p_max, off, window), full_hi = keys_hi(p_min, off, lk, causal);

  const int tid = threadIdx.x;
  const int rg = tid / kGroups, cg = tid % kGroups;
  const float* k_head = k + b * sk.b + kvh * sk.h;
  const float* v_head = v + b * sv.b + kvh * sv.h;

  float acc[R][D], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[i][d] = 0.f;
  }

  if (k_hi > k_lo) {
    // Q: row s of the tile, zeros past the last row and past Dqk
    for (int e = tid; e < BM * T::kK4; e += NT) {
      const int s = e / T::kK4, c = e % T::kK4, g = g0 + s;
      const bool ok = g < rows_total && 4 * c < dqk;
      const float* src = ok ? q + b * sq.b + (kvh * group + g % group) * sq.h +
                                  static_cast<int64_t>(g / group) * sq.l + 4 * c
                            : q;
      cp_async16(q_s + swz<DK>(s, c), src, ok);
    }
    // K and V tile t into stage st, zeros past Lk and in the columns past Dqk and Dv
    auto load_kv = [&](int t, int st) {
      float* ks = k_s + st * BN * T::QS;
      float* vs = v_s + st * BN * DV;
      for (int e = tid; e < BN * T::kK4; e += NT) {
        const int j = e / T::kK4, c = e % T::kK4, kp = t * BN + j;
        const bool ok = kp < lk && 4 * c < dqk;
        cp_async16(ks + swz<DK>(j, c), ok ? k_head + static_cast<int64_t>(kp) * sk.l + 4 * c : k,
                   ok);
      }
      for (int e = tid; e < BN * T::kV4; e += NT) {
        const int j = e / T::kV4, c = e % T::kV4, kp = t * BN + j;
        const bool ok = kp < lk && 4 * c < dv;
        cp_async16(vs + j * DV + 4 * c,
                   ok ? v_head + static_cast<int64_t>(kp) * sv.l + 4 * c : v, ok);
      }
      cp_async_commit();
    };

    const int t_first = k_lo / BN, t_last = (k_hi - 1) / BN;
    load_kv(t_first, 0);  // in one group with Q
    for (int t = t_first; t <= t_last; ++t) {
      const int st = (t - t_first) & 1;
      cp_async_wait_all();
      __syncthreads();  // tile t has landed; every thread is done with tile t - 1
      if (t < t_last) load_kv(t + 1, st ^ 1);

      // S = Q K^T: R rows x C keys a thread, 4 head dims at a time
      const float* ks = k_s + st * BN * T::QS;
      float s[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < T::kK4; ++c) {
        float kf[C][4];
#pragma unroll
        for (int j = 0; j < C; ++j) ld_vec<4>(kf[j], ks + swz<DK>(cg + kGroups * j, c));
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float qf[4];
          ld_vec<4>(qf, q_s + swz<DK>(rg + RG * i, c));
#pragma unroll
          for (int j = 0; j < C; ++j) {
            s[i][j] = fmaf(qf[0], kf[j][0], s[i][j]);
            s[i][j] = fmaf(qf[1], kf[j][1], s[i][j]);
            s[i][j] = fmaf(qf[2], kf[j][2], s[i][j]);
            s[i][j] = fmaf(qf[3], kf[j][3], s[i][j]);
          }
        }
      }

      // masks (only in a tile not inside every row's keys), then the online
      // softmax: each row's tile max over its 16 threads, the rescale, P
      const bool inside = t * BN >= full_lo && (t + 1) * BN <= full_hi;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float mx = -INFINITY;
        if (inside) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            s[i][j] *= scale_log2;
            mx = fmaxf(mx, s[i][j]);
          }
        } else {
          const int p = (g0 + rg + RG * i) / group;
          const int lo = keys_lo(p, off, window), hi = keys_hi(p, off, lk, causal);
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const int kp = t * BN + cg + kGroups * j;
            s[i][j] = kp >= lo && kp < hi ? s[i][j] * scale_log2 : -INFINITY;
            mx = fmaxf(mx, s[i][j]);
          }
        }
#pragma unroll
        for (int o = kGroups / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0, alpha = 0
        const float alpha = exp2f(m[i] - m_use);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[i][d] *= alpha;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float pr = exp2f(s[i][j] - m_use);
          l[i] += pr;
          s[i][j] = pr;
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float col[R];
#pragma unroll
        for (int i = 0; i < R; ++i) col[i] = s[i][j];
        float* dst = p_s + (cg + kGroups * j) * T::PS + rg * R;
#pragma unroll
        for (int i = 0; i < R; i += (R < 4 ? R : 4)) st_vec<(R < 4 ? R : 4)>(dst + i, col + i);
      }
      __syncthreads();  // P of the tile is in shared memory

      // O += P V: R rows x D dims a thread, one key at a time
      const float* vs = v_s + st * BN * DV;
#pragma unroll 8
      for (int j = 0; j < BN; ++j) {
        float pf[R], vf[D];
#pragma unroll
        for (int i = 0; i < R; i += (R < 4 ? R : 4))
          ld_vec<(R < 4 ? R : 4)>(pf + i, p_s + j * T::PS + rg * R + i);
#pragma unroll
        for (int u = 0; u < D / W; ++u)
          ld_vec<W>(vf + W * u, vs + j * DV + W * cg + kGroups * W * u);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int d = 0; d < D; ++d) acc[i][d] = fmaf(pf[i], vf[d], acc[i][d]);
      }
    }
  }

  // each row's sum over its 16 threads, then out = acc / max(sum, 1e-30)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float sum = l[i];
#pragma unroll
    for (int o = kGroups / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int g = g0 + rg + RG * i;
    if (g >= rows_total) continue;
    if (lse != nullptr && cg == 0)  // log2 domain; +inf for a row that saw no key
      lse[(static_cast<int64_t>(b) * n_heads + kvh * group + g % group) * lq + g / group] =
          sum > 0.f ? m[i] + log2f(sum) : INFINITY;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float* o_row = out + b * so.b + (kvh * group + g % group) * so.h +
                   static_cast<int64_t>(g / group) * so.l;
#pragma unroll
    for (int u = 0; u < D / W; ++u) {
      const int col = W * cg + kGroups * W * u;  // Dv is a multiple of 4: W columns stay whole
      if (col >= dv) continue;
      float x[W];
#pragma unroll
      for (int e = 0; e < W; ++e) x[e] = acc[i][W * u + e] * inv;
      st_vec<W>(o_row + col, x);
    }
  }
}

// The shared-memory limit of a kernel, raised once per kernel and device (a
// CUDA runtime call on every launch would pace the short ones). `raised`
// holds bit d for device d.
template <typename Kernel>
static cudaError_t raise_smem(Kernel kernel, int smem, std::atomic<uint64_t>& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(raised.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int DK, int DV, int F>
static cudaError_t tile_smem_raised(int* smem_out) {
  using T = Tile<DK, DV, F>;
  static_assert(sizeof(float) * T::kSmemFloats <= 227 * 1024, "a block's shared memory");
  constexpr int smem = static_cast<int>(sizeof(float)) * T::kSmemFloats;
  static std::atomic<uint64_t> raised{0};
  *smem_out = smem;
  return raise_smem(flash_attention_kernel<DK, DV, F>, smem, raised);
}

template <int DK, int DV, int F>
static cudaError_t launch_tile(const float* q, const float* k, const float* v, float* out,
                               float* lse, int batch, int n_heads, int n_kv_heads, int lq, int lk,
                               int dqk, int dv, const Strides* st, int causal, int window,
                               float scale, cudaStream_t stream) {
  using T = Tile<DK, DV, F>;
  const int64_t rows = static_cast<int64_t>(n_heads / n_kv_heads) * lq;
  const int64_t n_bh = static_cast<int64_t>(batch) * n_kv_heads;
  const int64_t blocks = n_bh * ((rows + T::BM - 1) / T::BM);
  if (blocks > 0x7fffffff || rows > 0x7fffffff) return cudaErrorInvalidConfiguration;
  int smem = 0;
  const cudaError_t err = tile_smem_raised<DK, DV, F>(&smem);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<DK, DV, F><<<static_cast<unsigned>(blocks), T::kThreads, smem, stream>>>(
      q, k, v, out, lse, n_heads, n_kv_heads, static_cast<int>(n_bh), lq, lk, st[0], st[1], st[2],
      st[3], dqk, dv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The form of widths (DK, DV) whose blocks hold row_tile query rows: kLarge,
// kMid (up to DK 256) or kSmall; -1 for none.
template <int DK, int DV>
static int tile_form(int row_tile) {
  if (row_tile == Tile<DK, DV, kLarge>::BM) return kLarge;
  if constexpr (DK <= 256)
    if (row_tile == Tile<DK, DV, kMid>::BM) return kMid;
  if (row_tile == Tile<DK, DV, kSmall>::BM) return kSmall;
  return -1;
}

// launch_tile, or (occupancy != nullptr) the blocks of the form an SM holds
// at once, as the runtime computes them for its threads and shared memory
template <int DK, int DV>
static cudaError_t tile_dispatch(int row_tile, int* occupancy, const float* q, const float* k,
                                 const float* v, float* out, float* lse, int batch, int n_heads,
                                 int n_kv_heads, int lq, int lk, int dqk, int dv,
                                 const Strides* st, int causal, int window, float scale,
                                 cudaStream_t stream) {
#define REPRO_FA_FORM(F)                                                                        \
  if (occupancy != nullptr) {                                                                   \
    int smem = 0;                                                                               \
    const cudaError_t err = tile_smem_raised<DK, DV, F>(&smem);                                 \
    if (err != cudaSuccess) return err;                                                         \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                       \
        occupancy, flash_attention_kernel<DK, DV, F>, Tile<DK, DV, F>::kThreads, smem);         \
  }                                                                                             \
  return launch_tile<DK, DV, F>(q, k, v, out, lse, batch, n_heads, n_kv_heads, lq, lk, dqk, dv, \
                                st, causal, window, scale, stream);
  switch (tile_form<DK, DV>(row_tile)) {
    case kLarge: {
      REPRO_FA_FORM(kLarge)
    }
    case kMid:
      if constexpr (DK <= 256) {
        REPRO_FA_FORM(kMid)
      }
      return cudaErrorInvalidValue;
    case kSmall: {
      REPRO_FA_FORM(kSmall)
    }
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_FORM
}

// The instantiations (DK, DV), narrowest first; both routes instantiate each.
#define REPRO_FA_WIDTHS(X) \
  X(32, 32)                \
  X(64, 64)                \
  X(80, 80)                \
  X(128, 128)              \
  X(192, 128)              \
  X(256, 256)              \
  X(576, 512)

// The instantiation that takes (dqk, dv): the first of REPRO_FA_WIDTHS at
// least as wide in both, into widths[0..1]; false when none is, or when a
// width is no multiple of 4 (16-byte rows) or dv > dqk.
static bool pick(int dqk, int dv, int* widths) {
  if (dqk <= 0 || dv <= 0 || dv > dqk || dqk % 4 != 0 || dv % 4 != 0) return false;
#define REPRO_FA_PICK(DK, DV) \
  if (dqk <= DK && dv <= DV) {  \
    widths[0] = DK;             \
    widths[1] = DV;             \
    return true;                \
  }
  REPRO_FA_WIDTHS(REPRO_FA_PICK)
#undef REPRO_FA_PICK
  return false;
}

static cudaError_t launch(int dqk, int dv, int row_tile, int* occupancy, const float* q,
                          const float* k, const float* v, float* out, float* lse, int batch,
                          int n_heads, int n_kv_heads, int lq, int lk, const Strides* st,
                          int causal, int window, float scale, cudaStream_t stream) {
  int w[2];
  if (!pick(dqk, dv, w)) return cudaErrorInvalidValue;
#define REPRO_FA_CASE(DK, DV)                                                                   \
  if (w[0] == DK && w[1] == DV)                                                                 \
    return tile_dispatch<DK, DV>(row_tile, occupancy, q, k, v, out, lse, batch, n_heads,        \
                                 n_kv_heads, lq, lk, dqk, dv, st, causal, window, scale, stream);
  REPRO_FA_WIDTHS(REPRO_FA_CASE)
#undef REPRO_FA_CASE
  return cudaErrorInvalidValue;
}

// -------------------------------------------------------------------------
// decode route
// -------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;
constexpr int kDecodeRowsMax = 4;  // query rows a decode block holds

template <int DK, int DV>
struct Decode {
  static_assert(DK % 8 == 0 && DV % 8 == 0 && DV <= DK, "widths");
  static constexpr int kK4 = DK / 4, kV4 = DV / 4;  // 16-byte chunks of a K row, of a V row
  // lanes of a team: one key row, the least of 8, 16, 32 that hold it in at
  // most 4 float4s a lane (32 at most): the fewer a team's lanes, the fewer
  // shuffles sum a dot and the more keys a warp scores at once
  static constexpr int kLanes = kK4 <= 32 ? 8 : kK4 <= 64 ? 16 : 32;
  static constexpr int kVec = (kK4 + kLanes - 1) / kLanes;   // float4s of a K row a lane holds
  static constexpr int kVecV = (kV4 + kLanes - 1) / kLanes;  // ... of a V row
  static constexpr int kTeams = kDecodeThreads / kLanes;
  static constexpr int kUnit = 4 / kVec > 0 ? 4 / kVec : 1;  // keys a team folds at once
  static constexpr int kQ4 = kLanes * kVec;                  // float4s of a row of q_s
  static constexpr int kA4 = kLanes * kVecV;                 // float4s of a row of acc_s
  // a second unit's registers while one is folded, where R rows' state
  // leaves room (at most 128 registers for the accumulators and both
  // units: (576, 512) at 4 rows, 136, spilled with it)
  template <int R>
  static constexpr bool kDoubleBuffer = 4 * (R * kVecV + 2 * kUnit * (kVec + kVecV)) <= 128;
  // dynamic shared memory of a block of R rows: q_s, acc_s ([kTeams][R][kA4]
  // float4: the teams' accumulators, then kTeams splits' partials at a
  // time), ml_s ([kTeams][R] float2) and each row's max over the splits
  template <int R>
  static constexpr size_t smem_bytes() {
    return sizeof(float4) * R * (kQ4 + kTeams * kA4) + sizeof(float2) * kTeams * R +
           sizeof(float) * R;
  }
};

// A unit of a team into registers: the keys base + j * kTeams + team of
// slots j < kUnit, K and V; zeros past s1 and in a row's chunks past dk4
// and dv4. The loads are only waited for where the registers are first read.
template <int DK, int DV>
__device__ __forceinline__ void load_unit(float4 (&kr)[Decode<DK, DV>::kUnit][Decode<DK, DV>::kVec],
                                          float4 (&vr)[Decode<DK, DV>::kUnit][Decode<DK, DV>::kVecV],
                                          const float* k_head, const float* v_head,
                                          int64_t k_stride, int64_t v_stride, int base, int s1,
                                          int dk4, int dv4, int team, int lane) {
  using D = Decode<DK, DV>;
#pragma unroll
  for (int j = 0; j < D::kUnit; ++j) {
    const int kp = base + j * D::kTeams + team;
    const bool live = kp < s1;
#pragma unroll
    for (int c = 0; c < D::kVec; ++c) {
      const int c4 = lane + D::kLanes * c;
      kr[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && c4 < dk4)
        kr[j][c] = load4(k_head + static_cast<int64_t>(kp) * k_stride + 4 * c4);
    }
#pragma unroll
    for (int c = 0; c < D::kVecV; ++c) {
      const int c4 = lane + D::kLanes * c;
      vr[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && c4 < dv4)
        vr[j][c] = load4(v_head + static_cast<int64_t>(kp) * v_stride + 4 * c4);
    }
  }
}

// One unit of a team: the keys base + j * kTeams + team (kFull: all lie
// before s1), each scored against the block's rows and folded into the
// team's running (m, l, acc) of each row, slots in order. Every row's and
// key's partial dot is taken first, then their sums over the team's lanes
// (independent shuffles, interleaved), then each row's softmax step: a row
// no key of the unit reaches keeps its state (p 0). The first design
// branched past such rows before their dots, which serialised the rows'
// shuffle chains.
template <int DK, int DV, int R, bool kFull>
__device__ __forceinline__ void fold_unit(const float4* q_s,
                                          const float4 (&kr)[Decode<DK, DV>::kUnit][Decode<DK, DV>::kVec],
                                          const float4 (&vr)[Decode<DK, DV>::kUnit][Decode<DK, DV>::kVecV],
                                          int base, int s1, int team, int lane, unsigned mask,
                                          float scale, const int (&lo)[R], const int (&hi)[R],
                                          float (&m)[R], float (&l)[R],
                                          float4 (&acc)[R][Decode<DK, DV>::kVecV]) {
  using D = Decode<DK, DV>;
  float s[R][D::kUnit];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4 qv[D::kVec];
#pragma unroll
    for (int c = 0; c < D::kVec; ++c) qv[c] = q_s[r * D::kQ4 + lane + D::kLanes * c];
#pragma unroll
    for (int j = 0; j < D::kUnit; ++j) {
      s[r][j] = 0.f;
#pragma unroll
      for (int c = 0; c < D::kVec; ++c) s[r][j] = dot4(qv[c], kr[j][c], s[r][j]);
    }
  }
#pragma unroll
  for (int o = D::kLanes / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < D::kUnit; ++j) s[r][j] += __shfl_xor_sync(mask, s[r][j], o);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float unit_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < D::kUnit; ++j) {
      const int kp = base + j * D::kTeams + team;
      s[r][j] = ((kFull || kp < s1) && kp >= lo[r] && kp < hi[r]) ? s[r][j] * scale : -INFINITY;
      unit_max = fmaxf(unit_max, s[r][j]);
    }
    // a new max rescales the state by exp(m - m_new), 0 on the row's first
    // live unit; an unchanged one would scale by exactly 1, so it is skipped
    const float m_new = fmaxf(m[r], unit_max);
    if (m_new != m[r]) {
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < D::kVecV; ++c) {
        acc[r][c].x *= alpha;
        acc[r][c].y *= alpha;
        acc[r][c].z *= alpha;
        acc[r][c].w *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < D::kUnit; ++j) {
      const float p = s[r][j] == -INFINITY ? 0.f : expf(s[r][j] - m_new);
      l[r] += p;
#pragma unroll
      for (int c = 0; c < D::kVecV; ++c) {
        acc[r][c].x = fmaf(p, vr[j][c].x, acc[r][c].x);
        acc[r][c].y = fmaf(p, vr[j][c].y, acc[r][c].y);
        acc[r][c].z = fmaf(p, vr[j][c].z, acc[r][c].z);
        acc[r][c].w = fmaf(p, vr[j][c].w, acc[r][c].w);
      }
    }
    m[r] = m_new;
  }
}

// The rows a block holds are g = row0 + r of the kv head's group x Lq rows:
// query head kvh * group + g / lq at query position g % lq. With more than
// one split, every block writes its rows' partial (acc, m, l) to part_acc
// and part_ml, and the last block of a row tile to finish, which it learns
// from counters[row tile] (no part of any sum), folds the splits' partials
// in split order and writes the output, then sets the counter back to 0.
template <int DK, int DV, int R>
__global__ void __launch_bounds__(kDecodeThreads, 1)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float4* __restrict__ part_acc, float2* __restrict__ part_ml,
                    int* __restrict__ counters, int n_heads, int n_kv_heads, int lq, int lk,
                    Strides sq, Strides sk, Strides sv, Strides so, int dqk, int dv, int causal,
                    int window, float scale, int n_splits, int chunk) {
  using D = Decode<DK, DV>;
  const int dk4 = dqk / 4, dv4 = dv / 4;
  extern __shared__ float4 smem[];
  float4* q_s = smem;                                                        // [R][kQ4]
  float4* acc_s = q_s + R * D::kQ4;                                          // [kTeams][R][kA4]
  float2* ml_s = reinterpret_cast<float2*>(acc_s + D::kTeams * R * D::kA4);  // [kTeams][R]
  float* fold_m = reinterpret_cast<float*>(ml_s + D::kTeams * R);            // [R]
  __shared__ int is_last;

  const int group = n_heads / n_kv_heads;
  const int rows_total = group * lq;
  const int row_tiles = (rows_total + R - 1) / R;
  const int split = blockIdx.x % n_splits;
  const int tile_id = blockIdx.x / n_splits;  // (b * n_kv_heads + kvh) * row_tiles + row tile
  const int row0 = (tile_id % row_tiles) * R;
  const int kvh = (tile_id / row_tiles) % n_kv_heads;
  const int b = tile_id / row_tiles / n_kv_heads;
  const int n_rows = min(R, rows_total - row0);

  // each row's keys [lo, hi) (none for a row past the tile's last), and the
  // block's [klo, khi) that covers them
  int lo[R], hi[R];
  int klo = lk, khi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pos = lk - lq + (row0 + r) % lq;
    int a = 0, e = lk;
    if (causal) e = min(e, pos + 1);
    if (window > 0) a = max(a, pos - window + 1);
    if (r >= n_rows) e = a;
    lo[r] = a;
    hi[r] = e;
    if (e > a) {
      klo = min(klo, a);
      khi = max(khi, e);
    }
  }
  for (int e = threadIdx.x; e < R * D::kQ4; e += kDecodeThreads) {
    const int r = e / D::kQ4, c = e % D::kQ4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && c < dk4) {
      const int g = row0 + r;
      x = load4(q + b * sq.b + (kvh * group + g / lq) * sq.h +
                static_cast<int64_t>(g % lq) * sq.l + 4 * c);
    }
    q_s[e] = x;
  }
  __syncthreads();

  const int team = threadIdx.x / D::kLanes;
  const int lane = threadIdx.x % D::kLanes;
  // the team's lanes within its warp: a team's shuffles are its own
  const unsigned mask = D::kLanes == 32
                            ? 0xffffffffu
                            : ((1u << D::kLanes) - 1u) << ((threadIdx.x % 32) & ~(D::kLanes - 1));
  float m[R], l[R];
  float4 acc[R][D::kVecV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D::kVecV; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The split's rounds (kRound keys each, a unit of every team) that some
  // row sees, u_first to u_end - 1. A team loads unit u + 1 into registers
  // before it folds unit u, so one unit's K and V are in flight while it
  // computes (the first design loaded a unit and then waited for it).
  constexpr int kRound = D::kTeams * D::kUnit;
  const int s0 = split * chunk, s1 = min(lk, s0 + chunk);
  const int top = min(s1, khi);
  const int u_first = klo > s0 ? (klo - s0) / kRound : 0;
  const int u_end = top > s0 && khi > klo ? (top - s0 + kRound - 1) / kRound : 0;
  const float* k_head = k + b * sk.b + kvh * sk.h;
  const float* v_head = v + b * sv.b + kvh * sv.h;
  {
    float4 ka[D::kUnit][D::kVec], va[D::kUnit][D::kVecV];
    float4 kb[D::kUnit][D::kVec], vb[D::kUnit][D::kVecV];
    auto fold = [&](const float4(&kr)[D::kUnit][D::kVec],
                    const float4(&vr)[D::kUnit][D::kVecV], int u) {
      const int base = s0 + u * kRound;
      if (base + kRound <= s1)  // every slot of the unit holds a key of the split
        fold_unit<DK, DV, R, true>(q_s, kr, vr, base, s1, team, lane, mask, scale, lo, hi, m, l,
                                   acc);
      else
        fold_unit<DK, DV, R, false>(q_s, kr, vr, base, s1, team, lane, mask, scale, lo, hi, m,
                                    l, acc);
    };
    if constexpr (!D::template kDoubleBuffer<R>) {  // load a unit, then fold it
      for (int u = u_first; u < u_end; ++u) {
        load_unit<DK, DV>(ka, va, k_head, v_head, sk.l, sv.l, s0 + u * kRound, s1, dk4, dv4,
                          team, lane);
        fold(ka, va, u);
      }
    } else {
    if (u_first < u_end)
      load_unit<DK, DV>(ka, va, k_head, v_head, sk.l, sv.l, s0 + u_first * kRound, s1, dk4, dv4,
                        team, lane);
    for (int u = u_first; u < u_end; u += 2) {
      if (u + 1 < u_end)
        load_unit<DK, DV>(kb, vb, k_head, v_head, sk.l, sv.l, s0 + (u + 1) * kRound, s1, dk4,
                          dv4, team, lane);
      fold(ka, va, u);
      if (u + 1 >= u_end) break;
      if (u + 2 < u_end)
        load_unit<DK, DV>(ka, va, k_head, v_head, sk.l, sv.l, s0 + (u + 2) * kRound, s1, dk4,
                          dv4, team, lane);
      fold(kb, vb, u + 1);
    }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) ml_s[team * R + r] = make_float2(m[r], l[r]);
#pragma unroll
    for (int c = 0; c < D::kVecV; ++c)
      acc_s[(team * R + r) * D::kA4 + lane + D::kLanes * c] = acc[r][c];
  }
  __syncthreads();

  // fold the teams in team order, each weighted by exp(m_team - m): each
  // row's max, then each team's weight once (in place of its m; -1 for a
  // team that saw no key of the row), then the weighted sums
  if (threadIdx.x < R) {
    float mx = -INFINITY;
    for (int t = 0; t < D::kTeams; ++t) mx = fmaxf(mx, ml_s[t * R + threadIdx.x].x);
    fold_m[threadIdx.x] = mx;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D::kTeams * R; e += kDecodeThreads) {
    const float m_t = ml_s[e].x;
    ml_s[e].x = m_t == -INFINITY ? -1.f : expf(m_t - fold_m[e % R]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * dv4; e += kDecodeThreads) {
    const int r = e / dv4, c = e % dv4;
    const float mx = fold_m[r];
    float ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < D::kTeams; ++t) {
      const float2 ml = ml_s[t * R + r];
      const float w = ml.x;
      if (w < 0.f) continue;  // the team saw no key of this row
      const float4 at = acc_s[(t * R + r) * D::kA4 + c];
      ls = fmaf(ml.y, w, ls);
      a = make_float4(fmaf(at.x, w, a.x), fmaf(at.y, w, a.y), fmaf(at.z, w, a.z),
                      fmaf(at.w, w, a.w));
    }
    const int g = row0 + r;
    const int h = kvh * group + g / lq, i = g % lq;
    if (n_splits == 1) {
      const float denom = fmaxf(ls, 1e-30f);
      *reinterpret_cast<float4*>(out + b * so.b + h * so.h + static_cast<int64_t>(i) * so.l +
                                 4 * c) =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    } else {
      const int64_t slot = (static_cast<int64_t>(b * n_heads + h) * lq + i) * n_splits + split;
      part_acc[slot * dv4 + c] = a;
      if (c == 0) part_ml[slot] = make_float2(mx, ls);
    }
  }
  if (n_splits == 1) return;

  // The last block of the row tile to finish folds the splits. The count
  // is a release of this block's partials (ordered before it by the
  // barrier) and an acquire of the others'; it is no part of any sum.
  __syncthreads();
  if (threadIdx.x == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(before)
                 : "l"(counters + tile_id)
                 : "memory");
    is_last = before == n_splits - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // out[row] = the splits' partials folded in split order, each weighted by
  // exp(m_split - m), over their weighted l clamped at 1e-30. The partials
  // pass through acc_s and ml_s kTeams splits at a time (all of them at
  // once where they fit), every thread loading some at once (the first
  // design's combine walked the splits one load after another); each row's
  // max over all splits comes first.
  auto slot_of = [&](int r, int s) {
    const int g = row0 + r;
    return (static_cast<int64_t>(b * n_heads + kvh * group + g / lq) * lq + g % lq) * n_splits +
           s;
  };
  auto stage = [&](int s0_, int cn, bool with_acc) {
    for (int e = threadIdx.x; e < n_rows * cn; e += kDecodeThreads)
      ml_s[e] = __ldcg(part_ml + slot_of(e / cn, s0_ + e % cn));  // [r][s]
    if (with_acc)
      for (int e = threadIdx.x; e < n_rows * cn * dv4; e += kDecodeThreads) {
        const int c = e % dv4, rs = e / dv4;
        acc_s[e] = __ldcg(part_acc + slot_of(rs / cn, s0_ + rs % cn) * dv4 + c);  // [r][s][c]
      }
    __syncthreads();
  };
  const bool one_pass = n_splits <= D::kTeams;  // every split's partials fit at once
  if (threadIdx.x < R) fold_m[threadIdx.x] = -INFINITY;
  for (int c0 = 0; c0 < n_splits && !one_pass; c0 += D::kTeams) {
    const int cn = min(D::kTeams, n_splits - c0);
    stage(c0, cn, false);
    if (threadIdx.x < n_rows)
      for (int s = 0; s < cn; ++s)
        fold_m[threadIdx.x] = fmaxf(fold_m[threadIdx.x], ml_s[threadIdx.x * cn + s].x);
    __syncthreads();
  }
  constexpr int kPer = (R * D::kA4 + kDecodeThreads - 1) / kDecodeThreads;  // elements a thread
  float ls[kPer];
  float4 a[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    ls[i] = 0.f;
    a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c0 = 0; c0 < n_splits; c0 += D::kTeams) {
    const int cn = min(D::kTeams, n_splits - c0);
    stage(c0, cn, true);
    if (one_pass) {
      if (threadIdx.x < n_rows)
        for (int s = 0; s < cn; ++s)
          fold_m[threadIdx.x] = fmaxf(fold_m[threadIdx.x], ml_s[threadIdx.x * cn + s].x);
      __syncthreads();
    }
    // each split's weight once, in place of its m (-1: no key of the split reaches the row)
    for (int e = threadIdx.x; e < n_rows * cn; e += kDecodeThreads) {
      const float m_s = ml_s[e].x;
      ml_s[e].x = m_s == -INFINITY ? -1.f : expf(m_s - fold_m[e / cn]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kDecodeThreads;
      if (e >= n_rows * dv4) break;
      const int r = e / dv4, c = e % dv4;
      for (int s = 0; s < cn; ++s) {
        const float2 p = ml_s[r * cn + s];
        const float w = p.x;
        if (w < 0.f) continue;  // no key of this split reaches the row
        const float4 at = acc_s[(r * cn + s) * dv4 + c];
        ls[i] = fmaf(p.y, w, ls[i]);
        a[i] = make_float4(fmaf(at.x, w, a[i].x), fmaf(at.y, w, a[i].y), fmaf(at.z, w, a[i].z),
                           fmaf(at.w, w, a[i].w));
      }
    }
    __syncthreads();  // before the next chunk overwrites acc_s and ml_s
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kDecodeThreads;
    if (e >= n_rows * dv4) break;
    const int r = e / dv4, c = e % dv4;
    const int g = row0 + r;
    const int h = kvh * group + g / lq, pos = g % lq;
    const float denom = fmaxf(ls[i], 1e-30f);
    *reinterpret_cast<float4*>(out + b * so.b + h * so.h + static_cast<int64_t>(pos) * so.l +
                               4 * c) = make_float4(a[i].x / denom, a[i].y / denom,
                                                    a[i].z / denom, a[i].w / denom);
  }
  if (threadIdx.x == 0) counters[tile_id] = 0;  // ready for the next call on the stream
}

template <int DK, int DV, int R>
static cudaError_t launch_decode_rows(const float* q, const float* k, const float* v, float* out,
                                      float4* part_acc, float2* part_ml, int* counters,
                                      int batch, int n_heads, int n_kv_heads, int lq, int lk,
                                      int dqk, int dv, const Strides* st, int causal, int window,
                                      float scale, int n_splits, int chunk, cudaStream_t stream) {
  using D = Decode<DK, DV>;
  const int64_t rows = static_cast<int64_t>(n_heads / n_kv_heads) * lq;
  const int64_t blocks =
      static_cast<int64_t>(batch) * n_kv_heads * ((rows + R - 1) / R) * n_splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  constexpr size_t smem = D::template smem_bytes<R>();
  static_assert(smem <= 227 * 1024, "a decode block's shared memory");
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err = raise_smem(flash_decode_kernel<DK, DV, R>, static_cast<int>(smem), raised);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<DK, DV, R><<<static_cast<unsigned>(blocks), kDecodeThreads, smem, stream>>>(
      q, k, v, out, part_acc, part_ml, counters, n_heads, n_kv_heads, lq, lk, st[0], st[1], st[2],
      st[3], dqk, dv, causal, window, scale, n_splits, chunk);
  return cudaGetLastError();
}

static cudaError_t launch_decode(int dqk, int dv, int row_tile, const float* q, const float* k,
                                 const float* v, float* out, float4* part_acc, float2* part_ml,
                                 int* counters, int batch, int n_heads, int n_kv_heads, int lq,
                                 int lk, const Strides* st, int causal, int window, float scale,
                                 int n_splits, int chunk, cudaStream_t stream) {
  int w[2];
  if (!pick(dqk, dv, w)) return cudaErrorInvalidValue;
#define REPRO_FA_ROWS(DK, DV, R)                                                               \
  if (row_tile == R)                                                                           \
    return launch_decode_rows<DK, DV, R>(q, k, v, out, part_acc, part_ml, counters, batch,     \
                                         n_heads, n_kv_heads, lq, lk, dqk, dv, st, causal,     \
                                         window, scale, n_splits, chunk, stream);
#define REPRO_FA_DECODE(DK, DV) \
  if (w[0] == DK && w[1] == DV) {  \
    REPRO_FA_ROWS(DK, DV, 1)       \
    REPRO_FA_ROWS(DK, DV, 2)       \
    REPRO_FA_ROWS(DK, DV, 4)       \
    return cudaErrorInvalidValue;  \
  }
  REPRO_FA_WIDTHS(REPRO_FA_DECODE)
#undef REPRO_FA_DECODE
#undef REPRO_FA_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace repro_fa

// q [B, H, Lq, Dqk], k [B, Hkv, Lk, Dqk], v [B, Hkv, Lk, Dv], out [B, H, Lq,
// Dv], all float32, given by their data pointers and strides[12] = (batch,
// head, position) element strides of q, k, v, out in that order, the last
// dim contiguous and every row aligned for a 16-byte load. (Dqk, Dv) is a
// pair repro_flash_attention_widths takes; H is a multiple of Hkv. row_tile
// is the query rows a block holds, that of one of the forms of the pair's
// instantiation (Tile<DK, DV, F>::BM: large, mid up to DK 256, small; any
// other value is cudaErrorInvalidValue). Returns cudaGetLastError() after
// the launch (0 on success). lse: null, or float32 [B, H, Lq] contiguous,
// into which the kernel writes each row's log-sum-exp as the backward takes
// it (csrc/flash_attention_bwd.cu): log2 domain of the scaled scores, m +
// log2(l) of the row's running max and sum, +inf for a row that sees no
// key. The output's bits are the same with and without it.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int batch, int n_heads, int n_kv_heads, int lq,
                                     int lk, int dqk, int dv, const int64_t* strides, int causal,
                                     int window, float scale, int row_tile, void* stream) {
  using namespace repro_fa;
  if (batch <= 0 || lq <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lk < 0) return cudaErrorInvalidValue;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  return launch(dqk, dv, row_tile, nullptr, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(out), static_cast<float*>(lse), batch, n_heads, n_kv_heads,
                lq, lk, st, causal, window, scale, static_cast<cudaStream_t>(stream));
}

// The blocks of the tile route's kernel for (dqk, dv) whose blocks hold
// row_tile rows that one SM of the current device holds at once, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor computes them from the
// kernel's registers, threads and shared memory, into *blocks. Returns 0, or
// the CUDA error (cudaErrorInvalidValue for a pair or row tile the route
// does not take).
extern "C" int repro_flash_attention_tile_occupancy(int dqk, int dv, int row_tile, int* blocks) {
  using namespace repro_fa;
  return launch(dqk, dv, row_tile, blocks, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, 1,
                0, 0, nullptr, 0, 0, 0.f, nullptr);
}

// The decode route: the same arguments as repro_flash_attention, then
// scratch for each row's partial of every split (part_acc [B*H*Lq,
// n_splits, Dv] and part_ml [B*H*Lq, n_splits, 2] float32) and a counter
// a row tile (counters: int32 [B*Hkv*row tiles], all 0, which every call
// leaves at 0 again); all three unused, and may be null, when n_splits is
// 1. Then the query rows a block holds (row_tile: 1, 2 or 4) and the
// splits: split s holds keys [s * chunk, min(Lk, (s + 1) * chunk)),
// n_splits >= 1, chunk >= 1, none empty. One kernel, whose last block of a
// row tile folds the splits. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int repro_flash_attention_decode(const void* q, const void* k, const void* v,
                                            void* out, int batch, int n_heads, int n_kv_heads,
                                            int lq, int lk, int dqk, int dv,
                                            const int64_t* strides, int causal, int window,
                                            float scale, void* part_acc, void* part_ml,
                                            void* counters, int row_tile, int n_splits,
                                            int chunk, void* stream) {
  using namespace repro_fa;
  if (batch <= 0 || lq <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lk < 0 || n_splits < 1 || chunk < 1 ||
      static_cast<int64_t>(n_splits - 1) * chunk >= (lk > 0 ? lk : 1) ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)) ||
      row_tile < 1 || row_tile > kDecodeRowsMax)
    return cudaErrorInvalidValue;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  return launch_decode(dqk, dv, row_tile, static_cast<const float*>(q),
                       static_cast<const float*>(k), static_cast<const float*>(v),
                       static_cast<float*>(out), static_cast<float4*>(part_acc),
                       static_cast<float2*>(part_ml), static_cast<int*>(counters), batch,
                       n_heads, n_kv_heads, lq, lk, st, causal, window, scale, n_splits, chunk,
                       static_cast<cudaStream_t>(stream));
}

// The widths (DK, DV) of the instantiation both routes run (dqk, dv) at,
// into widths[2]: 0, or -1 for a pair they do not take (see pick).
extern "C" int repro_flash_attention_widths(int dqk, int dv, int* widths) {
  return repro_fa::pick(dqk, dv, widths) ? 0 : -1;
}

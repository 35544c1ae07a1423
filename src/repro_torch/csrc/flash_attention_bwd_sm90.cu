// Backward pass of blocked softmax attention for Hopper's tensor cores:
// bfloat16 in, every product through wgmma with float32 accumulators,
// bfloat16 gradients out. Every bfloat16 attention backward of the port
// runs here; float32 runs csrc/flash_attention_bwd.cu on the CUDA cores.
//
// Replaces no TPU kernel: the reference trains through plain JAX, where
// XLA differentiates its naive attention (models/attention.py, _sdpa). The
// port's forward runs every bfloat16 attention through
// flash_attention_sm90.cu, which autograd cannot see into, so
// kernels/flash_attention.py wraps it in FlashAttentionFn, whose backward
// launches this source. It differentiates the Pallas kernel
// src/repro/kernels/flash_attention.py:103 (flash_attention_call).
//
// What it computes, for the forward's semantics (the caller's scale,
// causal mask, sliding window, query i at position Lk - Lq + i, GQA with H
// a multiple of Hkv, values of Dv <= Dqk columns, strided [B, L, H, D]
// views read and written in place):
//   P  = exp2(scale * log2(e) * Q K^T - lse) over the keys a row sees,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// with the query heads of a kv head summed into its dK and dV. lse is the
// forward's own log-sum-exp of each row, which flash_attention_sm90.cu
// writes when asked (log2 domain: m + log2(l) of the scores scaled by
// scale * log2(e); +inf for a row that sees no key, whose P is then 0 and
// which has no gradient). Masked pairs have P = 0.
//
// Numeric contract: Q, K, V and dO enter every product as the bf16 values
// they are. P and dS are rounded to bf16 before they enter a product (P
// in dV = P^T dO, dS in dK and dQ; wgmma takes bf16 operands). Scores,
// the exponentials (the hardware's ex2.approx, within 2 ulp), delta and
// all accumulators stay float32; dS is formed from the float32 P. dQ, dK
// and dV are scaled once at the end and written in bf16. The plain model
// of these numerics is ref.flash_attention_bwd_sm90_ref; the exact
// float32 formula, ref.flash_attention_bwd_ref, holds the kernels to a
// row-relative 5e-2 on the card.
//
// Bound on this card: operations. The least work is the three products
// of a visible (query, key) pair the backward cannot avoid beside S and
// dP, 2 * (3 Dqk + 2 Dv) FLOPs at 989 TFLOP/s bf16; this source computes
// S and dP twice (once for dK/dV, once for dQ), 2 * (4 Dqk + 3 Dv) FLOPs
// a pair (1.4x the least at Dqk = Dv), all of it on the tensor cores, and
// skips whole tiles outside a tile's causal or window range.
//
// Three kernels, launched in order on the caller's stream:
// (a) row_delta: delta = rowsum(dO o O) in float32, one warp a row, and
//     the forward's lse copied beside it; both into a scratch of rows
//     padded to a multiple of 64 (lse +inf and delta 0 past Lq), so that
//     a query tile's statistics are one aligned bulk copy. Bound by bytes.
// (b) dkdv: one block of one warpgroup per (batch, kv head, 64 keys). Its
//     K and V tiles arrive by TMA once. It walks the query heads of its
//     group and, in each, the query tiles of QT rows that see its keys,
//     Q, dO, lse and delta arriving by TMA (and bulk copies) in a ring of
//     two stages, so that the next tile's copy is in flight during the
//     products. Per tile: S^T = K Q^T and dP^T = V dO^T (both operands in
//     shared memory, K-major); P^T = exp2(S^T - lse), masked, becomes the
//     register A operand of dV += P^T dO (dO MN-major) while dP^T is still
//     being computed; dS^T = P^T o (dP^T - delta) becomes that of dK +=
//     dS^T Q (Q MN-major). The group is summed inside the block: no
//     atomics, and dQ is not written here.
// (c) dq: one block of one warpgroup per (batch, kv head, 64 query rows);
//     as in the forward the rows enumerate (query head of the group,
//     position), so the group shares each K/V stage. Q (up to Dqk 128)
//     and dO are loaded once into registers as wgmma's A fragments (at
//     Dqk 192 Q goes to shared memory by cp.async), with each row's lse
//     and delta. It walks the key tiles its rows see, K and V by TMA in the
//     forward's two-stage ring: S = Q K^T and dP = dO V^T (K and V
//     K-major), P, dS, then dQ += dS K with K read MN-major (the transposed
//     descriptor, as the forward reads V).
// Blocks are ordered so those with the most work start first: key tiles
// from the first (under a causal mask the most queries see them), row
// tiles from the last position. Every sum is taken in an order the shape
// alone fixes: no atomics, no split over keys, so two calls on the same
// inputs give the same bits.
//
// Widths. The kernels are instantiated at the (DQK, DV, QT) of
// FA_BWD90_WIDTHS; a call takes the narrowest that holds its (Dqk, Dv)
// (pick, asked through repro_flash_attention_bwd_sm90_widths), so 120, 80
// and (48, 32) run at 128 and 64 with zero columns: TMA fills the part of
// a box past a tensor map's width with zeros, and the fragment loads are
// predicated. A width that is no multiple of 8 (16-byte rows), or wider
// than every instantiation, is refused.

#include "sm90.cuh"

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace repro_fa_bwd90 {

using namespace repro_sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // ring depth of the query tiles (dkdv) and K/V tiles (dq)
constexpr int kKeys = 64;      // keys of a dkdv block and of a dq key tile: wgmma's M, N
constexpr int kRows = 64;      // query rows of a dq block: wgmma's M
constexpr int kPad = 64;       // the scratch's rows are padded to a multiple of this
constexpr int kDeltaRows = 8;  // rows of a row_delta block: one warp each

// ---------------------------------------------------------------------------
// (a) delta = rowsum(dO o O), and lse beside it, into the padded scratch
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kDeltaRows)
row_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ lse_pad,
                 float* __restrict__ delta_pad, int n_heads, int lq, int lq_pad, int dv,
                 Strides so, Strides sdo, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kDeltaRows + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t bh = row / lq_pad;
  const int i = static_cast<int>(row % lq_pad);
  float acc = 0.f;
  if (i < lq) {
    const int b = static_cast<int>(bh / n_heads), h = static_cast<int>(bh % n_heads);
    const __nv_bfloat16* orow = o + b * so.b + h * so.h + i * so.l;
    const __nv_bfloat16* grow = dout + b * sdo.b + h * sdo.h + i * sdo.l;
    for (int d = 2 * lane; d < dv; d += 64) {  // Dv is a multiple of 8: pairs stay whole
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(grow + d));
      acc = fmaf(g.x, x.x, acc);
      acc = fmaf(g.y, x.y, acc);
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    delta_pad[row] = acc;
    lse_pad[row] = i < lq ? lse[bh * lq + i] : INFINITY;
  }
}

// (key, query position) is a visible pair
__device__ __forceinline__ bool visible(int key, int qpos, int lk, int causal, int window) {
  return key < lk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// ---------------------------------------------------------------------------
// (b) dK and dV of 64 keys of one kv head
// ---------------------------------------------------------------------------

// Shared memory of a dkdv block: its K and V tiles, then two stages of a
// query tile's Q and dO, then the stages' lse and delta (QT floats each);
// every tile starts on a 1024-byte boundary (the 128B swizzle's period).
template <int DQK, int DV, int QT> struct DkdvShape {
  using TK = Tile<DQK, kKeys>;
  using TV = Tile<DV, kKeys>;
  using TQ = Tile<DQK, QT>;
  using TO = Tile<DV, QT>;
  static constexpr int kTileBytes = TQ::kBytes + TO::kBytes;
  static constexpr int kStatBytes = 2 * QT * 4;
  static constexpr int kTx = kTileBytes + kStatBytes;  // bytes a stage's copies bring
  static constexpr int kSmemBytes =
      TK::kBytes + TV::kBytes + kStages * (kTileBytes + kStatBytes) + 1024;  // + alignment
};

template <int DQK, int DV, int QT>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dvo, int n_kv_heads,
            int group, int lq, int lq_pad, int lk, int dqk, int dv, int bh_count, Strides sdk,
            Strides sdv, int causal, int window, float scale_log2, float scale) {
  using S = DkdvShape<DQK, DV, QT>;
  using TK = typename S::TK;
  using TV = typename S::TV;
  using TQ = typename S::TQ;
  using TO = typename S::TO;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[kStages + 1];  // a stage's copies have landed; [kStages]: K and V
  const uint32_t k_smem =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t v_smem = k_smem + TK::kBytes;
  const auto q_smem = [&](int s) { return v_smem + TV::kBytes + S::kTileBytes * s; };
  const auto do_smem = [&](int s) { return q_smem(s) + TQ::kBytes; };
  const uint32_t stat0 = v_smem + TV::kBytes + S::kTileBytes * kStages;
  const auto stat_smem = [&](int s) { return stat0 + S::kStatBytes * s; };  // lse, then delta
  const float* stat_ptr = reinterpret_cast<const float*>(
      smem_raw + (stat0 - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))));
  const auto bar = [&](int s) { return static_cast<uint32_t>(__cvta_generic_to_shared(&bars[s])); };

  // (batch, kv head) varies fastest; key tiles come first to last
  const int bh = blockIdx.x % bh_count, kt = blockIdx.x / bh_count;
  const int kvh = bh % n_kv_heads, b = bh / n_kv_heads;
  const int k0 = kt * kKeys, k1 = min(lk, k0 + kKeys);
  const int off = lk - lq;  // position of query 0
  // the query rows that see some key of [k0, k1), and their tiles of QT
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(lq, k1 - 1 + window - off) : lq;
  const int t_lo = i_lo / QT;
  const int n_q = i_hi > i_lo ? (i_hi - 1) / QT - t_lo + 1 : 0;
  const int n_tiles = group * n_q;  // query heads of the group x tiles of each
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
  __nv_bfloat16* dvb = dvo + b * sdv.b + kvh * sdv.h;

  if (n_tiles == 0) {  // no query sees these keys: their gradients are 0
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int idx = tid; idx < kKeys * (DQK / 2); idx += kThreads) {
      const int j = idx / (DQK / 2), c = 2 * (idx % (DQK / 2));
      if (k0 + j >= lk) continue;
      if (c < dqk) *reinterpret_cast<__nv_bfloat162*>(dkb + (k0 + j) * sdk.l + c) = zero;
      if (c < dv) *reinterpret_cast<__nv_bfloat162*>(dvb + (k0 + j) * sdv.l + c) = zero;
    }
    return;
  }

  // one thread asks for query tile n (head gi of the group, tile t) into a stage
  const auto load_q = [&](int n, int s) {
    const int h = kvh * group + n / n_q, q0 = (t_lo + n % n_q) * QT;
    mbar_expect_tx(bar(s), S::kTx);
#pragma unroll
    for (int a = 0; a < TQ::kAtoms; ++a)
      tma_load_4d(q_smem(s) + a * TQ::kAtomBytes, &q_map, bar(s), a * TQ::kElemsPerRow, q0, h, b);
#pragma unroll
    for (int a = 0; a < TO::kAtoms; ++a)
      tma_load_4d(do_smem(s) + a * TO::kAtomBytes, &do_map, bar(s), a * TO::kElemsPerRow, q0, h,
                  b);
    const int64_t row = (static_cast<int64_t>(b) * n_kv_heads * group + h) * lq_pad + q0;
    bulk_load(stat_smem(s), lse_pad + row, QT * 4, bar(s));
    bulk_load(stat_smem(s) + QT * 4, delta_pad + row, QT * 4, bar(s));
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= kStages; ++s) mbar_init(bar(s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar(kStages), TK::kBytes + TV::kBytes);
#pragma unroll
    for (int a = 0; a < TK::kAtoms; ++a)
      tma_load_4d(k_smem + a * TK::kAtomBytes, &k_map, bar(kStages), a * TK::kElemsPerRow, k0,
                  kvh, b);
#pragma unroll
    for (int a = 0; a < TV::kAtoms; ++a)
      tma_load_4d(v_smem + a * TV::kAtomBytes, &v_map, bar(kStages), a * TV::kElemsPerRow, k0,
                  kvh, b);
    load_q(0, 0);
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(bar(kStages), 0);

  float dka[DQK / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
  // the two keys (rows of S^T) whose accumulator fragments this thread holds
  int kp[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) kp[rr] = k0 + 16 * warp + lane / 4 + 8 * rr;

  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n % kStages;
    if (tid == 0 && n + 1 < n_tiles) load_q(n + 1, (n + 1) % kStages);
    mbar_wait(bar(stage), (n / kStages) & 1);
    const int q0 = (t_lo + n % n_q) * QT;
    const float* lse_s = stat_ptr + 2 * QT * stage;
    const float* delta_s = lse_s + QT;

    // S^T = K Q^T and dP^T = V dO^T: accumulator register j holds key row
    // 16*warp + lane/4 + 8*((j/2)%2), query column 8*(j/4) + 2*(lane%4) + j%2
    float s[QT / 2], dp[QT / 2];
#pragma unroll
    for (int j = 0; j < QT / 2; ++j) s[j] = dp[j] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      Wgmma<QT>::ss(s, TK::k_major(k_smem, kk), TQ::k_major(q_smem(stage), kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      Wgmma<QT>::ss(dp, TV::k_major(v_smem, kk), TO::k_major(do_smem(stage), kk));
    wgmma_commit();
    wgmma_wait<1>();  // S^T has landed
    fence_regs(s);

    // P^T = exp2(S^T - lse) where visible, in float32 (into s), and in bf16
    // as wgmma's A fragment
    const bool edge = (causal && k0 + kKeys - 1 > off + q0) ||
                      (window > 0 && k0 <= off + q0 + QT - 1 - window) || k0 + kKeys > lk;
    uint32_t pa[QT / 16][4];
#pragma unroll
    for (int j = 0; j < QT / 2; j += 2) {
      const int rr = (j >> 1) & 1;
      const int c = 8 * (j >> 2) + 2 * (lane & 3);
      float p0 = fast_exp2(s[j] * scale_log2 - lse_s[c]);
      float p1 = fast_exp2(s[j + 1] * scale_log2 - lse_s[c + 1]);
      if (edge) {
        if (!visible(kp[rr], off + q0 + c, lk, causal, window)) p0 = 0.f;
        if (!visible(kp[rr], off + q0 + c + 1, lk, causal, window)) p1 = 0.f;
      }
      s[j] = p0;
      s[j + 1] = p1;
      pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
    }
    // dV += P^T dO
    fence_regs(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      Wgmma<DV>::template rs<1>(dva, pa[kk], TO::mn_major(do_smem(stage), kk));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV may still run
    fence_regs(dp);

    // dS^T = P^T o (dP^T - delta), in bf16 as the A fragment of dK += dS^T Q
    uint32_t dsa[QT / 16][4];
#pragma unroll
    for (int j = 0; j < QT / 2; j += 2) {
      const int c = 8 * (j >> 2) + 2 * (lane & 3);
      dsa[j / 8][(j % 8) / 2] =
          pack_bf16(s[j] * (dp[j] - delta_s[c]), s[j + 1] * (dp[j + 1] - delta_s[c + 1]));
    }
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      Wgmma<DQK>::template rs<1>(dka, dsa[kk], TQ::mn_major(q_smem(stage), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(dsa);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // dK * scale and dV in bf16 through their strides; keys past Lk and
  // columns past Dqk, Dv are dropped
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kp[rr];
    if (key >= lk) continue;
#pragma unroll
    for (int c8 = 0; c8 < DQK / 8; ++c8) {
      const int i = 4 * c8 + 2 * rr, col = 8 * c8 + 2 * (lane & 3);
      if (col < dqk)
        *reinterpret_cast<__nv_bfloat162*>(dkb + key * sdk.l + col) =
            __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
    }
#pragma unroll
    for (int c8 = 0; c8 < DV / 8; ++c8) {
      const int i = 4 * c8 + 2 * rr, col = 8 * c8 + 2 * (lane & 3);
      if (col < dv)
        *reinterpret_cast<__nv_bfloat162*>(dvb + key * sdv.l + col) =
            __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dQ of 64 query rows of one kv head's group
// ---------------------------------------------------------------------------

// Rows r and r + 8 of a row tile (row r: query head head0 + r / lq, position
// r % lq) of a [B, H, L, width] bf16 tensor as wgmma's A fragment: k-step kk
// holds (r, cols 16kk + 2(lane%4) + {0, 1}), (r + 8, same), (r, those + 8),
// (r + 8, those + 8); rows past the end and columns past the width are 0.
template <int STEPS>
__device__ __forceinline__ void load_frag(uint32_t (&frag)[STEPS][4],
                                          const __nv_bfloat16* __restrict__ base,
                                          const Strides& st, int width, int r, int rows_total,
                                          int lq, int head0, int b, int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr, r += 8) {
    const bool live = r < rows_total;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(
        base + b * st.b + (head0 + (live ? r / lq : 0)) * st.h + (live ? r % lq : 0) * st.l);
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      const int c = 16 * kk + 2 * (lane & 3);  // widths are multiples of 8: pairs stay whole
      frag[kk][rr] = live && c < width ? __ldg(row + 8 * kk + (lane & 3)) : 0u;
      frag[kk][rr + 2] = live && c + 8 < width ? __ldg(row + 8 * kk + 4 + (lane & 3)) : 0u;
    }
  }
}

// Shared memory of a dq block: Q (at Dqk 192 only), then two K/V stages.
template <int DQK, int DV> struct DqShape {
  using TQ = Tile<DQK, kRows>;
  using TK = Tile<DQK, kKeys>;
  using TV = Tile<DV, kKeys>;
  // Q lives in registers as wgmma's A operand up to Dqk 128, in shared
  // memory at 192 (the registers then hold the wider dQ)
  static constexpr bool kQInRegs = DQK <= 128;
  static constexpr int kQBytes = kQInRegs ? 0 : TQ::kBytes;
  static constexpr int kStageBytes = TK::kBytes + TV::kBytes;
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;  // + alignment
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
          const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
          __nv_bfloat16* __restrict__ dq, int n_kv_heads, int group, int lq, int lq_pad, int lk,
          int dqk, int dv, int row_tiles, int bh_count, Strides sq, Strides sdo, Strides sdq,
          int causal, int window, float scale_log2, float scale) {
  using S = DqShape<DQK, DV>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using TV = typename S::TV;
  constexpr int kChunks = DQK / 8;  // 16-byte chunks per Q row
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];  // one barrier per stage: its K and V tiles have landed
  const uint32_t q_smem =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const auto k_smem = [&](int s) { return q_smem + S::kQBytes + S::kStageBytes * s; };
  const auto v_smem = [&](int s) { return k_smem(s) + TK::kBytes; };
  const auto bar = [&](int s) { return static_cast<uint32_t>(__cvta_generic_to_shared(&full[s])); };

  // (batch, kv head) varies fastest; row tiles come longest first (the forward's order)
  const int bh = blockIdx.x % bh_count;
  const int rank = blockIdx.x / bh_count;
  int tile;
  if (causal && lq % kRows == 0) {
    const int per_head = lq / kRows;  // tiles lie inside one head: latest positions first
    tile = (rank % group) * per_head + (per_head - 1 - rank / group);
  } else {
    tile = row_tiles - 1 - rank;
  }
  const int kvh = bh % n_kv_heads, b = bh / n_kv_heads;
  const int rows_total = group * lq;
  const int r0 = tile * kRows;
  const int r1 = min(r0 + kRows, rows_total);
  int min_i = 0, max_i = lq - 1;  // positions of the tile's rows (all, if it spans two heads)
  if (r0 / lq == (r1 - 1) / lq) {
    min_i = r0 % lq;
    max_i = (r1 - 1) % lq;
  }
  const int pos0 = lk - lq;  // position of query 0
  const int k_end = causal ? min(lk, pos0 + max_i + 1) : lk;
  const int k_begin = window > 0 ? max(0, pos0 + min_i - window + 1) : 0;
  const int min_hi = causal ? min(lk, pos0 + min_i + 1) : lk;  // keys every row sees: [max_lo, min_hi)
  const int max_lo = window > 0 ? max(0, pos0 + max_i - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the two rows whose accumulator fragments this thread holds: their keys
  // [lo, hi), lse and delta (rows past the end: no key, P = 0)
  int lo[2], hi[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 16 * warp + lane / 4 + 8 * rr;
    const int p = pos0 + r % lq;
    const bool live = r < rows_total;
    hi[rr] = live ? (causal ? min(lk, p + 1) : lk) : 0;
    lo[rr] = live && window > 0 ? max(0, p - window + 1) : 0;
    const int64_t at =
        (static_cast<int64_t>(b) * n_kv_heads * group + kvh * group + r / lq) * lq_pad + r % lq;
    lse_r[rr] = live ? lse_pad[at] : INFINITY;
    delta_r[rr] = live ? delta_pad[at] : 0.f;
  }

  uint32_t qa[S::kQInRegs ? DQK / 16 : 1][4];
  uint32_t oa[DV / 16][4];
  const int head0 = kvh * group;
  load_frag(oa, dout, sdo, dv, r0 + 16 * warp + lane / 4, rows_total, lq, head0, b, lane);
  if constexpr (S::kQInRegs) {
    load_frag(qa, q, sq, dqk, r0 + 16 * warp + lane / 4, rows_total, lq, head0, b, lane);
  } else {
    for (int idx = tid; idx < kRows * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = idx % kChunks, r = r0 + j;
      const bool ok = r < rows_total && c * 8 < dqk;
      const __nv_bfloat16* src =
          ok ? q + b * sq.b + (kvh * group + r / lq) * sq.h + (r % lq) * sq.l + c * 8 : q;
      cp_async16(q_smem + TQ::offset(j, c), src, ok);
    }
    cp_async_commit();
  }
  // one thread asks TMA for a tile's K and V, one box per swizzle atom; keys
  // past Lk and columns past the maps' widths arrive as zeros
  const auto load_kv = [&](int t, int s) {
    const int k0 = k_begin + t * kKeys;
    mbar_expect_tx(bar(s), S::kStageBytes);
#pragma unroll
    for (int a = 0; a < TK::kAtoms; ++a)
      tma_load_4d(k_smem(s) + a * TK::kAtomBytes, &k_map, bar(s), a * TK::kElemsPerRow, k0, kvh, b);
#pragma unroll
    for (int a = 0; a < TV::kAtoms; ++a)
      tma_load_4d(v_smem(s) + a * TV::kAtomBytes, &v_map, bar(s), a * TV::kElemsPerRow, k0, kvh, b);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar(s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) load_kv(0, 0);
  }
  cp_async_wait<0>();  // Q has landed
  fence_proxy_async();
  __syncthreads();

  float dqa[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dqa[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1, (t + 1) % kStages);
    mbar_wait(bar(stage), (t / kStages) & 1);  // tile t has landed

    // S = Q K^T and dP = dO V^T: accumulator register j holds row
    // 16*warp + lane/4 + 8*((j/2)%2), key 8*(j/4) + 2*(lane%4) + j%2
    float s[kKeys / 2], dp[kKeys / 2];
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j) s[j] = dp[j] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      if constexpr (S::kQInRegs)
        Wgmma<kKeys>::template rs<0>(s, qa[kk], TK::k_major(k_smem(stage), kk));
      else
        Wgmma<kKeys>::ss(s, TQ::k_major(q_smem, kk), TK::k_major(k_smem(stage), kk));
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      Wgmma<kKeys>::template rs<0>(dp, oa[kk], TV::k_major(v_smem(stage), kk));
    wgmma_commit();
    wgmma_wait<1>();  // S has landed
    fence_regs(s);

    const int k0 = k_begin + t * kKeys;
    const bool edge = k0 < max_lo || k0 + kKeys > min_hi;  // some key is masked for some row
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j) {
      const int rr = (j >> 1) & 1;
      const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      const float p = fast_exp2(s[j] * scale_log2 - lse_r[rr]);
      s[j] = edge && (kp < lo[rr] || kp >= hi[rr]) ? 0.f : p;
    }
    wgmma_wait<0>();  // dP has landed
    fence_regs(dp);
    // dS = P o (dP - delta) in bf16 as wgmma's A fragment
    uint32_t dsa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 2; j += 2) {
      const int rr = (j >> 1) & 1;
      dsa[j / 8][(j % 8) / 2] =
          pack_bf16(s[j] * (dp[j] - delta_r[rr]), s[j + 1] * (dp[j + 1] - delta_r[rr]));
    }
    // dQ += dS K
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      Wgmma<DQK>::template rs<1>(dqa, dsa[kk], TK::mn_major(k_smem(stage), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dsa);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // dQ * scale in bf16 through its strides; rows past Lq * group and
  // columns past Dqk are dropped
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 16 * warp + lane / 4 + 8 * rr;
    if (r >= rows_total) continue;
    __nv_bfloat16* row = dq + b * sdq.b + (kvh * group + r / lq) * sdq.h + (r % lq) * sdq.l;
#pragma unroll
    for (int c8 = 0; c8 < DQK / 8; ++c8) {
      const int i = 4 * c8 + 2 * rr, col = 8 * c8 + 2 * (lane & 3);
      if (col < dqk)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(dqa[i] * scale, dqa[i + 1] * scale);
    }
  }
}

// Raises a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& raised) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if ((raised.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int DQK, int DV, int QT>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, void* dq, void* dk, void* dv_out,
                          float* scratch, int batch, int n_heads, int n_kv_heads, int lq, int lk,
                          int dqk, int dv, const Strides* st, int causal, int window, float scale,
                          cudaStream_t stream) {
  using SB = DkdvShape<DQK, DV, QT>;
  using SC = DqShape<DQK, DV>;
  static_assert(SB::kSmemBytes <= 227 * 1024 && SC::kSmemBytes <= 227 * 1024,
                "a block's shared memory");
  static_assert(kPad % QT == 0, "a query tile's statistics lie inside one padded row");
  if (dqk > DQK || dv > DV || dv > dqk) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> raised_b{0}, raised_c{0};
  cudaError_t e;
  if ((e = allow_smem(dkdv_kernel<DQK, DV, QT>, SB::kSmemBytes, raised_b)) != cudaSuccess) return e;
  if ((e = allow_smem(dq_kernel<DQK, DV>, SC::kSmemBytes, raised_c)) != cudaSuccess) return e;
  const int group = n_heads / n_kv_heads;
  const int lq_pad = (lq + kPad - 1) / kPad * kPad;
  const int64_t rows = static_cast<int64_t>(batch) * n_heads * lq_pad;
  const int64_t bh = static_cast<int64_t>(batch) * n_kv_heads;
  const int64_t row_tiles = (static_cast<int64_t>(group) * lq + kRows - 1) / kRows;
  const int64_t key_tiles = (lk + kKeys - 1) / kKeys;
  if (rows / kDeltaRows + 1 > INT_MAX || bh * row_tiles > INT_MAX || bh * key_tiles > INT_MAX)
    return cudaErrorInvalidConfiguration;
  float* lse_pad = scratch;
  float* delta_pad = scratch + rows;
  const float sl2 = scale * kLog2e;
  // st: q, k, v, o, dout, dq, dk, dv
  if (rows > 0) {
    row_delta_kernel<<<static_cast<unsigned>((rows + kDeltaRows - 1) / kDeltaRows),
                       32 * kDeltaRows, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
        lse_pad, delta_pad, n_heads, lq, lq_pad, dv, st[3], st[4], rows);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // the maps are never read where there is no key (dq's rows then see
  // none) or no query (no dkdv block reaches a query tile)
  CUtensorMap k_map{}, v_map{}, q_map{}, do_map{};
  if (lk > 0 && !(encode_4d<typename SB::TK>(&k_map, k, batch, n_kv_heads, lk, dqk, st[1]) &&
                  encode_4d<typename SB::TV>(&v_map, v, batch, n_kv_heads, lk, dv, st[2])))
    return cudaErrorInvalidValue;
  if (lq > 0 && !(encode_4d<typename SB::TQ>(&q_map, q, batch, n_heads, lq, dqk, st[0]) &&
                  encode_4d<typename SB::TO>(&do_map, dout, batch, n_heads, lq, dv, st[4])))
    return cudaErrorInvalidValue;
  if (bh * key_tiles > 0) {
    dkdv_kernel<DQK, DV, QT><<<static_cast<unsigned>(bh * key_tiles), kThreads, SB::kSmemBytes,
                               stream>>>(
        k_map, v_map, q_map, do_map, lse_pad, delta_pad, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv_out), n_kv_heads, group, lq, lq_pad, lk, dqk, dv,
        static_cast<int>(bh), st[6], st[7], causal, window, sl2, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (bh * row_tiles == 0) return cudaSuccess;
  dq_kernel<DQK, DV><<<static_cast<unsigned>(bh * row_tiles), kThreads, SC::kSmemBytes, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(dout), lse_pad, delta_pad,
      static_cast<__nv_bfloat16*>(dq), n_kv_heads, group, lq, lq_pad, lk, dqk, dv,
      static_cast<int>(row_tiles), static_cast<int>(bh), st[0], st[4], st[5], causal, window,
      sl2, scale);
  return cudaGetLastError();
}

// The instantiations, narrowest first: Q/K width, value width, query rows
// of a dkdv tile. The smoke configs (32, and MLA's (48, 32) at 64), the
// full configs' 128 (hubert's and zamba2's 80, h2o-danube's 120),
// deepseek-v2's MLA (192, 128). At (192, 128) a dkdv block's dK and dV
// accumulators take 160 registers a thread: with 64-row query tiles (S^T,
// dP^T and P^T's fragment beside them) ptxas needed 255 and spilled in the
// loop, with 32-row tiles it needs 219 and none, and the smaller stages let
// two blocks share an SM.
#define FA_BWD90_WIDTHS(X) \
  X(32, 32, 64)            \
  X(64, 64, 64)            \
  X(128, 128, 64)          \
  X(192, 128, 32)

// The instantiation that takes (dqk, dv): the first of FA_BWD90_WIDTHS at
// least as wide in both, into widths[0..1]; false when none is, when a
// width is no multiple of 8 (16-byte rows) or when dv > dqk.
static bool pick(int dqk, int dv, int* widths) {
  if (dqk <= 0 || dv <= 0 || dv > dqk || dqk % 8 != 0 || dv % 8 != 0) return false;
#define FA_BWD90_PICK(PK, PV, QT) \
  if (dqk <= PK && dv <= PV) {    \
    widths[0] = PK;               \
    widths[1] = PV;               \
    return true;                  \
  }
  FA_BWD90_WIDTHS(FA_BWD90_PICK)
#undef FA_BWD90_PICK
  return false;
}

}  // namespace repro_fa_bwd90

// q [B, H, Lq, Dqk], k [B, Hkv, Lk, Dqk], v [B, Hkv, Lk, Dv], o and dout
// [B, H, Lq, Dv] (the forward's output and its gradient); dq, dk, dv the
// gradients, each the shape of its input; all bfloat16, given by their data
// pointers and strides[24] = (batch, head, position) element strides of q,
// k, v, o, dout, dq, dk, dv in that order: the last dim contiguous, every
// base and stride a multiple of 16 bytes (TMA). lse: the forward's
// log-sum-exp, float32 [B, H, Lq] contiguous (see
// repro_flash_attention_sm90). scratch: float32 of
// repro_flash_attention_bwd_sm90_scratch(B, H, Lq) floats, which the
// kernels write and read. (Dqk, Dv) is a pair
// repro_flash_attention_bwd_sm90_widths takes; H is a multiple of Hkv.
// Launches the row_delta, dkdv and dq kernels in order; returns the first
// CUDA error (0 on success), or cudaErrorInvalidValue for another pair or
// when a tensor map cannot be encoded.
extern "C" int repro_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const float* lse,
                                              void* dq, void* dk, void* dv_out, float* scratch,
                                              int batch, int n_heads, int n_kv_heads, int lq,
                                              int lk, int dqk, int dv, const int64_t* strides,
                                              int causal, int window, float scale, void* stream) {
  using namespace repro_fa_bwd90;
  if (batch <= 0 || n_heads <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lq < 0 || lk < 0)
    return cudaErrorInvalidValue;
  int w[2];
  if (!pick(dqk, dv, w)) return cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_BWD90_LAUNCH(PK, PV, QT)                                                            \
  if (w[0] == PK && w[1] == PV)                                                                \
    return launch<PK, PV, QT>(q, k, v, o, dout, lse, dq, dk, dv_out, scratch, batch, n_heads, \
                              n_kv_heads, lq, lk, dqk, dv, st, causal, window, scale, s);
  FA_BWD90_WIDTHS(FA_BWD90_LAUNCH)
#undef FA_BWD90_LAUNCH
  return cudaErrorInvalidValue;
}

// Floats of the scratch a (B, H, Lq) backward needs: lse and delta of B * H
// rows of Lq padded to a multiple of 64.
extern "C" int64_t repro_flash_attention_bwd_sm90_scratch(int batch, int n_heads, int lq) {
  using namespace repro_fa_bwd90;
  return 2 * static_cast<int64_t>(batch) * n_heads * ((lq + kPad - 1) / kPad * kPad);
}

// The widths (DQK, DV) of the instantiation a (dqk, dv) backward runs at,
// into widths[2]: 0, or -1 for a pair no instantiation takes.
extern "C" int repro_flash_attention_bwd_sm90_widths(int dqk, int dv, int* widths) {
  return repro_fa_bwd90::pick(dqk, dv, widths) ? 0 : -1;
}

// Dynamic shared memory of the dkdv and dq kernels at head dims (dqk, dv)
// into bytes[2]: 0, or -1 for a pair no instantiation takes.
extern "C" int repro_flash_attention_bwd_sm90_smem_bytes(int dqk, int dv, int* bytes) {
  using namespace repro_fa_bwd90;
  int w[2];
  if (!pick(dqk, dv, w)) return -1;
#define FA_BWD90_SMEM(PK, PV, QT)                        \
  if (w[0] == PK && w[1] == PV) {                        \
    bytes[0] = DkdvShape<PK, PV, QT>::kSmemBytes;        \
    bytes[1] = DqShape<PK, PV>::kSmemBytes;              \
    return 0;                                            \
  }
  FA_BWD90_WIDTHS(FA_BWD90_SMEM)
#undef FA_BWD90_SMEM
  return -1;
}

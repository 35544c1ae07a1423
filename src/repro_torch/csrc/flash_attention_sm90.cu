// Blocked online-softmax attention (FlashAttention) for Hopper's tensor
// cores: bfloat16 in, both products through wgmma with float32
// accumulators, bfloat16 out. Every bfloat16 attention of the port runs
// here; float32 runs csrc/flash_attention.cu on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:76-140
// (flash_attention_call, pl.pallas_call at :103), which ran a (B*H,
// q blocks, k blocks) grid with the running max, sum and output block in
// VMEM scratch and repeated the KV heads in memory for GQA first.
//
// What it computes, as the TPU kernel and ref.flash_attention_ref do:
// the scale the caller gives (1/sqrt(Dqk) by default; MLA's absorbed decode
// scores over Dqk 576 at 1/sqrt(192)); query i sits at position Lk - Lq + i; keys k < Lk,
// causal k <= the query position, sliding window k > position - window;
// GQA: kv head h / (H / Hkv); float32 running max and sum; the denominator
// clamped at 1e-30, so a row with no key (also Lq > Lk under causal) is
// 0, not NaN; strides for q, k, v and out, so the [B, L, H, Dh]
// activations and the [B, buf, Hkv, Dh] KV cache are read in place.
// Keys and values may differ in width (Dv <= Dqk; MLA: 192 and 128, and
// its latent 576 and 512, the values a view of the keys' first 512
// columns, read in place through their own tensor map).
//
// Numeric contract: Q, K and V enter both products as the bf16 values
// they already are; the probabilities P are rounded to bf16 before
// P.V (wgmma takes bf16 operands). Scores, the running max and sum and
// the output accumulator stay float32; the sum adds the float32 P, whose
// exp2 is the hardware's approximation (ex2.approx, within 2 ulp) of one
// fma, scale * log2(e) * s - m; O is rescaled once a key tile and divided
// by the clamped sum as a multiply by its reciprocal. The Pallas kernel
// and the plain version multiply in float32, so this kernel is held to
// them within bf16's 3e-2.
//
// Bound on this card: at prefill operations, 2 * (Dqk + Dv) FLOPs per unmasked
// (query, key) pair at 989 TFLOP/s bf16; at decode (Lq = 1) bytes, the
// KV cache read once at 3.35 TB/s. For the operations bound both
// products run on the tensor cores (wgmma.m64nNk16 bf16 -> f32), and
// key tiles wholly above the causal diagonal or below the window are
// never loaded. For the bytes bound GQA is kept inside the block: K/V
// are read once per (batch, kv head, row tile), never once per head.
//
// Design: warp specialised. A block holds a tile of a kv head's query rows,
// which enumerate (query head of the group, position), so the group's heads
// share every K/V stage and no KV head is repeated in memory (at decode
// Kimi-K2's 8 heads fill 8 rows of one tile). Its first warpgroup is the
// producer: one thread issues the K and V boxes by TMA (one box per
// 128-byte, at Dh 32 64-byte, swizzle atom; the tensor maps carry the
// strides, keys past Lk and columns past a map's width arrive as zeros)
// into two rings of kStages stages, one for K and one for V, each stage
// with a full mbarrier (its bytes have landed) and an empty one (every
// consumer warp is done with it). The other warpgroups are consumers, each
// owning 64 query rows (wgmma's M). Two forms, chosen from the rows of a kv
// head alone (form_consumers, asked through repro_flash_attention_sm90_form):
// where a kv head has more than 64 rows, two consumers share a block of
// 128 rows, so that one K/V stage feeds 128 rows; otherwise (decode, short
// prompts) one consumer holds 64 rows and no block carries an idle
// warpgroup. The two-consumer form drops the producer's registers to
// kProducerRegs and raises the consumers' to kConsumerRegs (setmaxnreg),
// one block an SM; the one-consumer form keeps the launch's budget. The
// blocks come in chunks of kv heads whose K and V fit a quarter of L2
// (kChunkBytes), so that the blocks running at once share their heads' K
// and V through L2 (MLA has no GQA: 128 kv heads of 1.3 MB each at 2,048
// tokens, read from device memory by every row tile when the heads vary
// fastest); inside a chunk row tiles come longest first.
//
// A consumer copies its Q rows once into shared memory (cp.async, a
// thread a 16-byte chunk, in the swizzled layout wgmma reads; each row's
// offset, which takes a division by Lq, is computed once into a table)
// and keeps them in
// registers in the layout of wgmma's A fragment (ldmatrix) wherever Q's
// fragment and O's accumulator fit (kQInRegs: up to (192, 128)), so S =
// Q.K^T reads only K from shared memory (with both operands there a 64x64
// product is bound by shared-memory bandwidth); at (256, 256) and (576, 256)
// those registers hold O, and S reads Q from shared memory. At the end the
// same tile stages O in bf16 for 16-byte stores. It overlaps its softmax
// with its products inside the warpgroup (FlashAttention-3's intra-warpgroup
// pipeline): for key tile t it issues S_t = Q.K_t^T and then O +=
// P_{t-1}.V_{t-1}, waits for S_t alone (wgmma_wait<1>), releases K_t's
// stage, and masks and exponentiates S_t on the CUDA cores while the tensor
// cores run P_{t-1}.V_{t-1}; then it waits for that product, releases
// V_{t-1}'s stage, rescales O once and packs P_t in bf16 as the register
// A operand of the next tile's P.V (V read MN-major,
// the transposed descriptor). The two consumers of a block run the same
// loop on their own rows without synchronising with each other, so one
// warpgroup's exponentials run under the other's products as the two drift;
// the ping-pong of FlashAttention-3 (named barriers that order the two
// warpgroups' products) is not kept: it would make each warpgroup wait on
// the other at every tile, and the consumers' registers (O, Q, S and P)
// leave no room for the second S a ping-pong schedule holds. A consumer
// runs the products only on the key tiles its own rows see (under a causal
// mask the first half of a 128-row tile sees one tile fewer) and waits for
// and releases the others. Masking happens only on a tile where some key is
// masked for some of the consumer's rows (the loop runs the masked and the
// unmasked tiles as separate loops, so that an unmasked tile carries no
// test: ptxas hoisted the key tests of a tile that might be masked ahead of
// its products); the online softmax runs in registers on S's accumulator
// fragment, in the exp2 domain with the scale folded in, its sign folded
// into Q (the hardware's approximate exp2); the rescale of O is left out
// where every factor of a warp's rows is 1. Both barrier waits of a tile
// come before its products: a wait's loop, or a branch, between a wgmma
// and its wait makes ptxas serialise every wgmma (its C7520 note, which
// chip_smoke.py prints). The maps are encoded on the
// host through the runtime's driver entry point, so the library needs no
// -lcuda. No atomics and no split over keys: two calls on the same inputs
// give the same bits. For training the caller may ask for each row's
// log-sum-exp (lse, log2 domain: m + log2(l) of the scaled scores), which
// the epilogue already holds and which the backward
// (flash_attention_bwd_sm90.cu) then takes instead of recomputing it; O's
// bits are the same with or without it. The building blocks (wgmma, tiles,
// TMA, mbarriers, setmaxnreg) live in sm90.cuh, shared with the backward.
// The CPU model of this schedule is ref.flash_attention_sm90_ref.
//
// Widths. The kernel is instantiated at the (DQK, DV, KEYS) of FA90_WIDTHS,
// each with the forms it allows. S takes ceil(DQK / 16) k-steps and P.V
// runs at N = DV (wgmma's N is any multiple of 8 up to 256), so the
// products run on no zero column at the configs' widths (80, 120, (192,
// 128), (48, 32), (80, 64)). The shared-memory tiles keep whole swizzle
// atoms (64 elements; 32 stays one 64-byte atom), whose columns past the
// width TMA fills with zeros and no product reads. A call takes the
// narrowest instantiation that holds its (Dqk, Dv) (pick, which the wrapper
// asks through repro_flash_attention_sm90_widths): a width between two (96)
// runs at the one above with zero columns, which add nothing to a score,
// since Q's copies are predicated. Dv past 256 (the absorbed decode's 512)
// does not fit one wgmma nor the registers of one accumulator (Dv/2 a
// thread), so the grid's y dimension cuts the value columns into slices of
// DV, and each slice's blocks recompute the scores. At DQK 576 a 64-key K
// stage is 72 KB, so that instantiation streams 32 keys a stage (S = Q.K^T
// as m64n32k16), keeping Q (72 KB) and two K and V stages within the 227 KB
// of a block. (576, 256) and (256, 256), whose consumers hold 128 floats of
// O a thread, take the one-consumer form only: two consumers' 240 registers
// would spill. A width that is no multiple of 8 (16-byte rows) or wider
// than every instantiation is refused.

#include "sm90.cuh"

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace repro_fa90 {

using namespace repro_sm90;

constexpr int kRows = 64;          // query rows of a consumer warpgroup: wgmma's M
constexpr int kWarpgroup = 128;    // threads of a warpgroup
constexpr int kMaxStages = 4;      // deepest K and V rings
constexpr int kSmemLimit = 232448; // shared memory a block may use (227 KB)
// the K and V bytes of the kv heads whose blocks run together (a quarter of
// the card's 50 MB L2)
constexpr int64_t kChunkBytes = int64_t{12} << 20;
constexpr int kProducerRegs = 24;  // the two-consumer form's register split (setmaxnreg):
constexpr int kConsumerRegs = 240; // 128 x 24 + 256 x 240 of the SM's 65,536

// a shared-memory tile's width: whole 64-element swizzle atoms (32 is one
// 64-byte atom)
__host__ __device__ constexpr int pad_width(int w) { return w <= 32 ? 32 : (w + 63) / 64 * 64; }

// One instantiation: Q/K rows of DQK columns, a value slice of DV columns,
// KEYS keys a K/V stage, NC consumer warpgroups (1 or 2).
template <int DQK, int DV, int KEYS, int NC> struct Shape {
  static constexpr int kThreads = kWarpgroup * (NC + 1);  // the producer, then the consumers
  static constexpr int kQkSteps = (DQK + 15) / 16;       // k-steps of S = Q.K^T
  using TQ = Tile<pad_width(DQK), kRows>;                // one consumer's Q (shared memory)
  using TK = Tile<pad_width(DQK), KEYS>;
  using TV = Tile<pad_width(DV), KEYS>;
  // Q in registers as wgmma's A operand while its fragment and O's
  // accumulator take at most 112 registers a thread, in shared memory otherwise
  static constexpr bool kQInRegs = 4 * kQkSteps + DV / 2 <= 112;
  // each consumer's Q tile, which also stages its O for the epilogue's
  // 16-byte stores
  static constexpr int kQBytes = NC * TQ::kBytes;
  static constexpr int kStageBytes = TK::kBytes + TV::kBytes;
  // the static shared memory: each consumer's row offsets of Q and out
  // (int64 a row), the stages' four barriers
  static constexpr int kStaticBytes = NC * 2 * kRows * 8 + 4 * kMaxStages * 8;
  // as many stages as fit, 2 to kMaxStages
  static constexpr int kFit = (kSmemLimit - 1024 - kStaticBytes - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;  // + alignment slack
};

template <int DQK, int DV, int KEYS, int NC>
__global__ void __launch_bounds__(Shape<DQK, DV, KEYS, NC>::kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int n_kv_heads, int group, int lq, int lk,
                            int dqk, int dv, int row_tiles, int bh_count, int chunk_heads,
                            Strides sq, Strides so,
                            int causal, int window, float scale_log2) {
  using S = Shape<DQK, DV, KEYS, NC>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using TV = typename S::TV;
  constexpr int kStages = S::kStages;
  constexpr int kTileRows = kRows * NC;
  extern __shared__ uint8_t smem_raw[];
  // per stage: its K (V) tile has landed; every consumer warp is done with it
  __shared__ uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
  // element offsets of each consumer row's Q and out rows: (head, position)
  // of a row take a division by Lq, done once a row
  __shared__ int64_t q_row[NC][kRows], o_row[NC][kRows];
  // the consumers' Q tiles (none when Q lives in registers), then the K/V
  // stages, 1024-byte aligned
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const auto k_smem = [&](int s) { return base + S::kQBytes + S::kStageBytes * s; };
  const auto v_smem = [&](int s) { return k_smem(s) + TK::kBytes; };
  const auto bar = [](uint64_t* b, int s) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(b + s));
  };
  const int v0 = blockIdx.y * DV;  // the value columns of this block's slice

  // the (batch, kv head)s come in chunks of chunk_heads, whose K and V
  // stay in L2 while the chunk's blocks run; inside a chunk the kv head
  // varies fastest and row tiles come longest first
  const int chunk = blockIdx.x / (chunk_heads * row_tiles);
  const int in_chunk = blockIdx.x % (chunk_heads * row_tiles);
  const int heads_here = min(chunk_heads, bh_count - chunk * chunk_heads);
  const int bh = chunk * chunk_heads + in_chunk % heads_here;
  const int rank = in_chunk / heads_here;
  int tile;
  if (causal && lq % kTileRows == 0) {
    const int per_head = lq / kTileRows;  // tiles lie inside one head: latest positions first
    tile = (rank % group) * per_head + (per_head - 1 - rank / group);
  } else {
    tile = row_tiles - 1 - rank;
  }
  const int kvh = bh % n_kv_heads, b = bh / n_kv_heads;
  const int rows_total = group * lq;
  const int pos0 = lk - lq;  // position of query 0
  // the keys [lo, hi) some row of rows [r0, r1) sees, and [max_lo, min_hi)
  // those every row sees (positions of all rows where they span two heads)
  struct Keys {
    int lo, hi, max_lo, min_hi;
  };
  const auto keys_of = [&](int r0, int r1) {
    int min_i = 0, max_i = lq - 1;
    if (r0 / lq == (r1 - 1) / lq) {
      min_i = r0 % lq;
      max_i = (r1 - 1) % lq;
    }
    Keys k;
    k.hi = causal ? min(lk, pos0 + max_i + 1) : lk;
    k.lo = window > 0 ? max(0, pos0 + min_i - window + 1) : 0;
    k.min_hi = causal ? min(lk, pos0 + min_i + 1) : lk;
    k.max_lo = window > 0 ? max(0, pos0 + max_i - window + 1) : 0;
    return k;
  };
  const int r0 = tile * kTileRows;
  const Keys blk = keys_of(r0, min(r0 + kTileRows, rows_total));
  const int k_begin = blk.lo;
  const int n_tiles = blk.hi > blk.lo ? (blk.hi - blk.lo + KEYS - 1) / KEYS : 0;

  // a consumer: rows [rc0, rc1) of the kv head, and the block's key tiles
  // [ta, tb) that they see
  const int wg = threadIdx.x / kWarpgroup;  // 0: the producer; 1 + c: consumer c
  const int c = wg > 0 ? wg - 1 : 0;
  const int tid = threadIdx.x % kWarpgroup, warp = tid / 32, lane = tid % 32;
  const int rc0 = r0 + kRows * c;
  const int rc1 = min(rc0 + kRows, rows_total);
  int ta = 0, tb = 0, max_lo = 0, min_hi = 0;
  if (rc0 < rc1) {
    const Keys own = keys_of(rc0, rc1);
    max_lo = own.max_lo;
    min_hi = own.min_hi;
    if (own.hi > own.lo) {
      ta = (own.lo - k_begin) / KEYS;
      tb = (own.hi - k_begin + KEYS - 1) / KEYS;
    }
  }
  // the two rows whose accumulator fragments this thread holds, and their keys [lo, hi)
  int lo[2], hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rc0 + 16 * warp + lane / 4 + 8 * rr;
    const int p = pos0 + r % lq;
    hi[rr] = r < rows_total ? (causal ? min(lk, p + 1) : lk) : 0;
    lo[rr] = r < rows_total && window > 0 ? max(0, p - window + 1) : 0;
  }

  // Q, copied before the block's barriers are ready into the consumer's
  // tile (cp.async, in the swizzled layout wgmma reads; rows past the end and
  // columns past Dqk are 0); with kQInRegs each warp then takes its 16 rows
  // into registers as wgmma's A fragment
  // A thread a 16-byte chunk, a row's chunks on neighbouring threads; a row
  // past the end is not copied (its scores and output are never used)
  const uint32_t q_smem = base + c * TQ::kBytes;
  if (wg > 0) {
    if (tid < kRows) {
      const int r = rc0 + tid;
      const int64_t head = kvh * group + r / lq, i = r % lq;
      q_row[c][tid] = b * sq.b + head * sq.h + i * sq.l;
      o_row[c][tid] = b * so.b + head * so.h + i * so.l;
    }
    named_sync(1 + c, kWarpgroup);
    constexpr int kChunks = pad_width(DQK) / 8;  // 16-byte chunks of a Q row in shared memory
    const int live_rows = min(kRows, rows_total - rc0);
    for (int idx = tid; idx < live_rows * kChunks; idx += kWarpgroup) {
      const int j = idx / kChunks, ch = idx % kChunks;
      const bool ok = ch * 8 < dqk;
      cp_async16(q_smem + TQ::offset(j, ch), ok ? q + q_row[c][j] + ch * 8 : q, ok);
    }
    cp_async_commit();
  }

  // the producer's copies of tile t's K and V into stage st: one box per
  // swizzle atom, keys past Lk and columns past a map's width as zeros
  const auto load_k = [&](int t, int st) {
    mbar_expect_tx(bar(k_full, st), TK::kBytes);
#pragma unroll
    for (int a = 0; a < TK::kAtoms; ++a)
      tma_load_4d(k_smem(st) + a * TK::kAtomBytes, &k_map, bar(k_full, st), a * TK::kElemsPerRow,
                  k_begin + t * KEYS, kvh, b);
  };
  const auto load_v = [&](int t, int st) {
    mbar_expect_tx(bar(v_full, st), TV::kBytes);
#pragma unroll
    for (int a = 0; a < TV::kAtoms; ++a)
      tma_load_4d(v_smem(st) + a * TV::kAtomBytes, &v_map, bar(v_full, st),
                  v0 + a * TV::kElemsPerRow, k_begin + t * KEYS, kvh, b);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(k_full, s), 1);
      mbar_init(bar(v_full, s), 1);
      mbar_init(bar(k_empty, s), 4 * NC);  // one arrival a consumer warp
      mbar_init(bar(v_empty, s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages; ++s)  // the first tiles take the empty stages at once
      if (s < n_tiles) {
        load_k(s, s);
        load_v(s, s);
      }
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the rings full, K of tile t before V of
    // tile t, each into the stage its consumers released kStages tiles ago
    if constexpr (NC == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int s = 0, phase = 0;  // the phase of the stage's previous use, which must be released
      for (int t = kStages; t < n_tiles; ++t) {
        mbar_wait(bar(k_empty, s), phase);
        load_k(t, s);
        mbar_wait(bar(v_empty, s), phase);
        load_v(t, s);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (NC == 2) setmaxnreg_inc<kConsumerRegs>();
  // The scale's sign goes into Q (its bf16 signs flipped; all of Q zeroed
  // for a scale of 0, with sl2 = 1), so that the softmax scales by a
  // positive sl2: the max of the scaled scores is the raw scores' max times
  // sl2, and each exponent one fma, sl2 * s - max
  const float sl2 = scale_log2 == 0.f ? 1.f : fabsf(scale_log2);
  const uint32_t q_keep = scale_log2 == 0.f ? 0u : 0xffffffffu;
  const uint32_t q_flip = scale_log2 < 0.f ? 0x80008000u : 0u;
  cp_async_wait<0>();  // Q has landed
  if constexpr (!S::kQInRegs) {
    if (q_flip != 0u || q_keep == 0u) {  // this thread's own chunks, as it copied them
      constexpr int kChunks = pad_width(DQK) / 8;
      for (int idx = tid; idx < min(kRows, rows_total - rc0) * kChunks; idx += kWarpgroup) {
        const uint32_t at = q_smem + TQ::offset(idx / kChunks, idx % kChunks);
        const uint4 x = ld_shared_b128(at);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          st_shared_b32(at + 4 * w, ((&x.x)[w] & q_keep) ^ q_flip);
      }
    }
  }
  fence_proxy_async();
  named_sync(1 + c, kWarpgroup);
  // k-step kk of the A fragment: (row, cols 16kk + 2(lane%4) + {0, 1}),
  // (row + 8, same), (row, those + 8), (row + 8, those + 8)
  uint32_t qa[S::kQInRegs ? S::kQkSteps : 1][4];
  if constexpr (S::kQInRegs) {
    const int j = 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < S::kQkSteps; ++kk) {
      ldmatrix_x4(qa[kk], q_smem + TQ::offset(j, 2 * kk + (lane >> 4)));
#pragma unroll
      for (int w = 0; w < 4; ++w) qa[kk][w] = (qa[kk][w] & q_keep) ^ q_flip;
    }
  }

  // the stage and phase of the tile in hand; a consumer warp's lane 0
  // releases a stage once the warpgroup's products that read it are done
  int s = 0, phase = 0;
  const auto advance = [&]() {
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  };
  const auto release = [&](uint64_t* b_, int st) { mbar_arrive(bar(b_, st), lane == 0); };
  const auto pass = [&]() {  // a tile none of the consumer's rows sees
    mbar_wait(bar(k_full, s), phase);
    release(k_empty, s);
    mbar_wait(bar(v_full, s), phase);
    release(v_empty, s);
    advance();
  };

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // P in bf16 as wgmma's A fragment: k-step kk takes accumulator registers
  // 8kk..8kk+7 of S, pairs (row, row + 8, row, row + 8) of two 8-key blocks
  uint32_t pa[KEYS / 16][4];
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
  // S = Q.K^T: accumulator register j holds row 16*warp + lane/4 + 8*((j/2)%2),
  // key 8*(j/4) + 2*(lane%4) + j%2 of the tile
  float sc[KEYS / 2];
  float alpha[2];

  const uint64_t qd = TQ::k_major(q_smem, 0);
  // issue S = Q.K^T of the K tile in stage st (O and P are fenced too: the
  // P.V a caller issues next reads them)
  const auto issue_scores = [&](int st) {
#pragma unroll
    for (int j = 0; j < KEYS / 2; ++j) sc[j] = 0.f;
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pa);
    const uint64_t kd = TK::k_major(k_smem(st), 0);
    // Q's descriptor, opaque here, so that its k-steps' descriptors are
    // formed a tile at a time and not held in registers across the loop
    uint64_t qd_t = qd;
    asm volatile("" : "+l"(qd_t));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::kQkSteps; ++kk) {
      if constexpr (S::kQInRegs)
        Wgmma<KEYS>::template rs<0>(sc, qa[kk], TK::k_step(kd, kk));
      else
        Wgmma<KEYS>::ss(sc, TQ::k_step(qd_t, kk), TK::k_step(kd, kk));
    }
    wgmma_commit();
  };
  // issue O += P.V of the V tile in stage st
  const auto issue_pv = [&](int st) {
    const uint64_t vd = TV::mn_major(v_smem(st), 0);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      Wgmma<DV>::template rs<1>(o, pa[kk], TV::mn_step(vd, kk));
    wgmma_commit();
  };
  // the online softmax of key tile t's scores, in place: sc becomes the
  // float32 P, l is rescaled and summed, alpha the factor O takes. kMask:
  // the tile holds a key some of the consumer's rows do not see (only then
  // is each key checked)
  const auto softmax = [&](auto mask, int t) {
    constexpr bool kMask = decltype(mask)::value;
    const int k0 = k_begin + t * KEYS;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KEYS / 2; ++j) {
      const int rr = (j >> 1) & 1;
      if constexpr (kMask) {
        const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        if (kp < lo[rr] || kp >= hi[rr]) sc[j] = -INFINITY;
      }
      mx[rr] = fmaxf(mx[rr], sc[j]);
    }
    float base_[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // a row's four threads are lanes 4g..4g+3
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr] * sl2);
      base_[rr] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: every p is 0
      alpha[rr] = fast_exp2(m[rr] - base_[rr]);      // 0 while m is -inf
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int j = 0; j < KEYS / 2; ++j) {
      const float p = fast_exp2(fmaf(sc[j], sl2, -base_[(j >> 1) & 1]));
      l[(j >> 1) & 1] += p;
      sc[j] = p;
    }
  };
  // O's one rescale a tile (left out where every factor of the warp's rows
  // is 1, which changes no bit), then P in bf16 into the A fragment
  const auto rescale_pack = [&]() {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int j = 0; j < KEYS / 2; j += 2) pa[j / 8][(j % 8) / 2] = pack_bf16(sc[j], sc[j + 1]);
  };

  for (int t = 0; t < ta; ++t) pass();
  if (tb > ta) {
    constexpr std::true_type masked{};
    constexpr std::false_type unmasked{};
    int ps = s, pphase = phase;  // the previous tile's stage and phase: its V is still in use
    mbar_wait(bar(k_full, s), phase);
    issue_scores(s);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty, s);
    softmax(masked, ta);
    rescale_pack();
    advance();
    // tile t: S_t, then O += P_{t-1}.V_{t-1} under S_t's softmax
    const auto step = [&](auto mask, int t) {
      mbar_wait(bar(k_full, s), phase);  // K_t and V_{t-1} have landed
      mbar_wait(bar(v_full, ps), pphase);  // (a wait's loop between a wgmma and its
                                           // wait makes ptxas serialise the wgmma)
      issue_scores(s);
      issue_pv(ps);
      wgmma_wait<1>();  // S_t is done, P_{t-1}.V_{t-1} may still run
      fence_regs(sc);
      release(k_empty, s);
      softmax(mask, t);
      wgmma_wait<0>();  // P_{t-1}.V_{t-1} is done: its V stage and P's registers are free
      fence_regs(o);
      fence_regs(pa);
      release(v_empty, ps);
      rescale_pack();
      ps = s;
      pphase = phase;
      advance();
    };
    // the tiles inside every row's keys, [u0, u1), take no mask: those
    // below max_lo (the window) and past min_hi (the causal diagonal) do
    const int e0 = max_lo > k_begin ? (max_lo - k_begin + KEYS - 1) / KEYS : 0;
    const int e1 = min_hi > k_begin ? (min_hi - k_begin) / KEYS : 0;
    const int u0 = min(max(e0, ta + 1), tb), u1 = min(max(e1, u0), tb);
    int t = ta + 1;
    for (; t < u0; ++t) step(masked, t);
    for (; t < u1; ++t) step(unmasked, t);
    for (; t < tb; ++t) step(masked, t);
    mbar_wait(bar(v_full, ps), pphase);  // the last tile's O += P.V
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(ps);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(v_empty, ps);
  }
  for (int t = tb; t < n_tiles; ++t) pass();

  // O * (1 / max(l, 1e-30)) in bf16, staged in the consumer's Q tile (its
  // products are done), then stored 16 bytes a thread through the out
  // strides; rows past Lq * group and columns past Dv are dropped. With lse,
  // each row's log-sum-exp in the log2 domain of the scaled scores, m +
  // log2(l) (+inf for a row that saw no key), into lse[b, head, position]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int j = 16 * warp + lane / 4 + 8 * rr, r = rc0 + j;
    if (lse != nullptr && (lane & 3) == 0 && r < rows_total)  // [b, head, position]
      lse[(static_cast<int64_t>(b) * n_kv_heads + kvh) * group * lq + r] =
          sum > 0.f ? m[rr] + log2f(sum) : INFINITY;
#pragma unroll
    for (int c8 = 0; c8 < DV / 8; ++c8) {
      const int i = 4 * c8 + 2 * rr;
      st_shared_b32(q_smem + TQ::offset(j, c8) + 4 * (lane & 3),
                    pack_bf16(o[i] * inv, o[i + 1] * inv));
    }
  }
  named_sync(1 + c, kWarpgroup);
  constexpr int kOutChunks = DV / 8;  // 16-byte chunks of an output row of the slice
  const int live_rows = min(kRows, rows_total - rc0);
  for (int idx = tid; idx < live_rows * kOutChunks; idx += kWarpgroup) {
    const int j = idx / kOutChunks, ch = idx % kOutChunks;
    if (v0 + 8 * ch < dv)
      *reinterpret_cast<uint4*>(out + o_row[c][j] + v0 + 8 * ch) =
          ld_shared_b128(q_smem + TQ::offset(j, ch));
  }
}

template <int DQK, int DV, int KEYS, int NC>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                          int batch, int n_kv_heads, int group, int lq, int lk, int dqk, int dv,
                          int row_tiles, int bh_count, int chunk_heads, const Strides* st,
                          int causal, int window,
                          float scale_log2, cudaStream_t stream) {
  using S = Shape<DQK, DV, KEYS, NC>;
  static_assert(S::kSmemBytes + S::kStaticBytes <= kSmemLimit, "a block's shared memory");
  if (dqk > DQK || dv > dqk || (lse != nullptr && dv > DV)) return cudaErrorInvalidValue;
  CUtensorMap k_map{}, v_map{};  // never read when there is no key
  if (lk > 0 &&
      !(encode_4d<typename S::TK>(&k_map, k, batch, n_kv_heads, lk, dqk, st[1]) &&
        encode_4d<typename S::TV>(&v_map, v, batch, n_kv_heads, lk, dv, st[2])))
    return cudaErrorInvalidValue;
  const int smem = S::kSmemBytes;
  // the dynamic shared-memory limit is raised once per instantiation and device
  static std::atomic<uint64_t> raised{0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if ((raised.load(std::memory_order_acquire) & bit) == 0) {
    e = cudaFuncSetAttribute(flash_attention_sm90_kernel<DQK, DV, KEYS, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_release);
  }
  const int blocks = row_tiles * bh_count;
  const dim3 grid(blocks, (dv + DV - 1) / DV);  // y: the slices of the value columns
  flash_attention_sm90_kernel<DQK, DV, KEYS, NC><<<grid, S::kThreads, smem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse,
      n_kv_heads, group, lq, lk, dqk, dv, row_tiles, bh_count, chunk_heads, st[0], st[3], causal,
      window,
      scale_log2);
  return cudaGetLastError();
}

// The instantiations, narrowest first: Q/K width, value slice width, keys a
// stage, and the most consumer warpgroups a block of it holds (2: both
// forms; 1: the one-consumer form only). At 80 a key tile's products are
// short beside its fixed costs (two barrier waits, the max's shuffles, O's
// rescale), so those instantiations take 128 keys a stage (on an H100
// zamba2's [4, 32, 2048, 80] row 0.2835 -> 0.2614 ms, hubert's [4, 16,
// 1000, 80] 0.0732 -> 0.0657 against 64 keys, attention_ab.py); at 128 and
// wider 128 keys were slower.
#define FA90_WIDTHS(X) \
  X(32, 32, 64, 2)     \
  X(48, 32, 64, 2)     \
  X(64, 64, 64, 2)     \
  X(80, 64, 128, 2)    \
  X(80, 80, 128, 2)    \
  X(120, 120, 64, 2)   \
  X(128, 128, 64, 2)   \
  X(192, 128, 64, 2)   \
  X(256, 256, 64, 1)   \
  X(576, 256, 32, 1)

// The instantiation that takes (dqk, dv): the first of FA90_WIDTHS whose
// Q/K width holds dqk and whose value slice holds dv, or is the widest
// slice (kMaxSlice), which then cuts the value columns over grid.y; its
// widths into widths[0..1], its most consumer warpgroups into *forms.
// False when none does, or when a width is no multiple of 8 (16-byte rows)
// or dv > dqk.
constexpr int kMaxSlice = 256;
static bool pick(int dqk, int dv, int* widths, int* forms) {
  if (dqk <= 0 || dv <= 0 || dv > dqk || dqk % 8 != 0 || dv % 8 != 0) return false;
#define FA90_PICK(PK, PV, KEYS, NC)                 \
  if (dqk <= PK && (dv <= PV || PV == kMaxSlice)) { \
    widths[0] = PK;                                 \
    widths[1] = PV;                                 \
    *forms = NC;                                    \
    return true;                                    \
  }
  FA90_WIDTHS(FA90_PICK)
#undef FA90_PICK
  return false;
}

// The form of a call whose kv heads have `rows` query rows each (group x
// Lq), at an instantiation that allows `forms` consumer warpgroups: two
// (128 rows a block) where a kv head has more rows than one consumer holds,
// else one (64 rows).
static int form_consumers(int forms, int64_t rows) { return forms == 2 && rows > kRows ? 2 : 1; }

// launch<PK, PV, KEYS, nc> for an instantiation allowing `NC` forms
template <int PK, int PV, int KEYS, int NC> struct Forms {
  template <typename... A> static cudaError_t run(int nc, A... args) {
    if constexpr (NC == 2)
      if (nc == 2) return launch<PK, PV, KEYS, 2>(args...);
    return launch<PK, PV, KEYS, 1>(args...);
  }
  static int smem(int nc) {
    if constexpr (NC == 2)
      if (nc == 2) return Shape<PK, PV, KEYS, 2>::kSmemBytes;
    return Shape<PK, PV, KEYS, 1>::kSmemBytes;
  }
};

}  // namespace repro_fa90

// q [B, H, Lq, Dqk], k [B, Hkv, Lk, Dqk], v [B, Hkv, Lk, Dv], out [B, H, Lq,
// Dv], all bfloat16, given by their data pointers and strides[12] = (batch,
// head, position) element strides of q, k, v, out in that order: the last
// dim contiguous, every base and stride a multiple of 16 bytes (cp.async
// and TMA). (Dqk, Dv) is a pair pick takes; H is a multiple of Hkv. lse:
// nullptr, or float32 [B, H, Lq] contiguous, which then takes each row's
// log-sum-exp (log2 domain, see the kernel's epilogue) for the backward;
// only a call whose Dv fits one value slice (at most 256) takes it.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for another pair, an lse the call cannot take, or
// when the K/V tensor maps cannot be encoded.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* out,
                                          float* lse, int batch, int n_heads, int n_kv_heads,
                                          int lq, int lk, int dqk, int dv, const int64_t* strides,
                                          int causal, int window, float scale, void* stream) {
  using namespace repro_fa90;
  if (batch <= 0 || lq <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lk < 0) return cudaErrorInvalidValue;
  int w[2], forms = 1;
  if (!pick(dqk, dv, w, &forms)) return cudaErrorInvalidValue;
  const int group = n_heads / n_kv_heads;
  const int64_t rows = static_cast<int64_t>(group) * lq;
  const int nc = form_consumers(forms, rows);
  const int64_t row_tiles = (rows + kRows * nc - 1) / (kRows * nc);
  const int64_t bh = static_cast<int64_t>(batch) * n_kv_heads;
  if (rows > INT_MAX || bh * row_tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(row_tiles), bhc = static_cast<int>(bh);
  const float sl2 = scale * kLog2e;
  // kv heads a chunk: as many as keep their K and V within kChunkBytes
  const int64_t kv_bytes = 2 * static_cast<int64_t>(lk) * (dqk + dv);
  const int chunk = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(bh, kChunkBytes / std::max<int64_t>(kv_bytes, 1))));
#define FA90_LAUNCH(PK, PV, KEYS, NC)                                                        \
  if (w[0] == PK && w[1] == PV)                                                              \
    return Forms<PK, PV, KEYS, NC>::run(nc, q, k, v, out, lse, batch, n_kv_heads, group, lq, \
                                        lk, dqk, dv, tiles, bhc, chunk, st, causal, window, sl2, \
                                        s);
  FA90_WIDTHS(FA90_LAUNCH)
#undef FA90_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the launch at head dims (dqk, dv) whose kv heads
// have `rows` query rows each (its form's Q tiles, K/V stages and the
// alignment slack), or -1 for a pair the kernel does not take.
extern "C" int repro_flash_attention_sm90_smem_bytes(int dqk, int dv, int rows) {
  using namespace repro_fa90;
  int w[2], forms = 1;
  if (!pick(dqk, dv, w, &forms)) return -1;
  const int nc = form_consumers(forms, rows);
#define FA90_SMEM(PK, PV, KEYS, NC) \
  if (w[0] == PK && w[1] == PV) return Forms<PK, PV, KEYS, NC>::smem(nc);
  FA90_WIDTHS(FA90_SMEM)
#undef FA90_SMEM
  return -1;
}

// The widths (Q/K, value slice) of the instantiation that runs (dqk, dv),
// into widths[2]: 0, or -1 for a pair the kernel does not take (see pick).
extern "C" int repro_flash_attention_sm90_widths(int dqk, int dv, int* widths) {
  int forms = 1;
  return repro_fa90::pick(dqk, dv, widths, &forms) ? 0 : -1;
}

// The query rows a block holds (64: one consumer warpgroup; 128: two) for
// head dims (dqk, dv) where each kv head has `rows` query rows (group x
// Lq), as the launch chooses them (form_consumers); -1 for a pair the
// kernel does not take.
extern "C" int repro_flash_attention_sm90_form(int dqk, int dv, int rows) {
  using namespace repro_fa90;
  int w[2], forms = 1;
  if (!pick(dqk, dv, w, &forms)) return -1;
  return kRows * form_consumers(forms, rows);
}

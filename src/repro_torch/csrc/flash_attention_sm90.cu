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
// exp2 is the hardware's approximation (ex2.approx, within 2 ulp). The
// Pallas kernel and the plain version multiply in float32, so this
// kernel is held to them within bf16's 3e-2.
//
// Bound on this card: at prefill operations, 2 * (Dqk + Dv) FLOPs per unmasked
// (query, key) pair at 989 TFLOP/s bf16; at decode (Lq = 1) bytes, the
// KV cache read once at 3.35 TB/s. For the operations bound both
// products run on the tensor cores (wgmma.m64nNk16 bf16 -> f32), and
// key tiles wholly above the causal diagonal or below the window are
// never loaded. For the bytes bound GQA is kept inside the block: K/V
// are read once per (batch, kv head, row tile), never once per head.
//
// Design: one block of one warpgroup (128 threads) per (batch, kv head,
// tile of 64 query rows); the rows enumerate (query head of the group,
// position), so the group's heads share every K/V stage and no KV head
// is repeated in memory (at decode Kimi-K2's 8 heads fill 8 rows of one
// tile). Row tiles are ordered so the ones with the most keys start
// first. Up to Dh 128, Q is loaded once into registers in the layout of
// wgmma's A fragment: S = Q.K^T then reads only K from shared memory
// (with both operands there a 64x64 product is bound by shared-memory
// bandwidth), and the smaller footprint lets three blocks share an SM
// (at most 168 registers). At Dh 256 those registers hold O, so Q is
// copied once into shared memory (cp.async, in the swizzled layout
// wgmma reads). K and V tiles of 64 keys arrive by TMA into a ring of
// two shared-memory stages, one mbarrier per stage: one thread issues one
// box per 128-byte (64-byte at Dh 32) swizzle atom, the hardware computes
// the addresses from tensor maps that carry the strides, and keys past Lk
// arrive as zeros; the next tile's copy is in flight while the current
// one is multiplied. The maps are encoded on the host through the
// runtime's driver entry point, so the library needs no -lcuda. Masking
// and the online softmax run in registers on S's accumulator fragment
// (the hardware's approximate exp2, with the scale folded in); P becomes wgmma's register A operand
// for O += P.V, with V read MN-major from shared memory (the transposed
// descriptor); O is rescaled once per tile. Keys outside a row tile's
// range are skipped whole. No atomics and no split over keys: two calls
// on the same inputs give the same bits. Warp specialisation and two
// consumer warpgroups are later work. For training the caller may ask for
// each row's log-sum-exp (lse, log2 domain: m + log2(l) of the scaled
// scores), which the epilogue already holds and which the backward
// (flash_attention_bwd_sm90.cu) then takes instead of recomputing it; O's
// bits are the same with or without it. The building blocks (wgmma,
// tiles, TMA) live in sm90.cuh, shared with the backward.
//
// Widths. The kernel is instantiated at the widths of FA90_WIDTHS: DQK (Q
// and K rows in shared memory, whole 64-element swizzle atoms; 32 stays
// one 64-byte atom) and DV (one slice of the value columns, 32, 64, 128 or
// 256: wgmma's N). A call takes the narrowest that holds its (Dqk, Dv)
// (pick, which the wrapper asks through repro_flash_attention_sm90_widths),
// so a narrower width (120, 80, 48) is rounded up with zero columns: TMA
// fills the part of a box past the tensor map's width with zeros, and Q's
// loads are predicated, so the padding adds nothing to a score. Dv past 256 (the absorbed decode's
// 512) does not fit one wgmma nor the registers of one accumulator (Dv/2
// a thread), so the grid's y dimension cuts the value columns into
// slices of DV, and each slice's blocks recompute the scores. At DQK 576
// a 64-key K stage is 72 KB, so that instantiation streams 32 keys a
// stage (S = Q.K^T as m64n32k16), keeping Q (72 KB) and two K and V
// stages within the 227 KB of a block. A width that is no multiple of 8
// (16-byte rows) or wider than every instantiation is refused.

#include "sm90.cuh"

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace repro_fa90 {

using namespace repro_sm90;

constexpr int kRows = 64;      // query rows per block: wgmma's M
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // K/V ring depth

// One instantiation: Q/K rows of DQK (padded) columns, a value slice of DV
// columns, KEYS keys a K/V stage.
template <int DQK, int DV, int KEYS> struct Shape {
  using TQ = Tile<DQK, kRows>;
  using TK = Tile<DQK, KEYS>;
  using TV = Tile<DV, KEYS>;
  // Q lives in registers as wgmma's A operand while both widths are at most
  // 128, in shared memory otherwise (the registers then hold O)
  static constexpr bool kQInRegs = DQK <= 128 && DV <= 128;
  static constexpr int kQBytes = kQInRegs ? 0 : TQ::kBytes;
  static constexpr int kStageBytes = TK::kBytes + TV::kBytes;
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;  // + alignment slack
};

template <int DQK, int DV, int KEYS>
__global__ void __launch_bounds__(kThreads, Shape<DQK, DV, KEYS>::kQInRegs ? 3 : 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int n_kv_heads, int group, int lq, int lk,
                            int dqk, int dv,                            int row_tiles, int bh_count, Strides sq, Strides so, int causal,
                            int window, float scale_log2) {
  using S = Shape<DQK, DV, KEYS>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using TV = typename S::TV;
  constexpr int kChunks = DQK / 8;  // 16-byte chunks per Q row
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];  // one barrier per stage: its K and V tiles have landed
  // Q's tile (none when Q lives in registers), then the K/V stages, 1024-byte aligned
  const uint32_t q_smem = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const auto k_smem = [&](int s) { return q_smem + S::kQBytes + S::kStageBytes * s; };
  const auto v_smem = [&](int s) { return k_smem(s) + TK::kBytes; };
  const int v0 = blockIdx.y * DV;  // the value columns of this block's slice

  // (batch, kv head) varies fastest; row tiles come longest first
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
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KEYS - 1) / KEYS : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the two rows whose accumulator fragments this thread holds, and their keys [lo, hi)
  int lo[2], hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 16 * warp + lane / 4 + 8 * rr;
    const int p = pos0 + r % lq;
    hi[rr] = r < rows_total ? (causal ? min(lk, p + 1) : lk) : 0;
    lo[rr] = r < rows_total && window > 0 ? max(0, p - window + 1) : 0;
  }

  const auto bar = [&](int s) { return static_cast<uint32_t>(__cvta_generic_to_shared(&full[s])); };
  // Q as wgmma's A fragment: k-step kk holds (row, cols 16kk + 2(lane%4) + {0, 1}),
  // (row + 8, same), (row, those + 8), (row + 8, those + 8); rows past the end
  // and columns past Dqk are 0
  uint32_t qa[S::kQInRegs ? DQK / 16 : 1][4];
  if constexpr (S::kQInRegs) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 16 * warp + lane / 4 + 8 * rr;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          q + b * sq.b + (kvh * group + r / lq) * sq.h + (r % lq) * sq.l);
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const int c = 16 * kk + 2 * (lane & 3);  // Dqk is a multiple of 8: pairs stay whole
        qa[kk][rr] = r < rows_total && c < dqk ? __ldg(row + 8 * kk + (lane & 3)) : 0u;
        qa[kk][rr + 2] = r < rows_total && c + 8 < dqk ? __ldg(row + 8 * kk + 4 + (lane & 3)) : 0u;
      }
    }
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
  // one thread asks TMA for a tile's K and its slice of V, one box per swizzle
  // atom; keys past Lk and columns past the maps' widths arrive as zeros
  const auto load_kv = [&](int t, int s) {
    const int k0 = k_begin + t * KEYS;
    mbar_expect_tx(bar(s), S::kStageBytes);
#pragma unroll
    for (int a = 0; a < TK::kAtoms; ++a)
      tma_load_4d(k_smem(s) + a * TK::kAtomBytes, &k_map, bar(s), a * TK::kElemsPerRow, k0, kvh, b);
#pragma unroll
    for (int a = 0; a < TV::kAtoms; ++a)
      tma_load_4d(v_smem(s) + a * TV::kAtomBytes, &v_map, bar(s), v0 + a * TV::kElemsPerRow, k0,
                  kvh, b);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar(s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      if (s < n_tiles) load_kv(s, s);
  }
  cp_async_wait<0>();  // Q has landed
  fence_proxy_async();
  __syncthreads();

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    if (tid == 0 && t + kStages - 1 < n_tiles)
      load_kv(t + kStages - 1, (t + kStages - 1) % kStages);
    mbar_wait(bar(stage), (t / kStages) & 1);  // tile t has landed

    // S = Q.K^T: accumulator register j holds row 16*warp + lane/4 + 8*((j/2)%2),
    // key 8*(j/4) + 2*(lane%4) + j%2 of the tile
    float s[KEYS / 2];
#pragma unroll
    for (int j = 0; j < KEYS / 2; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      if constexpr (S::kQInRegs)
        Wgmma<KEYS>::template rs<0>(s, qa[kk], TK::k_major(k_smem(stage), kk));
      else
        Wgmma<KEYS>::ss(s, TQ::k_major(q_smem, kk), TK::k_major(k_smem(stage), kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int k0 = k_begin + t * KEYS;
    const bool edge = k0 < max_lo || k0 + KEYS > min_hi;  // some key is masked for some row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KEYS / 2; ++j) {
      const int rr = (j >> 1) & 1;
      const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      float x = s[j] * scale_log2;
      if (edge && (kp < lo[rr] || kp >= hi[rr])) x = -INFINITY;
      s[j] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
    float base[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // a row's four threads are lanes 4g..4g+3
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      base[rr] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: every p is 0
      alpha[rr] = fast_exp2(m[rr] - base[rr]);          // 0 while m is -inf
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
    // P in bf16 as wgmma's A fragment: k-step kk takes accumulator registers
    // 8kk..8kk+7, pairs (row, row + 8, row, row + 8) of two 8-key blocks
    uint32_t a[KEYS / 16][4];
#pragma unroll
    for (int j = 0; j < KEYS / 2; j += 2) {
      const int rr = (j >> 1) & 1;
      const float p0 = fast_exp2(s[j] - base[rr]), p1 = fast_exp2(s[j + 1] - base[rr]);
      l[rr] += p0 + p1;
      a[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P.V
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      Wgmma<DV>::template rs<1>(o, a[kk], TV::mn_major(v_smem(stage), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // O / max(l, 1e-30) in bf16 through the out strides; rows past Lq * group
  // and columns past Dv are dropped. With lse, each row's log-sum-exp in
  // the log2 domain of the scaled scores, m + log2(l) (+inf for a row that
  // saw no key), into lse[b, head, position]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int r = r0 + 16 * warp + lane / 4 + 8 * rr;
    if (r >= rows_total) continue;
    const int head = kvh * group + r / lq;
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<int64_t>(b) * n_kv_heads * group + head) * lq + r % lq] =
          sum > 0.f ? m[rr] + log2f(sum) : INFINITY;
    __nv_bfloat16* row = out + b * so.b + head * so.h + (r % lq) * so.l;
#pragma unroll
    for (int c8 = 0; c8 < DV / 8; ++c8) {
      const int i = 4 * c8 + 2 * rr;
      const int col = v0 + 8 * c8 + 2 * (lane & 3);
      if (col < dv)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(o[i] / denom, o[i + 1] / denom);
    }
  }
}

template <int DQK, int DV, int KEYS>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                          int batch,
                          int n_kv_heads, int group, int lq, int lk, int dqk, int dv,
                          int row_tiles, int bh_count, int blocks, const Strides* st, int causal,
                          int window, float scale_log2, cudaStream_t stream) {
  using S = Shape<DQK, DV, KEYS>;
  static_assert(S::kSmemBytes <= 227 * 1024, "a block's shared memory");
  if (dqk > DQK || dv > dqk || (lse != nullptr && dv > DV)) return cudaErrorInvalidValue;
  CUtensorMap k_map{}, v_map{};  // never read when there is no key
  if (lk > 0 &&
      !(encode_4d<typename S::TK>(&k_map, k, batch, n_kv_heads, lk, dqk, st[1]) &&
        encode_4d<typename S::TV>(&v_map, v, batch, n_kv_heads, lk, dv, st[2])))
    return cudaErrorInvalidValue;
  const int smem = S::kSmemBytes;
  // the dynamic shared-memory limit is raised once per head dim and device
  static std::atomic<uint64_t> raised{0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if ((raised.load(std::memory_order_acquire) & bit) == 0) {
    e = cudaFuncSetAttribute(flash_attention_sm90_kernel<DQK, DV, KEYS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(blocks, (dv + DV - 1) / DV);  // y: the slices of the value columns
  flash_attention_sm90_kernel<DQK, DV, KEYS><<<grid, kThreads, smem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse,
      n_kv_heads, group, lq, lk, dqk, dv, row_tiles, bh_count, st[0], st[3], causal, window,
      scale_log2);
  return cudaGetLastError();
}

// The instantiations, narrowest first: Q/K width, value slice width, keys
// a stage.
#define FA90_WIDTHS(X) \
  X(32, 32, 64)        \
  X(64, 64, 64)        \
  X(128, 128, 64)      \
  X(192, 128, 64)      \
  X(256, 256, 64)      \
  X(576, 256, 32)

// The instantiation that takes (dqk, dv): the first of FA90_WIDTHS whose
// Q/K width holds dqk and whose value slice holds dv, or is the widest
// slice (kMaxSlice), which then cuts the value columns over grid.y; its
// widths into widths[0..1]. False when none does, or when a width is no
// multiple of 8 (16-byte rows) or dv > dqk.
constexpr int kMaxSlice = 256;
static bool pick(int dqk, int dv, int* widths) {
  if (dqk <= 0 || dv <= 0 || dv > dqk || dqk % 8 != 0 || dv % 8 != 0) return false;
#define FA90_PICK(PK, PV, KEYS)                     \
  if (dqk <= PK && (dv <= PV || PV == kMaxSlice)) { \
    widths[0] = PK;                                 \
    widths[1] = PV;                                 \
    return true;                                    \
  }
  FA90_WIDTHS(FA90_PICK)
#undef FA90_PICK
  return false;
}

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
                                          int lq, int lk, int dqk, int dv, const int64_t* strides, int causal,
                                          int window, float scale, void* stream) {
  using namespace repro_fa90;
  if (batch <= 0 || lq <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lk < 0) return cudaErrorInvalidValue;
  const int group = n_heads / n_kv_heads;
  const int64_t rows = static_cast<int64_t>(group) * lq;
  const int64_t row_tiles = (rows + kRows - 1) / kRows;
  const int64_t bh = static_cast<int64_t>(batch) * n_kv_heads;
  if (rows > INT_MAX || bh * row_tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(row_tiles), bhc = static_cast<int>(bh);
  const int blocks = tiles * bhc;
  const float sl2 = scale * kLog2e;
  int w[2];
  if (!pick(dqk, dv, w)) return cudaErrorInvalidValue;
#define FA90_LAUNCH(PK, PV, KEYS)                                                         \
  if (w[0] == PK && w[1] == PV)                                                           \
    return launch<PK, PV, KEYS>(q, k, v, out, lse, batch, n_kv_heads, group, lq, lk, dqk, dv, \
                                tiles, bhc, blocks, st, causal, window, sl2, s);
  FA90_WIDTHS(FA90_LAUNCH)
#undef FA90_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the launch at head dims (dqk, dv) (Q, two K/V
// stages and the alignment slack), or -1 for a pair the kernel does not take.
extern "C" int repro_flash_attention_sm90_smem_bytes(int dqk, int dv) {
  using namespace repro_fa90;
  int w[2];
  if (!pick(dqk, dv, w)) return -1;
#define FA90_SMEM(PK, PV, KEYS) \
  if (w[0] == PK && w[1] == PV) return Shape<PK, PV, KEYS>::kSmemBytes;
  FA90_WIDTHS(FA90_SMEM)
#undef FA90_SMEM
  return -1;
}

// The widths (Q/K, value slice) of the instantiation that runs (dqk, dv),
// into widths[2]: 0, or -1 for a pair the kernel does not take (see pick).
extern "C" int repro_flash_attention_sm90_widths(int dqk, int dv, int* widths) {
  return repro_fa90::pick(dqk, dv, widths) ? 0 : -1;
}

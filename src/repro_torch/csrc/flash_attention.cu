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
// What it computes, as the TPU kernel does: scale 1/sqrt(Dh); query i sits
// at position Lk - Lq + i (decode alignment); keys k < Lk, causal k <= the
// query position, sliding window k > position - window; float32 running
// max, sum and accumulator; the denominator clamped at 1e-30, so a row
// whose keys are all masked comes out 0, not NaN. No route uses atomics,
// and each fixes its order of summation by the shape alone, so a shape
// gives the same bits on every call.
//
// Bound on this card: at decode (Lq = 1) bytes, the KV cache read once; at
// prefill operations, 4 * Lq * Lk * Dh per head (halved when causal), at
// 67 TFLOP/s for float32 outside the tensor cores. Both routes keep the
// plain version's float32 arithmetic (qwen3-0.6b's float32
// decode-vs-forward check relies on it), so neither uses the tensor cores.
//
// Tile route (repro_flash_attention): one block per (b, kv head, tile of
// 64 query rows). The rows of a tile enumerate (query head of the kv
// head's group, query position), so GQA shares each staged K/V tile
// between the group's heads and no KV head is repeated in memory.
// Each query row is owned by Dh/32 threads, each holding 32 of its dims
// (q and the accumulator in registers); a score is their partial dots
// summed with __shfl_xor_sync. K and V tiles (32 keys, 16 at Dh = 256) are
// staged in shared memory as float4s. Each tile's scores are taken first,
// then the running max, sum and accumulator are rescaled once per tile.
// Strides are passed for q, k, v and out (the last dim contiguous), so the
// [B, L, H, Dh] activations and the [B, buf, Hkv, Dh] KV cache are read in
// place.
//
// Decode route (repro_flash_attention_decode), for few query rows per kv
// head (a decode step: group x Lq rows, 2 for qwen3-0.6b, 8 for Kimi-K2).
// On the tile route such a block has only those rows' threads live (8 of
// 256 at qwen3) walking every key in series, and the grid has B x Hkv
// blocks (32 on 132 SMs). Here:
// - a block holds a tile of R of a kv head's rows (1, 2, 4 or 8) and one
//   split of the keys, both chosen by the wrapper (decode_plan): Lk cut
//   into n_splits splits of `chunk` keys (at most 4 blocks an SM, no split
//   under 128 KB of K/V), so that B x Hkv x row tiles x n_splits blocks
//   fill the card at a long cache, and R made smaller while the blocks
//   cannot give every SM one at a short cache (a warp takes its rows one
//   after another);
// - in a block, a team of Dh/4 lanes (32 at most; 8 float32 a lane at Dh =
//   256) reads one key row with 16-byte loads, and the block's 256 / lanes
//   teams take the split's keys in turn (team t: keys t, t + teams, ...),
//   kUnit keys at a time, K and V loaded together; each team scores its
//   keys against all R rows (q from shared memory, the dot summed over the
//   team's lanes with shuffles) and folds them into its own running
//   (m, l, acc) per row. Only a split's last unit checks which of its
//   slots hold a key (fold_unit<..., false>): checking in every unit
//   slowed the long-cache rows;
// - the teams' states meet in shared memory and are folded in team order;
//   with one split the block writes the output, else each row's partial
//   (acc, m, l) goes to scratch the wrapper allocated, and
//   flash_decode_combine_kernel folds the splits in split order.

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

// -------------------------------------------------------------------------
// decode route
// -------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;
constexpr int kDecodeRowsMax = 8;  // query rows a decode block holds

template <int DH>
struct Decode {
  static constexpr int kLanes = DH / 4 < 32 ? DH / 4 : 32;  // lanes of a team: one key row
  static constexpr int kVec = DH / (4 * kLanes);            // float4s of a row a lane holds
  static constexpr int kTeams = kDecodeThreads / kLanes;
  static constexpr int kUnit = 8 / kVec;                    // keys a team folds at once
};

// One unit of a team: the keys base + j * kTeams + team of slots j < n_live
// (kFull: all kUnit slots, whose keys all lie before s1), K and V loaded
// together, each scored against the block's rows and folded into the
// team's running (m, l, acc) of each row, slots in order.
template <int DH, int R, bool kFull>
__device__ __forceinline__ void fold_unit(const float4* q_s, const float* k_head,
                                          const float* v_head, int64_t k_stride,
                                          int64_t v_stride, int base, int s1, int n_live,
                                          int team, int lane, unsigned mask, float scale,
                                          const int (&lo)[R], const int (&hi)[R], int n_rows,
                                          float (&m)[R], float (&l)[R],
                                          float4 (&acc)[R][Decode<DH>::kVec]) {
  using D = Decode<DH>;
  constexpr int kV4 = DH / 4;
  float4 kr[D::kUnit][D::kVec], vr[D::kUnit][D::kVec];
#pragma unroll
  for (int j = 0; j < D::kUnit; ++j) {
    if (!kFull && j >= n_live) break;
    const int kp = base + j * D::kTeams + team;
#pragma unroll
    for (int c = 0; c < D::kVec; ++c) {
      kr[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      vr[j][c] = kr[j][c];
      if (kFull || kp < s1) {
        const int d4 = 4 * (lane + D::kLanes * c);
        kr[j][c] = load4(k_head + static_cast<int64_t>(kp) * k_stride + d4);
        vr[j][c] = load4(v_head + static_cast<int64_t>(kp) * v_stride + d4);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rows) break;
    float4 qv[D::kVec];
#pragma unroll
    for (int c = 0; c < D::kVec; ++c) qv[c] = q_s[r * kV4 + lane + D::kLanes * c];
    float s[D::kUnit];
    float unit_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < D::kUnit; ++j) {
      if (!kFull && j >= n_live) break;
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < D::kVec; ++c) d = dot4(qv[c], kr[j][c], d);
#pragma unroll
      for (int o = D::kLanes / 2; o > 0; o >>= 1) d += __shfl_xor_sync(mask, d, o);
      const int kp = base + j * D::kTeams + team;
      s[j] = ((kFull || kp < s1) && kp >= lo[r] && kp < hi[r]) ? d * scale : -INFINITY;
      unit_max = fmaxf(unit_max, s[j]);
    }
    if (unit_max == -INFINITY) continue;  // no key of this unit reaches row r
    const float m_new = fmaxf(m[r], unit_max);
    const float alpha = expf(m[r] - m_new);  // 0 on the row's first live unit (m = -inf)
    l[r] *= alpha;
#pragma unroll
    for (int c = 0; c < D::kVec; ++c) {
      acc[r][c].x *= alpha;
      acc[r][c].y *= alpha;
      acc[r][c].z *= alpha;
      acc[r][c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < D::kUnit; ++j) {
      if (!kFull && j >= n_live) break;
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      l[r] += p;
#pragma unroll
      for (int c = 0; c < D::kVec; ++c) {
        acc[r][c].x = fmaf(p, vr[j][c].x, acc[r][c].x);
        acc[r][c].y = fmaf(p, vr[j][c].y, acc[r][c].y);
        acc[r][c].z = fmaf(p, vr[j][c].z, acc[r][c].z);
        acc[r][c].w = fmaf(p, vr[j][c].w, acc[r][c].w);
      }
    }
    m[r] = m_new;
  }
}

// the rows a block holds are g = row0 + r of the kv head's group x Lq rows:
// query head kvh * group + g / lq at query position g % lq
template <int DH, int R>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float4* __restrict__ part_acc, float2* __restrict__ part_ml, int n_heads,
                    int n_kv_heads, int lq, int lk, Strides sq, Strides sk, Strides sv,
                    Strides so, int causal, int window, float scale, int n_splits, int chunk) {
  using D = Decode<DH>;
  constexpr int kV4 = DH / 4;  // float4s of a row
  extern __shared__ float4 smem[];
  float4* q_s = smem;                                                    // [R][kV4]
  float4* acc_s = q_s + R * kV4;                                         // [kTeams][R][kV4]
  float2* ml_s = reinterpret_cast<float2*>(acc_s + D::kTeams * R * kV4);  // [kTeams][R]

  const int group = n_heads / n_kv_heads;
  const int rows_total = group * lq;
  const int row_tiles = (rows_total + R - 1) / R;
  int bid = blockIdx.x;
  const int split = bid % n_splits;
  bid /= n_splits;
  const int row0 = (bid % row_tiles) * R;
  bid /= row_tiles;
  const int kvh = bid % n_kv_heads;
  const int b = bid / n_kv_heads;
  const int n_rows = min(R, rows_total - row0);

  // each row's keys [lo, hi), and the block's [klo, khi) that covers them
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
  for (int e = threadIdx.x; e < R * kV4; e += kDecodeThreads) {
    const int r = e / kV4, c = e % kV4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) {
      const int g = row0 + r;
      x = load4(q + b * sq.b + (kvh * group + g / lq) * sq.h +
                static_cast<int64_t>(g % lq) * sq.l + 4 * c);
    }
    q_s[e] = x;
  }
  __syncthreads();

  const int team = threadIdx.x / D::kLanes;
  const int lane = threadIdx.x % D::kLanes;
  // the team's lanes within its warp: a team's branches are its own
  const unsigned mask = D::kLanes == 32
                            ? 0xffffffffu
                            : ((1u << D::kLanes) - 1u) << ((threadIdx.x % 32) & ~(D::kLanes - 1));
  float m[R], l[R];
  float4 acc[R][D::kVec];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D::kVec; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  constexpr int kRound = D::kTeams * D::kUnit;  // keys the block's teams take in one round
  const int s0 = split * chunk, s1 = min(lk, s0 + chunk);
  const float* k_head = k + b * sk.b + kvh * sk.h;
  const float* v_head = v + b * sv.b + kvh * sv.h;
  for (int base = s0; base < s1; base += kRound) {
    if (base + kRound <= klo || base >= khi) continue;  // no row sees a key of this round
    if (base + kRound <= s1) {  // every slot of the unit holds a key of the split
      fold_unit<DH, R, true>(q_s, k_head, v_head, sk.l, sv.l, base, s1, D::kUnit, team, lane,
                             mask, scale, lo, hi, n_rows, m, l, acc);
    } else {
      fold_unit<DH, R, false>(q_s, k_head, v_head, sk.l, sv.l, base, s1,
                              (s1 - base + D::kTeams - 1) / D::kTeams, team, lane, mask, scale,
                              lo, hi, n_rows, m, l, acc);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) ml_s[team * R + r] = make_float2(m[r], l[r]);
#pragma unroll
    for (int c = 0; c < D::kVec; ++c)
      acc_s[(team * R + r) * kV4 + lane + D::kLanes * c] = acc[r][c];
  }
  __syncthreads();

  // fold the teams in team order, each weighted by exp(m_team - m)
  for (int e = threadIdx.x; e < n_rows * kV4; e += kDecodeThreads) {
    const int r = e / kV4, c = e % kV4;
    float mx = -INFINITY;
    for (int t = 0; t < D::kTeams; ++t) mx = fmaxf(mx, ml_s[t * R + r].x);
    float ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < D::kTeams; ++t) {
      const float2 ml = ml_s[t * R + r];
      if (ml.x == -INFINITY) continue;  // the team saw no key of this row
      const float w = expf(ml.x - mx);
      const float4 at = acc_s[(t * R + r) * kV4 + c];
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
      part_acc[slot * kV4 + c] = a;
      if (c == 0) part_ml[slot] = make_float2(mx, ls);
    }
  }
}

// out[row] = the splits' partials of the row folded in split order, each
// weighted by exp(m_split - m), over their weighted l clamped at 1e-30; one
// thread per float4 of a row, rows numbered (b * H + h) * Lq + i
__global__ void __launch_bounds__(256)
flash_decode_combine_kernel(const float4* __restrict__ part_acc,
                            const float2* __restrict__ part_ml, float* __restrict__ out,
                            int n_heads, int lq, int dh, int n_splits, Strides so,
                            int64_t n_rows) {
  const int v4 = dh / 4;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_rows * v4) return;
  const int64_t row = e / v4;
  const int c = static_cast<int>(e % v4);
  const float2* ml = part_ml + row * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[s].x);
  float ls = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_splits; ++s) {
    const float2 p = ml[s];
    if (p.x == -INFINITY) continue;  // no key of this split reaches the row
    const float w = expf(p.x - mx);
    const float4 at = part_acc[(row * n_splits + s) * v4 + c];
    ls = fmaf(p.y, w, ls);
    a = make_float4(fmaf(at.x, w, a.x), fmaf(at.y, w, a.y), fmaf(at.z, w, a.z),
                    fmaf(at.w, w, a.w));
  }
  const float denom = fmaxf(ls, 1e-30f);
  const int i = static_cast<int>(row % lq);
  const int64_t bh = row / lq;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t b = bh / n_heads;
  *reinterpret_cast<float4*>(out + b * so.b + h * so.h + static_cast<int64_t>(i) * so.l + 4 * c) =
      make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
}

template <int DH, int R>
static cudaError_t launch_decode_rows(const float* q, const float* k, const float* v, float* out,
                                      float4* part_acc, float2* part_ml, int batch, int n_heads,
                                      int n_kv_heads, int lq, int lk, const Strides* st,
                                      int causal, int window, float scale, int n_splits,
                                      int chunk, cudaStream_t stream) {
  using D = Decode<DH>;
  const int64_t rows = static_cast<int64_t>(n_heads / n_kv_heads) * lq;
  const int64_t blocks =
      static_cast<int64_t>(batch) * n_kv_heads * ((rows + R - 1) / R) * n_splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float4) * (R * DH / 4) * (1 + D::kTeams) +
                      sizeof(float2) * D::kTeams * R;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<DH, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  flash_decode_kernel<DH, R><<<static_cast<unsigned>(blocks), kDecodeThreads, smem, stream>>>(
      q, k, v, out, part_acc, part_ml, n_heads, n_kv_heads, lq, lk, st[0], st[1], st[2], st[3],
      causal, window, scale, n_splits, chunk);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_decode_dh(int row_tile, const float* q, const float* k,
                                    const float* v, float* out, float4* part_acc,
                                    float2* part_ml, int batch, int n_heads, int n_kv_heads,
                                    int lq, int lk, const Strides* st, int causal, int window,
                                    float scale, int n_splits, int chunk, cudaStream_t stream) {
  switch (row_tile) {
#define REPRO_FA_ROWS(R)                                                                    \
  case R:                                                                                   \
    return launch_decode_rows<DH, R>(q, k, v, out, part_acc, part_ml, batch, n_heads,       \
                                     n_kv_heads, lq, lk, st, causal, window, scale,         \
                                     n_splits, chunk, stream);
    REPRO_FA_ROWS(1)
    REPRO_FA_ROWS(2)
    REPRO_FA_ROWS(4)
    REPRO_FA_ROWS(8)
#undef REPRO_FA_ROWS
    default:
      return cudaErrorInvalidValue;
  }
}

static cudaError_t launch_decode(int dh, int row_tile, const float* q, const float* k,
                                 const float* v, float* out, float4* part_acc, float2* part_ml,
                                 int batch, int n_heads, int n_kv_heads, int lq, int lk,
                                 const Strides* st, int causal, int window, float scale,
                                 int n_splits, int chunk, cudaStream_t stream) {
  cudaError_t err;
  switch (dh) {
#define REPRO_FA_DECODE(D)                                                                 \
  case D:                                                                                  \
    err = launch_decode_dh<D>(row_tile, q, k, v, out, part_acc, part_ml, batch, n_heads,   \
                              n_kv_heads, lq, lk, st, causal, window, scale, n_splits,     \
                              chunk, stream);                                              \
    break;
    REPRO_FA_DECODE(32)
    REPRO_FA_DECODE(64)
    REPRO_FA_DECODE(128)
    REPRO_FA_DECODE(256)
#undef REPRO_FA_DECODE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_splits == 1) return err;
  const int64_t n_rows = static_cast<int64_t>(batch) * n_heads * lq;
  const int64_t threads = n_rows * (dh / 4);
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_decode_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part_acc, part_ml, out, n_heads, lq, dh, n_splits, st[3], n_rows);
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

// The decode route: the same arguments as repro_flash_attention, then
// scratch for each row's partial of every split (part_acc [B*H*Lq,
// n_splits, Dh] and part_ml [B*H*Lq, n_splits, 2] float32; unused, and
// may be null, when n_splits is 1), the query rows a block holds
// (row_tile: 1, 2, 4 or 8) and the splits: split s holds keys
// [s * chunk, min(Lk, (s + 1) * chunk)), n_splits >= 1, chunk >= 1, none
// empty. Launches the decode kernel and, for more than one split, the
// combine. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int repro_flash_attention_decode(const void* q, const void* k, const void* v,
                                            void* out, int batch, int n_heads, int n_kv_heads,
                                            int lq, int lk, int dh, const int64_t* strides,
                                            int causal, int window, float scale, void* part_acc,
                                            void* part_ml, int row_tile, int n_splits, int chunk,
                                            void* stream) {
  using namespace repro_fa;
  if (batch <= 0 || lq <= 0) return cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || lk < 0 || n_splits < 1 || chunk < 1 ||
      static_cast<int64_t>(n_splits - 1) * chunk >= (lk > 0 ? lk : 1) ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)) || row_tile < 1 ||
      row_tile > kDecodeRowsMax)
    return cudaErrorInvalidValue;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  return launch_decode(dh, row_tile, static_cast<const float*>(q),
                       static_cast<const float*>(k), static_cast<const float*>(v),
                       static_cast<float*>(out), static_cast<float4*>(part_acc),
                       static_cast<float2*>(part_ml), batch, n_heads, n_kv_heads, lq, lk, st,
                       causal, window, scale, n_splits, chunk, static_cast<cudaStream_t>(stream));
}

// Shared pieces of the Shuffle+Reduce kernels: dtype/op codes, reduction
// identities, rounding-exact arithmetic and the warp reduction tree.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace repro {

enum Dtype : int { kF32 = 0, kI32 = 1 };
enum ReduceOp : int { kSum = 0, kMin = 1, kMax = 2 };
enum ApplyOp : int { kAdd = 0, kMul = 1, kSrc = 2 };

// Float arithmetic goes through the _rn intrinsics so that nvcc never
// contracts a multiply and an add into one FMA: every operation rounds
// where the plain PyTorch version rounds. Integer arithmetic wraps
// (two's complement), as int32 arithmetic does in PyTorch and XLA.
template <typename T> struct Arith;
template <> struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Arith<int32_t> {
  static __device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
  }
  static __device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
  }
};

template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ __forceinline__ float lowest() { return -__int_as_float(0x7f800000); }
  static __device__ __forceinline__ float highest() { return __int_as_float(0x7f800000); }
};
template <> struct Limits<int32_t> {
  static __device__ __forceinline__ int32_t lowest() { return INT32_MIN; }
  static __device__ __forceinline__ int32_t highest() { return INT32_MAX; }
};

// Reduction op: identity (what an empty bin holds) and combine.
template <typename T, int OP> struct Reduce;
template <typename T> struct Reduce<T, kSum> {
  static __device__ __forceinline__ T identity() { return T(0); }
  static __device__ __forceinline__ T apply(T a, T b) { return Arith<T>::add(a, b); }
};
template <typename T> struct Reduce<T, kMin> {
  static __device__ __forceinline__ T identity() { return Limits<T>::highest(); }
  static __device__ __forceinline__ T apply(T a, T b) { return b < a ? b : a; }
};
template <typename T> struct Reduce<T, kMax> {
  static __device__ __forceinline__ T identity() { return Limits<T>::lowest(); }
  static __device__ __forceinline__ T apply(T a, T b) { return b > a ? b : a; }
};

// Fixed-shape tree over each group of WIDTH lanes (the whole warp by
// default); the group's first lane ends with its result. Every lane of the
// warp takes part. The shape never depends on the data, so a float sum
// gives the same bits on every run.
template <typename T, int OP, int WIDTH = 32>
__device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    v = Reduce<T, OP>::apply(v, __shfl_down_sync(0xffffffffu, v, o, WIDTH));
  }
  return v;
}

// A bin boundary clamped into the stream [0, n]: offsets that overrun the
// stream cannot send a warp past its end. The result fits int32 because
// the offset does, so the bin loops keep 32-bit indices.
__device__ __forceinline__ int32_t clamp_offset(int32_t off, int64_t n) {
  return off < 0 ? 0 : (off > n ? static_cast<int32_t>(n) : off);
}

constexpr int kThreads = 256;  // 8 warps a block, one bin per warp at a time

// Blocks for a warp-per-bin grid-stride launch: enough to fill the card
// several times over, never more than there are bins.
inline int grid_for(int64_t n_bins) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t warps = kThreads / 32;
  int64_t blocks = (n_bins + warps - 1) / warps;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace repro

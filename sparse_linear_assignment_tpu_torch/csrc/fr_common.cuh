// Pieces shared by the auction kernels (fr_kernel.cu, fr_big_kernel.cu,
// ksp_kernel.cu): the sentinels, the order-preserving value images, the
// float top-2 with its tie rule (a lane's running top-2, the warp merge,
// both also in a form that carries the row's value at argbest, the warp
// merge in three redux.sync, the warp-wide top2), the 64-bit conflict
// key, and a warp's list append.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kUnassigned = 0x7fffffff;
constexpr int32_t kIntSentinel = -(1 << 30);
constexpr int32_t kStallK0 = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static __device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
  }
  // order-preserving unsigned image of a float (no NaNs occur)
  static __device__ __forceinline__ uint32_t order(float x) {
    uint32_t u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float unorder(uint32_t o) {
    uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
    return __uint_as_float(u);
  }
};

template <>
struct Traits<int32_t> {
  static __device__ __forceinline__ int32_t neg_inf() { return kIntSentinel; }
  static __device__ __forceinline__ uint32_t order(int32_t x) {
    return static_cast<uint32_t>(x) ^ 0x80000000u;
  }
  static __device__ __forceinline__ int32_t unorder(uint32_t o) {
    return static_cast<int32_t>(o ^ 0x80000000u);
  }
};

// Conflict key of a bid: the increment's order bits above the inverted
// bidder index, so that one 64-bit atomicMax per priced item keeps the
// largest increment and, on equal increments, the smallest bidder.
template <typename T>
__device__ __forceinline__ unsigned long long bid_key(T inc, int bidder) {
  return (static_cast<unsigned long long>(Traits<T>::order(inc)) << 32) |
         static_cast<unsigned long long>(~static_cast<uint32_t>(bidder));
}

// The bidder of a conflict key.
__device__ __forceinline__ int32_t key_bidder(unsigned long long key) {
  return static_cast<int32_t>(~static_cast<uint32_t>(key));
}

// Running top-2 of one lane: a strict > on ascending positions keeps the
// smallest index among equal maxima; an equal value lands in second.
__device__ __forceinline__ void top2_take(float v, int r, float& b, float& s,
                                          int& j) {
  if (v > b) {
    s = fmaxf(s, b);
    b = v;
    j = r;
  } else {
    s = fmaxf(s, v);
  }
}

// The exact merge of _top2_rows_f32 across a warp: ties go to the smaller
// index, the other tied position's value lands in second via min(b1, b2).
__device__ __forceinline__ void top2_warp_merge(float& b, float& s, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(kFull, b, off);
    const int j2 = __shfl_xor_sync(kFull, j, off);
    const float s2 = __shfl_xor_sync(kFull, s, off);
    const bool take1 = (b > b2) || (b == b2 && j <= j2);
    s = fmaxf(fminf(b, b2), fmaxf(s, s2));
    b = take1 ? b : b2;
    j = take1 ? j : j2;
  }
}

// The warp's top-2 from each lane's top-2 of disjoint positions, in three
// redux.sync: the best (a max of order images), the smallest argbest of
// the lanes holding it, and the second as the max over the lanes of the
// best they hold outside argbest (their second for the lane whose own
// argbest it is, their best for every other lane).  Max and min are exact
// and order-free: this equals top2_warp_merge but for the sign of a zero
// best or second.
__device__ __forceinline__ void top2_warp_redux(float& b, float& s, int& j) {
  const float best = Traits<float>::unorder(
      __reduce_max_sync(kFull, Traits<float>::order(b)));
  const int arg = static_cast<int>(__reduce_min_sync(
      kFull, b == best ? static_cast<uint32_t>(j) : 0xffffffffu));
  const float other = j == arg ? s : b;
  s = Traits<float>::unorder(
      __reduce_max_sync(kFull, Traits<float>::order(other)));
  b = best;
  j = arg;
}

// top2_take that also keeps `raw`, the row's value at the lane's best
// position, so that the value at argbest needs no second load.
__device__ __forceinline__ void top2_take_raw(float v, float raw, int r,
                                              float& b, float& s, int& j,
                                              float& bv) {
  if (v > b) {
    s = fmaxf(s, b);
    b = v;
    j = r;
    bv = raw;
  } else {
    s = fmaxf(s, v);
  }
}

// top2_warp_merge carrying the raw value at argbest with it.
__device__ __forceinline__ void top2_warp_merge_raw(float& b, float& s,
                                                    int& j, float& bv) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(kFull, b, off);
    const int j2 = __shfl_xor_sync(kFull, j, off);
    const float s2 = __shfl_xor_sync(kFull, s, off);
    const float bv2 = __shfl_xor_sync(kFull, bv, off);
    const bool take1 = (b > b2) || (b == b2 && j <= j2);
    s = fmaxf(fminf(b, b2), fmaxf(s, s2));
    b = take1 ? b : b2;
    j = take1 ? j : j2;
    bv = take1 ? bv : bv2;
  }
}

// Append `flag`ged indices of one warp to a list with one atomic per warp.
__device__ __forceinline__ void warp_append(bool flag, int x, int lane,
                                            int32_t* list, int* count) {
  const unsigned ball = __ballot_sync(kFull, flag);
  int slot = 0;
  if (lane == 0 && ball) slot = atomicAdd(count, __popc(ball));
  slot = __shfl_sync(kFull, slot, 0);
  if (flag) list[slot + __popc(ball & ((1u << lane) - 1u))] = x;
}

// Warp-wide top-2 of row[r] - rowp[r] over r < S.  Every lane returns
// best, argbest (smallest index among the maxima) and second (the max over
// every position except argbest), with has_second false when S == 1.
__device__ __forceinline__ void top2(const float* __restrict__ row,
                                     const float* rowp, int S, int sh,
                                     int lane, float& best, int& arg,
                                     float& second, bool& has_second) {
  (void)sh;
  const float ninf = Traits<float>::neg_inf();
  float b = ninf, s = ninf;
  int j = kUnassigned;
  for (int r = lane; r < S; r += 32) top2_take(row[r] - rowp[r], r, b, s, j);
  top2_warp_merge(b, s, j);
  best = b;
  arg = j;
  second = s;
  has_second = s != ninf;
}

}  // namespace

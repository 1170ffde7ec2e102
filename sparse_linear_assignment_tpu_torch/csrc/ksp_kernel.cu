// Forward-only Khosla auction rounds for a batch of densified k-sparse
// instances.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_ksparse.py:_ksp_kernel (driven by ksp_rounds_pallas_flat and
// ksp_chunk_pallas).  Semantics are those of ops/auction.py:khosla_round on
// a dense problem, run for up to `rounds` rounds per instance, each instance
// leaving the loop as soon as it has no active person (unassigned and not
// dropped).  See ops/ksparse_kernel.py for the Python wrapper, the plain
// PyTorch version and the note on what bounds this kernel.
//
// Layout: one CTA per instance (grid = B), kThreads threads and at most
// 65536 / (kThreads * kBlocksPerSm) registers a thread, so that kBlocksPerSm
// instances are resident on an SM.  The instance's small state lives in
// shared memory for the whole round loop: prices [M] and one 64-bit key per
// object; p2o, dropped, two active lists and this round's target by list
// slot per person.  Between rounds an object's key rests at ~owner (0 if it
// has none), so the key doubles as the owner map and no o2p is kept.  The
// person-major value plane `vals [B, N, M]` (-inf at non-arcs) stays in
// device memory; a round reads only the rows of its active persons, so the
// plane is read once in the first round and a few rows after that.
//
// Entry: the keys rest at the owners given by p2o (a continuation enters
// with assigned persons and the o2p it passed through, which is stale), and
// the unassigned, undropped persons form the first list.  None: leave.
// A round (two block barriers):
//   B. one warp per listed person, its row in 16-byte loads, kLoadsInFlight
//      of them a lane in flight before any is folded (the whole row at
//      M = 512): top-2 of (row - prices) with the smallest object on ties,
//      carrying the row's value at the best object through the merge (the
//      exact float the plain version reads), the price of the best object
//      reconstructed as best_val - best (what the drop test and the
//      single-arc bid use, as in the plain version); then the person is
//      dropped, or one 64-bit atomicMax posts its bid into the object's key
//      (bid order bits << 32 | ~person: the largest bid wins, the smallest
//      person on ties).  The one bid that finds the key at rest displaces
//      the object's owner (it is unassigned and joins the next list);
//                                                         -- barrier
//   C. only the round's entries: a bidder that its object's key names takes
//      the object, whose price becomes the winning bid and whose key rests
//      at the new owner; a bidder that lost (or has no arc) joins the next
//      list; a dropped one leaves;
//                                                         -- barrier
//   and the next list's count ends the loop when it is 0.  With a round
//   log (`trace`, null by default; a kernel instance of its own) thread 0
//   writes the round's row before that test: nits (the entry's plus the
//   rounds run), whether a person is still active (0 or 1, as JAX's max),
//   done.
// The order of a list does not change any result: bids meet through a
// commutative max.  The lists and their counts alternate between two sets
// by round.  A loser that reads its object's key after the winner set it to
// rest still reads another person.  Every bid of a round is computed from
// the prices of the round's start: prices change only in C, between the
// barriers.  Float arithmetic is subtracts and adds only, so nothing can
// contract into an fma and the result is bit-identical to the plain
// version.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

// 128 threads and 8 CTAs an SM: 64 registers a thread, no spills; 8 x 4
// warps x 2 KB of rows in flight at M = 512 (tools/ksp_kernel_variants.py
// times other shapes)
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;
// 16-byte loads a lane keeps in flight for a row (a warp: 2 KB)
constexpr int kLoadsInFlight = 4;

// phase counters (clock64 cycles of each CTA's thread 0, summed over CTAs;
// ops/ksparse_kernel.py:PHASES names them in this order).  `active` is the
// entry pass that lists the active persons, `total` runs from its start to
// the end of the last round; the price and key updates are part of
// `apply`, so `prices` stays 0 here.
constexpr int kProfActive = 0;
constexpr int kProfBids = 1;
constexpr int kProfApply = 2;
constexpr int kProfBarrier = 4;
constexpr int kProfTotal = 5;
constexpr int kProfRounds = 6;
constexpr int kProfWords = 7;

// this round's target of a list slot besides an object: no arc (the person
// stays active and bids nothing), dropped
constexpr int32_t kNoArc = -1;
constexpr int32_t kDropped = -2;

// the resting key of an object owned by `owner`
__device__ __forceinline__ unsigned long long rest_key(int32_t owner) {
  return static_cast<unsigned long long>(~static_cast<uint32_t>(owner));
}

// kTrace: the round log is written (`trace` not null).  The production
// instance (false) carries no trace code.
template <bool kTrace>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ksp_rounds_kernel(const float* __restrict__ vals, float* __restrict__ prices,
                  int32_t* __restrict__ p2o,
                  unsigned char* __restrict__ dropped,
                  int32_t* __restrict__ nits,
                  const float* __restrict__ thresholds,
                  long long* __restrict__ act_rows, long long* prof,
                  long long* stamps, int32_t* trace, float eps, int N, int M,
                  int rounds) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  long long t_start = 0;
  if (stamps && tid == 0)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));

  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* keys = smem;                              // [M]
  float* s_prices = reinterpret_cast<float*>(keys + M);         // [M]
  int32_t* s_p2o = reinterpret_cast<int32_t*>(s_prices + M);    // [N]
  int32_t* s_tgt = s_p2o + N;                   // [N] by list slot
  int32_t* lists = s_tgt + N;                   // [2][N]
  unsigned char* s_drop = reinterpret_cast<unsigned char*>(lists + 2 * N);
  __shared__ int cnt[2];                        // the two lists' counts
  __shared__ long long acc[kProfWords];         // thread 0's counters

  const bool timing = prof != nullptr && tid == 0;
  if (tid < kProfWords) acc[tid] = 0;
  long long mark = 0;
  // charge the cycles since the last mark to `slot` (thread 0 only)
  auto lap = [&](int slot) {
    if (timing) {
      const long long now = clock64();
      acc[slot] += now - mark;
      mark = now;
    }
  };

  const size_t pbase = static_cast<size_t>(b) * N;
  const size_t obase = static_cast<size_t>(b) * M;
  for (int j = tid; j < M; j += kThreads) {
    s_prices[j] = prices[obase + j];
    keys[j] = 0ull;
  }
  for (int i = tid; i < N; i += kThreads) {
    s_p2o[i] = p2o[pbase + i];
    s_drop[i] = dropped[pbase + i];
  }
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();
  long long t_first = 0;
  if (timing) t_first = mark = clock64();
  // the owners' resting keys and the first list; every thread runs the
  // same iterations, so warp_append sees whole warps
  for (int i0 = 0; i0 < N; i0 += kThreads) {
    const int i = i0 + tid;
    const int32_t own = i < N ? s_p2o[i] : kUnassigned;
    if (own != kUnassigned) keys[own] = rest_key(i);
    warp_append(i < N && own == kUnassigned && !s_drop[i], i, lane, lists,
                &cnt[0]);
  }
  lap(kProfActive);
  __syncthreads();
  lap(kProfBarrier);
  int nact = cnt[0];

  int ran = 0;
  long long rows_read = 0;
  if (nact > 0) {
    const float ninf = Traits<float>::neg_inf();
    const float thr = thresholds[b];
    const float* inst = vals + static_cast<size_t>(b) * N * M;
    const float4* p4 = reinterpret_cast<const float4*>(s_prices);
    const int m4 = M >> 2;
    int cur = 0;
    for (int it = 0; it < rounds; ++it) {
      const int32_t* list = lists + cur * N;
      int32_t* next = lists + (cur ^ 1) * N;
      int* next_cnt = &cnt[cur ^ 1];
      rows_read += nact;

      // B. bids: one listed person a warp, kLoadsInFlight loads a lane in
      // flight, folded in ascending positions
      for (int k = warp; k < nact; k += nwarps) {
        const int i = list[k];
        const float4* row =
            reinterpret_cast<const float4*>(inst + static_cast<size_t>(i) * M);
        float best = ninf, second = ninf, best_val = 0.0f;
        int arg = kUnassigned;
        for (int v0 = 0; v0 < m4; v0 += 32 * kLoadsInFlight) {
          float4 x[kLoadsInFlight];
#pragma unroll
          for (int u = 0; u < kLoadsInFlight; ++u) {
            const int v = v0 + u * 32 + lane;
            if (v < m4) x[u] = __ldg(row + v);
          }
#pragma unroll
          for (int u = 0; u < kLoadsInFlight; ++u) {
            const int v = v0 + u * 32 + lane;
            if (v < m4) {
              const float4 p = p4[v];
              const int pos = 4 * v;
              top2_take_raw(x[u].x - p.x, x[u].x, pos, best, second, arg,
                            best_val);
              top2_take_raw(x[u].y - p.y, x[u].y, pos + 1, best, second, arg,
                            best_val);
              top2_take_raw(x[u].z - p.z, x[u].z, pos + 2, best, second, arg,
                            best_val);
              top2_take_raw(x[u].w - p.w, x[u].w, pos + 3, best, second, arg,
                            best_val);
            }
          }
        }
        top2_warp_merge_raw(best, second, arg, best_val);
        if (lane == 0) {
          int32_t t = kNoArc;
          if (arg != kUnassigned) {
            const float price_at_best = best_val - best;
            if (price_at_best > thr) {
              s_drop[i] = 1;
              t = kDropped;
            } else {
              const float bid =
                  (second != ninf ? best_val - second : price_at_best) + eps;
              t = arg;
              const unsigned long long was =
                  atomicMax(&keys[arg], bid_key(bid, i));
              if (was != 0ull && (was >> 32) == 0ull) {
                // the round's first bid on an owned object: the owner leaves
                const int32_t owner = key_bidder(was);
                s_p2o[owner] = kUnassigned;
                next[atomicAdd(next_cnt, 1)] = owner;
              }
            }
          }
          s_tgt[k] = t;
        }
      }
      lap(kProfBids);
      __syncthreads();
      lap(kProfBarrier);

      // C. only the round's entries: winners take their objects, losers
      // and persons without an arc stay listed, dropped persons leave.
      // This round's count is reset for the round after next (every
      // thread read it before the barrier).
      if (tid == 0) cnt[cur] = 0;
      for (int x0 = 0; x0 < nact; x0 += kThreads) {
        const int x = x0 + tid;
        int32_t stay = -1;
        if (x < nact) {
          const int32_t i = list[x];
          const int32_t t = s_tgt[x];
          if (t >= 0) {
            const unsigned long long key = keys[t];
            if (key_bidder(key) == i) {
              s_p2o[i] = t;
              s_prices[t] = Traits<float>::unorder(
                  static_cast<uint32_t>(key >> 32));
              keys[t] = rest_key(i);
            } else {
              stay = i;
            }
          } else if (t == kNoArc) {
            stay = i;
          }
        }
        warp_append(stay >= 0, stay, lane, next, next_cnt);
      }
      lap(kProfApply);
      __syncthreads();
      lap(kProfBarrier);
      ++ran;
      nact = *next_cnt;
      cur ^= 1;
      if constexpr (kTrace) {
        if (tid == 0) {
          int32_t* row = trace + (static_cast<size_t>(b) * rounds + it) * 3;
          row[0] = nits[b] + ran;
          row[1] = nact > 0;
          row[2] = nact == 0;
        }
      }
      if (nact == 0) break;  // the instance is done; uniform over the CTA
    }
    if (timing) {
      acc[kProfTotal] = clock64() - t_first;
      acc[kProfRounds] = ran;
    }

    for (int j = tid; j < M; j += kThreads) prices[obase + j] = s_prices[j];
    for (int i = tid; i < N; i += kThreads) {
      p2o[pbase + i] = s_p2o[i];
      dropped[pbase + i] = s_drop[i];
    }
    if (tid == 0) {
      nits[b] += ran;
      if (act_rows) act_rows[b] += rows_read;
    }
  }
  // an instance that enters done leaves its (copied) state as it is
  if (timing) {
#pragma unroll
    for (int k = 0; k < kProfWords; ++k)
      atomicAdd(reinterpret_cast<unsigned long long*>(prof + k),
                static_cast<unsigned long long>(acc[k]));
  }
  if (stamps && tid == 0) {
    long long t_end;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
    stamps[2 * b] = t_start;
    stamps[2 * b + 1] = t_end;
  }
}

// Shared memory one instance needs: 12 bytes per object, 17 per person
// (ops/ksparse_kernel.py:smem_bytes holds the wrapper to the same sum).
size_t smem_bytes(int N, int M) {
  return static_cast<size_t>(M) * (sizeof(unsigned long long) + sizeof(float)) +
         static_cast<size_t>(N) * (4 * sizeof(int32_t) + 1);
}

}  // namespace

// Pointers are device pointers of contiguous tensors: vals [B, N, M] float32
// (M a multiple of 4 and vals 16-byte aligned: rows are read in 16-byte
// loads), prices [B, M] float32, p2o [B, N] int32, dropped [B, N] bytes (0
// or 1), nits [B] int32, thresholds [B] float32; act_rows [B], prof
// [kProfWords] and stamps [B, 2] (int64) and the round log trace
// [B, rounds, 3] (int32; rows of rounds not run are left as they are) may
// be null.  p2o must be a matching (no object owned twice).  prices, p2o,
// dropped and nits are updated in place.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int slap_ksp_rounds(const void* vals, void* prices, void* p2o,
                               void* dropped, void* nits,
                               const void* thresholds, void* act_rows,
                               void* prof, void* stamps, void* trace,
                               float eps, int B, int N, int M, int rounds,
                               void* stream) {
  if (B <= 0) return 0;
  if (M <= 0 || M % 4 != 0 || reinterpret_cast<uintptr_t>(vals) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, M);
  auto kernel = trace ? ksp_rounds_kernel<true> : ksp_rounds_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(prices),
      static_cast<int32_t*>(p2o), static_cast<unsigned char*>(dropped),
      static_cast<int32_t*>(nits), static_cast<const float*>(thresholds),
      static_cast<long long*>(act_rows), static_cast<long long*>(prof),
      static_cast<long long*>(stamps), static_cast<int32_t*>(trace), eps, N,
      M, rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slap_ksp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

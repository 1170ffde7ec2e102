// The batched-sparse Khosla kernel as the port first wrote it (one warp a
// row in 4-byte loads, a dependent reload of row[arg], three block barriers
// and passes over every person and object a round, 256 threads), kept with
// phase counters and CTA stamps so that tools/ksp_kernel_variants.py times
// it beside csrc/ksp_kernel.cu in one call.  Same C interface; build with
// -I sparse_linear_assignment_tpu_torch/csrc.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_ksparse.py:_ksp_kernel (driven by ksp_rounds_pallas_flat and
// ksp_chunk_pallas).  Semantics are those of ops/auction.py:khosla_round on
// a dense problem, run for up to `rounds` rounds per instance, each instance
// leaving the loop as soon as it has no active person (unassigned and not
// dropped).  See ops/ksparse_kernel.py for the Python wrapper, the plain
// PyTorch version and the note on what bounds this kernel.
//
// Layout: one CTA per instance (grid = B).  The instance's small state lives
// in shared memory for the whole round loop: prices [M] and one 64-bit
// conflict key per object, p2o, dropped and this round's choice per person.
// The person-major value plane `vals [B, N, M]` (-inf at non-arcs) stays in
// device memory; a round reads only the rows of its active persons, so the
// plane is read once in the first round and a few rows after that.
//
// A round:
//   A. list the active persons (warp-aggregated atomics); none: leave;
//   B. one warp per active person: top-2 of (row - prices) with the
//      smallest object on ties, best_val = row[arg], the price of the best
//      object reconstructed as best_val - best (what the drop test and the
//      single-arc bid use, as in the plain version), then either the person
//      is dropped or one 64-bit atomicMax posts its bid into the object's
//      key (bid order bits << 32 | ~person): the largest bid wins, the
//      smallest person on ties;
//   C. per person: an owner whose object got a winner is displaced, a bidder
//      that is its object's winner takes it (the two sets are disjoint);
//   D. per object: the price becomes the winning bid, the key is cleared.
// Every bid of a round is computed from the prices of the round's start:
// prices change only in D, after a barrier.  Float arithmetic is subtracts
// and adds only, so nothing can contract into an fma and the result is
// bit-identical to the plain version.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

constexpr int kThreads = 256;

// phase counters (clock64 cycles of each CTA's thread 0, summed over rounds
// and CTAs; ops/ksparse_kernel.py:PHASES names them in this order)
constexpr int kProfActive = 0;
constexpr int kProfBids = 1;
constexpr int kProfApply = 2;
constexpr int kProfPrices = 3;
constexpr int kProfBarrier = 4;
constexpr int kProfTotal = 5;
constexpr int kProfRounds = 6;
constexpr int kProfWords = 7;

__global__ void __launch_bounds__(kThreads)
ksp_rounds_kernel(const float* __restrict__ vals, float* __restrict__ prices,
                  int32_t* __restrict__ p2o, unsigned char* __restrict__ dropped,
                  int32_t* __restrict__ nits,
                  const float* __restrict__ thresholds,
                  long long* __restrict__ act_rows, long long* prof,
                  long long* stamps, float eps, int N, int M, int rounds) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  long long t_start = 0;
  if (stamps && tid == 0)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));

  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                              // [M]
  float* s_prices = reinterpret_cast<float*>(keys + M);         // [M]
  int32_t* s_p2o = reinterpret_cast<int32_t*>(s_prices + M);    // [N]
  int32_t* s_bestj = s_p2o + N;                                 // [N]
  int32_t* s_active = s_bestj + N;                              // [N]
  unsigned char* s_drop =
      reinterpret_cast<unsigned char*>(s_active + N);           // [N]

  __shared__ int c_nact;
  __shared__ int c_nits;
  __shared__ long long c_rows;
  __shared__ long long acc[kProfWords];  // thread 0's counters

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
    s_bestj[i] = -1;
  }
  if (tid == 0) {
    c_nact = 0;
    c_nits = nits[b];
    c_rows = 0;
  }
  __syncthreads();

  const float thr = thresholds[b];
  const float* inst = vals + static_cast<size_t>(b) * N * M;
  for (int it = 0; it < rounds; ++it) {
    long long round_start = 0;
    if (timing) round_start = mark = clock64();
    // A. the active persons: unassigned and not dropped
    for (int i0 = 0; i0 < N; i0 += kThreads) {
      const int i = i0 + tid;
      const bool act = i < N && s_p2o[i] == kUnassigned && !s_drop[i];
      const unsigned ball = __ballot_sync(kFull, act);
      int slot = 0;
      if (lane == 0 && ball) slot = atomicAdd(&c_nact, __popc(ball));
      slot = __shfl_sync(kFull, slot, 0);
      if (act) s_active[slot + __popc(ball & ((1u << lane) - 1u))] = i;
    }
    lap(kProfActive);
    __syncthreads();
    lap(kProfBarrier);
    const int nact = c_nact;
    if (nact == 0) {  // the instance is done; uniform over the CTA
      if (timing) acc[kProfTotal] += clock64() - round_start;
      break;
    }

    // B. choice, drop rule and bids: one warp per active person
    for (int k = warp; k < nact; k += nwarps) {
      const int i = s_active[k];
      const float* row = inst + static_cast<size_t>(i) * M;
      float best, second;
      int arg;
      bool has_second;
      top2(row, s_prices, M, 0, lane, best, arg, second, has_second);
      if (lane == 0) {
        if (arg == kUnassigned) {
          // a person with no arc neither bids nor is dropped
          s_bestj[i] = -1;
        } else {
          const float best_val = row[arg];
          const float price_at_best = best_val - best;
          if (price_at_best > thr) {
            s_drop[i] = 1;
            s_bestj[i] = -1;
          } else {
            const float bid =
                (has_second ? best_val - second : price_at_best) + eps;
            s_bestj[i] = arg;
            atomicMax(&keys[arg], bid_key(bid, i));
          }
        }
      }
    }
    lap(kProfBids);
    __syncthreads();
    lap(kProfBarrier);

    // C. persons: displaced owners leave, winners take their object
    for (int i = tid; i < N; i += kThreads) {
      const int32_t cur = s_p2o[i];
      if (cur != kUnassigned) {
        if (keys[cur]) s_p2o[i] = kUnassigned;
      } else {
        const int32_t j = s_bestj[i];
        if (j >= 0 && key_bidder(keys[j]) == i) s_p2o[i] = j;
      }
    }
    if (tid == 0) {
      c_nits += 1;
      c_rows += nact;
      c_nact = 0;
    }
    lap(kProfApply);
    __syncthreads();
    lap(kProfBarrier);

    // D. objects: the winning bid becomes the price
    for (int j = tid; j < M; j += kThreads) {
      const unsigned long long key = keys[j];
      if (key) {
        s_prices[j] = Traits<float>::unorder(static_cast<uint32_t>(key >> 32));
        keys[j] = 0ull;
      }
    }
    lap(kProfPrices);
    if (timing) {
      acc[kProfTotal] += clock64() - round_start;
      acc[kProfRounds] += 1;
    }
    // the next round's barrier after A orders D before its bids
  }

  __syncthreads();
  for (int j = tid; j < M; j += kThreads) prices[obase + j] = s_prices[j];
  for (int i = tid; i < N; i += kThreads) {
    p2o[pbase + i] = s_p2o[i];
    dropped[pbase + i] = s_drop[i];
  }
  if (tid == 0) {
    nits[b] = c_nits;
    if (act_rows) act_rows[b] += c_rows;
  }
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

// Shared memory one instance needs: 12 bytes per object, 13 per person
// (ops/ksparse_kernel.py:smem_bytes holds the wrapper to the same sum).
size_t smem_bytes(int N, int M) {
  return static_cast<size_t>(M) * (sizeof(unsigned long long) + sizeof(float)) +
         static_cast<size_t>(N) * (3 * sizeof(int32_t) + 1);
}

}  // namespace

// Pointers are device pointers of contiguous tensors: vals [B, N, M] float32,
// prices [B, M] float32, p2o [B, N] int32, dropped [B, N] bytes (0 or 1),
// nits [B] int32, thresholds [B] float32; act_rows [B], prof [kProfWords]
// and stamps [B, 2] (int64) may be null; `trace` (the shipped kernel's
// round log) must be.  prices, p2o, dropped and nits are updated in place.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int slap_ksp_rounds(const void* vals, void* prices, void* p2o,
                               void* dropped, void* nits,
                               const void* thresholds, void* act_rows,
                               void* prof, void* stamps, void* trace,
                               float eps, int B, int N, int M, int rounds,
                               void* stream) {
  if (B <= 0) return 0;
  // this design keeps no round log (the shipped kernel's `trace`)
  if (trace) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, M);
  cudaError_t err = cudaFuncSetAttribute(
      ksp_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksp_rounds_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(prices),
      static_cast<int32_t*>(p2o), static_cast<unsigned char*>(dropped),
      static_cast<int32_t*>(nits), static_cast<const float*>(thresholds),
      static_cast<long long*>(act_rows), static_cast<long long*>(prof),
      static_cast<long long*>(stamps), eps, N, M, rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slap_ksp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

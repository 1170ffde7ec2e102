// Forward-reverse auction rounds for a batch of dense square instances.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_fr.py:_fr_kernel
// (_fr_one_block, _generic_sub and the fused top-2 helpers).  Semantics are
// those of ops/fr_dense.py:fr_round with skip_certificate=True, run for up
// to `rounds` rounds per instance with an early exit once the instance is
// done (full matching).  See ops/fr_kernel.py for the Python wrapper, the
// plain PyTorch version and the note on what bounds this kernel.
//
// Layout: one CTA per instance (grid = B).  The instance's whole state
// (prices, profits, p2o, o2p, per-bidder argbest/floor, per-priced-item
// conflict keys) lives in shared memory for the whole round loop; values
// stay in device memory and are read each round, only for the rows of the
// current bidders.  Both layouts are passed (`vals` person-major,
// `vals_t` object-major) so that a bidder's row is contiguous in either
// mode: forward mode (persons bid) reads rows of `vals`, reverse mode
// (free objects bid) rows of `vals_t`.  The mode selects the dual roles:
//   forward: priced side = objects (rowp = prices, rowo2p = o2p),
//            bidders = persons (colpi = profits, colp2o = p2o)
//   reverse: priced side = persons (rowp = profits, rowo2p = p2o),
//            bidders = objects (colpi = prices, colp2o = o2p)
//
// A round:
//   A. list the unassigned bidders (warp-aggregated atomics);
//   B. one warp per bidder: top-2 of (row - rowp) with the smallest index
//      on ties, then one 64-bit atomicMax per bid into the priced item's
//      conflict key (increment order bits << 32 | ~bidder): the largest
//      increment wins, the smallest bidder on ties;
//   C. per priced item: apply the winning bid (rowp += inc, owner = winner);
//   D. per bidder-side entry: the winner takes its item (colpi = floor -
//      eps), the displaced owner is unassigned; count the cardinality delta;
//   E. thread 0: mode flip on a cardinality rise or a stall, doubling stall
//      horizon, nits, done = (cardinality == S).
// Float arithmetic is adds and subtracts only, in the JAX association
// order, so the result is bit-identical to the plain version.  Build
// without --use_fast_math (denormal flushing would change values).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

// meta row of an instance: nits, forward_mode, done, since_inc, stall_k
constexpr int kMeta = 5;

// Integer lattice: packed keys (profit << sh) | (mask - r), unique per
// position, so a plain max gives the value and its smallest index at once
// (ops/pallas_fr.py:286-296).  The key range guard of _integer_scale keeps
// the shift inside int32.  Shifts go through uint32_t: a left shift of a
// negative int is undefined in C++17; >> on int32_t is arithmetic.
__device__ __forceinline__ void top2(const int32_t* __restrict__ row,
                                     const int32_t* rowp, int S, int sh,
                                     int lane, int32_t& best, int& arg,
                                     int32_t& second, bool& has_second) {
  const int32_t mask = (1 << sh) - 1;
  int32_t bk = INT32_MIN, sk = INT32_MIN;
  for (int r = lane; r < S; r += 32) {
    const int32_t v = row[r] - rowp[r];
    const int32_t key = static_cast<int32_t>(
        (static_cast<uint32_t>(v) << sh) | static_cast<uint32_t>(mask - r));
    if (key > bk) {
      sk = bk;
      bk = key;
    } else {
      sk = max(sk, key);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t b2 = __shfl_xor_sync(kFull, bk, off);
    const int32_t s2 = __shfl_xor_sync(kFull, sk, off);
    sk = max(min(bk, b2), max(sk, s2));
    bk = max(bk, b2);
  }
  best = bk >> sh;
  arg = mask - (bk & mask);
  has_second = sk != INT32_MIN;
  second = sk >> sh;
}

template <typename T>
__global__ void __launch_bounds__(1024)
fr_rounds_kernel(const T* __restrict__ vals, const T* __restrict__ vals_t,
                 T* __restrict__ prices, T* __restrict__ profits,
                 int32_t* __restrict__ p2o, int32_t* __restrict__ o2p,
                 const T* __restrict__ eps, int32_t* __restrict__ meta,
                 long long* __restrict__ bid_rows, int S, int sh,
                 int rounds) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  int32_t* m = meta + static_cast<size_t>(b) * kMeta;
  if (m[2] != 0 || rounds <= 0) return;  // done instances are frozen

  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                      // [S]
  T* s_prices = reinterpret_cast<T*>(keys + S);         // [S]
  T* s_profits = s_prices + S;                          // [S]
  T* s_floor = s_profits + S;                           // [S]
  int32_t* s_p2o = reinterpret_cast<int32_t*>(s_floor + S);  // [S]
  int32_t* s_o2p = s_p2o + S;                           // [S]
  int32_t* s_bestj = s_o2p + S;                         // [S]
  int32_t* s_bidders = s_bestj + S;                     // [S]
  unsigned char* s_haswin =
      reinterpret_cast<unsigned char*>(s_bidders + S);  // [S]

  __shared__ int c_nits, c_mode, c_done, c_since, c_stallk, c_card;
  __shared__ int c_nbid, c_delta;
  __shared__ long long c_bidrows;

  const size_t base = static_cast<size_t>(b) * S;
  for (int x = tid; x < S; x += nthr) {
    s_prices[x] = prices[base + x];
    s_profits[x] = profits[base + x];
    s_p2o[x] = p2o[base + x];
    s_o2p[x] = o2p[base + x];
    keys[x] = 0ull;
  }
  if (tid == 0) {
    c_nits = m[0];
    c_mode = m[1];
    c_done = 0;
    c_since = m[3];
    c_stallk = m[4];
    c_card = 0;
    c_nbid = 0;
    c_delta = 0;
    c_bidrows = 0;
  }
  __syncthreads();
  {
    // matching cardinality at entry (orientation invariant)
    int cnt = 0;
    for (int x = tid; x < S; x += nthr) cnt += s_p2o[x] != kUnassigned;
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0 && cnt) atomicAdd(&c_card, cnt);
  }
  __syncthreads();

  const T eps_v = eps[b];
  const T ninf = Traits<T>::neg_inf();
  const size_t inst = static_cast<size_t>(b) * S * S;
  for (int it = 0; it < rounds; ++it) {
    const bool fwd = c_mode != 0;
    const T* A = (fwd ? vals : vals_t) + inst;
    T* rowp = fwd ? s_prices : s_profits;
    T* colpi = fwd ? s_profits : s_prices;
    int32_t* colp2o = fwd ? s_p2o : s_o2p;
    int32_t* rowo2p = fwd ? s_o2p : s_p2o;

    // A. the bidders: every unassigned entry of the bidding side
    for (int c0 = 0; c0 < S; c0 += nthr) {
      const int c = c0 + tid;
      const bool bid = c < S && colp2o[c] == kUnassigned;
      const unsigned ball = __ballot_sync(kFull, bid);
      int slot = 0;
      if (lane == 0 && ball) slot = atomicAdd(&c_nbid, __popc(ball));
      slot = __shfl_sync(kFull, slot, 0);
      if (bid) s_bidders[slot + __popc(ball & ((1u << lane) - 1u))] = c;
    }
    __syncthreads();
    const int nbid = c_nbid;

    // B. bids: one warp per bidder
    for (int k = warp; k < nbid; k += nwarps) {
      const int c = s_bidders[k];
      T best, second;
      int arg;
      bool has_second;
      top2(A + static_cast<size_t>(c) * S, rowp, S, sh, lane, best, arg,
           second, has_second);
      if (lane == 0) {
        if (best != ninf) {
          const T floor = has_second ? second : best;
          const T inc = best - floor + eps_v;
          s_bestj[c] = arg;
          s_floor[c] = floor;
          atomicMax(&keys[arg], bid_key(inc, c));
        } else {
          s_bestj[c] = -1;
        }
      }
    }
    __syncthreads();

    // C. priced side: apply each item's winning bid
    for (int r = tid; r < S; r += nthr) {
      const unsigned long long key = keys[r];
      if (key) {
        keys[r] = 0ull;
        rowp[r] = rowp[r] + Traits<T>::unorder(static_cast<uint32_t>(key >> 32));
        rowo2p[r] = key_bidder(key);
        s_haswin[r] = 1;
      } else {
        s_haswin[r] = 0;
      }
    }
    __syncthreads();

    // D. bidding side: winners take their item, displaced owners leave
    int d = 0;
    for (int c0 = 0; c0 < S; c0 += nthr) {
      const int c = c0 + tid;
      if (c < S) {
        const int32_t old = colp2o[c];
        if (old == kUnassigned) {
          const int32_t r = s_bestj[c];
          if (r >= 0 && rowo2p[r] == c) {
            colp2o[c] = r;
            colpi[c] = s_floor[c] - eps_v;
            ++d;
          }
        } else if (s_haswin[old]) {
          colp2o[c] = kUnassigned;
          --d;
        }
      }
    }
    d = __reduce_add_sync(kFull, d);
    if (lane == 0 && d) atomicAdd(&c_delta, d);
    __syncthreads();

    // E. control: mode flip, stall preemption with doubling horizon
    if (tid == 0) {
      const int delta = c_delta;
      c_card += delta;
      const bool increased = delta > 0;
      const bool stall_flip = !increased && (c_since + 1 >= c_stallk);
      const bool flip = increased || stall_flip;
      c_mode ^= flip ? 1 : 0;
      c_since = flip ? 0 : c_since + 1;
      c_stallk = increased ? kStallK0
                           : (stall_flip ? static_cast<int32_t>(
                                               static_cast<uint32_t>(c_stallk) * 2u)
                                         : c_stallk);
      c_nits += 1;
      c_bidrows += nbid;
      c_done = c_card == S;
      c_nbid = 0;
      c_delta = 0;
    }
    __syncthreads();
    if (c_done) break;
  }

  for (int x = tid; x < S; x += nthr) {
    prices[base + x] = s_prices[x];
    profits[base + x] = s_profits[x];
    p2o[base + x] = s_p2o[x];
    o2p[base + x] = s_o2p[x];
  }
  if (tid == 0) {
    m[0] = c_nits;
    m[1] = c_mode;
    m[2] = c_done;
    m[3] = c_since;
    m[4] = c_stallk;
    if (bid_rows) bid_rows[b] += c_bidrows;
  }
}

template <typename T>
int launch(const void* vals, const void* vals_t, void* prices, void* profits,
           void* p2o, void* o2p, const void* eps, void* meta, void* bid_rows,
           int B, int S, int rounds, cudaStream_t stream) {
  int sh = 0;
  while ((1 << sh) < S) ++sh;  // bit length of S - 1
  int threads = ((S + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(S) *
                      (sizeof(unsigned long long) + 3 * sizeof(T) +
                       4 * sizeof(int32_t) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fr_rounds_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fr_rounds_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(vals_t),
      static_cast<T*>(prices), static_cast<T*>(profits),
      static_cast<int32_t*>(p2o), static_cast<int32_t*>(o2p),
      static_cast<const T*>(eps), static_cast<int32_t*>(meta),
      static_cast<long long*>(bid_rows), S, sh, rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_int: 0 for float32 values, 1 for the int32 lattice.  Pointers are
// device pointers of contiguous tensors; bid_rows may be null.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int slap_fr_rounds(int is_int, const void* vals,
                              const void* vals_t, void* prices, void* profits,
                              void* p2o, void* o2p, const void* eps,
                              void* meta, void* bid_rows, int B, int S,
                              int rounds, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch<int32_t>(vals, vals_t, prices, profits, p2o, o2p, eps, meta,
                           bid_rows, B, S, rounds, st);
  return launch<float>(vals, vals_t, prices, profits, p2o, o2p, eps, meta,
                       bid_rows, B, S, rounds, st);
}

extern "C" const char* slap_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

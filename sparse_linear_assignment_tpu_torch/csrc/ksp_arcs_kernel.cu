// Forward-only Khosla auction rounds for a batch of k-sparse instances,
// read from their arc rows.
//
// Replaces no TPU kernel: the JAX package's Pallas kernel
// (ops/pallas_ksparse.py:_ksp_kernel) and the port's csrc/ksp_kernel.cu both
// run on a densified plane, which keeps one value per object in every
// person's row.  Where the objects far outnumber one person's arcs (the
// reference crate's asymmetric bench: 2,000 persons, 60,000 objects, 32 arcs
// a person) the plane is about 600 times the bytes of the arcs, and the plane
// kernel's per-object state no longer fits a block's shared memory.  This
// kernel reads each person's arcs instead.  Semantics are those of
// ops/auction.py:khosla_round on the densified plane (ops/ksparse_kernel.py:
// ksp_chunk_reference), run for up to `rounds` rounds per instance, each
// instance leaving the loop as soon as it has no active person.  See
// ops/ksparse_arcs.py for the wrapper, the plain PyTorch version and the note
// on what bounds this kernel.
//
// Layout: one CTA per instance (grid = B), kThreads threads, at most
// 65536 / (kThreads * kBlocksPerSm) registers a thread.  The arcs
// `cols/vals [B, N, K]` (column -1 pads) are read-only.  The per-object state
// lives in device memory: prices [B, M] of the value type and one 64-bit key
// per object
// `keys [B, M]`, zero on entry (the wrapper clears it); both are read and
// written at L2 (ld/st.cg and atomics), so that a CTA always sees its own
// writes and atomics.  The per-person state is in device memory too: p2o and
// dropped are the outputs, updated in place, and two active lists and this
// round's target by list slot are in `scratch [B, 3 N]`, so any N runs.
//
// Entry: the keys of the owners that p2o names are set to rest at them
// (~owner; 0 for a free object), and the unassigned, undropped persons form
// the first list.  None: leave.
// A round (two block barriers):
//   B. one warp per listed person, kPersonsInFlight persons a warp at once:
//      each lane loads one arc slot of each (a row of 32 arcs is one
//      coalesced 128-byte load of columns and one of values), drops a slot
//      whose column a later slot of the row repeats (the plane keeps the
//      later slot's value), gathers the column's price, and takes the top-2
//      of value - price with the smallest column on ties, carrying the value
//      at the best column; the warp merges them (csrc/fr_common.cuh).  Lane
//      u then drops person u (price at best, reconstructed as best_val -
//      best, above the threshold) or posts its bid with one 64-bit
//      atomicMax on the object's key (bid order bits << 32 | ~person: the
//      largest bid wins, the smallest person on ties).  The one bid that
//      finds the key at rest displaces the object's owner, which joins the
//      next list;
//                                                         -- barrier
//   C. only the round's entries: a bidder that its object's key names takes
//      the object, whose price becomes the winning bid and whose key rests
//      at the new owner; a bidder that lost joins the next list; a dropped
//      one leaves;
//                                                         -- barrier
//   and the next list's count ends the loop when it is 0.  With a round log
//   (`trace`, null by default; a kernel instance of its own) thread 0 writes
//   the round's row before that test, as csrc/ksp_kernel.cu does.
// A list's order changes no result: bids meet through a commutative max and
// the top-2 is taken over columns, not slots.  Every bid of a round is
// computed from the prices of the round's start: prices change only in C.
// Float arithmetic is subtracts and adds only, so nothing can contract into
// an fma and the result is bit-identical to the plain version.  Build
// without --use_fast_math.
//
// Two value types.  float32 posts a bid as one packed 64-bit key, as above.
// float64 (where float32 cannot resolve eps in a profit: ops/ksparse_arcs.py)
// has no room for the bidder beside a 64-bit bid: the key holds the bid's
// order bits alone, and a third pass between B and C (a barrier more) lets
// each bidder that matches its object's largest bid post its index with
// atomicMin into `winner [B, M]`, which the one bid that found the key at
// rest reset in B.  C reads the winner there; every bid's key is kept by
// list slot to read back its price.
//
// The eps-scaling ladder (ksp_arcs_ladder_kernel, the sparse entry points'
// scale_eps).  At one small eps a square instance is a price war: the
// reference crate's config A (10,000 persons, about 101 arcs each, values in
// [500, 1000), eps = 2^-15 / 10,001) would trade its objects about
// (value span) / eps times.  The ladder runs the same rounds (B, the winner
// pass, C: run_rounds, the one round body of both kernels) at a coarse eps
// first and shrinks it eightfold a phase, prices kept, each instance's
// phases back to back in its CTA: no phase waits for the batch's slowest
// instance, and a batch is one launch.  Between phases the CTA reduces the
// instance's largest price into the next drop threshold and resets the
// matching.  Its rows are distinct (the staging clears repeated columns), so
// its rounds leave the repeat test out (run_rounds' kDistinct), which at 176
// slots a row would cost ten 32-lane scans a person a round; they keep no
// round log.  It is a kernel of its own, so that the ladder's phase loop adds
// no code to the rounds kernel's launches.
//
// The ladder's few-bidder rounds bid in one burst (B', kDistinct only).  Most
// of a config A instance's rounds list a few persons (at most 8 in about nine
// rounds of ten): B would put them in one or two warps, which walk each row a
// 32-slot chunk at a time, a row load and then the price gathers that depend
// on it, six times in turn at 176 slots, each a trip to device memory or L2.
// A round whose list holds at most kBurstPersons persons (one a warp) over
// rows of at most 32 * kBurstChunks slots (burst_round) gives warp w list
// slot w instead: each lane issues the column and value loads of all its
// slots of the row, then all their price gathers, before it folds any, so
// the round waits for one row load and one gather, not six of each.  A lane
// folds its slots in B's order and the warp merge and the post are B's
// (post_bid), so the result is bit-equal.  Every other round takes B.  The
// ladder counts, by thread 0, the rounds that took the burst (`bursts`).
//
// The lone chain (the ladder's one-bidder rounds).  Once a ladder phase
// lists one person it never lists more: the lone bidder either drops, or
// has no arc and stays listed, or bids, wins its object (no other bid
// meets it) and displaces at most the object's owner, the next round's one
// listed person.  So each phase ends in a chain of such rounds, more than
// half of a config A instance's rounds.  Where rows fit the burst
// (lone_round), run_rounds returns as soon as a round leaves one person
// listed, and warp 0 runs the chain (lone_chain) while the other warps wait
// at one barrier: a round loads the row as B' does, gathers each slot's
// price and the owner word of its object's resting key (~owner, 0 for a
// free object) beside it, folds and merges as B' does, and lane 0 applies
// post_bid's and C's arithmetic with no atomic and no barrier: the drop
// test, or the object's price (C's Arith<T>::price of the bid's key), its
// key resting at the bidder, the bidder's p2o and the owner's.  The owner's
// row load is issued before those stores.  The ladder counts these rounds
// (`lones`) in nits, its rounds by phase and its bursts as before.  A
// kernel instance without the chain (kLone false, the rounds as they were
// before it) is kept for measurements only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

// 256 threads and 4 CTAs an SM: 64 registers a thread
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
// persons a warp works on at once: their row loads, then their price
// gathers, are in flight together
constexpr int kPersonsInFlight = 4;
// the ladder's burst (run_rounds' kDistinct rounds): a round whose list
// holds at most kBurstPersons persons, one a warp, over rows of at most
// 32 * kBurstChunks slots bids from each person's whole row at once.  The
// wrapper's plain version reads both numbers from this source
// (ops/ksparse_arcs.py: burst_rule).  Seven chunks are the
// most that leave the float64 ladder's spills as they were without the
// burst (72 bytes; eight spill 84).
constexpr int kBurstPersons = 8;
constexpr int kBurstChunks = 7;
static_assert(kBurstPersons == kThreads / 32, "one listed person a warp");

// whether a ladder round of `nact` listed persons over rows of K slots
// bids in one burst
__device__ __forceinline__ bool burst_round(int nact, int K) {
  return nact <= kBurstPersons && K <= 32 * kBurstChunks;
}

// whether a ladder round of `nact` listed persons over rows of K slots
// belongs to the lone chain
__device__ __forceinline__ bool lone_round(int nact, int K) {
  return nact == 1 && K <= 32 * kBurstChunks;
}

// phase counters, as csrc/ksp_kernel.cu counts them (ops/ksparse_kernel.py:
// PHASES); `prices` stays 0, float64's winner pass is part of `apply`
constexpr int kProfActive = 0;
constexpr int kProfBids = 1;
constexpr int kProfApply = 2;
constexpr int kProfBarrier = 4;
constexpr int kProfTotal = 5;
constexpr int kProfRounds = 6;
constexpr int kProfWords = 7;

// this round's target of a list slot besides an object: dropped
constexpr int32_t kDropped = -2;
constexpr int32_t kNoArc = -1;

// the resting key of an object owned by `owner` (below every bid's key in
// both value types)
__device__ __forceinline__ unsigned long long rest_key(int32_t owner) {
  return static_cast<unsigned long long>(~static_cast<uint32_t>(owner));
}

// the value types' pieces: -inf, max, and the bid's key
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float neg_inf() {
    return Traits<float>::neg_inf();
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float min(float a, float b) {
    return fminf(a, b);
  }
  // order bits above the inverted bidder: one atomicMax picks the winner
  static __device__ __forceinline__ unsigned long long key(float bid,
                                                           int bidder) {
    return bid_key(bid, bidder);
  }
  static __device__ __forceinline__ bool at_rest(unsigned long long k) {
    return (k >> 32) == 0ull;
  }
  static __device__ __forceinline__ float price(unsigned long long k) {
    return Traits<float>::unorder(static_cast<uint32_t>(k >> 32));
  }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double neg_inf() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double min(double a, double b) {
    return fmin(a, b);
  }
  // the order-preserving image of the bid alone (a bid is positive, so its
  // key has the top bit set and lies above every resting key)
  static __device__ __forceinline__ unsigned long long key(double bid, int) {
    const unsigned long long u =
        static_cast<unsigned long long>(__double_as_longlong(bid));
    return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
  }
  static __device__ __forceinline__ bool at_rest(unsigned long long k) {
    return (k >> 63) == 0ull;
  }
  static __device__ __forceinline__ double price(unsigned long long k) {
    const unsigned long long u =
        (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k;
    return __longlong_as_double(static_cast<long long>(u));
  }
};

// A lane's running top-2 over arcs in any order: the smallest column among
// equal profits is the best (the plane's smallest-index rule), an equal
// profit lands in second.  `raw` is the arc's value, kept for the best.
template <typename T>
__device__ __forceinline__ void top2_take_col(T v, T raw, int col, T& b,
                                              T& s, int& j, T& bv) {
  if (v > b || (v == b && col < j)) {
    s = Arith<T>::max(s, b);
    b = v;
    j = col;
    bv = raw;
  } else {
    s = Arith<T>::max(s, v);
  }
}

// csrc/fr_common.cuh's top2_warp_merge_raw in either value type: ties go to
// the smaller column, the other tied value lands in second.
template <typename T>
__device__ __forceinline__ void top2_merge(T& b, T& s, int& j, T& bv) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T b2 = __shfl_xor_sync(kFull, b, off);
    const int j2 = __shfl_xor_sync(kFull, j, off);
    const T s2 = __shfl_xor_sync(kFull, s, off);
    const T bv2 = __shfl_xor_sync(kFull, bv, off);
    const bool take1 = (b > b2) || (b == b2 && j <= j2);
    s = Arith<T>::max(Arith<T>::min(b, b2), Arith<T>::max(s, s2));
    b = take1 ? b : b2;
    j = take1 ? j : j2;
    bv = take1 ? bv : bv2;
  }
}

// One CTA's instance: its arcs, its per-object and per-person state, and
// its scratch (float64 keeps each list slot's bid key in front, then the
// targets and the two lists).
template <typename T>
struct Instance {
  const int32_t* cols;         // [N, K]
  const T* vals;               // [N, K]
  T* prices;                   // [M]
  unsigned long long* keys;    // [M]
  int32_t* winner;             // [M], float64 only
  int32_t* p2o;                // [N]
  unsigned char* drop;         // [N]
  unsigned long long* bidkey;  // [N], float64 only
  int32_t* tgt;                // [N]
  int32_t* lists;              // [2 N]
};

template <typename T>
__device__ __forceinline__ Instance<T> instance_at(
    int b, const int32_t* cols, const T* vals, T* prices,
    unsigned long long* keys, int32_t* winner, int32_t* p2o,
    unsigned char* dropped, int32_t* scratch, int N, int M, int K) {
  constexpr bool kPacked = sizeof(T) == 4;
  const size_t pbase = static_cast<size_t>(b) * N;
  const size_t obase = static_cast<size_t>(b) * M;
  Instance<T> in;
  in.cols = cols + pbase * K;
  in.vals = vals + pbase * K;
  in.prices = prices + obase;
  in.keys = keys + obase;
  in.winner = kPacked ? nullptr : winner + obase;
  in.p2o = p2o + pbase;
  in.drop = dropped + pbase;
  int32_t* base = scratch + static_cast<size_t>(b) * (kPacked ? 3 : 6) * N;
  in.bidkey = nullptr;
  if (!kPacked) {
    in.bidkey = reinterpret_cast<unsigned long long*>(base);
    base += 2 * N;
  }
  in.tgt = base;
  in.lists = base + N;
  return in;
}

// The owners' resting keys and the first list (into cnt[0], which the
// caller zeroed before a barrier); every thread runs the same iterations,
// so warp_append sees whole warps.  Returns the list's count.
template <typename T, typename Lap>
__device__ __forceinline__ int first_list(const Instance<T>& in, int* cnt,
                                          int N, Lap&& lap) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < N; i0 += kThreads) {
    const int i = i0 + tid;
    const int32_t own = i < N ? in.p2o[i] : kUnassigned;
    if (own != kUnassigned) __stcg(in.keys + own, rest_key(i));
    warp_append(i < N && own == kUnassigned && !in.drop[i], i, tid & 31,
                in.lists, &cnt[0]);
  }
  lap(kProfActive);
  __syncthreads();
  lap(kProfBarrier);
  return cnt[0];
}

// A lane's slots of `person`'s row in a burst of C chunks, slot 32 c + lane
// in chunk c (column -1 and value 0 past K), every load issued before any
// is used.
template <typename T, int C>
__device__ __forceinline__ void burst_row(const int32_t* cols, const T* vals,
                                          int person, int K, int lane,
                                          int (&col)[C], T (&val)[C]) {
  const size_t row = static_cast<size_t>(person) * K;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int s = c * 32 + lane;
    col[c] = -1;
    val[c] = T(0);
    if (s < K) {
      col[c] = __ldg(cols + row + s);
      val[c] = __ldg(vals + row + s);
    }
  }
}

// A burst row's top-2 over the warp: each lane folds its slots in slot
// order, then the warp merges.
template <typename T, int C>
__device__ __forceinline__ void burst_top2(const int (&col)[C],
                                           const T (&val)[C],
                                           const T (&price)[C], T& best,
                                           T& second, int& arg,
                                           T& best_val) {
  best = second = Arith<T>::neg_inf();
  best_val = T(0);
  arg = kUnassigned;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (col[c] >= 0)
      top2_take_col(val[c] - price[c], val[c], col[c], best, second, arg,
                    best_val);
  }
  top2_merge(best, second, arg, best_val);
}

// One lane's post of listed person `mi` (list slot `mk`) from its merged
// top-2 (best `mb` at column `ma`, whose value is `mv`; second `ms`): the
// drop test, or the bid's atomicMax on its object, the one bid that finds
// the key at rest displacing the owner into the next list; then the
// slot's target.
template <typename T>
__device__ __forceinline__ void post_bid(const Instance<T>& in, T thr, T eps,
                                         int mi, int mk, T mb, T ms, int ma,
                                         T mv, int32_t* next,
                                         int* next_cnt) {
  constexpr bool kPacked = sizeof(T) == 4;
  int32_t t = kNoArc;
  if (ma != kUnassigned) {
    const T price_at_best = mv - mb;
    if (price_at_best > thr) {
      in.drop[mi] = 1;
      t = kDropped;
    } else {
      const T bid =
          (ms != Arith<T>::neg_inf() ? mv - ms : price_at_best) + eps;
      const unsigned long long key = Arith<T>::key(bid, mi);
      t = ma;
      const unsigned long long was = atomicMax(in.keys + ma, key);
      if (Arith<T>::at_rest(was)) {
        // the round's first bid on the object: the owner leaves;
        // float64 clears the winner slot for this round
        if (was != 0ull) {
          const int32_t owner = key_bidder(was);
          in.p2o[owner] = kUnassigned;
          next[atomicAdd(next_cnt, 1)] = owner;
        }
        if (!kPacked) __stcg(in.winner + ma, kUnassigned);
      }
      if (!kPacked) in.bidkey[mk] = key;
    }
  }
  in.tgt[mk] = t;
}

// The rounds of both kernels (B, float64's winner pass, C) at one eps and
// one drop threshold: up to `rounds` rounds from the list `cur` of `nact`
// persons.  Returns the rounds run and leaves `nact` and `cur` at the next
// list (nact 0: no person is active).  kDistinct: every row lists a column
// once, and the repeat test is left out; a round that burst_round admits
// then bids in one burst (B'), the ladder's few-bidder rounds, which the
// rounds kernel's code never holds.  kLone (the ladder's): return as soon
// as a round leaves the lone chain's one person listed (lone_round).
// `lap(slot)` closes a profiling interval, `start(nact)` sees a round
// begin and `end(ran, nact)` end; the ladder passes empty ones, which
// compile away.
template <typename T, bool kDistinct, bool kLone, typename Lap,
          typename Start, typename End>
__device__ __forceinline__ int run_rounds(const Instance<T>& in, int* cnt,
                                          T thr, T eps, int N, int K,
                                          int rounds, int& nact, int& cur,
                                          Lap&& lap, Start&& start,
                                          End&& end) {
  constexpr bool kPacked = sizeof(T) == 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  constexpr int P = kPersonsInFlight;
  const T ninf = Arith<T>::neg_inf();
  int ran = 0;
  while (ran < rounds) {
    const int32_t* list = in.lists + cur * N;
    int32_t* next = in.lists + (cur ^ 1) * N;
    int* next_cnt = &cnt[cur ^ 1];
    start(nact);

    // B. bids
    if (kDistinct && burst_round(nact, K)) {
      // B'. a few-bidder round: warp w takes list slot w, and each lane
      // issues its kBurstChunks slots' column and value loads, then their
      // price gathers, before it folds any into its top-2 (in slot order)
      if (warp < nact) {
        const int person = list[warp];
        int col[kBurstChunks];
        T val[kBurstChunks];
        burst_row(in.cols, in.vals, person, K, lane, col, val);
        T price[kBurstChunks];
#pragma unroll
        for (int c = 0; c < kBurstChunks; ++c)
          price[c] = col[c] >= 0 ? __ldcg(in.prices + col[c]) : T(0);
        T best, second, best_val;
        int arg;
        burst_top2(col, val, price, best, second, arg, best_val);
        if (lane == 0)
          post_bid(in, thr, eps, person, warp, best, second, arg, best_val,
                   next, next_cnt);
      }
    } else {
      // P listed persons a warp at once
      for (int k0 = warp * P; k0 < nact; k0 += nwarps * P) {
        int person[P];
        T best[P], second[P], best_val[P];
        int arg[P];
#pragma unroll
        for (int u = 0; u < P; ++u) {
          person[u] = k0 + u < nact ? list[k0 + u] : -1;
          best[u] = second[u] = ninf;
          best_val[u] = T(0);
          arg[u] = kUnassigned;
        }
        for (int s0 = 0; s0 < K; s0 += 32) {
          const int s = s0 + lane;
          int col[P];
          T val[P];
#pragma unroll
          for (int u = 0; u < P; ++u) {
            col[u] = -1;
            val[u] = T(0);
            if (person[u] >= 0 && s < K) {
              const size_t at = static_cast<size_t>(person[u]) * K + s;
              col[u] = __ldg(in.cols + at);
              val[u] = __ldg(in.vals + at);
            }
          }
          T price[P];
#pragma unroll
          for (int u = 0; u < P; ++u) {
            price[u] = T(0);
            if (person[u] < 0) continue;  // uniform over the warp
            if constexpr (!kDistinct) {
              // a slot whose column a later slot of the row repeats is no
              // arc: the plane keeps the later slot's value
              const unsigned above = ~((2u << lane) - 1u);  // later lanes
              const unsigned same = __match_any_sync(
                  kFull, col[u] >= 0 ? col[u] : -1 - lane);
              bool later = col[u] >= 0 && (same & above) != 0u;
              for (int s1 = s0 + 32; s1 < K; s1 += 32) {
                const int c1 =
                    s1 + lane < K
                        ? __ldg(in.cols + static_cast<size_t>(person[u]) * K +
                                s1 + lane)
                        : -1;
                for (int q = 0; q < 32; ++q) {
                  const int other = __shfl_sync(kFull, c1, q);  // every lane
                  later |= col[u] >= 0 && other == col[u];
                }
              }
              if (later) col[u] = -1;
            }
            if (col[u] >= 0) price[u] = __ldcg(in.prices + col[u]);
          }
#pragma unroll
          for (int u = 0; u < P; ++u) {
            if (person[u] >= 0 && col[u] >= 0)
              top2_take_col(val[u] - price[u], val[u], col[u], best[u],
                            second[u], arg[u], best_val[u]);
          }
        }
        // the warp's merge of each person, then lane u posts person u's bid
        T mb = ninf, ms = ninf, mv = T(0);
        int ma = kUnassigned, mi = -1, mk = 0;
#pragma unroll
        for (int u = 0; u < P; ++u) {
          if (person[u] < 0) continue;  // uniform over the warp
          top2_merge(best[u], second[u], arg[u], best_val[u]);
          if (lane == u) {
            mb = best[u];
            ms = second[u];
            ma = arg[u];
            mv = best_val[u];
            mi = person[u];
            mk = k0 + u;
          }
        }
        if (lane < P && mi >= 0)
          post_bid(in, thr, eps, mi, mk, mb, ms, ma, mv, next, next_cnt);
      }
    }
    lap(kProfBids);
    __syncthreads();
    lap(kProfBarrier);

    if constexpr (!kPacked) {
      // float64: each bidder that matches its object's largest bid posts
      // its index; the smallest stays
      for (int x = tid; x < nact; x += kThreads) {
        const int32_t t = in.tgt[x];
        if (t >= 0 && __ldcg(in.keys + t) == in.bidkey[x])
          atomicMin(in.winner + t, list[x]);
      }
      lap(kProfApply);
      __syncthreads();
      lap(kProfBarrier);
    }

    // C. only the round's entries: winners take their objects, losers (and
    // a person with no arc) stay listed, dropped persons leave.  This
    // round's count is reset for the round after next (every thread read it
    // before the barrier).
    if (tid == 0) cnt[cur] = 0;
    for (int x0 = 0; x0 < nact; x0 += kThreads) {
      const int x = x0 + tid;
      int32_t stay = -1;
      if (x < nact) {
        const int32_t i = list[x];
        const int32_t t = in.tgt[x];
        if (t >= 0) {
          unsigned long long key;
          bool won;
          if constexpr (kPacked) {
            key = __ldcg(in.keys + t);
            won = key_bidder(key) == i;
          } else {
            key = in.bidkey[x];
            won = __ldcg(in.winner + t) == i;
          }
          if (won) {
            in.p2o[i] = t;
            __stcg(in.prices + t, Arith<T>::price(key));
            __stcg(in.keys + t, rest_key(i));
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
    end(ran, nact);
    if (nact == 0) break;  // no person is active; uniform over the CTA
    if constexpr (kLone) {
      if (lone_round(nact, K)) break;  // the chain's; uniform too
    }
  }
  return ran;
}

// The lone chain from `person`, the one listed person of a ladder round
// over rows that fit the burst (lone_round), run by one warp for up to
// `rounds` rounds at one eps and one drop threshold (see the note at the
// top), over rows of at most 32 C slots.  Lane 0 leaves the rounds run in
// out[0] and the persons then listed (0 or 1) in out[1].  Inlined: a call
// would save the ladder's live registers around it, and the float64
// ladder would spill more than without the chain.
template <typename T, int C>
__device__ __forceinline__ void lone_chain(const int32_t* cols, const T* vals,
                                        T* prices, unsigned long long* keys,
                                        int32_t* p2o, unsigned char* drop,
                                        T thr, T eps, int K, int person,
                                        int rounds, int* out) {
  const int lane = threadIdx.x & 31;
  // the low words of the objects' keys: a resting key's owner word
  const uint32_t* owner_word = reinterpret_cast<const uint32_t*>(keys);
  int col[C];
  T val[C];
  burst_row(cols, vals, person, K, lane, col, val);
  int ran = 0, listed = 1;
  while (true) {
    T price[C];
    uint32_t word[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      price[c] = T(0);
      word[c] = 0u;
      if (col[c] >= 0) {
        price[c] = __ldcg(prices + col[c]);
        word[c] = __ldcg(owner_word + 2 * static_cast<size_t>(col[c]));
      }
    }
    T best, second, best_val;
    int arg;
    burst_top2(col, val, price, best, second, arg, best_val);
    ++ran;
    if (arg == kUnassigned) {  // no arc: listed to the end of the budget
      ran = rounds;
      break;
    }
    const T price_at_best = best_val - best;
    if (price_at_best > thr) {
      if (lane == 0) drop[person] = 1;
      listed = 0;
      break;
    }
    const T bid =
        (second != Arith<T>::neg_inf() ? best_val - second : price_at_best) +
        eps;
    // the best object's owner word, from the one lane whose slot holds it
    uint32_t w = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col[c] == arg) w = word[c];
    w = __reduce_or_sync(kFull, w);
    const int32_t next = w != 0u ? key_bidder(w) : -1;
    const bool more = next >= 0 && ran < rounds;
    if (more) burst_row(cols, vals, next, K, lane, col, val);
    if (lane == 0) {
      __stcg(prices + arg, Arith<T>::price(Arith<T>::key(bid, person)));
      __stcg(keys + arg, rest_key(person));
      p2o[person] = arg;
      if (next >= 0) p2o[next] = kUnassigned;
    }
    if (!more) {
      listed = next >= 0;
      break;
    }
    person = next;
    __syncwarp();  // lane 0's stores before the next round's gathers
  }
  if (lane == 0) {
    out[0] = ran;
    out[1] = listed;
  }
}

// kTrace: the round log is written (`trace` not null).  The production
// instances (false) carry no trace code.
template <typename T, bool kTrace>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ksp_arcs_rounds_kernel(const int32_t* __restrict__ cols,
                       const T* __restrict__ vals, T* prices,
                       unsigned long long* keys, int32_t* winner,
                       int32_t* p2o, unsigned char* dropped,
                       int32_t* __restrict__ nits,
                       const T* __restrict__ thresholds, int32_t* scratch,
                       long long* __restrict__ act_rows, long long* prof,
                       long long* stamps, int32_t* trace, T eps, int N,
                       int M, int K, int rounds) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  long long t_start = 0;
  if (stamps && tid == 0)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));

  __shared__ int cnt[2];                 // the two lists' counts
  __shared__ long long acc[kProfWords];  // thread 0's counters
  const Instance<T> in = instance_at(b, cols, vals, prices, keys, winner,
                                     p2o, dropped, scratch, N, M, K);

  const bool timing = prof != nullptr && tid == 0;
  if (tid < kProfWords) acc[tid] = 0;
  long long mark = 0;
  auto lap = [&](int slot) {
    if (timing) {
      const long long now = clock64();
      acc[slot] += now - mark;
      mark = now;
    }
  };
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();
  long long t_first = 0;
  if (timing) t_first = mark = clock64();
  int nact = first_list(in, cnt, N, lap);

  int ran = 0;
  long long rows_read = 0;
  if (nact > 0) {
    int cur = 0;
    ran = run_rounds<T, false, false>(
        in, cnt, thresholds[b], eps, N, K, rounds, nact, cur, lap,
        [&](int active) { rows_read += active; },
        [&](int done, int active) {
          if constexpr (kTrace) {
            if (tid == 0) {
              int32_t* row =
                  trace + (static_cast<size_t>(b) * rounds + done - 1) * 3;
              row[0] = nits[b] + done;
              row[1] = active > 0;
              row[2] = active == 0;
            }
          }
        });
    if (timing) {
      acc[kProfTotal] = clock64() - t_first;
      acc[kProfRounds] = ran;
    }
    if (tid == 0) {
      nits[b] += ran;
      if (act_rows) act_rows[b] += rows_read;
    }
  }
  // an instance that enters done leaves its state as it is
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

template <typename T>
int launch(const void* cols, const void* vals, void* prices, void* keys,
           void* winner, void* p2o, void* dropped, void* nits,
           const void* thresholds, void* scratch, void* act_rows, void* prof,
           void* stamps, void* trace, T eps, int B, int N, int M, int K,
           int rounds, cudaStream_t stream) {
  auto kernel = trace ? ksp_arcs_rounds_kernel<T, true>
                      : ksp_arcs_rounds_kernel<T, false>;
  kernel<<<B, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<T*>(prices), static_cast<unsigned long long*>(keys),
      static_cast<int32_t*>(winner), static_cast<int32_t*>(p2o),
      static_cast<unsigned char*>(dropped), static_cast<int32_t*>(nits),
      static_cast<const T*>(thresholds), static_cast<int32_t*>(scratch),
      static_cast<long long*>(act_rows), static_cast<long long*>(prof),
      static_cast<long long*>(stamps), static_cast<int32_t*>(trace), eps, N,
      M, K, rounds);
  return static_cast<int>(cudaGetLastError());
}

// The largest price of the instance, on every thread (two barriers).
template <typename T>
__device__ __forceinline__ T block_max_price(const T* prices, int M,
                                             T* red) {
  const int tid = threadIdx.x;
  T top = Arith<T>::neg_inf();
  for (int j = tid; j < M; j += kThreads)
    top = Arith<T>::max(top, __ldcg(prices + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = Arith<T>::max(top, __shfl_xor_sync(kFull, top, off));
  if ((tid & 31) == 0) red[tid >> 5] = top;
  __syncthreads();
  top = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) top = Arith<T>::max(top, red[w]);
  __syncthreads();  // red is free again
  return top;
}

// An eps-scaling ladder of every instance in its CTA, its phases back to
// back (ops/compact.py:khosla_solve_scaled's rules): a phase runs the rounds
// of ksp_arcs_rounds_kernel at eps = max(step, target) until no person is
// active; then, unless its step was at or below the target (the last phase),
// the step shrinks eightfold, the drop threshold becomes
// half_m * (span + eps) + max(0, the largest price) in float64, rounded
// once to T, the matching and the drops are reset and every person is
// listed; prices stay.  The state between launches is p2o, dropped, prices,
// nits and the ladder's `steps`, `thresholds` and `phase` (updated in
// place); `phase_rounds [B, P]` gains each phase's rounds, `bursts [B]`
// the rounds that bid in one burst (burst_round) and, with kLone, `lones
// [B]` the rounds of the lone chain (lone_round; untouched without it).  A
// launch ends an instance's rounds after `rounds` of them (a phase that
// ends in the last one still hands over to the next), so a later launch
// continues, in a chain too.  The columns of a row are distinct (the
// staging clears a repeated column's earlier slots), so the rounds leave
// the repeat test out.
template <typename T, bool kLone>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ksp_arcs_ladder_kernel(const int32_t* __restrict__ cols,
                       const T* __restrict__ vals, T* prices,
                       unsigned long long* keys, int32_t* winner,
                       int32_t* p2o, unsigned char* dropped,
                       int32_t* __restrict__ nits, T* thresholds,
                       int32_t* scratch, const double* __restrict__ spans,
                       double* steps, int32_t* phase,
                       int32_t* __restrict__ phase_rounds,
                       int32_t* __restrict__ bursts,
                       int32_t* __restrict__ lones, int P, double target,
                       double half_m, int N, int M, int K, int rounds) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  __shared__ int cnt[2];
  __shared__ T red[kThreads / 32];
  __shared__ int chain[2];  // lone_chain's rounds run and persons listed
  const Instance<T> in = instance_at(b, cols, vals, prices, keys, winner,
                                     p2o, dropped, scratch, N, M, K);
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();
  int nact = first_list(in, cnt, N, [](int) {});
  double step = steps[b];
  T thr = thresholds[b];
  int ph = phase[b];
  int left = rounds, ran = 0, cur = 0, burst = 0, lone = 0;
  while (true) {
    if (nact > 0 && left > 0) {
      const T eps = static_cast<T>(step > target ? step : target);
      int r = 0;
      if (!(kLone && lone_round(nact, K)))
        r = run_rounds<T, true, kLone>(
            in, cnt, thr, eps, N, K, left, nact, cur, [](int) {},
            [&](int active) { burst += burst_round(active, K); },
            [](int, int) {});
      if constexpr (kLone) {
        if (lone_round(nact, K) && r < left) {
          // rows of at most six chunks (config A's) keep one chunk's
          // registers free
          if (tid < 32 && K <= 32 * (kBurstChunks - 1))
            lone_chain<T, kBurstChunks - 1>(
                in.cols, in.vals, in.prices, in.keys, in.p2o, in.drop, thr,
                eps, K, in.lists[cur * N], left - r, chain);
          else if (tid < 32)
            lone_chain<T, kBurstChunks>(
                in.cols, in.vals, in.prices, in.keys, in.p2o, in.drop, thr,
                eps, K, in.lists[cur * N], left - r, chain);
          __syncthreads();
          r += chain[0];
          lone += chain[0];
          burst += chain[0];  // a lone round fits the burst
          nact = chain[1];
        }
      }
      if (tid == 0 && ph < P)
        phase_rounds[static_cast<size_t>(b) * P + ph] += r;
      ran += r;
      left -= r;
    }
    // out of rounds inside a phase, or the last phase done: uniform
    if (nact > 0 || !(step > target)) break;
    step *= 0.125;
    ++ph;
    const T top = block_max_price(in.prices, M, red);
    const double pad = top > T(0) ? static_cast<double>(top) : 0.0;
    const double eps_next = step > target ? step : target;
    thr = static_cast<T>(
        __dadd_rn(__dmul_rn(half_m, __dadd_rn(spans[b], eps_next)), pad));
    int32_t* list = in.lists + cur * N;
    for (int i = tid; i < N; i += kThreads) {
      in.p2o[i] = kUnassigned;
      in.drop[i] = 0;
      list[i] = i;
    }
    for (int j = tid; j < M; j += kThreads) __stcg(in.keys + j, 0ull);
    nact = N;
    __syncthreads();
  }
  if (tid == 0) {
    nits[b] += ran;
    bursts[b] += burst;
    if constexpr (kLone) lones[b] += lone;
    steps[b] = step;
    thresholds[b] = thr;
    phase[b] = ph;
  }
}

template <typename T>
int launch_ladder(const void* cols, const void* vals, void* prices,
                  void* keys, void* winner, void* p2o, void* dropped,
                  void* nits, void* thresholds, void* scratch,
                  const void* spans, void* steps, void* phase,
                  void* phase_rounds, void* bursts, void* lones, int P,
                  double target, double half_m, int B, int N, int M, int K,
                  int rounds, bool chain, cudaStream_t stream) {
  auto kernel = chain ? ksp_arcs_ladder_kernel<T, true>
                      : ksp_arcs_ladder_kernel<T, false>;
  kernel<<<B, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<T*>(prices), static_cast<unsigned long long*>(keys),
      static_cast<int32_t*>(winner), static_cast<int32_t*>(p2o),
      static_cast<unsigned char*>(dropped), static_cast<int32_t*>(nits),
      static_cast<T*>(thresholds), static_cast<int32_t*>(scratch),
      static_cast<const double*>(spans), static_cast<double*>(steps),
      static_cast<int32_t*>(phase), static_cast<int32_t*>(phase_rounds),
      static_cast<int32_t*>(bursts), static_cast<int32_t*>(lones), P, target,
      half_m, N, M, K, rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pointers are device pointers of contiguous tensors: cols [B, N, K] int32
// (-1 pads); vals [B, N, K], prices [B, M] and thresholds [B] of the value
// type (`value_bytes` 4: float32, 8: float64); keys [B, M] (64-bit, all
// zero); winner [B, M] int32 for float64 (any contents), null for float32;
// p2o [B, N] int32, dropped [B, N] bytes (0 or 1), nits [B] int32;
// scratch [B, 3 N] int32 (float64: [B, 6 N]; any contents).  act_rows [B],
// prof [kProfWords] and stamps [B, 2] (int64) and the round log trace
// [B, rounds, 3] (int32; rows of rounds not run are left as they are) may be
// null.  p2o must be a matching (no object owned twice).
// prices, keys, p2o, dropped and nits are updated in place.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int slap_ksp_arcs_rounds(const void* cols, const void* vals,
                                    void* prices, void* keys, void* winner,
                                    void* p2o, void* dropped, void* nits,
                                    const void* thresholds, void* scratch,
                                    void* act_rows, void* prof, void* stamps,
                                    void* trace, double eps, int value_bytes,
                                    int B, int N, int M, int K, int rounds,
                                    void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || M <= 0 || K <= 0 || scratch == nullptr ||
      (value_bytes == 8) != (winner != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4)
    return launch<float>(cols, vals, prices, keys, winner, p2o, dropped, nits,
                         thresholds, scratch, act_rows, prof, stamps, trace,
                         static_cast<float>(eps), B, N, M, K, rounds, s);
  if (value_bytes == 8)
    return launch<double>(cols, vals, prices, keys, winner, p2o, dropped,
                          nits, thresholds, scratch, act_rows, prof, stamps,
                          trace, eps, B, N, M, K, rounds, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ladder (ksp_arcs_ladder_kernel): the arguments of slap_ksp_arcs_rounds
// without the counters, the log and eps, with thresholds [B] updated in
// place, and spans [B] (float64, each instance's value span), steps [B]
// (float64, the current phase's step), phase [B] int32, phase_rounds
// [B, P] int32, bursts [B] int32 (the rounds that bid in one burst) and
// lones [B] int32 (the rounds of the lone chain), the last five updated in
// place; target is the last phase's eps and half_m half the objects the
// drop threshold counts.  chain 0 launches the instance without the lone
// chain, for measurements (lones untouched).  The columns of a row must be
// distinct.
extern "C" int slap_ksp_arcs_ladder(const void* cols, const void* vals,
                                    void* prices, void* keys, void* winner,
                                    void* p2o, void* dropped, void* nits,
                                    void* thresholds, void* scratch,
                                    const void* spans, void* steps,
                                    void* phase, void* phase_rounds,
                                    void* bursts, void* lones, int P,
                                    double target, double half_m,
                                    int value_bytes, int B, int N, int M,
                                    int K, int rounds, int chain,
                                    void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || M <= 0 || K <= 0 || P <= 0 || scratch == nullptr ||
      bursts == nullptr || lones == nullptr ||
      (value_bytes == 8) != (winner != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4)
    return launch_ladder<float>(cols, vals, prices, keys, winner, p2o,
                                dropped, nits, thresholds, scratch, spans,
                                steps, phase, phase_rounds, bursts, lones, P,
                                target, half_m, B, N, M, K, rounds,
                                chain != 0, s);
  if (value_bytes == 8)
    return launch_ladder<double>(cols, vals, prices, keys, winner, p2o,
                                 dropped, nits, thresholds, scratch, spans,
                                 steps, phase, phase_rounds, bursts, lones, P,
                                 target, half_m, B, N, M, K, rounds,
                                 chain != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* slap_ksp_arcs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward-reverse auction rounds for a batch of dense square instances.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_fr.py:_fr_kernel
// (_fr_one_block, _generic_sub and the fused top-2 helpers).  Semantics are
// those of ops/fr_dense.py:fr_round with skip_certificate=True, run for up
// to `rounds` rounds per instance with an early exit once the instance is
// done (full matching).  See ops/fr_kernel.py for the Python wrapper, the
// plain PyTorch version and the note on what bounds this kernel.
//
// Layout: one CTA per instance (grid = B), one thread per two indices (at
// most 128: four warps) and at most 40 registers a thread, so that 12
// instances of 256² are resident on an SM.  The instance's whole state
// (prices, profits, p2o, o2p, two sets of per-priced-item conflict keys,
// per-bidder item and floor, and the unassigned entries of each side as
// lists) lives in shared memory for the whole round loop; values stay in
// device memory and are read each round, only for the rows of the current
// bidders.  Both layouts are passed (`vals` person-major, `vals_t`
// object-major) so that a bidder's row is contiguous in either mode:
// forward mode (persons bid) reads rows of `vals`, reverse mode (free
// objects bid) rows of `vals_t`.
// The mode selects the dual roles:
//   forward: priced side = objects (rowp = prices, rowo2p = o2p),
//            bidders = persons (colpi = profits, colp2o = p2o)
//   reverse: priced side = persons (rowp = profits, rowo2p = p2o),
//            bidders = objects (colpi = prices, colp2o = o2p)
//
// A round (two block barriers):
//   B. one bidder a warp, its row in 16-byte loads, all of them in flight
//      at once (two a lane at 256²): top-2 of (row - rowp) with the smallest
//      index on ties, then one 64-bit atomicMax per bid into the priced
//      item's conflict key of this round (increment order bits << 32 |
//      ~bidder): the largest increment wins, the smallest bidder on ties;
//                                                         -- barrier
//   C. only the round's entries, not all S: each bidder whose item's key
//      names it takes the item (rowp += inc, owner = bidder, colpi = floor
//      - eps) and the item's old owner leaves; a bidder that lost stays
//      one; a priced-side entry that was unassigned stays so unless it took
//      a bid.  That writes both of the next round's lists (the unassigned
//      of each side, so that either mode can follow) and counts the
//      cardinality change; the keys of the last round are cleared;
//                                                         -- barrier
//   control, computed by every thread from the same shared words: mode flip
//   on a cardinality rise or a stall, doubling stall horizon, nits, done =
//   (cardinality == S), and which list holds the next round's bidders;
//   with a round log (`trace`, null by default; kernel instances of their
//   own), thread 0 writes the round's row: nits, mode, cardinality, done
//   (ops/round_log.py).
// The order of a list does not change any result: bids meet through a
// commutative max, so the lists are built with one atomic a warp.
// The keys and the control words alternate between two sets by round, so
// no third barrier is needed to clear them.  Float arithmetic is adds and
// subtracts only, in the JAX association order, so the result is
// bit-identical to the plain version.  Build without --use_fast_math
// (denormal flushing would change values).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

// meta row of an instance: nits, forward_mode, done, since_inc, stall_k
constexpr int kMeta = 5;

// the largest block; 12 blocks of it fit an SM's registers at 40 a thread
// (at 256², 128 threads and 12 blocks an SM ran 5-10% faster than 256
// threads and 8 blocks; 16 blocks at 32 registers spill)
constexpr int kMaxThreads = 128;
constexpr int kBlocksPerSm = 12;
// indices a thread handles in the entry pass (the block has S / this
// threads); the apply pass touches only the round's entries
constexpr int kIndicesPerThread = 2;
// bidders a warp walks at once, and 16-byte loads a lane keeps in flight
// for each (the whole row at 256²)
constexpr int kBidders = 1;
constexpr int kLoadsPerRow = 2;

// control words of one set: cardinality change (at entry: the assigned
// count), next round's bidders if the mode stays, if it flips
constexpr int kCtlDelta = 0;
constexpr int kCtlStay = 1;
constexpr int kCtlFlip = 2;
constexpr int kCtlWords = 4;

// phase counters (clock64 cycles of each CTA's thread 0, summed over rounds
// and CTAs)
constexpr int kProfBids = 0;
constexpr int kProfApply = 1;
constexpr int kProfCtrl = 2;
constexpr int kProfBarrier = 3;
constexpr int kProfTotal = 4;
constexpr int kProfRounds = 5;
constexpr int kProfWords = 6;

// Per-lane running top-2 of a bidder's row, merged across the warp.
// float: best, second (max over every other position), argbest with the
// smallest index among equal maxima (a lane sees ascending positions).
struct TopF {
  float b, s;
  int j;
  __device__ __forceinline__ void init() {
    b = s = Traits<float>::neg_inf();
    j = kUnassigned;
  }
  __device__ __forceinline__ void take(float v, int r, int) {
    top2_take(v, r, b, s, j);
  }
  __device__ __forceinline__ void merge() { top2_warp_merge(b, s, j); }
  __device__ __forceinline__ void result(int, float& best, int& arg,
                                         float& second, bool& has) const {
    best = b;
    arg = j;
    second = s;
    has = s != Traits<float>::neg_inf();
  }
};

// int32 lattice: packed keys (profit << sh) | (mask - r), unique per
// position, so a plain max gives the value and its smallest index at once
// (ops/pallas_fr.py:286-296).  The key range guard of _integer_scale keeps
// the shift inside int32.  Shifts go through uint32_t: a left shift of a
// negative int is undefined in C++17; >> on int32_t is arithmetic.
struct TopI {
  int32_t bk, sk;
  __device__ __forceinline__ void init() { bk = sk = INT32_MIN; }
  __device__ __forceinline__ void take(int32_t v, int r, int sh) {
    const int32_t mask = (1 << sh) - 1;
    const int32_t key = static_cast<int32_t>(
        (static_cast<uint32_t>(v) << sh) | static_cast<uint32_t>(mask - r));
    if (key > bk) {
      sk = bk;
      bk = key;
    } else {
      sk = max(sk, key);
    }
  }
  __device__ __forceinline__ void merge() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t b2 = __shfl_xor_sync(kFull, bk, off);
      const int32_t s2 = __shfl_xor_sync(kFull, sk, off);
      sk = max(min(bk, b2), max(sk, s2));
      bk = max(bk, b2);
    }
  }
  __device__ __forceinline__ void result(int sh, int32_t& best, int& arg,
                                         int32_t& second, bool& has) const {
    const int32_t mask = (1 << sh) - 1;
    best = bk >> sh;
    arg = mask - (bk & mask);
    has = sk != INT32_MIN;
    second = sk >> sh;
  }
};

template <typename T> struct Top;
template <> struct Top<float> { using type = TopF; };
template <> struct Top<int32_t> { using type = TopI; };

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

// kTrace: the round log is written (`trace` not null).  The production
// instances (false) carry no trace code.
template <typename T, bool kTrace>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
fr_rounds_kernel(const T* __restrict__ vals, const T* __restrict__ vals_t,
                 T* __restrict__ prices, T* __restrict__ profits,
                 int32_t* __restrict__ p2o, int32_t* __restrict__ o2p,
                 const T* __restrict__ eps, int32_t* __restrict__ meta,
                 long long* __restrict__ bid_rows, long long* prof,
                 long long* stamps, int32_t* trace, int S, int sh,
                 int rounds) {
  using V4 = typename Vec4<T>::type;
  using TT = typename Top<T>::type;
  constexpr int R = kBidders, U = kLoadsPerRow;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  int32_t* m = meta + static_cast<size_t>(b) * kMeta;
  long long t_start = 0;
  if (stamps && tid == 0)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));
  // every thread reads the same entry state: the exit is uniform
  int nits = m[0], mode = m[1], since = m[3], stallk = m[4];
  if (m[2] != 0 || rounds <= 0) {  // done instances are frozen
    if (stamps && tid == 0) {
      stamps[2 * b] = t_start;
      stamps[2 * b + 1] = t_start;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* keys = smem;                      // [2][S]
  T* s_prices = reinterpret_cast<T*>(keys + 2 * S);     // [S]
  T* s_profits = s_prices + S;                          // [S]
  T* s_floor = s_profits + S;                           // [S] by bidder slot
  int32_t* s_p2o = reinterpret_cast<int32_t*>(s_floor + S);  // [S]
  int32_t* s_o2p = s_p2o + S;                           // [S]
  int32_t* tgt = s_o2p + S;        // [2][S] by round parity, bidder slot
  int32_t* lists = tgt + 2 * S;    // [2][2][S]: by pair, bidders / others
  __shared__ int ctl[2][kCtlWords];
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

  const size_t base = static_cast<size_t>(b) * S;
  for (int x = tid; x < S; x += nthr) {
    s_prices[x] = prices[base + x];
    s_profits[x] = profits[base + x];
    s_p2o[x] = p2o[base + x];
    s_o2p[x] = o2p[base + x];
    keys[x] = 0ull;
    keys[S + x] = 0ull;
  }
  if (tid < 2 * kCtlWords) ctl[tid / kCtlWords][tid % kCtlWords] = 0;
  __syncthreads();
  {
    // the entry's lists (the unassigned of each side) and its cardinality
    const int32_t* colp2o = mode ? s_p2o : s_o2p;
    const int32_t* rowo2p = mode ? s_o2p : s_p2o;
    int cnt = 0;
    for (int x0 = 0; x0 < S; x0 += nthr) {
      const int x = x0 + tid;
      const bool in = x < S;
      cnt += in && s_p2o[x] != kUnassigned;
      warp_append(in && colp2o[x] == kUnassigned, x, lane, lists,
                  &ctl[0][kCtlStay]);
      warp_append(in && rowo2p[x] == kUnassigned, x, lane, lists + S,
                  &ctl[0][kCtlFlip]);
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0 && cnt) atomicAdd(&ctl[0][kCtlDelta], cnt);
  }
  __syncthreads();

  const T eps_v = eps[b];
  const T ninf = Traits<T>::neg_inf();
  const size_t inst = static_cast<size_t>(b) * S * S;
  const int s4 = S >> 2;
  int card = ctl[0][kCtlDelta];
  int nbid = ctl[0][kCtlStay];   // this round's bidders
  int nrow = ctl[0][kCtlFlip];   // the priced side's unassigned
  const int32_t* blist = lists;
  const int32_t* rlist = lists + S;
  int pair = 0;                  // the list pair read this round
  int nprev = 0;                 // last round's bidders (keys to clear)
  int done = 0;
  long long rows_read = 0;
  for (int it = 0; it < rounds; ++it) {
    long long round_start = 0;
    if (timing) round_start = mark = clock64();
    const int cur = it & 1;
    unsigned long long* kcur = keys + cur * S;
    unsigned long long* kprev = keys + (cur ^ 1) * S;
    int32_t* tcur = tgt + cur * S;
    const int32_t* tprev = tgt + (cur ^ 1) * S;
    const bool fwd = mode != 0;
    const T* A = (fwd ? vals : vals_t) + inst;
    T* rowp = fwd ? s_prices : s_profits;
    T* colpi = fwd ? s_profits : s_prices;
    int32_t* colp2o = fwd ? s_p2o : s_o2p;
    int32_t* rowo2p = fwd ? s_o2p : s_p2o;
    const V4* rp4 = reinterpret_cast<const V4*>(rowp);
    rows_read += nbid;

    // B. bids: R bidders a warp step, every load of the step in flight;
    // a bidder's item and floor go to its slot of the list
    for (int g = warp * R; g < nbid; g += nwarps * R) {
      int c[R];
      TT t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        c[r] = g + r < nbid ? blist[g + r] : -1;
        t[r].init();
      }
      for (int v0 = 0; v0 < s4; v0 += 32 * U) {
        V4 x[R][U];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const V4* row = reinterpret_cast<const V4*>(
              A + static_cast<size_t>(c[r] < 0 ? 0 : c[r]) * S);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int v = v0 + u * 32 + lane;
            if (c[r] >= 0 && v < s4) x[r][u] = __ldg(row + v);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int v = v0 + u * 32 + lane;
            if (c[r] >= 0 && v < s4) {
              const V4 p = rp4[v];
              const int pos = 4 * v;
              t[r].take(x[r][u].x - p.x, pos, sh);
              t[r].take(x[r][u].y - p.y, pos + 1, sh);
              t[r].take(x[r][u].z - p.z, pos + 2, sh);
              t[r].take(x[r][u].w - p.w, pos + 3, sh);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (c[r] < 0) continue;  // warp-uniform
        t[r].merge();
        if (lane == 0) {
          T best, second;
          int arg;
          bool has_second;
          t[r].result(sh, best, arg, second, has_second);
          if (best != ninf) {
            const T floor = has_second ? second : best;
            const T inc = best - floor + eps_v;
            tcur[g + r] = arg;
            s_floor[g + r] = floor;
            atomicMax(&kcur[arg], bid_key(inc, c[r]));
          } else {
            tcur[g + r] = -1;
          }
        }
      }
    }
    lap(kProfBids);
    __syncthreads();
    lap(kProfBarrier);

    // C. only the round's entries: each bidder wins its item (the item
    // takes the bid, its old owner leaves) or stays a bidder; the priced
    // side's unassigned that took no bid stay so.  Both next lists are
    // written to the other pair; last round's keys are cleared.
    int* cn = ctl[cur ^ 1];  // this round's words, read after the barrier
    if (tid < kCtlWords) ctl[cur][tid] = 0;  // every thread has read them
    int32_t* out_col = lists + (pair ^ 1) * 2 * S;
    int32_t* out_row = out_col + S;
    for (int i = tid; i < nprev; i += nthr) {
      const int32_t r = tprev[i];
      if (r >= 0) kprev[r] = 0ull;
    }
    int d = 0;
    const int total = nbid + nrow;
    for (int x0 = 0; x0 < total; x0 += nthr) {
      const int x = x0 + tid;
      int32_t col_e = -1, row_e = -1;
      if (x < nbid) {
        const int32_t c = blist[x];
        const int32_t r = tcur[x];
        const unsigned long long key = r >= 0 ? kcur[r] : 0ull;
        if (key != 0ull && key_bidder(key) == c) {
          const int32_t old = rowo2p[r];
          rowp[r] = rowp[r] +
                    Traits<T>::unorder(static_cast<uint32_t>(key >> 32));
          rowo2p[r] = c;
          colp2o[c] = r;
          colpi[c] = s_floor[x] - eps_v;
          if (old != kUnassigned) {
            colp2o[old] = kUnassigned;  // displaced: bids next round
            col_e = old;
          } else {
            ++d;
          }
        } else {
          col_e = c;
        }
      } else if (x < total) {
        const int32_t r = rlist[x - nbid];
        if (kcur[r] == 0ull) row_e = r;
      }
      warp_append(col_e >= 0, col_e, lane, out_col, &cn[kCtlStay]);
      warp_append(row_e >= 0, row_e, lane, out_row, &cn[kCtlFlip]);
    }
    d = __reduce_add_sync(kFull, d);
    if (lane == 0 && d) atomicAdd(&cn[kCtlDelta], d);
    lap(kProfApply);
    __syncthreads();
    lap(kProfBarrier);

    // control: the same words in every thread, the same decision
    const int delta = cn[kCtlDelta];
    card += delta;
    const bool increased = delta > 0;
    const bool stall_flip = !increased && (since + 1 >= stallk);
    const bool flip = increased || stall_flip;
    mode ^= flip ? 1 : 0;
    since = flip ? 0 : since + 1;
    stallk = increased ? kStallK0
                       : (stall_flip ? static_cast<int32_t>(
                                           static_cast<uint32_t>(stallk) * 2u)
                                     : stallk);
    nits += 1;
    nprev = nbid;
    nbid = flip ? cn[kCtlFlip] : cn[kCtlStay];
    nrow = flip ? cn[kCtlStay] : cn[kCtlFlip];
    blist = flip ? out_row : out_col;
    rlist = flip ? out_col : out_row;
    pair ^= 1;
    done = card == S;
    if constexpr (kTrace) {
      if (tid == 0) {
        int32_t* row = trace + (static_cast<size_t>(b) * rounds + it) * 4;
        row[0] = nits;
        row[1] = mode;
        row[2] = card;
        row[3] = done;
      }
    }
    lap(kProfCtrl);
    if (timing) {
      acc[kProfTotal] += clock64() - round_start;
      acc[kProfRounds] += 1;
    }
    if (done) break;
  }

  for (int x = tid; x < S; x += nthr) {
    prices[base + x] = s_prices[x];
    profits[base + x] = s_profits[x];
    p2o[base + x] = s_p2o[x];
    o2p[base + x] = s_o2p[x];
  }
  if (tid == 0) {
    m[0] = nits;
    m[1] = mode;
    m[2] = done;
    m[3] = since;
    m[4] = stallk;
    if (bid_rows) bid_rows[b] += rows_read;
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

template <typename T>
int launch(const void* vals, const void* vals_t, void* prices, void* profits,
           void* p2o, void* o2p, const void* eps, void* meta, void* bid_rows,
           void* prof, void* stamps, void* trace, int B, int S, int rounds,
           cudaStream_t stream) {
  int sh = 0;
  while ((1 << sh) < S) ++sh;  // bit length of S - 1
  // S / kIndicesPerThread threads, a warp multiple, within [64,
  // kMaxThreads]
  int threads = ((S / kIndicesPerThread + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  // keys 2 x 8; prices, profits, floor; p2o, o2p, 2 targets, 4 lists
  const size_t smem = static_cast<size_t>(S) *
                      (2 * sizeof(unsigned long long) + 3 * sizeof(T) +
                       8 * sizeof(int32_t));
  auto kernel = trace ? fr_rounds_kernel<T, true> : fr_rounds_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(vals_t),
      static_cast<T*>(prices), static_cast<T*>(profits),
      static_cast<int32_t*>(p2o), static_cast<int32_t*>(o2p),
      static_cast<const T*>(eps), static_cast<int32_t*>(meta),
      static_cast<long long*>(bid_rows), static_cast<long long*>(prof),
      static_cast<long long*>(stamps), static_cast<int32_t*>(trace), S, sh,
      rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_int: 0 for float32 values, 1 for the int32 lattice; S a multiple of 4
// and both layouts 16-byte aligned (rows are read in 16-byte loads).
// Pointers are device pointers of contiguous tensors; bid_rows [B], prof
// [kProfWords] and stamps [B, 2] (int64) and the round log trace
// [B, rounds, 4] (int32; rows of rounds not run are left as they are) may be
// null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int slap_fr_rounds(int is_int, const void* vals,
                              const void* vals_t, void* prices, void* profits,
                              void* p2o, void* o2p, const void* eps,
                              void* meta, void* bid_rows, void* prof,
                              void* stamps, void* trace, int B, int S,
                              int rounds, void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || S % 4 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals_t) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch<int32_t>(vals, vals_t, prices, profits, p2o, o2p, eps, meta,
                           bid_rows, prof, stamps, trace, B, S, rounds, st);
  return launch<float>(vals, vals_t, prices, profits, p2o, o2p, eps, meta,
                       bid_rows, prof, stamps, trace, B, S, rounds, st);
}

extern "C" const char* slap_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

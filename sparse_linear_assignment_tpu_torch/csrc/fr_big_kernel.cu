// Forward-reverse auction rounds for ONE large dense square instance, on
// one thread-block cluster.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_fr_big.py:_fr_big_kernel (driven by fr_big_chunk).  Semantics
// are those of ops/fr_dense.py:fr_round with skip_certificate=True, run for
// up to `rounds` rounds with an early exit once the matching is full.  See
// ops/fr_big.py for the Python wrapper, the planner that sizes the launch,
// and the plain PyTorch version.
//
// What bounds it.  After a few wide opening rounds a round has a handful
// of bidders (about 8 on average at 4096²), so the bytes are tiny (all
// bidder rows of a 4096² solve take 0.21 ms at 3.35 TB/s) and the kernel
// is bound by latency: rounds x (barriers + one dependent row load).  The
// previous design, a cooperative launch over every SM with three grid
// barriers a round, one warp walking each 16 KB bidder row in 128
// dependent steps and the state in global memory, took 17.3 us a round.
//
// The design against that latency:
//   - one cluster of C CTAs (16, Hopper's non-portable maximum) holds the
//     whole solve; its hardware barrier (barrier.cluster) replaces the grid
//     barrier, four a round;
//   - the state lives in the cluster's distributed shared memory: CTA k
//     owns the indices [k w, (k+1) w), w = S / C, on both sides (prices,
//     profits, p2o, o2p, conflict keys, per-bidder argbest and floor, the
//     merge keys and the bidder lists of its slice), loaded at entry and
//     written back at exit; a remote entry is reached through
//     cluster.map_shared_rank;
//   - each bidder's row is split across the cluster by the same slices:
//     CTA k reads only its w-wide segment of the row and subtracts its own
//     local prices (or profits), so the inner loop touches no remote word;
//     a warp takes R bidders a step with up to 8 float4 loads a lane in
//     flight at once, so a round costs about one row-load latency;
//   - the partial top-2s merge exactly through fire-and-forget 32-bit
//     atomics on the bidder owner's shared memory: a max of order(best)
//     gives the best; then each CTA whose own best equals it adds 1 to a
//     count, its argbest to a min and its own second to a max, and every
//     other CTA adds its best to that max.  The second is the best itself
//     when two CTAs hold it, that max otherwise (max and min are exact and
//     order-free, so this equals _top2_rows_f32's merge bit for bit);
//   - the rest of a round is one pass over each CTA's own slice in shared
//     memory (w / 512 entries a thread) with one remote key read for each
//     index: no global-memory state at all.
//
// A round (four cluster barriers; mode roles as in fr_kernel.cu, forward:
// priced side = objects, bidders = persons; reverse: the mirror):
//   1. every CTA: for each bidder of the round (the lists of all CTAs,
//      concatenated), the top-2 of its own segment of the bidder's row;
//      atomicMax of order(best) on the bidder owner's kbest;
//                                                   -- cluster barrier 1
//   2. every CTA: its share of the count, argbest min and second max;
//                                                   -- cluster barrier 2
//   3. owner of each bidder: best, argbest, second, floor, increment; the
//      max of bid_key(inc, bidder) on the conflict key of the priced item,
//      at the item's owner (64 bits: a CAS loop);   -- cluster barrier 3
//   4. every CTA over its slice: apply each won item (price, owner); a
//      bidder that holds its item's key wins it (profit = floor - eps), an
//      owner whose item took a bid leaves; list the next round's bidders
//      for both possible modes and add up the cardinality change;
//                                                   -- cluster barrier 4
//   5. control, computed by every thread from the same words of all CTAs
//      read after barrier 4, so the whole cluster takes the same mode and
//      exit decision; with a round log (`trace`, null by default) rank 0's
//      thread 0 writes the round's row (nits, mode, cardinality, done), in
//      kernel instances of their own (kTrace).
// When a round has more bidders than one pass of partials holds
// (pass_rows, sized by the planner), steps 1-2 repeat per pass, with two
// more barriers each.
//
// Float arithmetic is adds and subtracts only, in the JAX association
// order, so the result is bit-identical to the plain version.  Build
// without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// float4 loads a lane keeps in flight in the row walk
constexpr int kLoadsInFlight = 8;
// a round with more bidders than this counts as a wide (opening) round
constexpr int kWide = 1024;

// per-CTA control words, read by every CTA after barrier 4
constexpr int kCtlDelta = 0;  // cardinality change (at entry: assigned)
constexpr int kCtlStay = 1;   // bidders of the next round if the mode stays
constexpr int kCtlFlip = 2;   // bidders of the next round if it flips
constexpr int kCtlWords = 4;

// phase counters (clock64 cycles of the leader thread, summed over rounds)
constexpr int kProfRows = 0;       // step 1: row segments and partials
constexpr int kProfMerge = 1;      // steps 2-3: merge and bid
constexpr int kProfApply = 2;      // step 4: apply and lists
constexpr int kProfCtrl = 3;       // step 5: control words, key reset
constexpr int kProfBarrier = 4;    // waiting in barriers
constexpr int kProfTotal = 5;      // whole rounds
constexpr int kProfWideRounds = 6; // rounds with more than kWide bidders
constexpr int kProfWideCycles = 7; // their cycles
constexpr int kProfBarriers = 8;   // cluster barriers passed
constexpr int kProfWords = 9;

struct Args {
  const float* vals;    // [S, S] person-major values
  const float* vals_t;  // [S, S] object-major values
  float* prices;        // [S]
  float* profits;       // [S]
  int32_t* p2o;         // [S]
  int32_t* o2p;         // [S]
  const float* eps;     // [1]
  int32_t* meta;        // nits, forward_mode, done, since_inc, stall_k
  long long* bid_rows;  // [1] or null
  long long* prof;      // [kProfWords] or null
  int32_t* trace;       // [rounds, 4] round log (ops/round_log.py) or null
  int S;
  int w;          // slice width, S / cluster size
  int pass_rows;  // bidders whose partials one pass holds
  int rounds;
};

// One bidder's top-2 over one CTA's segment of its row.
struct Partial {
  float best;
  float second;
  int32_t arg;
  int32_t bidder;
};

// 64-bit atomic max on a word of another CTA's shared memory.  On the
// H100 a 64-bit max on distributed shared memory (atomicMax through
// map_shared_rank, or atom/red.shared::cluster.max.u64) is not atomic
// across the cluster; a 64-bit compare-and-swap is, so the max is a CAS
// loop (32-bit max, min and add are atomic).  The first guess is 0: every
// key is above 0, so an untouched slot takes one CAS.
__device__ __forceinline__ void cluster_max64(unsigned long long* word,
                                              unsigned long long v) {
  unsigned long long old = 0ull;
  while (old < v) {
    const unsigned long long prev = atomicCAS(word, old, v);
    if (prev == old) break;
    old = prev;
  }
}

// Shared-memory layout of one CTA (dynamic; the planner's smem bytes):
// keys u64[w]; the merge words kbest, karg, kcnt, k2 u32[w]; prices,
// profits, p2o, o2p, bestj, floorv 4 B [w] each; the two bidder lists
// i32[2][w] (56 w bytes); then Partial[pass_rows].
// R: bidders a warp walks per step.  kTrace: the round log is written
// (a.trace not null).  The production instances (false) carry no trace code:
// with a null test in the round loop instead, a 4096² solve ran 1.7% slower
// than without the log (0.12 us a round, tools/kernel_ab.py).
template <int R, bool kTrace>
__global__ void __launch_bounds__(kThreads, 1) fr_big_cluster_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = a.S, w = a.w, w4 = a.w / 4;
  const int base = rank * w;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int P = a.pass_rows;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* kbest = reinterpret_cast<uint32_t*>(keys + w);  // max order
  uint32_t* karg = kbest + w;   // min argbest over CTAs holding the best
  uint32_t* kcnt = karg + w;    // CTAs holding the best
  uint32_t* k2 = kcnt + w;      // max order of the second candidates
  float* prices_s = reinterpret_cast<float*>(k2 + w);
  float* profits_s = prices_s + w;
  int32_t* p2o_s = reinterpret_cast<int32_t*>(profits_s + w);
  int32_t* o2p_s = p2o_s + w;
  int32_t* bestj = o2p_s + w;
  float* floorv = reinterpret_cast<float*>(bestj + w);
  int32_t* lists = reinterpret_cast<int32_t*>(floorv + w);  // [2][w]
  Partial* part = reinterpret_cast<Partial*>(lists + 2 * w);
  __shared__ int ctl[kCtlWords];
  __shared__ int pref[2][kMaxCluster + 1];  // list offsets: stay, flip
  __shared__ int sh_delta;

  // every thread reads the same entry state: the exit is uniform
  int nits = a.meta[0], mode = a.meta[1], since = a.meta[3];
  int stallk = a.meta[4];
  if (a.meta[2] != 0 || a.rounds <= 0) return;

  const bool timing = a.prof != nullptr && rank == 0 && tid == 0;
  long long acc[kProfWords];
#pragma unroll
  for (int k = 0; k < kProfWords; ++k) acc[k] = 0;
  long long mark = 0;
  // charge the cycles since the last mark to `slot` (leader thread only)
  auto lap = [&](int slot) {
    if (timing) {
      const long long now = clock64();
      acc[slot] += now - mark;
      mark = now;
    }
  };
  auto csync = [&]() {
    cluster.sync();
    lap(kProfBarrier);
    if (timing) ++acc[kProfBarriers];
  };

  // entry: the slice's state, zero keys, the current mode's bidders
  // ("stay" list) and the slice's share of the cardinality
  for (int i = tid; i < w; i += kThreads) {
    prices_s[i] = a.prices[base + i];
    profits_s[i] = a.profits[base + i];
    p2o_s[i] = a.p2o[base + i];
    o2p_s[i] = a.o2p[base + i];
    keys[i] = 0ull;
    kbest[i] = 0u;
    karg[i] = ~0u;
    kcnt[i] = 0u;
    k2[i] = 0u;
  }
  if (tid < kCtlWords) ctl[tid] = 0;
  __syncthreads();
  {
    const int32_t* colp2o = mode ? p2o_s : o2p_s;
    const int32_t* rowo2p = mode ? o2p_s : p2o_s;
    int cnt = 0;
    for (int i0 = wid * 32; i0 < w; i0 += kThreads) {
      const int i = i0 + lane;
      const bool in = i < w;
      cnt += in && p2o_s[i] != kUnassigned;
      warp_append(in && colp2o[i] == kUnassigned, base + i, lane, lists,
                  &ctl[kCtlStay]);
      warp_append(in && rowo2p[i] == kUnassigned, base + i, lane, lists + w,
                  &ctl[kCtlFlip]);
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0 && cnt) atomicAdd(&ctl[kCtlDelta], cnt);
  }
  cluster.sync();  // every CTA has started and published its words

  // warp 0 gathers the control words of all CTAs: the summed delta and
  // the offsets of each CTA's part of the two concatenated lists
  auto gather = [&]() {
    if (wid == 0) {
      int d = 0, ns = 0, nf = 0;
      if (lane < C) {
        const int* rc = cluster.map_shared_rank(ctl, lane);
        d = rc[kCtlDelta];
        ns = rc[kCtlStay];
        nf = rc[kCtlFlip];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t1 = __shfl_up_sync(kFull, ns, off);
        const int t2 = __shfl_up_sync(kFull, nf, off);
        if (lane >= off) {
          ns += t1;
          nf += t2;
        }
      }
      d = __reduce_add_sync(kFull, d);
      if (lane < C) {
        pref[0][lane + 1] = ns;
        pref[1][lane + 1] = nf;
      }
      if (lane == 0) {
        pref[0][0] = 0;
        pref[1][0] = 0;
        sh_delta = d;
      }
    }
  };
  gather();
  __syncthreads();

  int card = sh_delta;
  int done = 0;
  int kind = 0;  // which list holds this round's bidders: 0 stay, 1 flip
  long long rows_read = 0;
  const float eps_v = *a.eps;
  const float ninf = Traits<float>::neg_inf();
  for (int it = 0; it < a.rounds; ++it) {
    long long round_start = 0;
    if (timing) round_start = mark = clock64();
    const bool fwd = mode != 0;
    const float* A = fwd ? a.vals : a.vals_t;
    float* rowp = fwd ? prices_s : profits_s;
    float* colpi = fwd ? profits_s : prices_s;
    int32_t* colp2o = fwd ? p2o_s : o2p_s;
    int32_t* rowo2p = fwd ? o2p_s : p2o_s;
    const int* pf = pref[kind];
    int32_t* blist = lists + kind * w;
    const int nbid = pf[C];
    rows_read += nbid;
    const float4* rp4 = reinterpret_cast<const float4*>(rowp);

    for (int g0 = 0; g0 < nbid; g0 += P) {
      const int gn = min(nbid - g0, P);
      // 1. this CTA's segment of each bidder's row, R bidders a warp step
      for (int g = wid * R; g < gn; g += kWarps * R) {
        // lane r fetches bidder g + r from the list of its owner CTA q,
        // the number of CTAs whose part of the list ends at or before it
        int mine = -1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int gg = g0 + g + r;
          const unsigned before =
              __ballot_sync(kFull, lane < C && pf[lane + 1] <= gg);
          if (lane == r && g + r < gn) {
            const int q = __popc(before);
            mine = cluster.map_shared_rank(blist, q)[gg - pf[q]];
          }
        }
        int c[R];
        float b[R], s[R];
        int j[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          c[r] = __shfl_sync(kFull, mine, r);
          b[r] = ninf;
          s[r] = ninf;
          j[r] = kUnassigned;
        }
        constexpr int U = kLoadsInFlight / R;  // loads per bidder a chunk
        for (int v0 = 0; v0 < w4; v0 += 32 * U) {
          float4 x[R][U];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4* row = reinterpret_cast<const float4*>(
                A + static_cast<size_t>(c[r] < 0 ? 0 : c[r]) * S + base);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int v = v0 + u * 32 + lane;
              if (c[r] >= 0 && v < w4) x[r][u] = __ldg(row + v);
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int v = v0 + u * 32 + lane;
              if (c[r] >= 0 && v < w4) {
                const float4 p = rp4[v];
                const int pos = base + 4 * v;
                top2_take(x[r][u].x - p.x, pos, b[r], s[r], j[r]);
                top2_take(x[r][u].y - p.y, pos + 1, b[r], s[r], j[r]);
                top2_take(x[r][u].z - p.z, pos + 2, b[r], s[r], j[r]);
                top2_take(x[r][u].w - p.w, pos + 3, b[r], s[r], j[r]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (c[r] < 0) continue;  // warp-uniform
          top2_warp_merge(b[r], s[r], j[r]);
          if (lane == 0) {
            part[g + r] = Partial{b[r], s[r], j[r], c[r]};
            const int q = c[r] / w;
            // one image for both zeros: -0 == +0 in the tie rule
            atomicMax(cluster.map_shared_rank(kbest + (c[r] - q * w), q),
                      Traits<float>::order(b[r] == 0.0f ? 0.0f : b[r]));
          }
        }
      }
      lap(kProfRows);
      csync();
      // 2. a CTA holding the best adds itself to the count, its argbest
      // to the min and its second to the max; any other CTA its best
      for (int g = tid; g < gn; g += kThreads) {
        const Partial pt = part[g];
        const int q = pt.bidder / w;
        const int i = pt.bidder - q * w;
        const float gbest = Traits<float>::unorder(
            *cluster.map_shared_rank(kbest + i, q));
        float x = pt.best;
        if (pt.best == gbest) {
          atomicMin(cluster.map_shared_rank(karg + i, q),
                    static_cast<uint32_t>(pt.arg));
          atomicAdd(cluster.map_shared_rank(kcnt + i, q), 1u);
          x = pt.second;
        }
        atomicMax(cluster.map_shared_rank(k2 + i, q),
                  Traits<float>::order(x));
      }
      lap(kProfMerge);
      __syncthreads();  // the next pass rewrites the partials
      lap(kProfBarrier);
    }
    csync();

    // 3. the owner of each bidder places its bid
    if (tid < kCtlWords) ctl[tid] = 0;  // every CTA has read them
    const int nmine = pf[rank + 1] - pf[rank];
    for (int t = tid; t < nmine; t += kThreads) {
      const int c = blist[t];
      const int i = c - base;
      const float best = Traits<float>::unorder(kbest[i]);
      const int32_t arg = static_cast<int32_t>(karg[i]);
      // two CTAs holding the best: the other one's position is the second
      const float second =
          kcnt[i] >= 2u ? best : Traits<float>::unorder(k2[i]);
      kbest[i] = 0u;
      karg[i] = ~0u;
      kcnt[i] = 0u;
      k2[i] = 0u;
      if (best != ninf) {
        const float floor = second != ninf ? second : best;
        const float inc = best - floor + eps_v;
        bestj[i] = arg;
        floorv[i] = floor;
        const int q = arg / w;
        cluster_max64(cluster.map_shared_rank(keys + (arg - q * w), q),
                      bid_key(inc, c));
      } else {
        bestj[i] = -1;
      }
    }
    lap(kProfMerge);
    csync();

    // 4. apply, over this CTA's slice of both sides
    int d = 0;
    for (int i0 = wid * 32; i0 < w; i0 += kThreads) {
      const int i = i0 + lane;
      bool stay_bid = false, flip_bid = false;
      if (i < w) {
        const unsigned long long key = keys[i];
        if (key) {
          rowp[i] = rowp[i] + Traits<float>::unorder(
                                  static_cast<uint32_t>(key >> 32));
          rowo2p[i] = key_bidder(key);
        }
        flip_bid = rowo2p[i] == kUnassigned;
        const int32_t old = colp2o[i];
        if (old == kUnassigned) {
          const int32_t r = bestj[i];
          bool won = false;
          if (r >= 0) {
            const int q = r / w;
            won = key_bidder(*cluster.map_shared_rank(keys + (r - q * w),
                                                      q)) == base + i;
          }
          if (won) {
            colp2o[i] = r;
            colpi[i] = floorv[i] - eps_v;
            ++d;
          } else {
            stay_bid = true;
          }
        } else {
          const int q = old / w;
          if (*cluster.map_shared_rank(keys + (old - q * w), q) != 0ull) {
            colp2o[i] = kUnassigned;
            --d;
            stay_bid = true;
          }
        }
      }
      warp_append(stay_bid, base + i, lane, lists, &ctl[kCtlStay]);
      warp_append(flip_bid, base + i, lane, lists + w, &ctl[kCtlFlip]);
    }
    d = __reduce_add_sync(kFull, d);
    if (lane == 0 && d) atomicAdd(&ctl[kCtlDelta], d);
    lap(kProfApply);
    csync();

    // 5. control: the same words in every thread, the same decision
    gather();
    for (int i = tid; i < w; i += kThreads) keys[i] = 0ull;
    lap(kProfCtrl);
    __syncthreads();
    lap(kProfBarrier);
    const int delta = sh_delta;
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
    kind = flip ? 1 : 0;
    done = card == S;
    if constexpr (kTrace) {
      if (rank == 0 && tid == 0) {
        int32_t* row = a.trace + static_cast<size_t>(it) * 4;
        row[0] = nits;
        row[1] = mode;
        row[2] = card;
        row[3] = done;
      }
    }
    if (timing) {
      const long long cyc = clock64() - round_start;
      acc[kProfTotal] += cyc;
      if (nbid > kWide) {
        acc[kProfWideRounds] += 1;
        acc[kProfWideCycles] += cyc;
      }
    }
    if (done) break;
  }

  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  for (int i = tid; i < w; i += kThreads) {
    a.prices[base + i] = prices_s[i];
    a.profits[base + i] = profits_s[i];
    a.p2o[base + i] = p2o_s[i];
    a.o2p[base + i] = o2p_s[i];
  }
  if (rank == 0 && tid == 0) {
    a.meta[0] = nits;
    a.meta[1] = mode;
    a.meta[2] = done;
    a.meta[3] = since;
    a.meta[4] = stallk;
    if (a.bid_rows) *a.bid_rows += rows_read;
  }
  if (timing) {
#pragma unroll
    for (int k = 0; k < kProfWords; ++k) a.prof[k] += acc[k];
  }
}

// The cost of the pieces a round is made of: `iters` cluster barriers of
// the kernel's cluster shape, then `iters` dependent loads along `chain`
// (each a miss in L2), timed by the leader thread on the global timer.
// First, whether a 64-bit max from every thread of the cluster into one
// word of CTA 0 is atomic, through atomicMax and through cluster_max64
// (the largest value comes from the first thread, so a max that is not
// atomic keeps a later, smaller one).
__global__ void __launch_bounds__(kThreads, 1)
    fr_big_probe_kernel(const int32_t* chain, int iters, long long* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool leader = rank == 0 && threadIdx.x == 0;
  __shared__ unsigned long long by_max, by_cas;
  if (threadIdx.x == 0) by_max = by_cas = 0ull;
  cluster.sync();
  const unsigned long long top =
      static_cast<unsigned long long>(cluster.num_blocks()) * blockDim.x;
  const unsigned long long mine = top - (rank * blockDim.x + threadIdx.x);
  const unsigned long long v = (mine << 32) | (~mine & 0xffffffffull);
  atomicMax(cluster.map_shared_rank(&by_max, 0), v);
  cluster_max64(cluster.map_shared_rank(&by_cas, 0), v);
  cluster.sync();
  const unsigned long long want = (top << 32) | (~top & 0xffffffffull);
  long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int k = 0; k < iters; ++k) cluster.sync();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (leader) {
    int32_t j = 0;
    long long t2, t3;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t2));
    for (int k = 0; k < iters; ++k) j = __ldcg(chain + j);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t3));
    out[0] = t1 - t0;
    out[1] = t3 - t2;
    out[2] = by_max == want;
    out[3] = by_cas == want;
    out[4] = j;  // keeps the chain live
  }
}

template <typename K>
cudaError_t cluster_config(K kernel, int cluster, int smem, void* stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be placed is refused, never shrunk
  int placeable = 0;
  err = cudaOccupancyMaxActiveClusters(&placeable, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (placeable < 1) return cudaErrorInvalidClusterSize;
  return cudaSuccess;
}

template <int R, bool kTrace>
cudaError_t launch_kernel(const Args& a, int cluster, int smem,
                          void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(fr_big_cluster_kernel<R, kTrace>, cluster,
                                   smem, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fr_big_cluster_kernel<R, kTrace>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_rounds(const Args& a, int cluster, int smem,
                          void* stream) {
  return a.trace ? launch_kernel<R, true>(a, cluster, smem, stream)
                 : launch_kernel<R, false>(a, cluster, smem, stream);
}

}  // namespace

// One cluster launch of up to `rounds` rounds.  Pointers are device
// pointers of contiguous tensors; bid_rows, prof and the round log trace
// [rounds, 4] (int32: nits, mode, cardinality, done after each round run)
// may be null.  The launch shape comes from the planner
// (ops/fr_big.py:plan): `cluster` CTAs of `width` = S / cluster indices
// each, `rows_per_step` bidders a warp step (1, 2, 4 or 8), `pass_rows`
// partials a pass and `smem` bytes of dynamic shared memory.  Returns the
// cudaError_t of the launch (0 on success); a cluster that cannot be placed
// is refused.
extern "C" int slap_fr_big_rounds(const void* vals, const void* vals_t,
                                  void* prices, void* profits, void* p2o,
                                  void* o2p, const void* eps, void* meta,
                                  void* bid_rows, void* prof, void* trace,
                                  int S, int cluster, int width,
                                  int rows_per_step, int pass_rows, int smem,
                                  int rounds, void* stream) {
  if (S <= 0) return 0;
  if (cluster < 2 || cluster > kMaxCluster || width * cluster != S ||
      width % 4 != 0 || pass_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.vals = static_cast<const float*>(vals);
  a.vals_t = static_cast<const float*>(vals_t);
  a.prices = static_cast<float*>(prices);
  a.profits = static_cast<float*>(profits);
  a.p2o = static_cast<int32_t*>(p2o);
  a.o2p = static_cast<int32_t*>(o2p);
  a.eps = static_cast<const float*>(eps);
  a.meta = static_cast<int32_t*>(meta);
  a.bid_rows = static_cast<long long*>(bid_rows);
  a.prof = static_cast<long long*>(prof);
  a.trace = static_cast<int32_t*>(trace);
  a.S = S;
  a.w = width;
  a.pass_rows = pass_rows;
  a.rounds = rounds;
  cudaError_t err;
  switch (rows_per_step) {
    case 1: err = launch_rounds<1>(a, cluster, smem, stream); break;
    case 2: err = launch_rounds<2>(a, cluster, smem, stream); break;
    case 4: err = launch_rounds<4>(a, cluster, smem, stream); break;
    case 8: err = launch_rounds<8>(a, cluster, smem, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The probe kernel on a cluster of `cluster` CTAs: out[0] the nanoseconds
// of `iters` cluster barriers, out[1] of `iters` dependent loads along
// `chain` (int32 next indices), out[2] and out[3] 1 where the 64-bit
// atomicMax and the CAS loop across the cluster gave the true max, out[4]
// the chain's end.
extern "C" int slap_fr_big_probe(const void* chain, int iters, int cluster,
                                 void* out, void* stream) {
  if (cluster < 2 || cluster > kMaxCluster || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(fr_big_probe_kernel, cluster, 0, stream, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fr_big_probe_kernel,
                           static_cast<const int32_t*>(chain), iters,
                           static_cast<long long*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slap_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

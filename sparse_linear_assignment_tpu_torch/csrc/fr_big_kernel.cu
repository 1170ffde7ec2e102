// Forward-reverse auction rounds for ONE large dense square instance,
// spread over the whole card.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_fr_big.py:_fr_big_kernel (driven by fr_big_chunk).  Semantics
// are those of ops/fr_dense.py:fr_round with skip_certificate=True, run for
// up to `rounds` rounds with an early exit once the matching is full.  See
// ops/fr_big.py for the Python wrapper, the plain PyTorch version and the
// note on what bounds this kernel.
//
// Why many CTAs: one instance beyond 1024² does not fit one SM (the
// single-CTA kernel, fr_kernel.cu, keeps 37 bytes per side element in
// shared memory, 303 KB at 8192² against 227 KB), and one CTA would leave
// the other SMs idle.  So this is a persistent cooperative kernel: every
// CTA stays resident for the whole chunk, the round loop runs inside the
// kernel, and cooperative_groups grid barriers stand where fr_kernel.cu
// has __syncthreads().
//
// State (prices, profits, p2o, o2p, per-bidder argbest and floor, per
// priced-item conflict keys and win flags, the bidder lists and the
// counters) lives in global memory; at 8192² it is well under 1 MB and
// stays in L2.  Values stay in device memory in both layouts (`vals`
// person-major, `vals_t` object-major) so that a bidder's row is
// contiguous in either mode; only the current bidders' rows are read.
// Mode roles as in fr_kernel.cu:
//   forward: priced side = objects (rowp = prices, rowo2p = o2p),
//            bidders = persons (colpi = profits, colp2o = p2o)
//   reverse: priced side = persons (rowp = profits, rowo2p = p2o),
//            bidders = objects (colpi = prices, colp2o = o2p)
//
// A round (three grid barriers):
//   B. one warp per bidder, over the whole grid: top-2 of (row - rowp) with
//      the smallest index on ties, then one 64-bit global atomicMax per bid
//      on the priced item's conflict key;            -- grid barrier 1
//   C. per priced item: apply the winning bid (rowp += inc, owner = winner),
//      record the win, clear the key; reset the other parity's counters;
//                                                    -- grid barrier 2
//   D. per bidder-side entry: the winner takes its item, a displaced owner
//      leaves; add up the cardinality delta; list the next round's bidders
//      for both possible modes (the bidding side's unassigned entries if
//      the mode stays, the priced side's if it flips);
//                                                    -- grid barrier 3
//   E. control, computed by EVERY thread from the same global counters
//      read after barrier 3, so every CTA takes the same mode and exit
//      decision (a CTA that disagreed would deadlock the next barrier).
// Lists and counters are double-buffered by round parity, so a reset never
// races a read.
//
// Coherence: state written by other CTAs inside the launch is read with
// plain loads after a grid barrier (never __ldg or const __restrict__, whose
// read-only path is not coherent within a kernel); only the two value
// layouts take the read-only path.  Float arithmetic is adds and subtracts
// only, in the JAX association order, so the result is bit-identical to the
// plain version.  Build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// CTAs per SM of the cooperative grid (capped by the occupancy limit):
// fewer CTAs make each grid barrier cheaper, and 16 warps per SM still
// spread the early rounds' thousands of bidders over the card; not tuned
constexpr int kBlocksPerSm = 2;

// control words: bidder counts of the two lists, per parity, the
// cardinality delta per parity, the cardinality at entry
constexpr int kNSame = 0;   // [2] bidders if the mode stays
constexpr int kNFlip = 2;   // [2] bidders if the mode flips
constexpr int kDelta = 4;   // [2] cardinality change of the round
constexpr int kCard = 6;    // matching cardinality at entry
constexpr int kCtrl = 8;

struct Args {
  const float* vals;       // [S, S] person-major values
  const float* vals_t;     // [S, S] object-major values
  float* prices;           // [S]
  float* profits;          // [S]
  int32_t* p2o;            // [S]
  int32_t* o2p;            // [S]
  const float* eps;        // [1]
  int32_t* meta;           // nits, forward_mode, done, since_inc, stall_k
  long long* bid_rows;     // [1] or null
  unsigned long long* keys;  // [S] conflict keys, zero at entry
  int32_t* bestj;          // [S] per bidder: its item, -1 for no bid
  float* floorv;           // [S] per bidder: profit it keeps
  int32_t* haswin;         // [S] per priced item: won this round
  int32_t* lists;          // [2 parity][2 kind][S] bidder lists
  int32_t* ctrl;           // [kCtrl], zero at entry
  int S;
  int rounds;
};

// The bidder list of a round parity; kind 0: the mode stays, 1: it flips.
__device__ __forceinline__ int32_t* list_of(int32_t* lists, int S,
                                            int parity, int kind) {
  return lists + static_cast<size_t>(2 * parity + kind) * S;
}

// Append `flag`ged indices of one warp to a list with one atomic per warp.
__device__ __forceinline__ void warp_append(bool flag, int x, int lane,
                                            int32_t* list, int32_t* count) {
  const unsigned ball = __ballot_sync(kFull, flag);
  int slot = 0;
  if (lane == 0 && ball) slot = atomicAdd(count, __popc(ball));
  slot = __shfl_sync(kFull, slot, 0);
  if (flag) list[slot + __popc(ball & ((1u << lane) - 1u))] = x;
}

__global__ void __launch_bounds__(kThreads) fr_big_rounds_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int S = a.S;
  const int lane = threadIdx.x & 31;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int T = gridDim.x * blockDim.x;  // a multiple of 32
  const int gw = gt >> 5;
  const int W = T >> 5;
  const int wbase = gt & ~31;  // warp-uniform start of the strided loops
  int32_t* ctrl = a.ctrl;
  int32_t* lists = a.lists;

  // every thread reads the same entry state: the exit is uniform
  int nits = a.meta[0], mode = a.meta[1], since = a.meta[3];
  int stallk = a.meta[4];
  if (a.meta[2] != 0 || a.rounds <= 0) return;

  // entry: the current mode's bidders (parity 0, "same" list) and the
  // matching cardinality
  {
    const int32_t* colp2o = mode ? a.p2o : a.o2p;
    int cnt = 0;
    for (int x0 = wbase; x0 < S; x0 += T) {
      const int x = x0 + lane;
      const bool in = x < S;
      cnt += in && a.p2o[x] != kUnassigned;
      warp_append(in && colp2o[x] == kUnassigned, x, lane,
                  list_of(lists, S, 0, 0), &ctrl[kNSame]);
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0 && cnt) atomicAdd(&ctrl[kCard], cnt);
  }
  grid.sync();

  int card = ctrl[kCard];
  int done = 0;
  int kind = 0;  // which list of this round's parity holds its bidders
  long long rows_read = 0;
  const float eps_v = *a.eps;
  const float ninf = Traits<float>::neg_inf();
  for (int it = 0; it < a.rounds; ++it) {
    const int par = it & 1;
    const bool fwd = mode != 0;
    const float* A = fwd ? a.vals : a.vals_t;
    float* rowp = fwd ? a.prices : a.profits;
    float* colpi = fwd ? a.profits : a.prices;
    int32_t* colp2o = fwd ? a.p2o : a.o2p;
    int32_t* rowo2p = fwd ? a.o2p : a.p2o;
    const int32_t* bidders = list_of(lists, S, par, kind);
    const int nbid = ctrl[(kind ? kNFlip : kNSame) + par];
    rows_read += nbid;

    // B. bids: one warp per bidder across the grid
    for (int k = gw; k < nbid; k += W) {
      const int c = bidders[k];
      float best, second;
      int arg;
      bool has_second;
      top2(A + static_cast<size_t>(c) * S, rowp, S, 0, lane, best, arg,
           second, has_second);
      if (lane == 0) {
        if (best != ninf) {
          const float floor = has_second ? second : best;
          const float inc = best - floor + eps_v;
          a.bestj[c] = arg;
          a.floorv[c] = floor;
          atomicMax(&a.keys[arg], bid_key(inc, c));
        } else {
          a.bestj[c] = -1;
        }
      }
    }
    grid.sync();

    // C. priced side: apply each item's winning bid
    if (gt == 0) {
      ctrl[kNSame + (par ^ 1)] = 0;
      ctrl[kNFlip + (par ^ 1)] = 0;
      ctrl[kDelta + (par ^ 1)] = 0;
    }
    for (int r = gt; r < S; r += T) {
      const unsigned long long key = a.keys[r];
      if (key) {
        a.keys[r] = 0ull;
        rowp[r] = rowp[r] + Traits<float>::unorder(
                                static_cast<uint32_t>(key >> 32));
        rowo2p[r] = key_bidder(key);
        a.haswin[r] = 1;
      } else {
        a.haswin[r] = 0;
      }
    }
    grid.sync();

    // D. bidding side: winners take their item, displaced owners leave;
    // next round's bidders for both possible modes
    int d = 0;
    for (int x0 = wbase; x0 < S; x0 += T) {
      const int c = x0 + lane;
      bool stay_bid = false, flip_bid = false;
      if (c < S) {
        const int32_t old = colp2o[c];
        if (old == kUnassigned) {
          const int32_t r = a.bestj[c];
          if (r >= 0 && rowo2p[r] == c) {
            colp2o[c] = r;
            colpi[c] = a.floorv[c] - eps_v;
            ++d;
          } else {
            stay_bid = true;
          }
        } else if (a.haswin[old]) {
          colp2o[c] = kUnassigned;
          --d;
          stay_bid = true;
        }
        flip_bid = rowo2p[c] == kUnassigned;
      }
      warp_append(stay_bid, c, lane, list_of(lists, S, par ^ 1, 0),
                  &ctrl[kNSame + (par ^ 1)]);
      warp_append(flip_bid, c, lane, list_of(lists, S, par ^ 1, 1),
                  &ctrl[kNFlip + (par ^ 1)]);
    }
    d = __reduce_add_sync(kFull, d);
    if (lane == 0 && d) atomicAdd(&ctrl[kDelta + par], d);
    grid.sync();

    // E. control: the same words in every thread, the same decision
    const int delta = ctrl[kDelta + par];
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
    if (done) break;
  }

  if (gt == 0) {
    a.meta[0] = nits;
    a.meta[1] = mode;
    a.meta[2] = done;
    a.meta[3] = since;
    a.meta[4] = stallk;
    if (a.bid_rows) *a.bid_rows += rows_read;
  }
}

}  // namespace

// One cooperative launch of up to `rounds` rounds.  Pointers are device
// pointers of contiguous tensors; `scratch` is an int32 buffer of
// fr_big_scratch_words(S) words, zero at entry; bid_rows may be null.
// Returns the cudaError_t of the launch (0 on success): a grid that cannot
// be co-resident is refused, never shrunk to a wrong size.
extern "C" long long slap_fr_big_scratch_words(int S) {
  return 2LL * S + 7LL * S + kCtrl;
}

extern "C" int slap_fr_big_rounds(const void* vals, const void* vals_t,
                                  void* prices, void* profits, void* p2o,
                                  void* o2p, const void* eps, void* meta,
                                  void* bid_rows, void* scratch, int S,
                                  int rounds, void* stream) {
  if (S <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fr_big_rounds_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  // no more warps than an entry-round bidder list can use (one per row)
  const int warps_per_block = kThreads / 32;
  const int useful = (S + warps_per_block - 1) / warps_per_block;
  int blocks = per_sm * sms;
  if (blocks > useful) blocks = useful;

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
  int32_t* w = static_cast<int32_t*>(scratch);
  a.keys = reinterpret_cast<unsigned long long*>(w);
  a.bestj = w + 2 * static_cast<size_t>(S);
  a.floorv = reinterpret_cast<float*>(a.bestj + S);
  a.haswin = a.bestj + 2 * static_cast<size_t>(S);
  a.lists = a.bestj + 3 * static_cast<size_t>(S);
  a.ctrl = a.bestj + 7 * static_cast<size_t>(S);
  a.S = S;
  a.rounds = rounds;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fr_big_rounds_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slap_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One forward-auction round of ONE dense instance, with the eps-CS margins
// of the updated state, spread over the whole card.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_dense.py:
// _round_kernel (the pallas_call of fused_dense_round), whose body is
// _round_math.  See ops/dense_round_single.py for the Python wrapper and
// the planner that sizes the launch; the plain PyTorch version is
// ops/dense_round.py:fused_dense_round_batch_reference at B = 1.
//
// What bounds it.  The function needs the value plane read once, a
// subtract and two compares an element: the bytes bound it, 20 us at
// 4096² (64 MiB at 3.35 TB/s).  This design reads the bidders' columns
// for the bids and the whole plane again for the margins (both margins
// are outputs for every person, at the new prices), so a round where
// everyone bids moves twice the bound's bytes.  At 256² one read takes
// 0.08 us and the round is a chain of latencies: launch, two dependent
// walks of an object slice and the grid barriers between the phases.
//
// The previous port ran this round as the batch kernel at B = 1
// (csrc/dense_round_kernel.cu): one CTA of 256 threads for the instance,
// so one SM walked every bidder's row and then all N rows again, from a
// transposed copy of the plane made on every call, with the state in that
// CTA's shared memory (12 bytes an object and 12 a person, so a shape
// limit) and eps and done copied from the host.  The design against that:
//
//   - the plane is read as it arrives, object-major vals [M, N] (JAX's
//     layout): a warp takes 32 adjacent persons, one a lane, and each step
//     of its walk is one coalesced 128-byte line of an object row; up to
//     kUnroll rows a lane in flight;
//   - the card is filled by slicing the objects: a work item is one
//     32-person tile x one slice of W objects (8 warps a CTA, the slice's
//     rows interleaved over the warps), so even 256 persons give over 100
//     CTAs; a tile without a bidder skips the bid walk;
//   - the partial top-2s (best, second, value at best, object) of the
//     slices merge exactly: the CTA merges its warps' in shared memory and
//     writes one partial a person and slice, person-major [N, S]; after a
//     grid barrier a warp a person loads the S partials in one coalesced
//     load (a lane a slice) and merges them across the warp with the
//     order-free merge (equal profits to the smaller object, the loser's
//     best into second through min(b1, b2));
//   - bids meet in one native 64-bit global atomicMax on the object's key
//     (fr_common.cuh:bid_key): the largest bid, the smallest person among
//     equal bids.  (A 64-bit max on distributed shared memory would not be
//     atomic on the H100; this kernel uses no cluster.)
//   - after a second grid barrier every item walks its slice once more
//     against the slice's new prices, staged in shared memory from the
//     keys (the winning bid, or the old price; the tile-0 items write the
//     slices' prices' and o2p'): the
//     max of value - new price merges over the CTA's warps and then into
//     maxp by an order-free 32-bit float max (a signed max or an unsigned
//     min on the bits), so no item waits for another; each person's p2o'
//     follows from the staged key of its one candidate (its object, or
//     its bid's object), decided by the warp that walks that row, which
//     also takes `chosen` from its walk: no gather, no third barrier;
//   - every load a step needs is issued before any is used, and a walk's
//     first values load beside the slice's staged prices: a phase of a
//     small instance is one dependent load level;
//   - eps and done arrive as kernel arguments, or by pointer when they are
//     tensors on the card: no host-to-device copy;
//   - the state lives in global memory (the outputs and one scratch
//     buffer the wrapper sizes): no shape limit beyond the card's memory.
//
// One cooperative launch with two grid barriers (grid = the items the
// card holds at once, each CTA looping over items).  Three stream-ordered
// launches of the same phases were measured beside it
// (tools/dense_round_single_stream.cu, tools/kernel_ab.py) and were about
// 2 us slower at 256² on an H100: a launch where they have three.  The
// kernel is a template on the phases it runs: the wrapper's instance runs
// all three (kPhases = 7); the instances 0, 1 and 3 (the launch and
// barriers alone, the latency floor's skeleton, and the first one or two
// phases) exist only to split a round's time, so the shipped instance
// carries no run-time mask.  The kernels use 10 KB of static shared
// memory, so there is no function attribute to set; the cooperative
// grid's device queries run once a device per process.
//
// Coherence: data written by other CTAs inside the cooperative launch (the
// partials, keys, choices) is never read through the read-only path
// (__ldg): the partials and choices with __ldcg, the keys, final after the
// last barrier, with plain loads; only the inputs take __ldg.  Float
// arithmetic is subtracts, adds, max and min in the JAX order, so the
// result is bit-identical to the plain version.  Build without
// --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fr_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a lane keeps in flight in a slice walk
constexpr int kUnroll = 8;
// the widest object slice, staged in shared memory (MAX_SLICE of
// ops/dense_round_single.py)
constexpr int kMaxSlice = 512;
// CTAs an SM the cooperative kernel's registers must allow (64 a thread),
// so that a large instance has 528 CTAs of loads in flight
constexpr int kCoopBlocksPerSM = 4;

struct Args {
  const float* vals;            // [M, N] object-major values
  const float* prices;          // [M]
  const int32_t* p2o;           // [N]
  const int32_t* o2p;           // [M]
  const float* eps_p;           // eps as a float32 on the card, or null
  const unsigned char* done_p;  // done as a bool on the card, or null
  float eps;                    // eps when eps_p is null
  int done;                     // done when done_p is null
  float* prices_out;            // [M]
  int32_t* p2o_out;             // [N]
  int32_t* o2p_out;             // [M]
  float* chosen;                // [N]
  float* maxp;                  // [N]
  float4* part;                 // [N, S] best, second, value, object bits
  unsigned long long* keys;     // [M] conflict keys
  int32_t* bestj;               // [N] each bidder's object, -1: no bid
  int M, N, W, S, T;
};

// Running top-2 of one person: best profit `b`, its object `j` (the
// smallest among equal profits), the value there `bv`, and `s`, the
// maximum over every other object seen.
struct Top2 {
  float b, s, bv;
  int j;
};

struct Smem {
  unsigned long long key[kMaxSlice];  // the slice's keys (phase 3)
  float price[kMaxSlice];  // the slice's prices (phase 1), new prices (3)
  Top2 top[kWarps][32];    // the warps' partials; .b a partial max in 3
};

__device__ __forceinline__ Top2 top2_empty() {
  const float ninf = Traits<float>::neg_inf();
  return Top2{ninf, ninf, ninf, kUnassigned};
}

// The exact, order-free merge of two top-2s over disjoint object sets
// (top2_warp_merge_raw's step).
__device__ __forceinline__ void top2_merge(Top2& x, const Top2& y) {
  const bool keep = (x.b > y.b) || (x.b == y.b && x.j <= y.j);
  x.s = fmaxf(fminf(x.b, y.b), fmaxf(x.s, y.s));
  if (!keep) {
    x.b = y.b;
    x.j = y.j;
    x.bv = y.bv;
  }
}

__device__ __forceinline__ float read_eps(const Args& a) {
  return a.eps_p ? *a.eps_p : a.eps;
}

__device__ __forceinline__ bool read_done(const Args& a) {
  return a.done_p ? *a.done_p != 0 : a.done != 0;
}

// The new price of an object: the winning bid, or the old price.
__device__ __forceinline__ float new_price(unsigned long long key,
                                          float price) {
  return key ? Traits<float>::unorder(static_cast<uint32_t>(key >> 32))
             : price;
}

// An order-free float max into global memory (no NaNs): the sign bit
// picks a signed max or an unsigned min on the bits, both of which keep
// the larger float; the word starts at -inf.
__device__ __forceinline__ void atomic_max_float(float* word, float x) {
  if (!signbit(x))
    atomicMax(reinterpret_cast<int*>(word), __float_as_int(x));
  else
    atomicMin(reinterpret_cast<unsigned*>(word), __float_as_uint(x));
}

// An item's place: tile t, slice s, the lane's person i (in: i < N), the
// slice's first object j0 and its rows, the lane's column at row j0.
struct Item {
  int t, s, i, j0, rows;
  bool in;
  const float* col;
};

__device__ __forceinline__ Item item_at(const Args& a, int item) {
  Item it;
  it.t = item % a.T;
  it.s = item / a.T;
  it.i = it.t * 32 + (threadIdx.x & 31);
  it.in = it.i < a.N;
  it.j0 = it.s * a.W;
  it.rows = min(a.W, a.M - it.j0);
  it.col = a.vals + static_cast<size_t>(it.j0) * a.N + (it.in ? it.i : 0);
  return it;
}

// One step of a warp's walk: the lane's values at rows r0, r0 + 8, ...
// (-inf past the slice or the persons), all loads in flight together.
__device__ __forceinline__ void load_rows(const Args& a, const Item& it,
                                          int r0, float (&v)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int r = r0 + u * kWarps;
    v[u] = (it.in && r < it.rows)
               ? __ldg(it.col + static_cast<size_t>(r) * a.N)
               : Traits<float>::neg_inf();
  }
}

// Phase 1, one item: each warp's lanes walk their persons' columns over
// the warp's rows of the slice (r = w, w + 8, ...) against the slice's
// prices staged in shared memory (the first step's values load beside
// them), the CTA merges its warps and writes one partial top-2 a person.
// A tile without a bidder writes nothing; every warp reads the same 32
// p2o entries, so the test is uniform.  A walk of one step makes the test
// after its loads, a longer one before them.
__device__ void walk_bids(const Args& a, bool done, int item, Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const Item it = item_at(a, item);
  const bool bids = it.in && !done && __ldg(a.p2o + it.i) == kUnassigned;
  const bool early = it.rows > kWarps * kUnroll;
  if (early && !__ballot_sync(kFull, bids)) return;
  float v[kUnroll];
  load_rows(a, it, wid, v);
  for (int r = tid; r < it.rows; r += kThreads)
    sm.price[r] = __ldg(a.prices + it.j0 + r);
  if (!early && !__ballot_sync(kFull, bids)) return;
  __syncthreads();
  Top2 x = top2_empty();
  for (int r0 = wid; r0 < it.rows; r0 += kWarps * kUnroll) {
    if (r0 != wid) load_rows(a, it, r0, v);
    // a lane's rows arrive in ascending order, so a strict > keeps the
    // smallest object; a profit equal to best lands in second
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      if (r < it.rows)
        top2_take_raw(v[u] - sm.price[r], v[u], it.j0 + r, x.b, x.s, x.j,
                      x.bv);
    }
  }
  sm.top[wid][lane] = x;
  __syncthreads();
  if (wid == 0) {
    for (int w = 1; w < kWarps; ++w) top2_merge(x, sm.top[w][lane]);
    if (it.in)
      a.part[static_cast<size_t>(it.i) * a.S + it.s] =
          make_float4(x.b, x.s, x.bv, __int_as_float(x.j));
  }
  __syncthreads();  // the next item restages the prices
}

// Phase 2, one person a warp: a bidder's S partials, a lane each (one
// coalesced load for S <= 32), merged across the warp; lane 0 places the
// bid on its object's key.
__device__ void place_bids(const Args& a, bool done, float eps, int i) {
  const int lane = threadIdx.x & 31;
  const float4* pp = a.part + static_cast<size_t>(i) * a.S;
  Top2 x = top2_empty();
  for (int s = lane; s < a.S; s += 32) {
    const float4 p = __ldcg(pp + s);
    top2_merge(x, Top2{p.x, p.y, p.z, __float_as_int(p.w)});
  }
  if (done || __ldg(a.p2o + i) != kUnassigned) return;  // warp-uniform
  top2_warp_merge_raw(x.b, x.s, x.j, x.bv);
  if (lane != 0) return;
  const float ninf = Traits<float>::neg_inf();
  if (x.b == ninf) {  // no arc at any price: no bid
    a.bestj[i] = -1;
    return;
  }
  const float bid = (x.s != ninf ? x.bv - x.s : x.bv - x.b) + eps;
  a.bestj[i] = x.j;
  atomicMax(a.keys + x.j, bid_key(bid, i));
}

// Phase 3, one item: the slice's keys and new prices staged in shared
// memory (the new price is the winning bid, or the old price; tile 0
// writes the slice's prices' and o2p'), the
// first step's values loading beside them; each person's max of value -
// new price over the slice, merged over the CTA's warps and into maxp with
// an order-free float max.  Each person has one candidate object for p2o'
// (its object, or its bid's object); the warp that walks the candidate's
// row decides p2o' from the staged key and takes `chosen` from its walk,
// so each person has one writer (warp 0 of slice 0 for a person without a
// candidate).  The keys are final after the barrier: plain loads.
__device__ void margins(const Args& a, bool done, int item, Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const Item it = item_at(a, item);
  const int32_t cur = it.in ? __ldg(a.p2o + it.i) : kUnassigned;
  const bool bidder = it.in && !done && cur == kUnassigned;
  const int32_t bj = bidder ? __ldcg(a.bestj + it.i) : -1;
  float v[kUnroll];
  load_rows(a, it, wid, v);
  for (int r = tid; r < it.rows; r += kThreads) {
    const int j = it.j0 + r;
    const unsigned long long k = a.keys[j];
    const float pn = new_price(k, __ldg(a.prices + j));
    sm.key[r] = k;
    sm.price[r] = pn;
    if (it.t == 0) {
      a.prices_out[j] = pn;
      a.o2p_out[j] = k ? key_bidder(k) : __ldg(a.o2p + j);
    }
  }
  const int32_t cand = cur != kUnassigned ? cur : bj;  // -1: none
  __syncthreads();
  const float ninf = Traits<float>::neg_inf();
  float mx = ninf, ch = ninf;
  for (int r0 = wid; r0 < it.rows; r0 += kWarps * kUnroll) {
    if (r0 != wid) load_rows(a, it, r0, v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      if (r < it.rows) {
        const float pr = v[u] - sm.price[r];
        mx = fmaxf(mx, pr);
        if (it.j0 + r == cand) ch = pr;
      }
    }
  }
  if (it.in) {
    const int rc = cand - it.j0;
    if (cand >= 0 && rc < it.rows && rc >= 0 && rc % kWarps == wid) {
      // a displaced owner leaves, a bidder that holds its object's key
      // takes it
      const unsigned long long k = sm.key[rc];
      const bool keeps = cur != kUnassigned ? !k : key_bidder(k) == it.i;
      a.p2o_out[it.i] = keeps ? cand : kUnassigned;
      a.chosen[it.i] = keeps ? ch : ninf;
    } else if (cand < 0 && it.s == 0 && wid == 0) {
      a.p2o_out[it.i] = kUnassigned;
      a.chosen[it.i] = ninf;
    }
  }
  sm.top[wid][lane].b = mx;
  __syncthreads();
  if (wid == 0) {
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm.top[w][lane].b);
    if (it.in) atomic_max_float(a.maxp + it.i, mx);
  }
  __syncthreads();  // the next item restages the slice
}

// Zero the keys and start maxp at -inf: every CTA takes a grid stride.
__device__ void clear(const Args& a) {
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  for (int k = first; k < a.M; k += stride) a.keys[k] = 0ull;
  for (int k = first; k < a.N; k += stride)
    a.maxp[k] = Traits<float>::neg_inf();
}

// The round's phases: bit k of kPhases runs phase k + 1 (7: the round;
// fewer only to time the pieces).
template <int kPhases>
__global__ void __launch_bounds__(kThreads, kCoopBlocksPerSM)
    dense_round_single_coop(Args a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const bool done = read_done(a);
  const int items = a.T * a.S;
  if (kPhases & 1) {
    clear(a);
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      walk_bids(a, done, item, sm);
  }
  grid.sync();
  if (kPhases & 2) {
    const float eps = read_eps(a);
    for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < a.N;
         i += gridDim.x * kWarps)
      place_bids(a, done, eps, i);
  }
  grid.sync();
  if (kPhases & 4) {
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      margins(a, done, item, sm);
  }
}

// The cooperative grid for `items` work items on the current device: the
// CTAs the card holds at once of the round's instance, at most one an
// item.  Every instance launches this grid (those running fewer phases
// need no more resources), so the pieces time the round's own launch.
// The device queries run once a device per process.
cudaError_t coop_grid(int items, int* grid) {
  constexpr int kMaxDevices = 64;
  static int cap[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return cudaErrorNotSupported;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_round_single_coop<7>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap[dev] = per_sm * sms;
  }
  *grid = items < cap[dev] ? items : cap[dev];
  return cudaSuccess;
}

template <int kPhases>
cudaError_t launch_coop(Args& a, cudaStream_t st) {
  int grid = 0;
  cudaError_t err = coop_grid(a.S * a.T, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(dense_round_single_coop<kPhases>), dim3(grid),
      dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel arguments from the C interface's (see slap_dense_round_single
// below); cudaErrorInvalidValue for a plan that does not cover M x N.
cudaError_t make_args(Args& a, const void* ptr_table, float eps, int done,
                      int M, int N, int W, int S, int T) {
  uint64_t ptrs[14];  // the table may sit at any byte address
  memcpy(ptrs, ptr_table, sizeof(ptrs));
  if (M <= 0 || N <= 0 || W <= 0 || W > kMaxSlice || S <= 0 || T <= 0 ||
      static_cast<long long>(S) * W < M || 32LL * T < N)
    return cudaErrorInvalidValue;
  a.vals = reinterpret_cast<const float*>(ptrs[0]);
  a.prices = reinterpret_cast<const float*>(ptrs[1]);
  a.p2o = reinterpret_cast<const int32_t*>(ptrs[2]);
  a.o2p = reinterpret_cast<const int32_t*>(ptrs[3]);
  a.eps_p = reinterpret_cast<const float*>(ptrs[4]);
  a.done_p = reinterpret_cast<const unsigned char*>(ptrs[5]);
  a.eps = eps;
  a.done = done;
  a.prices_out = reinterpret_cast<float*>(ptrs[6]);
  a.p2o_out = reinterpret_cast<int32_t*>(ptrs[7]);
  a.o2p_out = reinterpret_cast<int32_t*>(ptrs[8]);
  a.chosen = reinterpret_cast<float*>(ptrs[9]);
  a.maxp = reinterpret_cast<float*>(ptrs[10]);
  a.part = reinterpret_cast<float4*>(ptrs[11]);
  a.keys = reinterpret_cast<unsigned long long*>(ptrs[12]);
  a.bestj = reinterpret_cast<int32_t*>(ptrs[13]);
  a.M = M;
  a.N = N;
  a.W = W;
  a.S = S;
  a.T = T;
  return cudaSuccess;
}

}  // namespace

// One round of one M x N instance.  `ptr_table` holds 14 device pointers
// of contiguous tensors, in this order: vals [M, N] float32, prices [M]
// float32, p2o [N] and o2p [M] int32 (read only); eps_p (a float32)
// holding eps, or null for the value `eps`; done_p (a byte) holding done,
// or null for the value `done`; the outputs
// prices_out [M], p2o_out [N], o2p_out [M], chosen [N], maxp [N]; the
// scratch arrays part [N, S] (16-byte aligned), keys [M], bestj [N], sized
// by ops/dense_round_single.py:plan with W, S and T.  phases: 7 the round;
// 0, 1 or 3 (bit k: phase k + 1) only to time the pieces.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int slap_dense_round_single(const void* ptr_table, float eps,
                                       int done, int M, int N, int W, int S,
                                       int T, int phases, void* stream) {
  Args a;
  cudaError_t err = make_args(a, ptr_table, eps, done, M, N, W, S, T);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phases) {
    case 7:
      return static_cast<int>(launch_coop<7>(a, st));
    case 0:
      return static_cast<int>(launch_coop<0>(a, st));
    case 1:
      return static_cast<int>(launch_coop<1>(a, st));
    case 3:
      return static_cast<int>(launch_coop<3>(a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* slap_dense_round_single_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward-auction rounds for every instance of a batch of dense instances:
// up to a whole chunk of rounds with the eps-scaling bookkeeping in one
// launch, or one round with the eps-CS margins of the updated state.
//
// Replaces the JAX package's two Pallas TPU kernels of ops/pallas_dense.py,
// _batch_round_kernel (driven by fused_dense_round_batch_flat) and
// _round_kernel (fused_dense_round), both bodies of _round_math, together
// with the XLA bookkeeping that batch.py:_batch_chunk_pallas runs around
// each round.  See ops/dense_round.py for the Python wrappers, the plain
// PyTorch versions and the note on what bounds this kernel.
//
// Layout: one CTA of 256 threads per instance (grid = B).  The person-major
// value plane `vals [B, N, M]` (a person's M values contiguous, -inf at
// non-arcs) stays in device memory; only the rows of the round's bidders
// are read, a warp taking R of them at once in 16-byte loads with up to 8
// loads a lane in flight.  The instance's state lives in shared memory for
// the whole launch: prices [M], one 64-bit conflict key per object, p2o [N],
// each bidder's choice (in a margin round: each person's keep flag) and the
// bidder list; o2p is updated in place in device memory (only winners
// write it); eps, nits, nreductions, optimal_found and done are registers.
//
// A round:
//   S. release the pairs that lost eps-CS at a reduced eps (the previous
//      round's decision), list the unassigned persons, clear the keys;
//   A. per bidder: top-2 of (value - price) over the objects, the smallest
//      object among equal profits, `second` the maximum over every object
//      but the best (equal to `best` on a tie), best_val = value there; a
//      bidder with a finite best bids (best_val - second) + eps, or
//      (best_val - best) + eps with a single arc, by one 64-bit atomicMax on
//      the object's key (bid order bits << 32 | ~person): the largest bid
//      wins, the smallest person among equal bids;
//   C. per person: an owner whose object got a winner is displaced, a bidder
//      that is its object's winner takes it; count the unassigned;
//      per object: the price becomes the winning bid, o2p the winner;
//   M. only when the instance has just become fully assigned and N == M
//      (the bookkeeping never reads the margins otherwise): per person,
//      maxp = max over objects of (value - new price) and chosen = value -
//      new price at its object; is_optimal = every chosen + tol >= maxp -
//      target; each person's keep flag = chosen + tol >= maxp - 0.15 eps;
//   then the bookkeeping of batch.py:_batch_chunk_pallas: nits, stop,
//   the eps reduction, nreductions, optimal_found, done (also at
//   max_iterations).  An instance that is done leaves the loop; one done at
//   entry returns at once.
// In single-round mode (the margin outputs given) the launch runs one round
// without bookkeeping and writes both margins for every person, done or not.
// Every bid is computed from the prices of the round's start: prices change
// only in C, after a barrier.  Float arithmetic is adds, subtracts, max,
// min and one explicit __fmul_rn, so nothing can contract into an fma and
// the result is bit-identical to the plain version.  Build without
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// loads a lane keeps in flight in a row walk (16-byte loads, or 4-byte on
// rows that are not 16-byte aligned)
constexpr int kLoadsInFlight = 8;

struct Args {
  const float* vals;       // [B, N, M] person-major values
  float* prices;           // [B, M] in and out
  int32_t* p2o;            // [B, N] in and out
  int32_t* o2p;            // [B, M] in and out (winners write)
  float* eps;              // [B] in and out (chunk mode)
  int32_t* nits;           // [B] chunk mode, else null
  int32_t* nred;           // [B]
  unsigned char* optimal;  // [B]
  unsigned char* done;     // [B] in and out (chunk mode), in (single)
  float* chosen;           // [B, N] single-round mode, else null
  float* maxp;             // [B, N] single-round mode, else null
  long long* rows;         // [B] rows read, or null
  float target;
  float tol;
  int max_iterations;
  int chunk;
  int sfoe;                // 1 when N != M: no eps-scaling, no margins
  int N;
  int M;
};

// Running top-2 of one person over a set of objects: best profit `b`, its
// object `j` (the smallest among equal profits), the value there `bv`, and
// `s`, the maximum over every other object of the set.
struct Top2 {
  float b, s, bv;
  int j;
};

__device__ __forceinline__ void top2_push(Top2& t, float v, float price,
                                          int r) {
  const float pr = v - price;
  if (pr > t.b) {
    // a lane's objects arrive in ascending order, so a strict > keeps the
    // smallest object; the old best becomes a candidate for second
    t.s = fmaxf(t.s, t.b);
    t.b = pr;
    t.j = r;
    t.bv = v;
  } else {
    // a profit equal to best lands in second and never replaces the object
    t.s = fmaxf(t.s, pr);
  }
}

// The exact merge of the lanes' partial top-2s over disjoint object sets:
// equal profits go to the smaller object, the loser's best is a candidate
// for second through min(b1, b2).
__device__ __forceinline__ void top2_warp_merge_bv(Top2& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(kFull, t.b, off);
    const float s2 = __shfl_xor_sync(kFull, t.s, off);
    const float bv2 = __shfl_xor_sync(kFull, t.bv, off);
    const int j2 = __shfl_xor_sync(kFull, t.j, off);
    const bool keep = (t.b > b2) || (t.b == b2 && t.j <= j2);
    t.s = fmaxf(fminf(t.b, b2), fmaxf(t.s, s2));
    if (!keep) {
      t.b = b2;
      t.j = j2;
      t.bv = bv2;
    }
  }
}

// The top-2s of R persons' rows (id < 0: no person), walked by one warp:
// every lane ends with the merged result.  VEC = 4 reads float4s (rows
// 16-byte aligned), VEC = 1 floats.
template <int VEC, int R>
__device__ __forceinline__ void warp_top2(const float* __restrict__ inst,
                                          int M, const float* sp,
                                          const int (&id)[R], int lane,
                                          Top2 (&t)[R]) {
  constexpr int U = kLoadsInFlight / R;  // loads a row, a lane, a step
  const float ninf = Traits<float>::neg_inf();
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = Top2{ninf, ninf, ninf, kUnassigned};
  if constexpr (VEC == 4) {
    const int m4 = M >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(sp);
    for (int v0 = 0; v0 < m4; v0 += 32 * U) {
      float4 x[R][U];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* row = reinterpret_cast<const float4*>(
            inst + static_cast<size_t>(id[r] < 0 ? 0 : id[r]) * M);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + u * 32 + lane;
          if (id[r] >= 0 && v < m4) x[r][u] = __ldg(row + v);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + u * 32 + lane;
          if (id[r] >= 0 && v < m4) {
            const float4 p = p4[v];
            const int pos = 4 * v;
            top2_push(t[r], x[r][u].x, p.x, pos);
            top2_push(t[r], x[r][u].y, p.y, pos + 1);
            top2_push(t[r], x[r][u].z, p.z, pos + 2);
            top2_push(t[r], x[r][u].w, p.w, pos + 3);
          }
        }
      }
    }
  } else {
    for (int v0 = 0; v0 < M; v0 += 32 * U) {
      float x[R][U];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* row =
            inst + static_cast<size_t>(id[r] < 0 ? 0 : id[r]) * M;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + u * 32 + lane;
          if (id[r] >= 0 && v < M) x[r][u] = __ldg(row + v);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + u * 32 + lane;
          if (id[r] >= 0 && v < M) top2_push(t[r], x[r][u], sp[v], v);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (id[r] >= 0) top2_warp_merge_bv(t[r]);  // warp-uniform
}

template <int VEC, int R>
__global__ void __launch_bounds__(kThreads) dense_chunk_kernel(Args a) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int N = a.N, M = a.M;
  const bool single = a.chosen != nullptr;
  const bool was_done = a.done[b] != 0;  // uniform over the CTA
  if (was_done && !single) return;        // a finished instance is frozen
  const float ninf = Traits<float>::neg_inf();

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* prices = reinterpret_cast<float*>(keys + M);          // [M]
  int32_t* p2o = reinterpret_cast<int32_t*>(prices + M);       // [N]
  int32_t* bestj = p2o + N;  // [N] choices; keep flags in a margin round
  int32_t* list = bestj + N;                                   // [N]
  __shared__ int c_nbid, c_unas, c_viol;

  const size_t ob = static_cast<size_t>(b) * M;
  const size_t pb = static_cast<size_t>(b) * N;
  const float* inst = a.vals + static_cast<size_t>(b) * N * M;
  for (int j = tid; j < M; j += kThreads) prices[j] = a.prices[ob + j];
  for (int i = tid; i < N; i += kThreads) p2o[i] = a.p2o[pb + i];
  if (tid == 0) {
    c_nbid = 0;
    c_unas = 0;
    c_viol = 0;
  }
  float eps = a.eps[b];
  int nits = 0, nred = 0, optimal = 0, done = 0;
  if (!single) {
    nits = a.nits[b];
    nred = a.nred[b];
    optimal = a.optimal[b];
  }
  long long rows = 0;
  bool release = false;  // the last round reduced eps: drop the losers
  __syncthreads();

  const int rounds = single ? 1 : a.chunk;
  for (int it = 0; it < rounds; ++it) {
    // S. release, the bidders, clear keys
    if (!was_done) {
      for (int c0 = 0; c0 < N; c0 += kThreads) {
        const int c = c0 + tid;
        const bool in = c < N;
        if (in && release && bestj[c] == 0) p2o[c] = kUnassigned;
        const bool bid = in && p2o[c] == kUnassigned;
        const unsigned ball = __ballot_sync(kFull, bid);
        int slot = 0;
        if (lane == 0 && ball) slot = atomicAdd(&c_nbid, __popc(ball));
        slot = __shfl_sync(kFull, slot, 0);
        if (bid) list[slot + __popc(ball & ((1u << lane) - 1u))] = c;
      }
    }
    for (int j = tid; j < M; j += kThreads) keys[j] = 0ull;
    release = false;
    __syncthreads();
    const int nbid = c_nbid;
    rows += nbid;

    // A. the bids, R bidders a warp step
    if (tid == 0) {
      c_unas = 0;  // every thread read the last round's counts before
      c_viol = 0;  // the barrier above
    }
    for (int g = wid * R; g < nbid; g += kWarps * R) {
      int id[R];
#pragma unroll
      for (int r = 0; r < R; ++r) id[r] = g + r < nbid ? list[g + r] : -1;
      Top2 t[R];
      warp_top2<VEC, R>(inst, M, prices, id, lane, t);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (id[r] < 0) continue;
          if (t[r].b != ninf) {
            const float bid =
                (t[r].s != ninf ? t[r].bv - t[r].s : t[r].bv - t[r].b) + eps;
            bestj[id[r]] = t[r].j;
            atomicMax(&keys[t[r].j], bid_key(bid, id[r]));
          } else {
            bestj[id[r]] = -1;
          }
        }
      }
    }
    __syncthreads();

    // C. persons: displaced owners leave, winners take their object;
    // objects: the winning bid becomes the price, the winner the owner
    if (tid == 0) c_nbid = 0;  // read by every thread before the barrier
    int unas = 0;
    for (int c0 = 0; c0 < N; c0 += kThreads) {
      const int c = c0 + tid;
      if (c < N) {
        const int32_t cur = p2o[c];
        if (cur != kUnassigned) {
          if (keys[cur]) p2o[c] = kUnassigned;
        } else if (!was_done) {
          const int32_t j = bestj[c];
          if (j >= 0 && key_bidder(keys[j]) == c) p2o[c] = j;
        }
        unas += p2o[c] == kUnassigned;
      }
    }
    unas = __reduce_add_sync(kFull, unas);
    if (lane == 0 && unas) atomicAdd(&c_unas, unas);
    for (int j = tid; j < M; j += kThreads) {
      const unsigned long long key = keys[j];
      if (key) {
        prices[j] = Traits<float>::unorder(static_cast<uint32_t>(key >> 32));
        a.o2p[ob + j] = key_bidder(key);
      }
    }
    __syncthreads();

    if (single) {
      // M for every person: both margins as outputs
      for (int g = wid * R; g < N; g += kWarps * R) {
        int id[R];
#pragma unroll
        for (int r = 0; r < R; ++r) id[r] = g + r < N ? g + r : -1;
        Top2 t[R];
        warp_top2<VEC, R>(inst, M, prices, id, lane, t);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (id[r] < 0) continue;
            const int32_t cur = p2o[id[r]];
            a.maxp[pb + id[r]] = t[r].b;
            a.chosen[pb + id[r]] =
                cur != kUnassigned
                    ? inst[static_cast<size_t>(id[r]) * M + cur] - prices[cur]
                    : ninf;
          }
        }
      }
      rows += N;
      break;
    }

    // the bookkeeping
    ++nits;
    const bool fully = c_unas == 0;
    if (fully && a.sfoe) {
      optimal = 1;  // no eps-scaling: a full assignment stops
      done = 1;
    } else if (fully) {
      // M: the margins at the new prices, every person assigned
      const float eps_next = __fmul_rn(eps, 0.15f);
      for (int g = wid * R; g < N; g += kWarps * R) {
        int id[R];
#pragma unroll
        for (int r = 0; r < R; ++r) id[r] = g + r < N ? g + r : -1;
        Top2 t[R];
        warp_top2<VEC, R>(inst, M, prices, id, lane, t);
        if (lane == 0) {
          int viol = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (id[r] < 0) continue;
            const int32_t cur = p2o[id[r]];
            const float chosen =
                inst[static_cast<size_t>(id[r]) * M + cur] - prices[cur];
            const float lhs = chosen + a.tol;
            viol += !(lhs >= t[r].b - a.target);
            bestj[id[r]] = lhs >= t[r].b - eps_next;
          }
          if (viol) atomicAdd(&c_viol, viol);
        }
      }
      rows += N;
      __syncthreads();
      const bool is_optimal = c_viol == 0;
      optimal |= is_optimal;
      if (is_optimal || eps < a.target) {
        done = 1;
      } else {
        eps = eps_next;
        ++nred;
        release = true;
      }
    }
    if (nits >= a.max_iterations) done = 1;
    if (done) break;
  }

  // a reduction in the last round releases its losers before the exit
  for (int i = tid; i < N; i += kThreads) {
    if (release && bestj[i] == 0) p2o[i] = kUnassigned;
    a.p2o[pb + i] = p2o[i];
  }
  for (int j = tid; j < M; j += kThreads) a.prices[ob + j] = prices[j];
  if (tid == 0) {
    if (!single) {
      a.eps[b] = eps;
      a.nits[b] = nits;
      a.nred[b] = nred;
      a.optimal[b] = static_cast<unsigned char>(optimal);
      a.done[b] = static_cast<unsigned char>(done);
    }
    if (a.rows) a.rows[b] += rows;
  }
}

// Shared memory one instance needs: 12 bytes per object (key, price) and
// 12 per person (p2o, choice, list entry); ops/dense_round.py:smem_bytes
// holds the wrapper to the same sum.
size_t smem_bytes(int N, int M) {
  return static_cast<size_t>(M) * (sizeof(unsigned long long) + sizeof(float)) +
         static_cast<size_t>(N) * 3 * sizeof(int32_t);
}

template <int VEC, int R>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.N, a.M);
  cudaError_t err = cudaFuncSetAttribute(
      dense_chunk_kernel<VEC, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_chunk_kernel<VEC, R><<<B, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over a batch of B instances of N persons x M objects.  Pointers
// are device pointers of contiguous tensors: vals [B, N, M] float32 (read),
// prices [B, M] float32, p2o [B, N] int32, o2p [B, M] int32 and eps [B]
// float32 (updated in place), done [B] bytes (0 or 1).  Chunk mode
// (chosen == null): up to `chunk` rounds with the bookkeeping, nits [B] and
// nreductions [B] int32, optimal [B] and done [B] bytes updated in place.
// Single-round mode (chosen and maxp [B, N] float32 given): one round,
// nits/nred/optimal unused, eps and done read only.  rows [B] int64, if
// given, gains the rows each instance read.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int slap_dense_chunk(const void* vals, void* prices, void* p2o,
                                void* o2p, void* eps, void* nits, void* nred,
                                void* optimal, void* done, void* chosen,
                                void* maxp, void* rows, float target,
                                float tol, int max_iterations, int chunk,
                                int sfoe, int B, int N, int M, void* stream) {
  if (B <= 0) return 0;
  Args a;
  a.vals = static_cast<const float*>(vals);
  a.prices = static_cast<float*>(prices);
  a.p2o = static_cast<int32_t*>(p2o);
  a.o2p = static_cast<int32_t*>(o2p);
  a.eps = static_cast<float*>(eps);
  a.nits = static_cast<int32_t*>(nits);
  a.nred = static_cast<int32_t*>(nred);
  a.optimal = static_cast<unsigned char*>(optimal);
  a.done = static_cast<unsigned char*>(done);
  a.chosen = static_cast<float*>(chosen);
  a.maxp = static_cast<float*>(maxp);
  a.rows = static_cast<long long*>(rows);
  a.target = target;
  a.tol = tol;
  a.max_iterations = max_iterations;
  a.chunk = chunk;
  a.sfoe = sfoe;
  a.N = N;
  a.M = M;
  if ((chosen == nullptr) != (maxp == nullptr) ||
      (chosen == nullptr && (nits == nullptr || nred == nullptr ||
                             optimal == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (!vec) return launch<1, 1>(a, B, st);
  // bidders a warp step: as many as keep kLoadsInFlight loads a lane
  const int loads = (M / 4 + 31) / 32;
  if (loads <= 1) return launch<4, 8>(a, B, st);
  if (loads <= 2) return launch<4, 4>(a, B, st);
  if (loads <= 4) return launch<4, 2>(a, B, st);
  return launch<4, 1>(a, B, st);
}

extern "C" const char* slap_dense_round_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

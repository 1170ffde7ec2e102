// One fused forward-auction round, with the eps-CS margins of the updated
// state, for every instance of a batch of dense instances.
//
// Replaces the JAX package's two Pallas TPU kernels of ops/pallas_dense.py:
// _batch_round_kernel (driven by fused_dense_round_batch_flat, the grid over
// the batch) and _round_kernel (fused_dense_round, one instance), both bodies
// of _round_math.  The single-instance entry point is this kernel at B = 1.
// See ops/dense_round.py for the Python wrapper, the plain PyTorch version
// and the note on what bounds this kernel.
//
// Layout: one CTA of 256 threads per instance (grid = B).  The object-major
// value plane `vals [B, M, N]` (persons contiguous, -inf at non-arcs) stays
// in device memory and is read twice: once for the bids, once for the
// margins at the new prices.  The instance's small state lives in shared
// memory: prices [M], one 64-bit conflict key per object, p2o [N] and each
// person's choice.
//
// Threads are laid out as W person lanes x S row splits (W * S = 256, W the
// power of two in [32, 256] that covers N, or 256 with the persons walked
// in tiles).  A lane reads one person's column, so a warp's loads are
// coalesced along the person axis; the S splits of a person share the M
// rows and are merged through shared memory with the exact top-2 merge.
//
// A round:
//   A. per person: top-2 of (value - price) over the objects, the smallest
//      object among equal profits, `second` the maximum over every object
//      but the best (so equal to `best` on a tie), best_val = value there;
//   B. persons that are unassigned, in an instance that is not done, with a
//      finite best, bid (best_val - second) + eps, or (best_val - best) + eps
//      with a single arc, by one 64-bit atomicMax on the object's key
//      (bid order bits << 32 | ~person): the largest bid wins, the smallest
//      person among equal bids;
//   C. per person: an owner whose object got a winner is displaced, a bidder
//      that is its object's winner takes it (the two sets are disjoint);
//   D. per object: the price becomes the winning bid, o2p the winner;
//   E. per person: maxp = max over objects of (value - new price) and
//      chosen = value - new price at the person's own object, -inf for an
//      unassigned person.
// An instance that is done skips A-C (nobody bids) and still returns its
// margins.  Every bid is computed from the prices of the round's start:
// prices change only in D, after a barrier.  Float arithmetic is subtracts,
// adds, max and min only, so nothing can contract into an fma and the
// result is bit-identical to the plain version.  Build without
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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
    // rows arrive in ascending order, so a strict > keeps the smallest
    // object; the old best becomes a candidate for second
    t.s = fmaxf(t.s, t.b);
    t.b = pr;
    t.j = r;
    t.bv = v;
  } else {
    // a profit equal to best lands in second and never replaces the object
    t.s = fmaxf(t.s, pr);
  }
}

// The exact merge of two partial top-2s over disjoint object sets: equal
// profits go to the smaller object, and the loser's best is a candidate
// for second through min(b1, b2).
__device__ __forceinline__ void top2_merge(Top2& t, float b2, float s2,
                                           float bv2, int j2) {
  const bool keep = (t.b > b2) || (t.b == b2 && t.j <= j2);
  t.s = fmaxf(fminf(t.b, b2), fmaxf(t.s, s2));
  if (!keep) {
    t.b = b2;
    t.j = j2;
    t.bv = bv2;
  }
}

__global__ void __launch_bounds__(kThreads)
dense_round_kernel(const float* __restrict__ vals,
                   const float* __restrict__ prices,
                   const int32_t* __restrict__ p2o,
                   const int32_t* __restrict__ o2p,
                   const float* __restrict__ eps,
                   const unsigned char* __restrict__ done,
                   float* __restrict__ prices_out,
                   int32_t* __restrict__ p2o_out,
                   int32_t* __restrict__ o2p_out,
                   float* __restrict__ chosen_out,
                   float* __restrict__ maxp_out, int N, int M, int W) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = kThreads / W;   // row splits per person
  const int lane = tid % W;     // person lane
  const int split = tid / W;    // which share of the rows
  const float ninf = Traits<float>::neg_inf();

  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                              // [M]
  float* s_prices = reinterpret_cast<float*>(keys + M);         // [M]
  int32_t* s_p2o = reinterpret_cast<int32_t*>(s_prices + M);    // [N]
  int32_t* s_bestj = s_p2o + N;                                 // [N]
  float* sc_b = reinterpret_cast<float*>(s_bestj + N);          // [kThreads]
  float* sc_s = sc_b + kThreads;
  float* sc_bv = sc_s + kThreads;
  int32_t* sc_j = reinterpret_cast<int32_t*>(sc_bv + kThreads);

  const size_t pbase = static_cast<size_t>(b) * N;
  const size_t obase = static_cast<size_t>(b) * M;
  const float* inst = vals + static_cast<size_t>(b) * M * N;
  for (int j = tid; j < M; j += kThreads) {
    s_prices[j] = prices[obase + j];
    keys[j] = 0ull;
  }
  for (int i = tid; i < N; i += kThreads) {
    s_p2o[i] = p2o[pbase + i];
    s_bestj[i] = -1;
  }
  __syncthreads();

  const bool active = done[b] == 0;  // uniform over the CTA
  if (active) {
    const float e = eps[b];
    for (int u0 = 0; u0 < N; u0 += W) {
      const int u = u0 + lane;
      // A. this thread's share of the person's objects
      Top2 t = {ninf, ninf, ninf, kUnassigned};
      if (u < N) {
        const float* col = inst + u;
        int r = split;
        for (; r + (kUnroll - 1) * S < M; r += kUnroll * S) {
          float v[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            v[k] = col[static_cast<size_t>(r + k * S) * N];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            top2_push(t, v[k], s_prices[r + k * S], r + k * S);
        }
        for (; r < M; r += S)
          top2_push(t, col[static_cast<size_t>(r) * N], s_prices[r], r);
      }
      if (S > 1) {
        sc_b[tid] = t.b;
        sc_s[tid] = t.s;
        sc_bv[tid] = t.bv;
        sc_j[tid] = t.j;
        __syncthreads();
        if (split == 0) {
          for (int k = 1; k < S; ++k) {
            const int o = k * W + lane;
            top2_merge(t, sc_b[o], sc_s[o], sc_bv[o], sc_j[o]);
          }
        }
      }
      // B. the bid
      if (split == 0 && u < N && s_p2o[u] == kUnassigned && t.b != ninf) {
        const float bid = (t.s != ninf ? t.bv - t.s : t.bv - t.b) + e;
        s_bestj[u] = t.j;
        atomicMax(&keys[t.j], bid_key(bid, u));
      }
      if (S > 1) __syncthreads();  // the scratch is free for the next tile
    }
    __syncthreads();

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
    // C writes p2o and D writes prices, both only read the keys: no barrier
  }

  // D. objects: the winning bid becomes the price, the winner the owner
  for (int j = tid; j < M; j += kThreads) {
    const unsigned long long key = keys[j];
    int32_t owner = o2p[obase + j];
    if (key) {
      s_prices[j] = Traits<float>::unorder(static_cast<uint32_t>(key >> 32));
      owner = key_bidder(key);
    }
    prices_out[obase + j] = s_prices[j];
    o2p_out[obase + j] = owner;
  }
  __syncthreads();

  // E. the margins at the new prices
  for (int u0 = 0; u0 < N; u0 += W) {
    const int u = u0 + lane;
    float mx = ninf;
    if (u < N) {
      const float* col = inst + u;
      int r = split;
      for (; r + (kUnroll - 1) * S < M; r += kUnroll * S) {
        float v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          v[k] = col[static_cast<size_t>(r + k * S) * N];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          mx = fmaxf(mx, v[k] - s_prices[r + k * S]);
      }
      for (; r < M; r += S)
        mx = fmaxf(mx, col[static_cast<size_t>(r) * N] - s_prices[r]);
    }
    if (S > 1) {
      sc_b[tid] = mx;
      __syncthreads();
      if (split == 0)
        for (int k = 1; k < S; ++k) mx = fmaxf(mx, sc_b[k * W + lane]);
    }
    if (split == 0 && u < N) {
      const int32_t cur = s_p2o[u];
      maxp_out[pbase + u] = mx;
      chosen_out[pbase + u] =
          cur != kUnassigned
              ? inst[static_cast<size_t>(cur) * N + u] - s_prices[cur]
              : ninf;
      p2o_out[pbase + u] = cur;
    }
    if (S > 1) __syncthreads();
  }
}

// Shared memory one instance needs: 12 bytes per object, 8 per person and
// the 16 bytes per thread of the merge scratch
// (ops/dense_round.py:smem_bytes holds the wrapper to the same sum).
size_t smem_bytes(int N, int M) {
  return static_cast<size_t>(M) * (sizeof(unsigned long long) + sizeof(float)) +
         static_cast<size_t>(N) * 2 * sizeof(int32_t) +
         static_cast<size_t>(kThreads) * 4 * sizeof(float);
}

}  // namespace

// Pointers are device pointers of contiguous tensors: vals [B, M, N] float32,
// prices [B, M] float32, p2o [B, N] int32, o2p [B, M] int32, eps [B] float32,
// done [B] bytes (0 or 1); the five outputs prices_out [B, M], p2o_out
// [B, N], o2p_out [B, M], chosen_out [B, N] and maxp_out [B, N] are written,
// the inputs are not.  Returns the cudaError_t of the launch (0 on success).
extern "C" int slap_dense_round(const void* vals, const void* prices,
                                const void* p2o, const void* o2p,
                                const void* eps, const void* done,
                                void* prices_out, void* p2o_out,
                                void* o2p_out, void* chosen_out,
                                void* maxp_out, int B, int N, int M,
                                void* stream) {
  if (B <= 0) return 0;
  int W = 32;
  while (W < N && W < kThreads) W *= 2;
  const size_t smem = smem_bytes(N, M);
  cudaError_t err = cudaFuncSetAttribute(
      dense_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_round_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(prices),
      static_cast<const int32_t*>(p2o), static_cast<const int32_t*>(o2p),
      static_cast<const float*>(eps), static_cast<const unsigned char*>(done),
      static_cast<float*>(prices_out), static_cast<int32_t*>(p2o_out),
      static_cast<int32_t*>(o2p_out), static_cast<float*>(chosen_out),
      static_cast<float*>(maxp_out), N, M, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slap_dense_round_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

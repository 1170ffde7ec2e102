// The single-instance dense round of csrc/dense_round_single.cu in its
// other launch form: three stream-ordered launches (bid walk, merge and
// bid, margins) where the shipped kernel makes one cooperative launch
// with two grid barriers.  Kept to time the two forms against each other
// (tools/kernel_ab.py); the package never builds it.  The phases are the
// shipped file's own device functions (included below), so the two forms
// compute the same bits.
//
// Build (tools/kernel_ab.py does): nvcc with the package's flags and
// -I sparse_linear_assignment_tpu_torch/csrc.  The library exports the
// shipped entry point and slap_dense_round_single_stream, which takes
// the same arguments and accepts only phases = 7.

#include "dense_round_single.cu"

namespace {

__global__ void __launch_bounds__(kThreads) stream_walk(Args a) {
  __shared__ Smem sm;
  clear(a);
  walk_bids(a, read_done(a), blockIdx.x, sm);
}

__global__ void __launch_bounds__(kThreads) stream_bid(Args a) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i < a.N) place_bids(a, read_done(a), read_eps(a), i);
}

__global__ void __launch_bounds__(kThreads) stream_margins(Args a) {
  __shared__ Smem sm;
  margins(a, read_done(a), blockIdx.x, sm);
}

}  // namespace

extern "C" int slap_dense_round_single_stream(const void* ptr_table,
                                              float eps, int done, int M,
                                              int N, int W, int S, int T,
                                              int phases, void* stream) {
  if (phases != 7) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  cudaError_t err = make_args(a, ptr_table, eps, done, M, N, W, S, T);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stream_walk<<<S * T, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_bid<<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_margins<<<S * T, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

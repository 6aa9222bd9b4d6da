// Range stab counts (K5): for each of Q half-open queries [qs, qe), the
// number of N half-open intervals [s, e) it intersects, for Hopper (sm_90a).
//
//   count[q] = #{ i : s[i] < qe[q] && e[i] > qs[q] }
//
// Not a port of a TPU kernel: accord_tpu/ops/range_kernel.py::
// range_stab_counts is plain jnp, and XLA fuses its compare-and-reduce so
// the [Q, N] tile never reaches memory.  Plain PyTorch cannot fuse it (it
// writes a bool tile per compare), so the port computes the function here.
// The plain version is accord_tpu_torch/ops/range_kernel.py::
// range_stab_counts; the two are held == .
//
// Bound: operations.  The function tests every (interval, query) pair: two
// compares and a predicated add, 3 integer operations a pair, so 10^10
// pairs (the rangestress lane: 10^6 intervals, 10^4 queries) are 3*10^10
// operations, ~0.45 ms at 67 T op/s, while its bytes (8 N + 8 Q read, 4 Q
// written) take ~2.4 us.  A simple design for that:
//  * a block of 256 threads owns 2048 queries, 8 a thread, held in
//    registers with their 8 counts;
//  * the block walks a slice of the intervals in stages of 2048: the stage
//    is loaded once, coalesced, into shared memory as (s, e) pairs, and
//    every thread reads each pair as one 8-byte broadcast (all lanes one
//    address, no bank conflict) and tests it against its 8 queries;
//  * the grid is (query tiles) x (interval slices), sized to about eight
//    blocks an SM, so a short query axis still fills the card; each block
//    adds its partial count of each of its queries to the output with one
//    atomicAdd (skipped when 0), after the launch zeroes the output.
// Any Q >= 1 and N >= 0 are taken with no padding asked of the caller: the
// last stage is filled with (INT_MAX, INT_MIN), which no query hits, and
// query slots past Q are never written.  Integer counts make the atomics'
// order irrelevant: the result is exact.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueriesPerThread = 8;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kStage = 2048;           // intervals in shared memory at a time
constexpr int kBlocksPerSm = 8;        // the grid's target

__global__ void __launch_bounds__(kThreads)
range_stab_kernel(const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ends, long long N,
                  const int32_t* __restrict__ q_starts,
                  const int32_t* __restrict__ q_ends, int Q,
                  long long per_block, int32_t* __restrict__ counts) {
  __shared__ int2 stage[kStage];
  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kQueriesPerBlock;

  int qs[kQueriesPerThread], qe[kQueriesPerThread], c[kQueriesPerThread];
#pragma unroll
  for (int j = 0; j < kQueriesPerThread; ++j) {
    const long long q = q0 + j * kThreads + tid;  // coalesced across the warp
    // a slot past Q gets [INT_MAX, INT_MIN): no interval hits it
    qs[j] = q < Q ? q_starts[q] : INT_MAX;
    qe[j] = q < Q ? q_ends[q] : INT_MIN;
    c[j] = 0;
  }

  const long long lo = static_cast<long long>(blockIdx.y) * per_block;
  const long long hi = lo + per_block < N ? lo + per_block : N;
  for (long long base = lo; base < hi; base += kStage) {
    __syncthreads();  // the previous stage is consumed
    for (int i = tid; i < kStage; i += kThreads) {
      const long long g = base + i;
      stage[i] = g < hi ? make_int2(__ldg(starts + g), __ldg(ends + g))
                        : make_int2(INT_MAX, INT_MIN);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kStage; ++i) {
      const int2 v = stage[i];
#pragma unroll
      for (int j = 0; j < kQueriesPerThread; ++j)
        c[j] += (v.x < qe[j]) & (v.y > qs[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kQueriesPerThread; ++j) {
    const long long q = q0 + j * kThreads + tid;
    if (q < Q && c[j]) atomicAdd(counts + q, c[j]);
  }
}

}  // namespace

extern "C" {

// Zeroes counts and launches K5 on `stream`.  All pointers are device
// pointers to contiguous int32 arrays: starts, ends [N]; q_starts, q_ends,
// counts [Q].  Returns the cudaError_t of the first call that failed (0 on
// success).
int range_stab_launch(const void* starts, const void* ends, long long N,
                      const void* q_starts, const void* q_ends, int Q,
                      void* counts, void* stream) {
  if (Q <= 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * Q, s);
  if (err != cudaSuccess || N == 0) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long qtiles = (Q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const long long stages = (N + kStage - 1) / kStage;
  long long slices = (static_cast<long long>(kBlocksPerSm) * sms + qtiles - 1)
                     / qtiles;
  if (slices < 1) slices = 1;
  if (slices > stages) slices = stages;
  const long long stages_per_block = (stages + slices - 1) / slices;
  slices = (stages + stages_per_block - 1) / stages_per_block;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);

  const dim3 grid(static_cast<unsigned>(qtiles), static_cast<unsigned>(slices));
  range_stab_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      N, static_cast<const int32_t*>(q_starts),
      static_cast<const int32_t*>(q_ends), Q, stages_per_block * kStage,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

const char* range_stab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

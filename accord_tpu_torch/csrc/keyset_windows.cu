// Key-set windows (K4): the TPC-C replay's whole conflict window in one CTA,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accord_tpu/ops/pallas_kernels.py
// _keyset_windows_kernel (entry keyset_windows_pallas).  For each window of
// B write-only transactions, each row a set of P integer keys (negative =
// padding) and a rank (negative = padded row), it computes
//   edge(r, c) = rows r and c share a valid key
//                & 0 <= rank[c] < rank[r]          (c is earlier, both valid)
// and outputs the number of edges and the deepest execution wave of the
// window's DAG: the fixpoint of accord_tpu_torch/ops/wavefront.py, where
// iteration `it` gives wave `it` to every unassigned row whose deps were all
// assigned by the previous iterations; waves start at -1, the loop stops once
// every row is assigned or after iteration B, and the max is over all rows
// (padded rows have no edges and take wave 0).  The plain version is
// accord_tpu_torch/ops/keyset.py::keyset_windows; the two are held == .
//
// Grid: like the Pallas grid of reps*W steps, slot i resolves window
// (i + i / W) % W.  A persistent grid of resident CTAs walks the slots; two
// CTAs may resolve the same window at once (reps > 1), so all per-window
// scratch is indexed by the CTA, never by the window, and both write the
// same two output values.
//
// Bound: the inputs are B*(P+1) int32 a window (90 KB at B = 2048, P = 11)
// and the outputs two int32.  The function needs no more operations than a
// key-to-rows scan does (a few per key slot, pair of rows sharing a key and
// edge), so on sparse windows such as TPC-C's its bound is the bytes.  This
// kernel takes the dense formulation instead, a P x P key compare for every
// earlier pair: ~B*B/2 * P*P compares a window (2.5e8 at B = 2048), far
// above that bound; a sparse formulation is work for a later PR.  Design:
//  * the window's keys and ranks are staged once in dynamic shared memory
//    (negative keys rewritten to -2 there, and to -1 in the row's registers,
//    so a pad never equals anything and the compare needs no validity test);
//  * a thread owns a row, holds its P keys in registers and walks the
//    columns in order, so the lanes of a warp read the same column's keys:
//    a broadcast, no bank conflict.  A column is compared only when its rank
//    is valid and below the row's, which skips the later half of the pairs;
//    the P x P compare is fully unrolled (P is a template argument) into
//    predicate-accumulating integer compares;
//  * the row's bits are packed into 32-bit words as they are made and
//    stored column-major in the CTA's global scratch (word c of row r at
//    c * B + r, so a warp's rows hit consecutive words), with the row's
//    edge count in shared memory and its first and last non-zero word in
//    scratch: 2048 x 64 words = 512 KB a CTA at B = 2048, more than a
//    block's 227 KB of shared memory, L2-resident while the CTA uses it;
//  * the fixpoint is K2's (csrc/wavefront.cu): a row is ready when
//    popc(row & assigned) over its non-zero words equals its edge count;
//    `ready` is computed for every row from the previous iteration's
//    `assigned` bitset, then a barrier, then `assigned` is updated, so a
//    row never joins the wave of a dep assigned in the same iteration.  The
//    max wave is the last iteration that assigned a row;
//  * 512 threads and ~107 KB of shared memory at B = 2048 let two CTAs share
//    an SM, so one CTA's barrier-bound fixpoint overlaps another's compares.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// dynamic shared memory of one CTA: keys [B, P], ranks [B], edge counts
// [B], the assigned and newly-ready bitsets, two counters
size_t smem_bytes(int B, int P) {
  const size_t W = (static_cast<size_t>(B) + 31) / 32;
  return (static_cast<size_t>(B) * P + 2 * static_cast<size_t>(B) + 2 * W + 2)
      * sizeof(int32_t);
}

// global scratch words of one CTA: the packed matrix and each row's span
// of non-zero words
size_t scratch_words_per_cta(int B) {
  const size_t W = (static_cast<size_t>(B) + 31) / 32;
  return static_cast<size_t>(B) * W + B;
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
keyset_windows_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ rank, int n_windows, int B,
                      int slots, uint32_t* __restrict__ scratch,
                      int32_t* __restrict__ edges,
                      int32_t* __restrict__ max_wave) {
  extern __shared__ int32_t smem[];
  const int W = (B + 31) / 32;
  int32_t* skeys = smem;
  int32_t* srank = skeys + static_cast<size_t>(B) * P;
  int32_t* total = srank + B;
  uint32_t* assigned = reinterpret_cast<uint32_t*>(total + B);
  uint32_t* newly = assigned + W;
  int* n_assigned = reinterpret_cast<int*>(newly + W);
  int* n_edges = n_assigned + 1;

  const size_t per_cta = static_cast<size_t>(B) * W + B;
  uint32_t* bits = scratch + blockIdx.x * per_cta;
  uint32_t* span = bits + static_cast<size_t>(B) * W;

  const int tid = threadIdx.x;

  for (int slot = blockIdx.x; slot < slots; slot += gridDim.x) {
    const int w = (slot + slot / n_windows) % n_windows;
    const int32_t* wkeys = keys + static_cast<size_t>(w) * B * P;
    const int32_t* wrank = rank + static_cast<size_t>(w) * B;
    for (int i = tid; i < B * P; i += blockDim.x) {
      const int32_t k = wkeys[i];
      skeys[i] = k < 0 ? -2 : k;
    }
    for (int r = tid; r < B; r += blockDim.x) srank[r] = wrank[r];
    for (int c = tid; c < W; c += blockDim.x) {
      assigned[c] = 0;
      newly[c] = 0;
    }
    if (tid == 0) {
      *n_assigned = 0;
      *n_edges = 0;
    }
    __syncthreads();

    // ---- the edges of each row, packed to bits
    int my_edges = 0;
    for (int r = tid; r < B; r += blockDim.x) {
      const int32_t rr = srank[r];
      int32_t rk[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int32_t k = skeys[r * P + i];
        rk[i] = k < 0 ? -1 : k;
      }
      int t = 0, lo = W, hi = 0;
      for (int cw = 0; cw < W; ++cw) {
        uint32_t word = 0;
        if (rr >= 0) {
          const int n = min(32, B - cw * 32);
          for (int j = 0; j < n; ++j) {
            const int c = cw * 32 + j;
            const int32_t rc = srank[c];
            if (rc >= 0 && rc < rr) {
              const int32_t* ck = skeys + c * P;
              bool hit = false;
#pragma unroll
              for (int jj = 0; jj < P; ++jj) {
                const int32_t k = ck[jj];
#pragma unroll
                for (int i = 0; i < P; ++i) hit |= (rk[i] == k);
              }
              if (hit) word |= 1u << j;
            }
          }
        }
        bits[static_cast<size_t>(cw) * B + r] = word;
        if (word) {
          t += __popc(word);
          lo = min(lo, cw);
          hi = cw;
        }
      }
      total[r] = t;
      span[r] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
      my_edges += t;
    }
    my_edges = __reduce_add_sync(0xffffffffu, my_edges);
    if ((tid & 31) == 0) atomicAdd(n_edges, my_edges);
    __syncthreads();

    // ---- the wave fixpoint
    int last_wave = -1;
    int prev_done = 0;
    for (int it = 0; it <= B; ++it) {
      for (int r = tid; r < B; r += blockDim.x) {
        if ((assigned[r >> 5] >> (r & 31)) & 1u) continue;
        const int t = total[r];
        int done = 0;
        if (t > 0) {
          const uint32_t sp = span[r];
          const int hi = static_cast<int>(sp >> 16);
          for (int c = static_cast<int>(sp & 0xffffu); c <= hi; ++c) {
            const uint32_t a = assigned[c];
            if (a) done += __popc(bits[static_cast<size_t>(c) * B + r] & a);
          }
        }
        if (done == t) {
          atomicOr(&newly[r >> 5], 1u << (r & 31));
          atomicAdd(n_assigned, 1);
        }
      }
      __syncthreads();
      // read before the next iteration's atomicAdds can start
      const int n_done = *n_assigned;
      if (n_done > prev_done) last_wave = it;
      prev_done = n_done;
      for (int c = tid; c < W; c += blockDim.x) {
        assigned[c] |= newly[c];
        newly[c] = 0;
      }
      __syncthreads();
      if (n_done >= B) break;
    }
    if (tid == 0) {
      edges[w] = *n_edges;
      max_wave[w] = last_wave;
    }
    __syncthreads();
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, int, int, int,
                          uint32_t*, int32_t*, int32_t*);

// Only the P its callers use is instantiated: 11, the TPC-C new-order key
// set (a district and 10 stock keys).  Another P needs its own line here.
KernelFn kernel_for(int P) {
  return P == 11 ? keyset_windows_kernel<11> : nullptr;
}

}  // namespace

extern "C" {

// Sizes the launch for `slots` = reps * W grid slots of B-row windows with P
// keys a row (P == 11, B <= 65535): *grid is the number of CTAs (0
// when a window does not fit in the block's shared memory) and
// *scratch_words the int32 words of global scratch they need.  Returns the cudaError_t of the queries (0 on success).
int keyset_windows_plan(int P, int B, int slots, int* grid,
                        long long* scratch_words) {
  *grid = 0;
  *scratch_words = 0;
  KernelFn fn = kernel_for(P);
  if (fn == nullptr || B <= 0 || B > 65535 || slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(B, P);
  if (bytes > static_cast<size_t>(optin)) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(resident < slots ? resident : slots);
  *scratch_words = static_cast<long long>(*grid) * scratch_words_per_cta(B);
  return 0;
}

// Launches K4 on `stream`: keys int32 [W, B, P] and rank int32 [W, B] are
// contiguous device arrays, edges and max_wave int32 [W] the outputs,
// `scratch` the buffer of keyset_windows_plan for this `grid`.  Returns the
// cudaError_t of the launch (0 on success).
int keyset_windows_launch(const void* keys, const void* rank, int n_windows,
                          int B, int P, int slots, int grid, void* scratch,
                          void* edges, void* max_wave, void* stream) {
  KernelFn fn = kernel_for(P);
  if (fn == nullptr || n_windows <= 0 || B <= 0 || slots <= 0 || grid <= 0 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(B, P);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(rank),
      n_windows, B, slots, static_cast<uint32_t*>(scratch),
      static_cast<int32_t*>(edges), static_cast<int32_t*>(max_wave));
  return static_cast<int>(cudaGetLastError());
}

const char* keyset_windows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

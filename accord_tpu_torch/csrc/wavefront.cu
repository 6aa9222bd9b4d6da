// Wavefront (K2): Kahn layering of one window's conflict DAG, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel accord_tpu/ops/pallas_kernels.py
// _waves_kernel (entry execution_waves_pallas).  Given dep[B, B] (b depends
// on b'), it computes wave[b] = 0 for rows without deps and
// 1 + max(wave[deps(b)]) otherwise, as the fixpoint of
// accord_tpu/ops/wavefront.py does: iteration `it` assigns wave `it` to every
// unassigned row whose deps were all assigned by the previous iterations;
// waves start at -1, so a row on or behind a cycle keeps -1.  The plain
// version is accord_tpu_torch/ops/wavefront.py::execution_waves; the two are
// held == for every input.
//
// Bound: the bytes are B*B once (256 KB at B = 512) and the operations a
// few million, so the card could do it in well under a microsecond; what
// bounds this kernel is its chain of dependent steps, each ending in a
// block-wide barrier.  Design for that: one CTA of 1024 threads, two paths
// in one launch.
//  1. Rank order.  The window's conflict graph comes from conflict_edges,
//     so every edge points to a strictly lower rank.  With the optional
//     txn_rank the rows are put in rank order ((rank, row) pairs sorted by a
//     bitonic network; rows already in order are only checked), ties kept in
//     row order.  Without it the rows keep their order.
//  2. Packing.  The matrix is packed into bits in that order, column-major
//     with a row stride of S = B + 1 words (word c of position p at
//     c * S + p, so a warp's consecutive positions hit consecutive words,
//     and the 16 words of one row land in 16 different banks).  When B is a
//     multiple of 32 the lanes of a warp read consecutive 16-byte chunks of
//     a row (the lone CTA pulls the whole matrix through one SM, so its loads
//     must touch as few cache lines as they can) and lane pairs join their
//     16-bit halves by a shuffle; otherwise a warp ballot makes each word; a
//     scatter by atomicOr places the bits when the order is permuted.  The
//     bits live in dynamic shared memory where they fit (B <= 1312 on an
//     H100) and in a global scratch buffer (L2-resident) above, so every B is
//     taken.  While packing, each set bit is checked to point to an earlier
//     position (__syncthreads_or).
//  3a. Forward pass, when every bit does: the matrix is strictly lower
//     triangular, so the wave is the longest path, which one blocked forward
//     substitution in the (max, +) semiring computes over tiles of 32
//     positions.  Warp 0 settles a tile's 32x32 diagonal block by shuffles
//     (position j's value is final once every earlier position of the tile
//     has been folded in, so the steps run in order, over the columns that
//     hold a bit), then all threads fold the settled tile into every later
//     position: a max over the set bits of one word a position, against the
//     tile's 32 waves held in registers (predicated, so a dense word costs
//     no more than a sparse one and no load waits on another).  Warp 0
//     folds the next tile's own positions, so it settles that tile without
//     waiting: one block barrier a tile, ceil(B/32) in all, whatever the
//     depth.
//  3b. Fixpoint, when a bit does not (any dep_bb conflict_edges did not
//     make, cycles included, and a call without txn_rank whose rows are not
//     in triangular order): the Kahn iteration, on the same bits.  A row is
//     ready when its bits & ~assigned are empty (ORed over its words with no
//     early exit, so the loads overlap); `assigned` is
//     double-buffered (iteration it reads one bitset and ORs it, and the
//     rows it assigns, into the other), so an iteration has one barrier
//     (__syncthreads_or of "assigned a row"), and the loop stops at the first
//     iteration that assigns none: nothing changes after it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// 32-bit words of the bits region: the packed matrix ([W] rows of stride
// B + 1), which first holds the rank-sort buffer (u64 [B]); a multiple of
// four, so the arrays after it stay 16-byte aligned
__host__ __device__ inline size_t bits_words(int B) {
  const size_t W = (static_cast<size_t>(B) + 31) / 32;
  const size_t words = (static_cast<size_t>(B) + 1) * W;
  const size_t sort = 2 * static_cast<size_t>(B);
  return ((words > sort ? words : sort) + 3) & ~static_cast<size_t>(3);
}

// 32-bit words of the whole working set: the bits region, then the waves by
// position, position -> row, row -> position ([B] each), then the two
// `assigned` bitsets of the fixpoint ([W] each)
size_t region_words(int B) {
  const size_t W = (static_cast<size_t>(B) + 31) / 32;
  return bits_words(B) + 3 * static_cast<size_t>(B) + 2 * W;
}

__device__ __forceinline__ void compare_swap(uint64_t* a, int i, int j) {
  const uint64_t x = a[i], y = a[j];
  if (y < x) {
    a[i] = y;
    a[j] = x;
  }
}

// Sorts a[0, n) ascending, the whole block taking part: the bitonic network
// for the next power of two m >= n with every pair ascending (each merge
// stage k starts with the flip i <-> i ^ (k-1), then the strides k/4, ...,
// 1).  a[n, m) would be +inf and never move, so pairs reaching past n are
// skipped.
__device__ void bitonic_sort(uint64_t* a, int n) {
  int m = 1;
  while (m < n) m <<= 1;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = threadIdx.x; c < (m >> 1); c += blockDim.x) {
        const int base = (c & ~(j - 1)) << 1, off = c & (j - 1);
        const int i = base + off;
        const int partner = j == k >> 1 ? base + k - 1 - off : i + j;
        if (partner < n) compare_swap(a, i, partner);
      }
      __syncthreads();
    }
  }
}

// 16 bool bytes -> 16 bits (byte i -> bit i)
__device__ __forceinline__ uint32_t pack16(uint4 q) {
  auto nib = [](uint32_t x) {
    x = __vcmpne4(x, 0u) & 0x01010101u;
    return (x * 0x01020408u) >> 24;
  };
  return nib(q.x) | nib(q.y) << 4 | nib(q.z) << 8 | nib(q.w) << 12;
}

// Stores word c of row r (columns 32c .. 32c+31) in rank order, rows of
// stride S.  -> whether one of its bits points to a position that is not
// earlier than the row's.
__device__ __forceinline__ bool emit(uint32_t* bits, size_t S, bool permuted,
                                     const int* inv, int r, int c,
                                     uint32_t word) {
  if (!permuted) {
    bits[c * S + r] = word;
    const int lo = r - 32 * c;  // the columns >= r are bits lo and above
    return lo <= 0 ? word != 0 : (lo < 32 && (word >> lo) != 0);
  }
  const int p = inv[r];
  bool bad = false;
  while (word) {
    const int q = inv[32 * c + __ffs(word) - 1];
    word &= word - 1;
    atomicOr(bits + (q >> 5) * S + p, 1u << (q & 31));
    bad |= q >= p;
  }
  return bad;
}

// Warp 0 settles tile t: position 32t + lane, all of whose deps in earlier
// tiles are folded into wv already
__device__ __forceinline__ void settle_tile(const uint32_t* bits, size_t S,
                                            int* wv, int B, int t, int lane) {
  const int p = 32 * t + lane;
  const bool ok = p < B;
  const uint32_t d = ok ? bits[t * S + p] : 0u;
  int v = ok ? wv[p] : 0;
  const uint32_t cols = __reduce_or_sync(kFull, d);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if ((cols >> j) & 1u) {
      const int x = __shfl_sync(kFull, v, j);
      if ((d >> j) & 1u) v = max(v, x + 1);
    }
  }
  if (ok) wv[p] = v;
}

__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const uint8_t* __restrict__ dep,
                 const int32_t* __restrict__ rank, int B,
                 uint32_t* scratch, int in_smem,
                 int32_t* __restrict__ wave, int32_t* __restrict__ stats) {
  extern __shared__ uint32_t smem[];
  uint32_t* base = in_smem ? smem : scratch;
  const int W = (B + 31) / 32;
  const size_t S = static_cast<size_t>(B) + 1;  // the bits' row stride
  uint32_t* bits = base;
  int* wv = reinterpret_cast<int*>(base + bits_words(B));
  int* order = wv + B;  // position -> row
  int* inv = order + B;  // row -> position
  uint32_t* assigned = reinterpret_cast<uint32_t*>(inv + B);  // [2][W]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t n_words = S * W;

  // ---- 1. rank order
  bool permuted = false;
  if (rank != nullptr) {
    int unsorted = 0;
    for (int r = tid + 1; r < B; r += blockDim.x) unsorted |= rank[r - 1] > rank[r];
    permuted = __syncthreads_or(unsorted) != 0;
  }
  if (permuted) {
    uint64_t* pairs = reinterpret_cast<uint64_t*>(bits);
    for (int r = tid; r < B; r += blockDim.x)
      pairs[r] = static_cast<uint64_t>(static_cast<uint32_t>(rank[r]) ^ 0x80000000u) << 32
          | static_cast<uint32_t>(r);
    __syncthreads();
    bitonic_sort(pairs, B);
    for (int p = tid; p < B; p += blockDim.x) {
      const int r = static_cast<int>(static_cast<uint32_t>(pairs[p]));
      order[p] = r;
      inv[r] = p;
    }
    __syncthreads();
    for (size_t i = tid; i < n_words; i += blockDim.x) bits[i] = 0;
    __syncthreads();
  }

  // ---- 2. packing, and the triangular check
  bool bad = false;
  if ((B & 31) == 0 && (reinterpret_cast<uintptr_t>(dep) & 15) == 0) {
    // chunk g: 16 bytes q = g % (B/16) of row r = g / (B/16); a warp reads
    // 512 contiguous bytes, and the even lane of each pair stores the word.
    // B/16 is even and the chunk count a multiple of 64, so a pair never
    // straddles two rows and a warp is always whole in the loop
    constexpr int kBatch = 4;
    const int per_row = B / 16;
    const size_t n_chunks = static_cast<size_t>(B) * per_row;
    for (size_t g0 = tid; g0 < n_chunks; g0 += kBatch * blockDim.x) {
      uint4 q[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const size_t g = g0 + static_cast<size_t>(k) * blockDim.x;
        if (g < n_chunks) q[k] = __ldg(reinterpret_cast<const uint4*>(dep) + g);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const size_t g = g0 + static_cast<size_t>(k) * blockDim.x;
        if (g < n_chunks) {  // uniform over the warp
          const uint32_t half = pack16(q[k]);
          const uint32_t word = half | __shfl_down_sync(kFull, half, 1) << 16;
          if ((lane & 1) == 0)
            bad |= emit(bits, S, permuted, inv, static_cast<int>(g / per_row),
                        static_cast<int>(g % per_row) / 2, word);
        }
      }
    }
  } else {
    for (size_t i = warp; i < static_cast<size_t>(B) * W; i += n_warps) {
      const int r = static_cast<int>(i / W);
      const int c = static_cast<int>(i % W);
      const int col = c * 32 + lane;
      const bool v = col < B && dep[static_cast<size_t>(r) * B + col] != 0;
      const uint32_t word = __ballot_sync(kFull, v);
      if (lane == 0) bad |= emit(bits, S, permuted, inv, r, c, word);
    }
  }
  bad = __syncthreads_or(bad) != 0;

  int steps = 0;
  if (!bad) {
    // ---- 3a. forward pass over tiles of 32 positions
    for (int p = tid; p < B; p += blockDim.x) wv[p] = 0;
    __syncthreads();
    if (warp == 0) settle_tile(bits, S, wv, B, 0, lane);
    for (int t = 0; t < W; ++t) {
      __syncthreads();  // tile t is settled
      // the settled tile's waves + 1 (past B: any value, no bit selects it)
      int settled[32];
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const int4 x = *reinterpret_cast<const int4*>(wv + 32 * t + j);
        settled[j] = x.x + 1;
        settled[j + 1] = x.y + 1;
        settled[j + 2] = x.z + 1;
        settled[j + 3] = x.w + 1;
      }
      for (int p = 32 * (t + 1) + tid; p < B; p += blockDim.x) {
        const uint32_t d = bits[t * S + p];
        if (d) {
          int m = wv[p];
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if ((d >> j) & 1u) m = max(m, settled[j]);
          wv[p] = m;
        }
      }
      // warp 0 folded tile t + 1's own positions just now
      if (warp == 0 && t + 1 < W) {
        __syncwarp();
        settle_tile(bits, S, wv, B, t + 1, lane);
      }
    }
    steps = W;
  } else {
    // ---- 3b. the fixpoint
    for (int p = tid; p < B; p += blockDim.x) wv[p] = -1;
    for (int c = tid; c < 2 * W; c += blockDim.x) assigned[c] = 0;
    __syncthreads();
    for (int it = 0; it <= B; ++it) {
      const uint32_t* cur = assigned + (it & 1) * W;
      uint32_t* next = assigned + ((it + 1) & 1) * W;
      int newly = 0;
      for (int p = tid; p < B; p += blockDim.x) {
        if ((cur[p >> 5] >> (p & 31)) & 1u) continue;
        uint32_t pending = 0;  // the row's deps not yet assigned
#pragma unroll 8
        for (int c = 0; c < W; ++c) pending |= bits[c * S + p] & ~cur[c];
        if (pending == 0) {
          wv[p] = it;
          atomicOr(next + (p >> 5), 1u << (p & 31));
          newly = 1;
        }
      }
      // `next` held iteration it-1's input, a subset of `cur`
      for (int c = tid; c < W; c += blockDim.x) atomicOr(next + c, cur[c]);
      ++steps;
      if (!__syncthreads_or(newly)) break;
    }
  }

  for (int p = tid; p < B; p += blockDim.x) wave[permuted ? order[p] : p] = wv[p];
  if (stats != nullptr && tid == 0) {
    stats[0] = bad ? 0 : 1;
    stats[1] = permuted ? 1 : 0;
    stats[2] = steps;
  }
}

bool fits_in_smem(int B) {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return false;
  return region_words(B) * sizeof(uint32_t) <= static_cast<size_t>(optin);
}

}  // namespace

extern "C" {

// The int32 words of global scratch a launch on a B-row window needs: 0 when
// its working set fits the block's shared memory on the current card.
long long wavefront_scratch_words(int B) {
  return fits_in_smem(B) ? 0 : static_cast<long long>(region_words(B));
}

// Launches K2 on `stream`: dep uint8 [B, B] and wave int32 [B] are
// contiguous device arrays; rank (may be null) int32 [B] orders the rows;
// `scratch` holds wavefront_scratch_words(B) words (ignored when that is 0);
// `stats` (may be null) int32 [3] receives 1 for the forward pass (0 for the
// fixpoint), 1 when the ranks were sorted, and the chain's steps (tiles, or
// fixpoint iterations).  Returns the cudaError_t of the launch (0 on
// success).
int wavefront_launch(const void* dep, const void* rank, int B, void* scratch,
                     void* wave, void* stats, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = fits_in_smem(B);
  if (!in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = in_smem ? region_words(B) * sizeof(uint32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wavefront_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dep), static_cast<const int32_t*>(rank), B,
      static_cast<uint32_t*>(scratch), in_smem ? 1 : 0,
      static_cast<int32_t*>(wave), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

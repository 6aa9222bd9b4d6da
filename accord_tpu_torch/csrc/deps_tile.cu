// Deps tile (K1): the [B, E] dependency mask of one flush window, and its
// per-row edge counts, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accord_tpu/ops/pallas_kernels.py
// _deps_kernel (entry batched_active_deps_pallas).  The function is
//   dep[b, e] = touches[b, key(e)] & rank(e) < rank(b)
//             & (witness_mask(b) >> kind(e)) & 1
//             & active(e) & ~(committed(e) & eat(e) < succ_w(e) < rank(b))
//   count[b]  = sum_e dep[b, e]
// with succ_w computed before the launch (plain torch), as the JAX package
// computes it outside Pallas.  The plain version is
// accord_tpu_torch/ops/deps_kernel.py::deps_tile; the two are held == .
//
// Bound: memory.  The output is B*E bytes (66 MB for the 512 x 128,768
// window of the default benchmark world) against ~3.6 MB of inputs, so the
// kernel is a write stream.  Design for that, in two launches:
//  * the TPU kernel rode the MXU with a one-hot bf16 matmul to avoid a slow
//    dynamic gather.  Here the first launch packs touches into bits,
//    transposed: word tbits[w, k] holds touches[32w .. 32w+31, k].  It also
//    zeroes the counts;
//  * the tile's block owns 32 txn rows (one w) and 4096 entries, 16 a
//    thread.  For each entry it builds, once, the 32-bit mask of the block's
//    rows that take it as a dep: the touch word (ONE load for all 32 rows),
//    ANDed with the rows whose witness mask holds the entry's kind (a table
//    of 32 words in shared memory) and with the rows whose rank lies in
//    (rank(e), hi(e)], hi(e) = succ_w(e) when e is elidable and INT_MAX
//    otherwise.  The rank term is all the rows or none of them when
//    (rank(e), hi(e)] holds every row rank of the block or none, as on the
//    benchmark world; only other entries compare the 32 ranks one by one;
//  * each row's 16 mask bytes are then cut out of the 16 masks by a shift
//    and byte permutes and written as ONE 16-byte streaming store, so a warp
//    writes 512 contiguous bytes of a row;
//  * the row counts stay in registers: one warp reduction a row
//    (__reduce_add_sync, a single instruction) leaves the warp's count of
//    row i in lane i, and one shared and one global integer atomic a
//    (warp, row) and (block, row) sum them.  (A 32-entry count array a
//    thread does not stay in registers under the 64-register cap below: it
//    goes to local memory, which cost a third of the tile's time on the
//    H100.);
//  * at most 64 registers a thread, so four blocks fit an SM: the default
//    window's 512 blocks then run in one wave on 132 SMs, not in a full wave
//    and a partial one.
// Any E, B and K are taken: a row whose start is 16-byte aligned is written
// as 16-byte stores, one that is 8-byte aligned (E a multiple of 8, as the
// sharded encoder pads it) as pairs of 8-byte stores, any other byte by
// byte; the packed touches live in a global scratch buffer of
// ceil(B/32) * K words that the wrapper allocates.
//
// The shard axis (accord_tpu/ops/sharded.py::make_sharded_step, where each
// device of the mesh runs the tile on its key block and the counts are
// psum'd): S shards in ONE packing launch and ONE tile launch.  Touches are
// [B, S*Ks] (shard s owns columns [s*Ks, (s+1)*Ks)), the entry arrays
// [S, Es] with local key indices, the mask [S, B, Es].  The tile's grid adds
// the shard as its z axis: an entry of shard s reads the packed word at
// column s*Ks + key and writes plane s; every shard's row counts go to the
// one count[B], which is the psum.  The flat window is the case S = 1.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntriesPerThread = 16;
constexpr int kEntriesPerBlock = kThreads * kEntriesPerThread;
constexpr int kRowsPerBlock = 32;  // one 32-bit word of packed touches
constexpr int kPackThreads = 256;

// InternalStatus bands (accord_tpu_torch/local/cfk.py)
constexpr int kTransitivelyKnown = 0;
constexpr int kCommitted = 4;
constexpr int kApplied = 6;
constexpr int kInactive = 7;

// tbits[w * K + k] bit i = touches[32w + i, k] (0 past row B); the first
// block of each row group zeroes that group's counts
__global__ void __launch_bounds__(kPackThreads)
pack_touches_kernel(const uint8_t* __restrict__ touches, int B, int K,
                    uint32_t* __restrict__ tbits, int32_t* __restrict__ count) {
  const int k = blockIdx.x * kPackThreads + threadIdx.x;
  const int w = blockIdx.y;
  const int rows = min(32, B - 32 * w);
  if (blockIdx.x == 0 && threadIdx.x < rows) count[32 * w + threadIdx.x] = 0;
  if (k >= K) return;
  const uint8_t* col = touches + static_cast<size_t>(32 * w) * K + k;
  uint32_t word = 0;
  for (int i = 0; i < rows; ++i)
    word |= static_cast<uint32_t>(col[static_cast<size_t>(i) * K] != 0) << i;
  tbits[static_cast<size_t>(w) * K + k] = word;
}

// v = p[e .. e+3], 0 past E; one 16-byte load where it is aligned
__device__ __forceinline__ void load4(const int32_t* __restrict__ p, int e,
                                      int E, int (&v)[4]) {
  if (e + 4 <= E && (reinterpret_cast<uintptr_t>(p + e) & 15) == 0) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + e));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = e + j < E ? p[e + j] : 0;
  }
}

// bytes 0..3 of the result: bit i of a, b, c, d (in bit 0 of each byte)
__device__ __forceinline__ uint32_t row_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d, int i) {
  const uint32_t lo = __byte_perm(a >> i, b >> i, 0x0040);
  const uint32_t hi = __byte_perm(c >> i, d >> i, 0x0040);
  return __byte_perm(lo, hi, 0x5410) & 0x01010101u;
}

// kStacked: more than one shard (blockIdx.z picks it); a flat window has
// none of the shard offsets.  kRows16: every row starts on a 16-byte
// boundary (E a multiple of 16, as the flat encoder pads it), so each is
// written as 16-byte stores alone; otherwise each row's alignment picks
// its stores
template <bool kStacked, bool kRows16>
__global__ void __launch_bounds__(kThreads, 4)
deps_tile_kernel(const uint32_t* __restrict__ tbits, int K, int Ks,
                 const int32_t* __restrict__ entry_key,
                 const int32_t* __restrict__ entry_rank,
                 const int32_t* __restrict__ entry_eat,
                 const int32_t* __restrict__ entry_status,
                 const int32_t* __restrict__ entry_kind,
                 const int32_t* __restrict__ succ_w,
                 const int32_t* __restrict__ txn_rank,
                 const int32_t* __restrict__ txn_wit,
                 int B, int E,
                 uint8_t* __restrict__ dep, int32_t* __restrict__ count) {
  __shared__ int row_rank[kRowsPerBlock];
  __shared__ uint32_t witnesses[32];  // kind -> the rows witnessing it
  __shared__ int row_count[kRowsPerBlock];
  __shared__ int rank_lo, rank_hi;    // the block's least and largest row rank
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int e0 = (blockIdx.x * kThreads + tid) * kEntriesPerThread;
  const int b0 = blockIdx.y * kRowsPerBlock;
  // shard s: its entries, its key block's packed words and its mask plane
  const uint32_t* __restrict__ tcol =
      tbits + static_cast<size_t>(blockIdx.y) * K;
  if (kStacked) {
    const size_t shard = blockIdx.z;
    entry_key += shard * E;
    entry_rank += shard * E;
    entry_eat += shard * E;
    entry_status += shard * E;
    entry_kind += shard * E;
    succ_w += shard * E;
    tcol += shard * Ks;
    dep += shard * B * static_cast<size_t>(E);
  }
  const int rows = min(kRowsPerBlock, B - b0);
  const uint32_t all_rows = rows == 32 ? 0xffffffffu : (1u << rows) - 1;

  if (tid < 32) {
    // warp 0: the rows' ranks, their range, and the witness table
    const int tr = tid < rows ? txn_rank[b0 + tid] : 0;
    const int tw = tid < rows ? txn_wit[b0 + tid] : 0;
    row_rank[tid] = tr;
    row_count[tid] = 0;
    const int lo = __reduce_min_sync(0xffffffffu, tid < rows ? tr : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, tid < rows ? tr : INT_MIN);
    if (tid == 0) {
      rank_lo = lo;
      rank_hi = hi;
    }
    uint32_t rows_of_kind = 0;  // lane = kind
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int wi = __shfl_sync(0xffffffffu, tw, i);
      rows_of_kind |= static_cast<uint32_t>((wi >> tid) & 1) << i;
    }
    witnesses[tid] = rows_of_kind & all_rows;
  }
  __syncthreads();
  const int lo_all = rank_lo, hi_all = rank_hi;

  // each entry's 32-bit mask of the block's rows that take it as a dep,
  // four entries at a time from 16-byte loads
  uint32_t mask[kEntriesPerThread];
#pragma unroll
  for (int g = 0; g < kEntriesPerThread; g += 4) {
    int key[4], st[4], rank[4], kind[4], succ[4], eat[4];
    load4(entry_key, e0 + g, E, key);
    load4(entry_status, e0 + g, E, st);
    load4(entry_rank, e0 + g, E, rank);
    load4(entry_kind, e0 + g, E, kind);
    load4(succ_w, e0 + g, E, succ);
    load4(entry_eat, e0 + g, E, eat);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mask[g + j] = 0;
      const bool live = e0 + g + j < E && rank[j] >= 0
          && st[j] > kTransitivelyKnown && st[j] != kInactive && key[j] >= 0
          && key[j] < Ks && static_cast<unsigned>(kind[j]) < 32u;
      if (!live) continue;
      const bool elidable = st[j] >= kCommitted && st[j] <= kApplied
          && succ[j] > eat[j];
      const int hi = elidable ? succ[j] : INT_MAX;  // dep iff rank < tr <= hi
      uint32_t in_range;
      if (rank[j] < lo_all && hi >= hi_all) {
        in_range = all_rows;
      } else if (rank[j] >= hi_all || hi < lo_all) {
        in_range = 0;
      } else {
        in_range = 0;
        for (int i = 0; i < rows; ++i) {
          const int tr = row_rank[i];
          in_range |= static_cast<uint32_t>(rank[j] < tr && tr <= hi) << i;
        }
      }
      if (in_range)
        mask[g + j] = in_range & witnesses[kind[j]]
            & tcol[key[j]];
    }
  }

  const bool full = e0 + kEntriesPerThread <= E;
  int my_row = 0;  // lane i: the warp's count of row i
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    int n = 0;
    if (i < rows && e0 < E) {
      const uint32_t w0 = row_bytes(mask[0], mask[1], mask[2], mask[3], i);
      const uint32_t w1 = row_bytes(mask[4], mask[5], mask[6], mask[7], i);
      const uint32_t w2 = row_bytes(mask[8], mask[9], mask[10], mask[11], i);
      const uint32_t w3 = row_bytes(mask[12], mask[13], mask[14], mask[15], i);
      n = static_cast<int>(((w0 + w1 + w2 + w3) * 0x01010101u) >> 24);
      uint8_t* out = dep + static_cast<size_t>(b0 + i) * E + e0;
      // a row's alignment is the same for the warp's 32 lanes (e0 steps by
      // 16), so each branch is taken by the whole warp
      const unsigned align = reinterpret_cast<uintptr_t>(out) & 15u;
      if (kRows16 || (full && align == 0)) {
        __stcs(reinterpret_cast<uint4*>(out), make_uint4(w0, w1, w2, w3));
      } else if (full && align == 8) {
        __stcs(reinterpret_cast<uint2*>(out), make_uint2(w0, w1));
        __stcs(reinterpret_cast<uint2*>(out + 8), make_uint2(w2, w3));
      } else {
        for (int j = 0; j < kEntriesPerThread && e0 + j < E; ++j) {
          const uint32_t w = j < 4 ? w0 : j < 8 ? w1 : j < 12 ? w2 : w3;
          out[j] = static_cast<uint8_t>((w >> (8 * (j & 3))) & 1u);
        }
      }
    }
    n = __reduce_add_sync(0xffffffffu, n);  // every lane, past E too
    if (lane == i) my_row = n;
  }
  if (my_row) atomicAdd(&row_count[lane], my_row);
  __syncthreads();
  if (tid < rows && row_count[tid]) atomicAdd(&count[b0 + tid], row_count[tid]);
}

}  // namespace

extern "C" {

// Launches the packing pass (which also zeroes count) when phases & 1 and
// the tile when phases & 2, on `stream`, for S shards of Ks keys and E
// entries each (S = 1 for a flat window).  All pointers are device pointers
// to contiguous arrays: touches uint8 [B, S*Ks]; the six entry arrays int32
// [S, E] (keys local to their shard); txn_rank and txn_wit int32 [B];
// scratch uint32 [ceil(B/32) * S*Ks]; dep uint8 [S, B, E]; count int32 [B],
// summed over the shards.  The tile alone (phases 2) needs the scratch and
// zeroed counts of an earlier packing pass.  Returns the cudaError_t of the
// first launch that failed (0 on success).
int deps_tile_launch(const void* touches, int S, int Ks, const void* entry_key,
                     const void* entry_rank, const void* entry_eat,
                     const void* entry_status, const void* entry_kind,
                     const void* succ_w, const void* txn_rank,
                     const void* txn_wit, int B, int E, void* scratch,
                     void* dep, void* count, int phases, void* stream) {
  if (B <= 0 || E <= 0 || S <= 0 || Ks <= 0 || S > INT_MAX / Ks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = S * Ks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned words = (static_cast<unsigned>(B) + 31) / 32;
  if (words > 65535u || S > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (phases & 1) {
    const dim3 pack_grid((K + kPackThreads - 1) / kPackThreads, words);
    pack_touches_kernel<<<pack_grid, kPackThreads, 0, s>>>(
        static_cast<const uint8_t*>(touches), B, K,
        static_cast<uint32_t*>(scratch), static_cast<int32_t*>(count));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 2) {
    const dim3 grid((E + kEntriesPerBlock - 1) / kEntriesPerBlock, words, S);
    const bool rows16 = E % 16 == 0
        && (reinterpret_cast<uintptr_t>(dep) & 15) == 0;
    auto* kernel = S > 1 ? (rows16 ? deps_tile_kernel<true, true>
                                   : deps_tile_kernel<true, false>)
                         : (rows16 ? deps_tile_kernel<false, true>
                                   : deps_tile_kernel<false, false>);
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(scratch), K, Ks,
        static_cast<const int32_t*>(entry_key),
        static_cast<const int32_t*>(entry_rank),
        static_cast<const int32_t*>(entry_eat),
        static_cast<const int32_t*>(entry_status),
        static_cast<const int32_t*>(entry_kind),
        static_cast<const int32_t*>(succ_w),
        static_cast<const int32_t*>(txn_rank),
        static_cast<const int32_t*>(txn_wit), B, E,
        static_cast<uint8_t*>(dep), static_cast<int32_t*>(count));
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

const char* deps_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

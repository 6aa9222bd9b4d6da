// Key-set windows (K4): the TPC-C replay's conflict windows as a sparse
// key-to-rows kernel for Hopper (sm_90a), one CTA a window.
//
// Replaces the Pallas TPU kernel accord_tpu/ops/pallas_kernels.py
// _keyset_windows_kernel (:240, entry keyset_windows_pallas :282).  Each
// window holds B rows; a row is a set of P int32 keys (negative = padding)
// and an int32 rank (negative = padded row).  With
//   edge(r, c) = r and c share a key >= 0 and 0 <= rank[c] < rank[r]
// the kernel writes, for each window, the number of distinct edges and the
// deepest Kahn layer of that DAG (padded rows and rows without deps are in
// wave 0).  Ranks may tie (tied rows are not edges); keys may be unsorted,
// repeated inside a row and as large as 2^31-1.  The plain version is
// accord_tpu_torch/ops/keyset.py::keyset_windows; the two are held == .
//
// Bound: the inputs are read once, B*(P+1) int32 a window, and two int32 are
// written: 48,074,568 bytes on the full TPC-C replay, 0.0144 ms at 3.35 TB/s.
// The function needs only a key-to-rows scan's operations (a few per key
// slot, per pair of rows sharing a key and per edge; about 1.5e7 on that
// replay), so its bound is the bytes.  The kernel does work only where rows
// share a key; it never compares every pair of rows.  Design:
//  1. Rank order.  The window's (rank, row) pairs are sorted in shared
//     memory (a window already in rank order, as the replay's are, is only
//     checked).  Each valid row gets its position `pos` in rank order and
//     `gstart`, the first position of its rank group (tied ranks form one
//     group).
//  2. Shared keys.  A thread per position sorts its row's keys in registers
//     (a 16-wide sorting network) and drops duplicates and negatives; a
//     padded row keeps none.  Every kept key goes into a hash table in
//     shared memory (open addressing, one word a key, its top bit set once
//     a second row holds it; the key 2^31-1, which would fill a word, has a
//     counter of its own).  A key no other row holds can make no edge and
//     no dep, so each row keeps, in global scratch by position, only the
//     sorted list of its shared keys.  On TPC-C that drops ~90% of the
//     22,528 key slots of a window: the stock keys are mostly unique.
//  3. The index.  Each kept key becomes one 64-bit slot
//       key << 32 | pos << 16 | gstart
//     in shared memory (below 2^63, so it never equals the sentinel ~0),
//     appended at a warp-scanned offset, and the slots are sorted: a
//     bitonic network padded to a power of two with +inf that never moves,
//     its steps of stride >= 64 through shared memory with a barrier each,
//     those below 64 in registers with warp shuffles (two elements a lane).
//     Each key's rows are then one contiguous run, in rank order.
//  4. The edges.  A thread per slot finds the start of its key's run and of
//     its rank group in the run by binary search.  The rows before the group
//     are the earlier-ranked rows on that key.  A pair is counted on key k
//     only when k is the smallest key the two rows share (their lists
//     merged, at most 2P compares), so each pair counts once.  Integer
//     atomics sum the counts, which do not depend on their order.
//  5. The waves.  On each key, the deps that can set a row's wave are the
//     rows of the immediately lower rank group in the run: every earlier row
//     on the key is a dep of that group too, so it has a smaller wave.  Each
//     slot keeps that group's slot range in place of its key.  Waves start
//     at 0; a sweep over the slots sets wave[pos] to 1 + the largest wave in
//     the range where that is larger, in place (a value only rises, and only
//     towards the longest path, so the fixpoint is the same in any order).
//     The loop stops after a sweep that changed nothing (__syncthreads_or):
//     at most max wave + 1 sweeps.  Waves are 16 bits in shared memory,
//     raised by compare-and-swap on their 32-bit word.
// Shared memory holds, in turn, the rank pairs, the hash table (the largest
// power of two of words <= 2*B*P, more than the keys it can hold) and the
// slots, in 8*B*P bytes, beside the waves: 180 KB at B*P = 22,528, so one
// 1024-thread CTA an SM.  Range: 1 <= P <= 16 and B*P <= 22,528 (then
// B < 2^16 fits the slot's fields).
//
// Larger windows (P > 16, or B*P above what one block's shared memory holds,
// up to kMaxGlobalSlots) take a second kernel, keyset_windows_global_kernel:
// the same function, one 1024-thread CTA a window, with every array in
// per-window global scratch (L2-resident at these sizes) and 32-bit fields
// throughout.  It is written to be right, not fast: it has no hash filter
// and no P-wide register arrays.  Every valid (rank position, key) pair of
// the window is one 64-bit word pos << 32 | key; their bitonic sort, run
// over the scratch with the same network as above, puts each row's keys in
// order and its repeats side by side, so a block-wide compaction keeps each
// row's distinct keys (the row lists).  The index is the same pairs as
// key << 32 | pos, sorted again; the edges (a merge of two row lists up to
// the run's key) and the waves (32-bit, raised by atomicMax) are those of
// steps 4 and 5, the predecessor ranges kept in an array of their own.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxP = 16;
constexpr int kMaxSlots = 22528;
constexpr uint64_t kSentinel = ~0ull;
constexpr uint32_t kNoKey = 0xffffffffu;
constexpr uint64_t kKeyMask = 0xffffffff00000000ull;
constexpr uint32_t kTopKey = 0x7fffffffu;  // 2^31 - 1
constexpr uint32_t kShared = 0x80000000u;  // a hash word's "second row" bit

// dynamic shared memory of one CTA: the slots [B*P] u64 (first the rank
// pairs, then the hash table), the waves [B] u16 (two a word), five counters
size_t smem_bytes(int B, int P) {
  return static_cast<size_t>(B) * P * sizeof(uint64_t) +
         ((static_cast<size_t>(B) + 1) / 2 + 5) * sizeof(uint32_t);
}

__device__ __forceinline__ void compare_swap(uint64_t* a, int i, int j) {
  const uint64_t x = a[i], y = a[j];
  if (y < x) {
    a[i] = y;
    a[j] = x;
  }
}

// the lane's register against the same register of lane ^ mask; the lower
// index keeps the minimum
__device__ __forceinline__ uint64_t exchange(uint64_t x, int mask, bool lower) {
  const uint64_t y = __shfl_xor_sync(0xffffffffu, x, mask);
  return lower ? min(x, y) : max(x, y);
}

// The steps of stride < 64 of merge stage k (all of it when k <= 64) on a
// 64-element chunk held by one warp: lane l holds elements l (x0) and
// 32 + l (x1).
__device__ __forceinline__ void low_steps(uint64_t& x0, uint64_t& x1,
                                          int lane, int k) {
  int j;
  if (k >= 128) {  // stride 32: the lane's own pair
    const uint64_t lo = min(x0, x1);
    x1 = max(x0, x1);
    x0 = lo;
    j = 16;
  } else if (k == 64) {  // the flip t <-> 63 - t: x0 of l with x1 of l ^ 31
    const uint64_t y1 = __shfl_xor_sync(0xffffffffu, x1, 31);
    const uint64_t y0 = __shfl_xor_sync(0xffffffffu, x0, 31);
    x0 = min(x0, y1);
    x1 = max(x1, y0);
    j = 16;
  } else {  // the flip t <-> t ^ (k-1) inside each half
    const bool lower = (lane & (k >> 1)) == 0;
    x0 = exchange(x0, k - 1, lower);
    x1 = exchange(x1, k - 1, lower);
    j = k >> 2;
  }
  for (; j > 0; j >>= 1) {
    const bool lower = (lane & j) == 0;
    x0 = exchange(x0, j, lower);
    x1 = exchange(x1, j, lower);
  }
}

// merge stages k_first..k_last (k_last <= 64), or stage k_first's strides
// below 64 (k_first >= 128), on every 64-element chunk, in registers
__device__ void register_pass(uint64_t* a, int n, int m, int k_first,
                              int k_last) {
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 64; base < m;
       base += (blockDim.x >> 5) * 64) {
    if (base >= n) break;
    const int i0 = base + lane, i1 = i0 + 32;
    uint64_t x0 = i0 < n ? a[i0] : kSentinel;
    uint64_t x1 = i1 < n ? a[i1] : kSentinel;
    for (int k = k_first; k <= k_last; k <<= 1) low_steps(x0, x1, lane, k);
    if (i0 < n) a[i0] = x0;
    if (i1 < n) a[i1] = x1;
  }
  __syncthreads();
}

// Sorts a[0, n) ascending, the whole block taking part: the bitonic network
// for the next power of two m >= max(n, 64) with every pair ascending (each
// merge stage k starts with the flip i <-> i ^ (k-1), then the strides k/4,
// ..., 1).  a[n, m) would be +inf and never move: a pair's lower index gets
// the minimum, so pairs reaching past n are skipped.  Strides >= 64 run in
// shared memory, the rest in registers.  An input already sorted is only
// checked.
__device__ void bitonic_sort(uint64_t* a, int n) {
  bool sorted = true;
  for (int i = threadIdx.x + 1; i < n; i += blockDim.x)
    sorted &= a[i - 1] <= a[i];
  if (__syncthreads_and(sorted)) return;
  int m = 64;
  while (m < n) m <<= 1;
  register_pass(a, n, m, 2, 64);
  for (int k = 128; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int c = threadIdx.x; c < (m >> 1); c += blockDim.x) {
        const int base = (c & ~(j - 1)) << 1, off = c & (j - 1);
        const int i = base + off;
        const int partner = j == k >> 1 ? base + k - 1 - off : i + j;
        if (partner < n) compare_swap(a, i, partner);
      }
      __syncthreads();
    }
    register_pass(a, n, m, k, k);
  }
}

// sorts 16 values in registers (static indices only)
__device__ __forceinline__ void sort16(uint32_t (&v)[kMaxP]) {
#pragma unroll
  for (int k = 2; k <= kMaxP; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kMaxP; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const uint32_t a = v[i], b = v[l];
          const bool up = (i & k) == 0;
          v[i] = up ? min(a, b) : max(a, b);
          v[l] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// the first index in [lo, hi) whose value is >= x, or hi
__device__ __forceinline__ int lower_bound(const uint64_t* a, int lo, int hi,
                                           uint64_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// wave[p] = max(wave[p], w) on 16-bit waves packed two a word; -> raised
__device__ __forceinline__ bool raise_wave(uint32_t* wave2, int p, uint32_t w) {
  uint32_t* word = wave2 + (p >> 1);
  const int shift = (p & 1) * 16;
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  for (;;) {
    if (((old >> shift) & 0xffffu) >= w) return false;
    const uint32_t want = (old & ~(0xffffu << shift)) | (w << shift);
    const uint32_t seen = atomicCAS(word, old, want);
    if (seen == old) return true;
    old = seen;
  }
}

__device__ __forceinline__ int slot_pos(uint64_t v) {
  return static_cast<int>(static_cast<uint32_t>(v) >> 16);
}

// where the probe for `key` starts: the top log_t bits of a multiplicative hash
__device__ __forceinline__ uint32_t probe_start(uint32_t key, int log_t) {
  return (key * 0x9e3779b1u) >> (32 - log_t);
}

// enters `key` (< 2^31 - 1) in the table, or marks it shared when a row put
// it there before
__device__ void table_insert(uint32_t* table, int log_t, uint32_t key) {
  const uint32_t mask = (1u << log_t) - 1;
  for (uint32_t h = probe_start(key, log_t);; h = (h + 1) & mask) {
    uint32_t cur = *reinterpret_cast<volatile uint32_t*>(table + h);
    if (cur == kNoKey) {
      cur = atomicCAS(table + h, kNoKey, key);
      if (cur == kNoKey) return;
    }
    if ((cur & ~kShared) == key) {
      if (!(cur & kShared)) atomicOr(table + h, kShared);
      return;
    }
  }
}

// whether a second row holds `key`, which is in the table
__device__ bool table_shared(const uint32_t* table, int log_t, uint32_t key) {
  const uint32_t mask = (1u << log_t) - 1;
  for (uint32_t h = probe_start(key, log_t);; h = (h + 1) & mask) {
    const uint32_t cur = table[h];
    if ((cur & ~kShared) == key) return (cur & kShared) != 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
keyset_windows_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ rank, int B, int P,
                      uint32_t* __restrict__ scratch,
                      int32_t* __restrict__ edges,
                      int32_t* __restrict__ max_wave,
                      int32_t* __restrict__ stats) {
  extern __shared__ uint64_t slot[];
  const int N = B * P;
  uint32_t* wave2 = reinterpret_cast<uint32_t*>(slot + N);
  const volatile uint16_t* wave = reinterpret_cast<uint16_t*>(wave2);
  // edges, max wave, pair checks, slots in the index, rows holding 2^31-1
  int* counter = reinterpret_cast<int*>(wave2 + (B + 1) / 2);

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int32_t* wkeys = keys + static_cast<size_t>(w) * N;
  const int32_t* wrank = rank + static_cast<size_t>(w) * B;
  // the shared-key lists by position [B, P], then one word a slot
  uint32_t* canon = scratch + static_cast<size_t>(w) * 2 * N;
  uint32_t* aux = canon + N;

  // ---- 1. rank order: position p -> row | gstart << 16 (kNoKey: none)
  for (int r = tid; r < B; r += blockDim.x) {
    const int32_t rr = wrank[r];
    slot[r] = rr >= 0 ? (static_cast<uint64_t>(rr) << 32 | static_cast<uint32_t>(r))
                      : kSentinel;
  }
  if (tid < 5) counter[tid] = 0;
  __syncthreads();
  bitonic_sort(slot, B);
  for (int p = tid; p < B; p += blockDim.x) {
    const uint64_t v = slot[p];
    aux[p] = v == kSentinel
                 ? kNoKey
                 : static_cast<uint32_t>(v) |
                       static_cast<uint32_t>(lower_bound(slot, 0, p, v & kKeyMask)) << 16;
  }
  __syncthreads();

  // ---- 2. each row's keys, and which of them a second row holds
  uint32_t* table = reinterpret_cast<uint32_t*>(slot);
  const int log_t = 31 - __clz(2 * N);
  for (int i = tid; i < (1 << log_t); i += blockDim.x) table[i] = kNoKey;
  __syncthreads();
  for (int p = tid; p < B; p += blockDim.x) {
    const uint32_t rg = aux[p];
    uint32_t k[kMaxP];
    const int32_t* rk = wkeys + static_cast<size_t>(rg & 0xffffu) * P;
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) {
      const int32_t x = (rg != kNoKey && i < P) ? rk[i] : -1;
      k[i] = x < 0 ? kNoKey : static_cast<uint32_t>(x);
    }
    sort16(k);
    uint32_t prev = kNoKey;
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) {
      const uint32_t x = k[i];
      if (x == prev) {
        k[i] = kNoKey;  // a repeat: a hole, closed below
      } else {
        prev = x;
        if (x == kTopKey)
          atomicAdd(&counter[4], 1);
        else if (x != kNoKey)
          table_insert(table, log_t, x);
      }
    }
    uint32_t* mine = canon + static_cast<size_t>(p) * P;
#pragma unroll
    for (int i = 0; i < kMaxP; ++i)
      if (i < P) mine[i] = k[i];
  }
  __syncthreads();
  // keep each row's shared keys, in order, and reserve their slots
  const bool top_shared = counter[4] > 1;
  uint16_t* first = reinterpret_cast<uint16_t*>(wave2);  // a row's first slot
  for (int p0 = 0; p0 < B; p0 += blockDim.x) {
    const int p = p0 + tid;
    uint32_t* mine = canon + static_cast<size_t>(p) * P;
    uint32_t k[kMaxP];
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) k[i] = (p < B && i < P) ? mine[i] : kNoKey;
    int n = 0;
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) {
      if (k[i] != kNoKey &&
          !(k[i] == kTopKey ? top_shared : table_shared(table, log_t, k[i])))
        k[i] = kNoKey;
      n += k[i] != kNoKey;
    }
    sort16(k);
#pragma unroll
    for (int i = 0; i < kMaxP; ++i)
      if (p < B && i < P) mine[i] = k[i];
    int end = n;  // inclusive scan over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += y;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(&counter[3], end);
    base = __shfl_sync(0xffffffffu, base, 31) + end - n;
    if (p < B) first[p] = static_cast<uint16_t>(base);
  }
  __syncthreads();

  // ---- 3. the index: a slot for each shared key of each row, by key, then
  // by rank
  for (int p = tid; p < B; p += blockDim.x) {
    const uint32_t* mine = canon + static_cast<size_t>(p) * P;
    uint32_t k[kMaxP];
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) k[i] = i < P ? mine[i] : kNoKey;
    uint64_t* row_slots = slot + first[p];
    first[p] = 0;  // from here on, the wave of position p
    const uint64_t low = static_cast<uint32_t>(p) << 16 | (aux[p] >> 16);
#pragma unroll
    for (int i = 0; i < kMaxP; ++i)
      if (k[i] != kNoKey) row_slots[i] = static_cast<uint64_t>(k[i]) << 32 | low;
  }
  __syncthreads();
  const int M = counter[3];
  bitonic_sort(slot, M);

  // ---- 4. the edges, and each slot's predecessor range lo | hi << 16
  int my_edges = 0, my_checks = 0;
  for (int s = tid; s < M; s += blockDim.x) {
    const uint64_t v = slot[s];
    aux[s] = 0;
    const uint64_t run = v & kKeyMask;
    if (s == 0 || (slot[s - 1] & kKeyMask) != run) continue;  // first on key
    const uint32_t key = static_cast<uint32_t>(v >> 32);
    const int start = lower_bound(slot, 0, s, run);
    const int group = lower_bound(slot, start, s, run | (v & 0xffffu) << 16);
    if (group == start) continue;                 // no earlier rank on key
    uint32_t mine[kMaxP];
    const uint32_t* mk = canon + static_cast<size_t>(slot_pos(v)) * P;
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) mine[i] = i < P ? mk[i] : kNoKey;
    for (int t = start; t < group; ++t) {
      const uint32_t* theirs = canon + static_cast<size_t>(slot_pos(slot[t])) * P;
      bool lower = false;
      for (int i = 0; i < P && !lower; ++i) {
        const uint32_t x = theirs[i];
        if (x >= key) break;  // sorted lists: no smaller key left to share
#pragma unroll
        for (int q = 0; q < kMaxP; ++q) lower |= mine[q] == x;
      }
      my_edges += !lower;
    }
    my_checks += group - start;
    const uint64_t below = slot[group - 1];
    const int lo = lower_bound(slot, start, group - 1, run | (below & 0xffffu) << 16);
    aux[s] = static_cast<uint32_t>(lo) | static_cast<uint32_t>(group) << 16;
  }
  my_edges = __reduce_add_sync(0xffffffffu, my_edges);
  my_checks = __reduce_add_sync(0xffffffffu, my_checks);
  if ((tid & 31) == 0) {
    atomicAdd(&counter[0], my_edges);
    atomicAdd(&counter[2], my_checks);
  }
  __syncthreads();
  // the key is no longer needed: the slot keeps its range in its place
  for (int s = tid; s < M; s += blockDim.x)
    slot[s] = static_cast<uint64_t>(aux[s]) << 32 | static_cast<uint32_t>(slot[s]);
  __syncthreads();

  // ---- 5. the waves, swept to their fixpoint
  int sweeps = 0;
  for (;;) {
    int changed = 0;
    for (int s = tid; s < M; s += blockDim.x) {
      const uint64_t v = slot[s];
      const int lo = static_cast<int>((v >> 32) & 0xffffu);
      const int hi = static_cast<int>(v >> 48);
      if (lo >= hi) continue;
      int m = 0;
      for (int t = lo; t < hi; ++t) m = max(m, static_cast<int>(wave[slot_pos(slot[t])]));
      changed |= raise_wave(wave2, slot_pos(v), static_cast<uint32_t>(m + 1));
    }
    ++sweeps;
    if (!__syncthreads_or(changed)) break;
  }

  int my_max = 0;
  for (int p = tid; p < B; p += blockDim.x) my_max = max(my_max, static_cast<int>(wave[p]));
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  if ((tid & 31) == 0) atomicMax(&counter[1], my_max);
  __syncthreads();
  if (tid == 0) {
    edges[w] = counter[0];
    max_wave[w] = counter[1];
    if (stats != nullptr) {
      stats[3 * w] = counter[3];
      stats[3 * w + 1] = counter[2];
      stats[3 * w + 2] = sweeps;
    }
  }
}

// ---- the large-window path: every array in global scratch ----

constexpr int kMaxGlobalSlots = 1 << 22;

// uint32 words of global scratch one window of the large-window path needs:
// three u64 arrays of N = B*P (the pairs, then the index; the row lists; the
// predecessor ranges) and four u32 arrays of B (+1), rounded up to keep the
// next window's u64 arrays aligned
__host__ __device__ inline long long global_words(int B, int P) {
  const long long n = static_cast<long long>(B) * P;
  return (6 * n + 4LL * B + 2) & ~1LL;
}

// Keeps the distinct non-sentinel values of the sorted a[0, n) in order,
// written to out; the whole block takes part.  -> how many were kept.
// `warp_sums` is kThreads/32 + 1 ints of shared memory.
__device__ int compact_distinct(const uint64_t* a, int n, uint64_t* out,
                                int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int mine = 0;
  for (int i = lo; i < hi; ++i) {
    const uint64_t v = a[i];
    mine += v != kSentinel && (i == 0 || a[i - 1] != v);
  }
  int incl = mine;  // inclusive scan over the warp, then over the warps
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive over the warps
    if (lane == n_warps - 1) warp_sums[32] = s;
  }
  __syncthreads();
  int o = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - mine;
  for (int i = lo; i < hi; ++i) {
    const uint64_t v = a[i];
    if (v != kSentinel && (i == 0 || a[i - 1] != v)) out[o++] = v;
  }
  const int total = warp_sums[32];
  __syncthreads();
  return total;
}

// whether the sorted row lists [i, i_end) and [j, j_end) of `lists` (keys in
// the low 32 bits) share a key below `key`
__device__ __forceinline__ bool share_below(const uint64_t* lists, int i,
                                            int i_end, int j, int j_end,
                                            uint32_t key) {
  while (i < i_end && j < j_end) {
    const uint32_t x = static_cast<uint32_t>(lists[i]);
    const uint32_t y = static_cast<uint32_t>(lists[j]);
    if (x >= key || y >= key) return false;
    if (x == y) return true;
    if (x < y)
      ++i;
    else
      ++j;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
keyset_windows_global_kernel(const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ rank, int B, int P,
                             uint32_t* __restrict__ scratch,
                             int32_t* __restrict__ edges,
                             int32_t* __restrict__ max_wave,
                             int32_t* __restrict__ stats) {
  __shared__ int warp_sums[kThreads / 32 + 1];
  __shared__ int counter[3];  // edges, max wave, pair checks
  const int N = B * P;
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* wkeys = keys + static_cast<size_t>(w) * N;
  const int32_t* wrank = rank + static_cast<size_t>(w) * B;
  uint64_t* a = reinterpret_cast<uint64_t*>(
      scratch + static_cast<size_t>(w) * global_words(B, P));
  uint64_t* lists = a + N;    // distinct pos << 32 | key, by position
  uint64_t* range = a + 2 * static_cast<size_t>(N);  // lo << 32 | hi a slot
  uint32_t* row_of = reinterpret_cast<uint32_t*>(a + 3 * static_cast<size_t>(N));
  uint32_t* gstart = row_of + B;
  uint32_t* first = gstart + B;  // [B + 1]: a position's first list entry
  uint32_t* wave = first + B + 1;
  volatile uint32_t* vwave = wave;

  // ---- 1. rank order: position -> row, and its rank group's start
  for (int r = tid; r < B; r += blockDim.x) {
    const int32_t rr = wrank[r];
    a[r] = rr >= 0 ? (static_cast<uint64_t>(rr) << 32 | static_cast<uint32_t>(r))
                   : kSentinel;
  }
  if (tid < 3) counter[tid] = 0;
  __syncthreads();
  bitonic_sort(a, B);
  for (int p = tid; p < B; p += blockDim.x) {
    const uint64_t v = a[p];
    row_of[p] = v == kSentinel ? kNoKey : static_cast<uint32_t>(v);
    gstart[p] = static_cast<uint32_t>(lower_bound(a, 0, p, v & kKeyMask));
  }
  __syncthreads();

  // ---- 2. the row lists: each valid row's distinct keys, in order
  for (int i = tid; i < N; i += blockDim.x) {
    const int p = i / P;
    const uint32_t row = row_of[p];
    const int32_t key = row == kNoKey ? -1 : wkeys[static_cast<size_t>(row) * P + i % P];
    a[i] = key >= 0 ? (static_cast<uint64_t>(p) << 32 | static_cast<uint32_t>(key))
                    : kSentinel;
  }
  __syncthreads();
  bitonic_sort(a, N);
  const int M = compact_distinct(a, N, lists, warp_sums);
  for (int p = tid; p <= B; p += blockDim.x) {
    first[p] = static_cast<uint32_t>(
        lower_bound(lists, 0, M, static_cast<uint64_t>(p) << 32));
    if (p < B) wave[p] = 0;
  }

  // ---- 3. the index: each list entry as key << 32 | pos, by key, then rank
  for (int i = tid; i < M; i += blockDim.x) {
    const uint64_t v = lists[i];
    a[i] = (v << 32) | (v >> 32);
  }
  __syncthreads();
  bitonic_sort(a, M);

  // ---- 4. the edges, and each slot's predecessor range
  int my_edges = 0, my_checks = 0;
  for (int s = tid; s < M; s += blockDim.x) {
    const uint64_t v = a[s];
    range[s] = 0;
    const uint64_t run = v & kKeyMask;
    if (s == 0 || (a[s - 1] & kKeyMask) != run) continue;  // first on key
    const uint32_t pos = static_cast<uint32_t>(v);
    const int start = lower_bound(a, 0, s, run);
    const int group = lower_bound(a, start, s, run | gstart[pos]);
    if (group == start) continue;  // no earlier rank on key
    const uint32_t key = static_cast<uint32_t>(v >> 32);
    for (int t = start; t < group; ++t) {
      const uint32_t q = static_cast<uint32_t>(a[t]);
      my_edges += !share_below(lists, first[pos], first[pos + 1], first[q],
                               first[q + 1], key);
    }
    my_checks += group - start;
    const uint32_t below = static_cast<uint32_t>(a[group - 1]);
    const int lo = lower_bound(a, start, group - 1, run | gstart[below]);
    range[s] = static_cast<uint64_t>(lo) << 32 | static_cast<uint32_t>(group);
  }
  my_edges = __reduce_add_sync(0xffffffffu, my_edges);
  my_checks = __reduce_add_sync(0xffffffffu, my_checks);
  if ((tid & 31) == 0) {
    atomicAdd(&counter[0], my_edges);
    atomicAdd(&counter[2], my_checks);
  }
  __syncthreads();

  // ---- 5. the waves, swept to their fixpoint
  int sweeps = 0;
  for (;;) {
    int changed = 0;
    for (int s = tid; s < M; s += blockDim.x) {
      const uint64_t r = range[s];
      const int lo = static_cast<int>(r >> 32), hi = static_cast<int>(r & 0xffffffffu);
      if (lo >= hi) continue;
      uint32_t m = 0;
      for (int t = lo; t < hi; ++t)
        m = max(m, vwave[static_cast<uint32_t>(a[t])]);
      const uint32_t pos = static_cast<uint32_t>(a[s]);
      if (vwave[pos] < m + 1) {
        atomicMax(wave + pos, m + 1);
        changed = 1;
      }
    }
    ++sweeps;
    if (!__syncthreads_or(changed)) break;
  }

  int my_max = 0;
  for (int p = tid; p < B; p += blockDim.x) my_max = max(my_max, static_cast<int>(vwave[p]));
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  if ((tid & 31) == 0) atomicMax(&counter[1], my_max);
  __syncthreads();
  if (tid == 0) {
    edges[w] = counter[0];
    max_wave[w] = counter[1];
    if (stats != nullptr) {
      stats[3 * w] = M;
      stats[3 * w + 1] = counter[2];
      stats[3 * w + 2] = sweeps;
    }
  }
}

// 1 when a window of B rows of P keys takes the shared-memory kernel, 0 when
// it takes the large-window kernel, -1 when K4 does not take it
int choose_path(int B, int P, int optin) {
  if (P < 1 || B < 1 || static_cast<long long>(B) * P > kMaxGlobalSlots) return -1;
  if (P <= kMaxP && B <= kMaxSlots / P &&
      smem_bytes(B, P) <= static_cast<size_t>(optin))
    return 1;
  return 0;
}

cudaError_t smem_optin(int* optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  return err;
}

}  // namespace

extern "C" {

// Plans K4 for windows of B rows of P keys on the current card: *in_smem is
// 1 when they take the shared-memory kernel (1 <= P <= 16, B*P <= 22,528 and
// the slots fit one block's shared memory) and 0 when they take the
// large-window kernel (any P >= 1, B*P <= 2^22); *scratch_words is the
// uint32 words of global scratch one window needs.  Returns
// cudaErrorInvalidValue outside the range, else the cudaError_t of the
// queries (0 on success).
int keyset_windows_plan(int P, int B, long long* scratch_words, int* in_smem) {
  *scratch_words = 0;
  *in_smem = 0;
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int path = choose_path(B, P, optin);
  if (path < 0) return static_cast<int>(cudaErrorInvalidValue);
  *in_smem = path;
  *scratch_words = path ? 2LL * B * P : global_words(B, P);
  return 0;
}

// Launches K4 on `stream`, one CTA a window, on the path keyset_windows_plan
// names: keys int32 [W, B, P] and rank int32 [W, B] are contiguous device
// arrays, edges and max_wave int32 [W] the outputs, `scratch` W times
// keyset_windows_plan's words, and `stats` (may be null) int32 [W, 3]: the
// slots in each window's index (the shared-memory kernel indexes its rows'
// shared keys, the large-window kernel every distinct key of a valid row),
// its pair checks and its wave sweeps.  Returns the cudaError_t of the
// launch.
int keyset_windows_launch(const void* keys, const void* rank, int n_windows,
                          int B, int P, void* scratch, void* edges,
                          void* max_wave, void* stats, void* stream) {
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int path = choose_path(B, P, optin);
  if (path < 0 || n_windows <= 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    keyset_windows_global_kernel<<<n_windows, kThreads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(rank), B,
        P, static_cast<uint32_t*>(scratch), static_cast<int32_t*>(edges),
        static_cast<int32_t*>(max_wave), static_cast<int32_t*>(stats));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = smem_bytes(B, P);
  err = cudaFuncSetAttribute(
      keyset_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  keyset_windows_kernel<<<n_windows, kThreads, bytes, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(rank), B,
      P, static_cast<uint32_t*>(scratch), static_cast<int32_t*>(edges),
      static_cast<int32_t*>(max_wave), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* keyset_windows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// range_stab_counts; the two are held == .  The same module's
// stab_counts_by_query_index is this algorithm in plain torch.
//
// Bound: bytes.  The function reads 8 N + 8 Q bytes and writes 4 Q; on the
// rangestress lane (10^6 intervals, 10^4 queries) that is 2.4 us at
// 3.35 TB/s.  Testing every pair is 3 integer operations a pair, 3*10^10
// on that lane, 1.8 ms at the int32 rate.  The function needs far fewer,
// by an identity that holds for every input:
//
//   count(q) = F(q) + C(q),   F(q) = #{s < qe} - #{e <= qs},
//                             C(q) = #{s >= qe and e <= qs}.
//
// F is two one-sided counts; C has pairs only where e <= qs <= qe <= s for
// a query with qs <= qe, so only intervals with s >= e (inverted, or empty
// like the store's [0, 0) pads) and inverted queries (qs > qe) take part.
// Q is small and N large, so the queries are indexed, not the intervals,
// in tiles of up to 12,288 queries, in four steps:
//  1. sort, two launches.  A block per 1024 queries of a tile and per
//     bound sorts their (qe, index) or (qs, index) pairs, packed into one
//     64-bit key (sign bit flipped), with a bitonic network in registers
//     (warp shuffles below a distance of 32, shared memory above); it also
//     zeroes the counts, the tile's histograms and the two list counters.
//     Then each chunk's element finds its place in the tile by adding its
//     ranks in the tile's other chunks (binary searches in shared memory;
//     ties go to the earlier chunk, so the order is by (bound, index)),
//     and further blocks fill the tile's bucket tables: tab[b] = #{bounds
//     whose bucket is below b}, 2048 buckets over the tile's bound range.
//     (One block sorting a whole tile in shared memory would be bound by
//     that one SM's shared-memory bandwidth.)
//  2. stream: a grid of (query tiles) x (interval slices), one block of
//     1024 threads an SM, loads its tile's sorted qe and qs and their
//     tables into shared memory and streams its slice of the intervals
//     once, four a thread (16-byte loads).  Each interval's rank among the
//     sorted qe (#{qe <= s}) and qs (#{qs < e}) is a search of the few
//     bounds in its bucket (a full binary search over 12,288 bounds put
//     the probes of every lane on one shared-memory bank), and adds one to
//     that bin of two shared-memory histograms; a warp whose 32 lanes hit
//     one bin adds 32 once, so a hot bin costs no more than a spread one.
//     The block then adds its non-zero bins to the tile's global
//     histograms.  The blocks of tile 0 also list the intervals with
//     s >= e, counted on the device;
//  3. combine: 17 blocks a tile.  Sixteen take the inclusive prefix sum of
//     one histogram, which is #{s < qe} or #{e <= qs} at each sorted
//     position, and add it to (or subtract it from) the counts of an
//     eighth of the positions' queries through the sort order; the atomics
//     leave from 16 SMs, not 2.  The last lists the inverted queries;
//  4. correct: a pairwise kernel, on a fixed grid that reads the two
//     lists' lengths on the device (no host sync), adds C for the listed
//     intervals against the queries with qs <= qe and for every interval
//     against the listed queries.  On the rangestress data both lists are
//     empty; the store pads at most 127 of each.
// Every launch after the first is a programmatic dependent launch: it may
// start while the one before it drains and waits for it on the device
// (the stream's first intervals are loaded before that wait).  What bounds
// K5 now is latency, not bytes: five launches, the merge's chains of
// binary searches, the stream's searches and global atomics (chip_smoke.py
// logs the four steps apart).  Integer counts and atomics make the result
// exact in any order.  Any Q >= 1 and 0 <= N < 2^31 are taken with no
// padding asked of the caller.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the query index
constexpr int kMaxTile = 12288;        // queries a tile: 208 KB in stream
constexpr int kIndexThreads = 1024;    // threads a block but the correction
constexpr int kChunk = kIndexThreads;  // queries a chunk sort block sorts
constexpr int kMergeThreads = 256;
constexpr int kCombineParts = 8;       // combine blocks a tile and bound
constexpr int kBucketBits = 11;        // a tile's bucket table per bound
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kPerIndexThread = kMaxTile / kIndexThreads;
constexpr int kPerThread = 4;          // intervals a thread per step
// the pairwise correction
constexpr int kThreads = 256;
constexpr int kQueriesPerThread = 8;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kStage = 2048;           // intervals in shared memory at a time
constexpr int kBlocksPerSm = 8;        // the grid
constexpr unsigned kFull = 0xffffffffu;

// Scratch, carved from one int32 buffer of range_stab_scratch_words(N, Q).
struct Scratch {
  int32_t* counters;   // [2]: listed intervals, listed queries
  int2* bad;           // [N]: the intervals with s >= e
  int32_t* chunk_qe;   // [Q] each, tile t at t * tile: bounds sorted by
  int32_t* chunk_qs;   //   chunk of kChunk,
  int32_t* chunk_ie;   //   and their tile-local indices
  int32_t* chunk_is;
  int32_t* sorted_qe;  // bounds sorted over the tile
  int32_t* sorted_qs;
  int32_t* perm_qe;    // tile-local query index of each sorted position
  int32_t* perm_qs;
  int32_t* hist_a;     // intervals whose #{qe <= s} is the bin
  int32_t* hist_b;     // intervals whose #{qs < e} is the bin
  int32_t* inv;        // [Q]: the inverted queries
  int32_t* tab_qe;     // [tiles * (kBuckets + 1)] each: bucket starts
  int32_t* tab_qs;
};

int tiles_for(int Q) { return Q > 0 ? (Q + kMaxTile - 1) / kMaxTile : 0; }

Scratch carve(void* base, long long N, int Q) {
  int32_t* w = static_cast<int32_t*>(base);
  Scratch sc;
  sc.counters = w;
  sc.bad = reinterpret_cast<int2*>(w + 4);  // 16-byte offset
  int32_t* q = w + 4 + 2 * N;
  int32_t** arrays[] = {&sc.chunk_qe, &sc.chunk_qs, &sc.chunk_ie,
                        &sc.chunk_is, &sc.sorted_qe, &sc.sorted_qs,
                        &sc.perm_qe, &sc.perm_qs, &sc.hist_a, &sc.hist_b,
                        &sc.inv};
  for (int32_t** a : arrays) {
    *a = q;
    q += Q;
  }
  sc.tab_qe = q;
  sc.tab_qs = q + static_cast<long long>(tiles_for(Q)) * (kBuckets + 1);
  return sc;
}

// Programmatic dependent launch: each launch after the first may start
// while the one before it drains.  A kernel lets the next one start at its
// top, and a dependent kernel waits for the one before it (and so for all
// earlier ones) before it reads their results or returns.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ unsigned long long sort_key(int32_t v, int j) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(v)
                                          ^ 0x80000000u) << 32)
         | static_cast<uint32_t>(j);
}

__device__ __forceinline__ int32_t key_value(unsigned long long x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x >> 32) ^ 0x80000000u);
}

// Sorts kChunk queries of a tile by one bound: grid (tiles x chunks a
// tile, 2 bounds), one key a thread.
__global__ void __launch_bounds__(kIndexThreads)
range_chunk_sort_kernel(const int32_t* __restrict__ q_starts,
                        const int32_t* __restrict__ q_ends, int Q, int tile,
                        int chunks, Scratch sc, int32_t* __restrict__ counts) {
  __shared__ unsigned long long keys[kChunk];
  let_next_start();
  const int tid = threadIdx.x;
  const bool by_start = blockIdx.y != 0;
  const int t = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * kChunk;  // tile-local
  const int base = t * tile;
  const int len = min(kChunk, min(tile, Q - base) - c0);
  if (len <= 0) return;
  if (tid < len) {
    (by_start ? sc.hist_b : sc.hist_a)[base + c0 + tid] = 0;
    if (!by_start) counts[base + c0 + tid] = 0;  // the combine adds to it
  }
  if (blockIdx.x == 0 && !by_start && tid < 2) sc.counters[tid] = 0;
  const int32_t* src = by_start ? q_starts : q_ends;
  unsigned long long x =
      tid < len ? sort_key(src[base + c0 + tid], c0 + tid) : ~0ull;
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long y;
      if (j >= 32) {
        __syncthreads();  // the last stage's reads are done
        keys[tid] = x;
        __syncthreads();
        y = keys[tid ^ j];
      } else {
        y = __shfl_xor_sync(kFull, x, j);
      }
      // the lower of the pair keeps the smaller key where k's run ascends
      const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
      x = keep_min == (x < y) ? x : y;
    }
  }
  if (tid < len) {
    (by_start ? sc.chunk_qs : sc.chunk_qe)[base + c0 + tid] = key_value(x);
    (by_start ? sc.chunk_is : sc.chunk_ie)[base + c0 + tid] =
        static_cast<int32_t>(x & 0xffffffffu);
  }
}

// r[k] = #{a[0..n) <= x[k]} (kAtOrBelow) or #{a[0..n) < x[k]}, for sorted
// a and n >= 1: ceil(log2 n) + 1 loads each, the same count in every lane.
template <bool kAtOrBelow, int K>
__device__ __forceinline__ void rank(const int32_t* a, int n,
                                     const int (&x)[K], int (&r)[K]) {
  int b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) b[k] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = a[b[k] + half];
      b[k] += (kAtOrBelow ? v <= x[k] : v < x[k]) ? half : 0;
    }
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = a[b[k]];
    r[k] = b[k] + (kAtOrBelow ? v <= x[k] : v < x[k]);
  }
}

// A tile's bounds lie in [lo, hi]; value v is in bucket (v - lo) >> shift,
// the shift the least that leaves fewer than kBuckets buckets.
__device__ __forceinline__ int bucket_shift(int lo, int hi) {
  const unsigned range = static_cast<unsigned>(hi) - static_cast<unsigned>(lo);
  const int bits = range ? 32 - __clz(range) : 0;
  return bits > kBucketBits ? bits - kBucketBits : 0;
}

// Places each chunk-sorted bound in its tile: its position in its chunk
// plus its rank in every other chunk of the tile (keys in an earlier
// chunk that equal it come before it, in a later one after it).  The same
// searches give the tile's bucket table: tab[b] = #{v : bucket(v) < b} for
// b = 0..kBuckets.  Grid (tiles x blocks a tile, 2 bounds): the first
// `blocks` of a tile place a position a thread, the rest fill a table
// entry a thread.
__global__ void __launch_bounds__(kMergeThreads)
range_merge_kernel(int Q, int tile, int blocks, Scratch sc) {
  extern __shared__ int32_t vals[];
  wait_for_previous();
  let_next_start();
  const int tid = threadIdx.x;
  const bool by_start = blockIdx.y != 0;
  constexpr int kTableBlocks = (kBuckets + kMergeThreads) / kMergeThreads;
  const int t = blockIdx.x / (blocks + kTableBlocks);
  const int b = blockIdx.x % (blocks + kTableBlocks);
  const int base = t * tile;
  const int len = min(tile, Q - base);
  const bool table = b >= blocks;
  const int first = (table ? b - blocks : b) * kMergeThreads;
  if (!table && first >= len) return;
  const int32_t* chunk = (by_start ? sc.chunk_qs : sc.chunk_qe) + base;
  for (int j = tid; j < len; j += kMergeThreads) vals[j] = chunk[j];
  __syncthreads();
  const int chunks = (len + kChunk - 1) / kChunk;
  const int pos = first + tid;
  if (!table && pos < len) {
    const int x[1] = {vals[pos]};
    const int mine = pos / kChunk;
    int at = pos % kChunk;
    for (int c = 0; c < chunks; ++c) {
      if (c == mine) continue;
      int r[1];
      const int n = min(kChunk, len - c * kChunk);
      if (c < mine) rank<true>(vals + c * kChunk, n, x, r);
      else rank<false>(vals + c * kChunk, n, x, r);
      at += r[0];
    }
    (by_start ? sc.sorted_qs : sc.sorted_qe)[base + at] = x[0];
    (by_start ? sc.perm_qs : sc.perm_qe)[base + at] =
        (by_start ? sc.chunk_is : sc.chunk_ie)[base + pos];
  }
  if (table && pos <= kBuckets) {
    int lo = vals[0], hi = vals[min(kChunk, len) - 1];
    for (int c = 1; c < chunks; ++c) {
      lo = min(lo, vals[c * kChunk]);
      hi = max(hi, vals[min(len, (c + 1) * kChunk) - 1]);
    }
    // the values below bucket pos's first value
    const long long edge = static_cast<long long>(lo)
                           + (static_cast<long long>(pos)
                              << bucket_shift(lo, hi));
    int below = len;
    if (edge <= INT_MAX) {
      const int x[1] = {static_cast<int>(edge)};
      below = 0;
      for (int c = 0; c < chunks; ++c) {
        int r[1];
        rank<false>(vals + c * kChunk, min(kChunk, len - c * kChunk), x, r);
        below += r[0];
      }
    }
    (by_start ? sc.tab_qs : sc.tab_qe)[t * (kBuckets + 1) + pos] = below;
  }
}

// r[k] = #{a[0..n) <= x[k]} (kAtOrBelow) or #{a[0..n) < x[k]} for sorted
// a[0..n) in [lo, hi] with bucket table tab: the bucket of x[k] gives the
// range of a to search, and the search runs only in it.
template <bool kAtOrBelow, int K>
__device__ __forceinline__ void bucket_rank(const int32_t* a, int n,
                                            const int32_t* tab, int lo,
                                            int hi, int shift,
                                            const int (&x)[K], int (&r)[K]) {
  int b[K], m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = x[k] < lo ? 0 : n;  // every bound above x, or below it
    m[k] = 0;
    if (x[k] >= lo && x[k] <= hi) {
      const unsigned d =
          (static_cast<unsigned>(x[k]) - static_cast<unsigned>(lo)) >> shift;
      b[k] = tab[d];
      m[k] = tab[d + 1] - b[k];
    }
  }
  bool more = true;
  while (more) {
    more = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (m[k] > 0) {
        const int half = m[k] >> 1;
        const int v = a[b[k] + half];
        if (kAtOrBelow ? v <= x[k] : v < x[k]) {
          b[k] += half + 1;
          m[k] -= half + 1;
        } else {
          m[k] = half;
        }
        more |= m[k] > 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = b[k];
}

// Adds one to hist[bin] for each lane that is `valid`; a warp whose lanes
// all hit one bin adds 32 with one atomic.
__device__ __forceinline__ void add_bin(int32_t* hist, int bin, bool valid,
                                        unsigned lane) {
  const int first = __shfl_sync(kFull, bin, 0);
  if (__all_sync(kFull, valid && bin == first)) {
    if (lane == 0) atomicAdd(hist + first, 32);
  } else if (valid) {
    atomicAdd(hist + bin, 1);
  }
}

// Appends `item` for each lane where `take` holds to list[] at a slot
// drawn from *count (one atomic a warp); slots at or past `cap` are
// dropped, so repeated launches never write out of bounds.
template <typename T>
__device__ __forceinline__ void append(bool take, T item, T* list,
                                       int32_t* count, long long cap,
                                       unsigned lane) {
  const unsigned m = __ballot_sync(kFull, take);
  if (!m) return;
  const int leader = __ffs(m) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(count, __popc(m));
  at = __shfl_sync(kFull, at, leader) + __popc(m & ((1u << lane) - 1));
  if (take && at < cap) list[at] = item;
}

// A lane's kPerThread intervals from i (one 16-byte load a bound where
// aligned and whole); ok[k] says whether i + k < hi.
__device__ __forceinline__ void load_step(const int32_t* __restrict__ starts,
                                          const int32_t* __restrict__ ends,
                                          long long i, long long hi,
                                          int aligned, int (&s)[kPerThread],
                                          int (&e)[kPerThread],
                                          bool (&ok)[kPerThread]) {
  if (aligned && i + kPerThread <= hi) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(starts + i));
    const int4 b = __ldg(reinterpret_cast<const int4*>(ends + i));
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    e[0] = b.x; e[1] = b.y; e[2] = b.z; e[3] = b.w;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) ok[k] = true;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      ok[k] = i + k < hi;
      s[k] = ok[k] ? __ldg(starts + i + k) : 0;
      e[k] = ok[k] ? __ldg(ends + i + k) : 0;
    }
  }
}

__global__ void __launch_bounds__(kIndexThreads, 1)
range_stream_kernel(const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ ends, long long N, int Q,
                    int tile, int slices, long long per_block, int aligned,
                    Scratch sc) {
  extern __shared__ int32_t smem[];
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int t = blockIdx.x / slices;
  const long long slice = blockIdx.x % slices;
  const int base = t * tile;
  const int len = min(tile, Q - base);
  int32_t* qe = smem;
  int32_t* qs = smem + tile;
  int32_t* ha = smem + 2 * tile;
  int32_t* hb = smem + 3 * tile;
  int32_t* te = smem + 4 * tile;
  int32_t* ts = te + kBuckets + 1;
  // w is the warp's first interval, so every lane of a warp runs the same
  // steps (the shuffles and ballots need all 32).  The intervals are the
  // caller's: the first step's load is in flight before the wait.
  const long long lo = slice * per_block;
  const long long hi = lo + per_block < N ? lo + per_block : N;
  const long long w0 = lo + kPerThread * static_cast<long long>(tid - lane);
  int s[kPerThread], e[kPerThread];
  bool ok[kPerThread];
  if (w0 < hi) load_step(starts, ends, w0 + kPerThread * lane, hi, aligned,
                         s, e, ok);
  wait_for_previous();
  let_next_start();
  for (int b = tid; b <= kBuckets; b += kIndexThreads) {
    te[b] = sc.tab_qe[t * (kBuckets + 1) + b];
    ts[b] = sc.tab_qs[t * (kBuckets + 1) + b];
  }
#pragma unroll
  for (int r = 0; r < kPerIndexThread; ++r) {  // all loads in flight at once
    const int j = tid + r * kIndexThreads;
    if (j < len) {
      qe[j] = sc.sorted_qe[base + j];
      qs[j] = sc.sorted_qs[base + j];
      ha[j] = 0;
      hb[j] = 0;
    }
  }
  __syncthreads();

  const bool compact = t == 0;
  const int lo_e = qe[0], hi_e = qe[len - 1], lo_s = qs[0], hi_s = qs[len - 1];
  const int shift_e = bucket_shift(lo_e, hi_e);
  const int shift_s = bucket_shift(lo_s, hi_s);
  for (long long w = w0; w < hi; w += kPerThread * kIndexThreads) {
    if (w != w0)
      load_step(starts, ends, w + kPerThread * lane, hi, aligned, s, e, ok);
    int pa[kPerThread], pb[kPerThread];
    // #{qe <= s}: s < qe from there on; #{qs < e}: e <= qs from there on
    bucket_rank<true>(qe, len, te, lo_e, hi_e, shift_e, s, pa);
    bucket_rank<false>(qs, len, ts, lo_s, hi_s, shift_s, e, pb);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      add_bin(ha, pa[k], ok[k] && pa[k] < len, lane);
      add_bin(hb, pb[k], ok[k] && pb[k] < len, lane);
    }
    if (compact) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        append(ok[k] && s[k] >= e[k], make_int2(s[k], e[k]), sc.bad,
               sc.counters, N, lane);
    }
  }
  __syncthreads();
  for (int j = tid; j < len; j += kIndexThreads) {
    if (ha[j]) atomicAdd(sc.hist_a + base + j, ha[j]);
    if (hb[j]) atomicAdd(sc.hist_b + base + j, hb[j]);
  }
}

// a[0..n) <- its inclusive prefix sums, by a block of kIndexThreads.
__device__ void block_inclusive_scan(int32_t* a, int n) {
  __shared__ int32_t warp_sums[kIndexThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kIndexThreads - 1) / kIndexThreads;
  const int j0 = min(n, tid * per), j1 = min(n, j0 + per);
  int sum = 0;
  for (int j = j0; j < j1; ++j) sum += a[j];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int j = j0; j < j1; ++j) {
    run += a[j];
    a[j] = run;
  }
  __syncthreads();
}

// Grid (tiles, 2 kCombineParts + 1): blocks 0, 2, 4, ... add #{s < qe} to
// each query's count and blocks 1, 3, 5, ... subtract #{e <= qs} (the
// histograms' inclusive prefix sums, scattered back through the sort
// orders), each for a part of the sorted positions, so the scattered
// atomics leave from many SMs; the last block lists the inverted queries.
__global__ void __launch_bounds__(kIndexThreads)
range_combine_kernel(const int32_t* __restrict__ q_starts,
                     const int32_t* __restrict__ q_ends, int Q, int tile,
                     Scratch sc, int32_t* __restrict__ counts) {
  extern __shared__ int32_t run[];  // by sorted position
  wait_for_previous();
  let_next_start();
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int base = blockIdx.x * tile;
  const int len = min(tile, Q - base);
  if (blockIdx.y == 2 * kCombineParts) {
    int qs[kPerIndexThread], qe[kPerIndexThread];
#pragma unroll
    for (int r = 0; r < kPerIndexThread; ++r) {  // all loads in flight
      const int j = tid + r * kIndexThreads;
      qs[r] = j < len ? q_starts[base + j] : 0;
      qe[r] = j < len ? q_ends[base + j] : 0;
    }
    // each warp's lanes run the same steps (the ballots need all 32)
#pragma unroll
    for (int r = 0; r < kPerIndexThread; ++r) {
      const int j = tid + r * kIndexThreads;
      append(j < len && qs[r] > qe[r], base + j, sc.inv, sc.counters + 1, Q,
             lane);
    }
    return;
  }
  const bool by_start = blockIdx.y & 1;
  const int part = blockIdx.y >> 1;
  const int32_t* hist = (by_start ? sc.hist_b : sc.hist_a) + base;
  const int32_t* perm = (by_start ? sc.perm_qs : sc.perm_qe) + base;
  int h[kPerIndexThread], p[kPerIndexThread];
#pragma unroll
  for (int r = 0; r < kPerIndexThread; ++r) {  // all loads in flight
    const int j = tid + r * kIndexThreads;
    h[r] = j < len ? hist[j] : 0;
    p[r] = j < len && j * kCombineParts / len == part ? perm[j] : 0;
  }
#pragma unroll
  for (int r = 0; r < kPerIndexThread; ++r)
    if (tid + r * kIndexThreads < len) run[tid + r * kIndexThreads] = h[r];
  __syncthreads();
  block_inclusive_scan(run, len);
#pragma unroll
  for (int r = 0; r < kPerIndexThread; ++r) {
    const int j = tid + r * kIndexThreads;
    if (j < len && j * kCombineParts / len == part)
      atomicAdd(counts + base + p[r], by_start ? -run[j] : run[j]);
  }
}

// C for one set of pairs: the n_iv intervals (the list `bad`, or every
// interval when kInvertedQueries) against the n_q queries (every query with
// qs <= qe, or the listed inverted ones), spread over the grid in items of
// (2048 queries, kStage intervals).  A block holds its 2048 queries in
// registers, 8 a thread, stages the intervals in shared memory, reads each
// as one 8-byte broadcast, and adds each query's count with one atomic.
template <bool kInvertedQueries>
__device__ void outside_pairs(int2* stage, const int32_t* starts,
                              const int32_t* ends, const int2* bad,
                              long long n_iv, const int32_t* q_starts,
                              const int32_t* q_ends, const int32_t* inv,
                              int n_q, int32_t* counts) {
  const int tid = threadIdx.x;
  const long long stages = (n_iv + kStage - 1) / kStage;
  const long long items = (n_q + kQueriesPerBlock - 1) / kQueriesPerBlock
                          * stages;
  const long long per = (items + gridDim.x - 1) / gridDim.x;
  long long it = blockIdx.x * per;
  const long long end = it + per < items ? it + per : items;
  while (it < end) {
    const long long qt = it / stages;
    const long long qt_end = (qt + 1) * stages < end ? (qt + 1) * stages
                                                     : end;
    int qs[kQueriesPerThread], qe[kQueriesPerThread], qi[kQueriesPerThread],
        c[kQueriesPerThread];
#pragma unroll
    for (int j = 0; j < kQueriesPerThread; ++j) {
      const long long slot = qt * kQueriesPerBlock + j * kThreads + tid;
      int q = -1;
      if (slot < n_q) q = kInvertedQueries ? inv[slot] : static_cast<int>(slot);
      qs[j] = q >= 0 ? q_starts[q] : 0;
      qe[j] = q >= 0 ? q_ends[q] : 0;
      // the listed intervals pair only with the queries that are not
      // inverted (the inverted ones take every interval below)
      qi[j] = !kInvertedQueries && qs[j] > qe[j] ? -1 : q;
      c[j] = 0;
    }
    for (; it < qt_end; ++it) {
      const long long i0 = (it - qt * stages) * kStage;
      const int n = static_cast<int>(n_iv - i0 < kStage ? n_iv - i0 : kStage);
      __syncthreads();  // the previous stage is consumed
      for (int i = tid; i < n; i += kThreads)
        stage[i] = kInvertedQueries
                       ? make_int2(__ldg(starts + i0 + i), __ldg(ends + i0 + i))
                       : bad[i0 + i];
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int2 v = stage[i];
#pragma unroll
        for (int j = 0; j < kQueriesPerThread; ++j)
          c[j] += (v.x >= qe[j]) & (v.y <= qs[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQueriesPerThread; ++j)
      if (qi[j] >= 0 && c[j]) atomicAdd(counts + qi[j], c[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
range_correct_kernel(const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ ends, long long N,
                     const int32_t* __restrict__ q_starts,
                     const int32_t* __restrict__ q_ends, int Q, Scratch sc,
                     int32_t* __restrict__ counts) {
  __shared__ int2 stage[kStage];
  wait_for_previous();
  const long long n_bad = min(static_cast<long long>(sc.counters[0]), N);
  const int n_inv = min(sc.counters[1], Q);
  outside_pairs<false>(stage, starts, ends, sc.bad, n_bad, q_starts, q_ends,
                       nullptr, Q, counts);
  outside_pairs<true>(stage, starts, ends, nullptr, N, q_starts, q_ends,
                      sc.inv, n_inv, counts);
}

// Launches `kernel` on `st`; `early` lets it start while the previous
// kernel on the stream drains (it waits for it with wait_for_previous).
template <typename... Params, typename... Args>
cudaError_t launch(bool early, void (*kernel)(Params...), dim3 grid,
                   dim3 block, size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = st;
  config.attrs = &attr;
  config.numAttrs = early ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Queries a tile for Q queries: the tiles are as even as kMaxTile allows.
int range_stab_tile(int Q) {
  const int tiles = tiles_for(Q);
  return tiles ? (Q + tiles - 1) / tiles : 0;
}

// int32 words of scratch range_stab_launch needs for N intervals and Q
// queries.
long long range_stab_scratch_words(long long N, int Q) {
  return 4 + 2 * N + 11LL * Q + 2LL * tiles_for(Q) * (kBuckets + 1);
}

// Launches K5's steps on `stream`: bit 0 the sort (two launches), bit 1 the
// stream, bit 2
// the combine, bit 3 the correction (15: the whole count; each step reads
// what the previous one wrote).  All pointers are device pointers to
// contiguous int32 arrays: starts, ends [N]; q_starts, q_ends, counts [Q];
// scratch [range_stab_scratch_words(N, Q)].  Returns the cudaError_t of
// the first call that failed (0 on success).
int range_stab_launch(const void* starts, const void* ends, long long N,
                      const void* q_starts, const void* q_ends, int Q,
                      void* scratch, void* counts, int phases, void* stream) {
  if (Q <= 0 || N < 0 || N > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tile = range_stab_tile(Q);
  const int tiles = (Q + tile - 1) / tile;
  const Scratch sc = carve(scratch, N, Q);
  const int32_t* s = static_cast<const int32_t*>(starts);
  const int32_t* e = static_cast<const int32_t*>(ends);
  const int32_t* qs = static_cast<const int32_t*>(q_starts);
  const int32_t* qe = static_cast<const int32_t*>(q_ends);
  int32_t* out = static_cast<int32_t*>(counts);

  if (phases & 1) {
    const int chunks = (tile + kChunk - 1) / kChunk;
    err = launch(false, range_chunk_sort_kernel, dim3(tiles * chunks, 2),
                 dim3(kIndexThreads), 0, st, qs, qe, Q, tile, chunks, sc, out);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (tile + kMergeThreads - 1) / kMergeThreads;
    const int table_blocks = (kBuckets + kMergeThreads) / kMergeThreads;
    const size_t smem = sizeof(int32_t) * tile;
    err = allow_smem(reinterpret_cast<const void*>(range_merge_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch(true, range_merge_kernel,
                 dim3(tiles * (blocks + table_blocks), 2), dim3(kMergeThreads),
                 smem, st, Q, tile, blocks, sc);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((phases & 2) && N > 0) {
    const size_t smem = sizeof(int32_t) * (4 * tile + 2 * (kBuckets + 1));
    const void* fn = reinterpret_cast<const void*>(range_stream_kernel);
    int per_sm = 0;
    err = allow_smem(fn, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, range_stream_kernel, kIndexThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the card's resident blocks shared among the tiles; at least a full
    // step of the block's threads each
    long long slices = static_cast<long long>(sms) * per_sm / tiles;
    if (slices < 1) slices = 1;
    long long per_block = (N + slices - 1) / slices;
    const long long step = static_cast<long long>(kPerThread) * kIndexThreads;
    if (per_block < step) per_block = step;
    per_block = (per_block + kPerThread - 1) / kPerThread * kPerThread;
    slices = (N + per_block - 1) / per_block;
    if (slices * tiles > INT_MAX)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    const int aligned =
        ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(e))
         % sizeof(int4)) == 0;
    err = launch(true, range_stream_kernel,
                 dim3(static_cast<unsigned>(slices * tiles)),
                 dim3(kIndexThreads), smem, st, s, e, N, Q, tile,
                 static_cast<int>(slices), per_block, aligned, sc);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 4) {
    const size_t smem = sizeof(int32_t) * tile;
    err = allow_smem(reinterpret_cast<const void*>(range_combine_kernel),
                     smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch(true, range_combine_kernel,
                 dim3(tiles, 2 * kCombineParts + 1), dim3(kIndexThreads), smem,
                 st, qs, qe, Q, tile, sc, out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 8) {
    err = launch(true, range_correct_kernel, dim3(sms * kBlocksPerSm),
                 dim3(kThreads), 0, st, s, e, N, qs, qe, Q, sc, out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* range_stab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

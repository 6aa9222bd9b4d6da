// succ_w (K6): each conflict-index entry's successor committed-write
// executeAt, the per-entry half of the deps tile's transitive elision, for
// Hopper (sm_90a).
//
//   succ_w[e] = min { eat(f) : f a committed write, key(f) == key(e),
//                               (eat(f), f) > (eat(e), e) }   (INT_MAX if none)
//
// where a committed write has status in [4, 6], rank >= 0 and its kind's bit
// in the write-kind mask, and the pair compare is lexicographic (equal eats
// order by entry index).  Not a port of a TPU kernel: the JAX package
// computes succ_w in XLA, outside its Pallas tile, as a stable two-pass
// lexsort by (key, eat) and a segmented exclusive suffix-min scan
// (accord_tpu/ops/deps_kernel.py::_successor_write_eat).  The plain version
// is accord_tpu_torch/ops/deps_kernel.py::successor_write_eat (stacked:
// sharded_successor_write_eat); the two are held == .
//
// Bound: bytes.  The function reads five int32 [E] arrays and writes one:
// 24 E bytes, 0.92 us at E = 128,768 on 3.35 TB/s.  The plain version is a
// general stable sort of int64 composites and some thirty eager operations
// around it; what it costs is launches and the sort, not bytes.  The design
// sorts only what the answer needs, and only within a key:
//  * a write's own eat is the value it offers, so the first write after e
//    in (key, eat, index) order holds the answer, and the entries that are
//    not writes need no sorting at all: each finds its answer by a binary
//    search in its key's sorted writes;
//  * the writes are bucketed by key with a counting sort (the number of
//    keys is known), then each block sorts one chunk of 1024 bucketed
//    writes in shared memory (a merge sort of 16-byte records).  A
//    key's writes that span chunks (a hot key, or a key cut by a chunk's
//    edge) stay in up to eight sorted pieces, one a chunk, and an entry
//    searches each (on the H100 a merge of the pieces by one block cost
//    more than the extra searches); over more than eight chunks, the last
//    of those chunks' blocks to finish merges them in global memory, a
//    merge path a thread.  So an entry makes at most eight binary searches
//    of at most W writes, and the work is O(W log W) whatever the skew;
//  * four launches and a memset: count (the last block to finish scans the
//    counts), scatter, sort and merge, search.  Counts are taken with one
//    atomic per distinct key a warp, so one hot key costs no more atomics
//    than spread keys a warp.
//
// Keys need not be sorted, contiguous or in range: the bucket is the key
// modulo the bucket count (the identity for keys in [0, S*Ks)), and each
// record carries its key, which the sort and the search compare first.
// The stacked layout ([S, E] arrays, keys local to shard s's block of Ks
// keys) offsets each key by s*Ks in wrapping int32 arithmetic, as the plain
// version does, so no two shards share a segment; the index of an entry is
// its flat index s*E + e.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // scatter, search
constexpr int kCountThreads = 1024;  // count; its last block scans
constexpr int kChunk = 1024;         // writes sorted by one block
constexpr int kPerThread = 4;        // of them sorted in a thread's registers
constexpr int kSortThreads = kChunk / kPerThread;
// a key's writes over at most this many chunks stay in their sorted pieces,
// which the search takes one by one; over more, they are merged into one
constexpr int kMaxPieces = 8;
constexpr unsigned kSign = 0x80000000u;

// InternalStatus bands (accord_tpu_torch/local/cfk.py)
constexpr int kCommitted = 4;
constexpr int kApplied = 6;

__device__ __forceinline__ bool committed_write(int rank, int status,
                                                int kind, unsigned mask) {
  // (mask >> kind) & 1 as torch shifts an int32: 0 for kind < 0 or >= 32
  // (mask < 2^31)
  return status >= kCommitted && status <= kApplied && rank >= 0
      && static_cast<unsigned>(kind) < 32u && ((mask >> kind) & 1u);
}

// entry i's key offset by its shard's block (wrapping int32, as
// key + s * ks in torch) and its bucket
__device__ __forceinline__ void key_of(const int32_t* __restrict__ key,
                                       int i, int E, int ks, unsigned nb,
                                       unsigned& gk, unsigned& bucket) {
  const unsigned s = static_cast<unsigned>(i / E);
  gk = static_cast<unsigned>(key[i]) + s * static_cast<unsigned>(ks);
  bucket = gk % nb;
}

// records: (bucket, key, eat ^ sign, index), ordered as unsigned tuples
__device__ __forceinline__ bool rec_less(const uint4& a, const uint4& b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.z != b.z) return a.z < b.z;
  return a.w < b.w;
}

// start[0..nb] = the exclusive prefix sums of cnt[0..nb), by one block
__device__ void scan_counts(const int32_t* cnt, unsigned nb,
                            int32_t* __restrict__ start) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned per = (nb + blockDim.x - 1) / blockDim.x;
  const unsigned lo = min(nb, threadIdx.x * per), hi = min(nb, lo + per);
  int sum = 0;
  for (unsigned j = lo; j < hi; ++j) sum += __ldcg(cnt + j);
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane]
                                                           : 0;
    int w = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w - v;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (unsigned j = lo; j < hi; ++j) {
    start[j] = run;
    run += __ldcg(cnt + j);
  }
  if (threadIdx.x == blockDim.x - 1) start[nb] = run;
}

// slot[i] = entry i's place among its bucket's writes (-1 for a non-write);
// the last block to finish turns the counts into the buckets' starts
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ rank,
             const int32_t* __restrict__ status,
             const int32_t* __restrict__ kind, int n, int E, int ks,
             unsigned nb, unsigned mask, int32_t* cnt,
             int32_t* __restrict__ slot, int32_t* __restrict__ start,
             unsigned* done) {
  __shared__ bool last;
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  bool w = false;
  unsigned gk = 0, bucket = 0;
  if (i < n) {
    w = committed_write(rank[i], status[i], kind[i], mask);
    if (w) key_of(key, i, E, ks, nb, gk, bucket);
  }
  const unsigned writers = __ballot_sync(0xffffffffu, w);
  if (w) {
    // one atomic for the lanes of a bucket
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(writers, bucket);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(cnt + bucket, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    slot[i] = base + __popc(peers & ((1u << lane) - 1u));
  } else if (i < n) {
    slot[i] = -1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) scan_counts(cnt, nb, start);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ key,
               const int32_t* __restrict__ eat,
               const int32_t* __restrict__ slot, int n, int E, int ks,
               unsigned nb, const int32_t* __restrict__ start,
               uint4* __restrict__ rec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slot[i];
  if (s < 0) return;
  unsigned gk, bucket;
  key_of(key, i, E, ks, nb, gk, bucket);
  rec[start[bucket] + s] = make_uint4(
      bucket, gk, static_cast<unsigned>(eat[i]) ^ kSign,
      static_cast<unsigned>(i));
}

template <bool kShared>
__device__ __forceinline__ uint4 load(const uint4* p) {
  if constexpr (kShared) return *p;
  else return __ldcg(p);  // other blocks wrote it: past this SM's L1
}

template <bool kShared>
__device__ __forceinline__ void store(uint4* p, const uint4& v) {
  if constexpr (kShared) *p = v;
  else __stcg(p, v);
}

// outputs [d0, d1) of the merge of the sorted runs a[0, na) and b[0, nb)
// into out (merge path: a binary search finds where the slice starts, and
// an equal pair takes a first); in shared or in global memory
template <bool kShared>
__device__ void merge_slice(const uint4* a, int na, const uint4* b, int nb,
                            uint4* out, int d0, int d1) {
  int lo = max(0, d0 - nb), hi = min(d0, na);
  while (lo < hi) {  // i from a and d0 - i from b precede output d0
    const int mid = (lo + hi) >> 1;
    if (rec_less(load<kShared>(b + d0 - 1 - mid), load<kShared>(a + mid)))
      hi = mid;
    else
      lo = mid + 1;
  }
  int i = lo, j = d0 - lo;
  uint4 x = i < na ? load<kShared>(a + i) : make_uint4(0, 0, 0, 0);
  uint4 y = j < nb ? load<kShared>(b + j) : make_uint4(0, 0, 0, 0);
  for (int d = d0; d < d1; ++d) {
    if (j >= nb || (i < na && !rec_less(y, x))) {
      store<kShared>(out + d, x);
      if (++i < na) x = load<kShared>(a + i);
    } else {
      store<kShared>(out + d, y);
      if (++j < nb) y = load<kShared>(b + j);
    }
  }
}

// merges the sorted runs src[a0, a1) and src[a1, b1) of global memory
// into dst[a0, b1), a slice of the output a thread
__device__ void merge_runs(const uint4* src, uint4* dst, int a0, int a1,
                           int b1) {
  const int n = b1 - a0;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int d0 = min(n, static_cast<int>(threadIdx.x) * per);
  const int d1 = min(n, d0 + per);
  if (d0 < d1)
    merge_slice<false>(src + a0, a1 - a0, src + a1, b1 - a1, dst + a0, d0,
                       d1);
}

__device__ __forceinline__ void order(uint4& a, uint4& b) {
  if (rec_less(b, a)) {
    const uint4 t = a;
    a = b;
    b = t;
  }
}

// bottom-up merges of the m sorted pieces of src[0, n), piece p starting
// at edge(p), into one run -> where it ended (src or dst)
template <typename Edge>
__device__ uint4* merge_pieces(uint4* src, uint4* dst, int m, Edge edge) {
  for (int width = 1; width < m; width *= 2) {
    for (int p = 0; p < m; p += 2 * width)
      merge_runs(src, dst, edge(p), edge(min(p + width, m)),
                 edge(min(p + 2 * width, m)));
    __syncthreads();
    uint4* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// one key's writes rec[lo, hi), sorted chunk by chunk from chunk c0 on (m
// pieces), merged into one sorted run by one block in global memory
// (through tmp)
__device__ void merge_segment(uint4* rec, uint4* tmp, int lo, int hi, int c0,
                              int m) {
  const int n = hi - lo;
  auto edge = [&](int p) {  // where piece p starts, from lo; edge(m) = n
    return p >= m ? n : max(lo, (c0 + p) * kChunk) - lo;
  };
  const uint4* run = merge_pieces(rec + lo, tmp + lo, m, edge);
  if (run != rec + lo)
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      __stcg(rec + lo + j, __ldcg(run + j));
}

__global__ void __launch_bounds__(kSortThreads)
sort_kernel(const int32_t* __restrict__ start, unsigned nb, uint4* rec,
            uint4* tmp, int32_t* arrive) {
  __shared__ uint4 smem[2 * kChunk];  // the chunk's two buffers
  __shared__ bool merge_it;
  const int total = start[nb];
  const int c = blockIdx.x;
  const int c0 = c * kChunk;
  if (c0 >= total) return;
  const int len = min(kChunk, total - c0);
  // a merge sort of the chunk: each thread sorts four records in registers,
  // then eight rounds merge runs of 4, 8, ... into one, a thread writing
  // four outputs a round
  uint4* src = smem;
  uint4* dst = smem + kChunk;
  for (int j = threadIdx.x; j < kChunk; j += kSortThreads)
    src[j] = j < len ? rec[c0 + j] : make_uint4(~0u, ~0u, ~0u, ~0u);
  __syncthreads();
  const int t0 = threadIdx.x * kPerThread;
  uint4 v0 = src[t0], v1 = src[t0 + 1], v2 = src[t0 + 2], v3 = src[t0 + 3];
  order(v0, v1);
  order(v2, v3);
  order(v0, v2);
  order(v1, v3);
  order(v1, v2);
  src[t0] = v0;
  src[t0 + 1] = v1;
  src[t0 + 2] = v2;
  src[t0 + 3] = v3;
  __syncthreads();
  for (int width = kPerThread; width < kChunk; width *= 2) {
    const int pair = t0 / (2 * width) * (2 * width);
    merge_slice<true>(src + pair, width, src + pair + width, width,
                      dst + pair, t0 - pair, t0 - pair + kPerThread);
    __syncthreads();
    uint4* t = src;
    src = dst;
    dst = t;
  }
  for (int j = threadIdx.x; j < len; j += kSortThreads) rec[c0 + j] = src[j];
  // the keys cut by this chunk's edges (its first and its last bucket)
  // over more than kMaxPieces chunks: each chunk that holds part of one
  // arrives once, and the last to arrive merges its pieces
  const unsigned cut[2] = {src[0].x, src[len - 1].x};
  __threadfence();
  __syncthreads();
  for (int q = 0; q < 2; ++q) {
    const unsigned b = cut[q];
    if (q == 1 && b == cut[0]) break;
    const int lo = start[b], hi = start[b + 1];
    const int first = lo / kChunk, last = (hi - 1) / kChunk;
    if (last - first < kMaxPieces) continue;
    if (threadIdx.x == 0)
      merge_it = atomicAdd(arrive + b, 1) == last - first;
    __syncthreads();
    if (merge_it) merge_segment(rec, tmp, lo, hi, first, last - first + 1);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
search_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ eat,
              int n, int E, int ks, unsigned nb,
              const int32_t* __restrict__ start,
              const uint4* __restrict__ rec, int32_t* __restrict__ succ) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  unsigned gk, bucket;
  key_of(key, i, E, ks, nb, gk, bucket);
  const uint4 me = make_uint4(
      bucket, gk, static_cast<unsigned>(eat[i]) ^ kSign,
      static_cast<unsigned>(i));
  const int lo0 = start[bucket], end = start[bucket + 1];
  // the key's writes: sorted pieces, one a chunk they touch, or one sorted
  // run where there were more than kMaxPieces (sort_kernel merged them)
  const int first = lo0 / kChunk;
  const int span = end > lo0 ? (end - 1) / kChunk - first + 1 : 1;
  const int pieces = span <= kMaxPieces ? span : 1;
  uint4 best = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int p = 0; p < pieces; ++p) {
    int lo = p == 0 ? lo0 : (first + p) * kChunk;
    const int piece_end = pieces == 1 ? end
                                      : min(end, (first + p + 1) * kChunk);
    int hi = piece_end;
    while (lo < hi) {  // the piece's first write after (key, eat, index)
      const int mid = (lo + hi) >> 1;
      if (rec_less(me, rec[mid])) hi = mid;
      else lo = mid + 1;
    }
    if (lo < piece_end && rec_less(rec[lo], best)) best = rec[lo];
  }
  succ[i] = best.x == bucket && best.y == gk ? static_cast<int>(best.z ^ kSign)
                                             : INT_MAX;
}

// the scratch's layout, in int32 words: the zeroed counters (cnt[nb + 1],
// arrive[nb], done) first, then start[nb + 1], slot[n], and the records and
// the merge buffer (4 words each, 16-byte aligned)
struct Layout {
  unsigned nb;
  long long zeroed, start, slot, rec, tmp, words;
  Layout(int S, int E, int ks) {
    const long long n = static_cast<long long>(S) * E;
    const long long keys = static_cast<long long>(S) * (ks > 0 ? ks : 0);
    nb = static_cast<unsigned>(keys < 1 ? 1 : keys < n ? keys : n);
    zeroed = 2LL * nb + 2;
    start = zeroed;
    slot = start + nb + 1;
    rec = (slot + n + 3) / 4 * 4;
    tmp = rec + 4 * n;
    words = tmp + 4 * n;
  }
};

}  // namespace

extern "C" {

// int32 words of scratch for S shards of E entries and Ks keys each
long long succ_w_scratch_words(int S, int E, int ks) {
  return Layout(S, E, ks).words;
}

// succ_w for S shards of E entries each (S = 1 for a flat window) and Ks
// keys a shard, on `stream`.  The five entry arrays are int32 [S, E] device
// arrays (keys local to their shard), `scratch` int32 of
// succ_w_scratch_words(S, E, Ks) words (any content), succ int32 [S, E].
// `steps` runs the first 1-4 of its steps (the memset and the count, the
// scatter, the sort and merge, the search: 4 is succ_w, fewer time the
// steps apart).  Returns the cudaError_t of the first call that failed (0
// on success).
int succ_w_launch(const void* entry_key, const void* entry_rank,
                  const void* entry_eat, const void* entry_status,
                  const void* entry_kind, int S, int E, int ks,
                  int write_mask, void* scratch, void* succ, int steps,
                  void* stream) {
  if (S <= 0 || E <= 0 || ks < 0 || S > INT_MAX / E || steps < 1
      || steps > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = S * E;
  const Layout L(S, E, ks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* w = static_cast<int32_t*>(scratch);
  int32_t* cnt = w;
  int32_t* arrive = w + L.nb + 1;
  unsigned* done = reinterpret_cast<unsigned*>(w + 2LL * L.nb + 1);
  int32_t* start = w + L.start;
  int32_t* slot = w + L.slot;
  uint4* rec = reinterpret_cast<uint4*>(w + L.rec);
  uint4* tmp = reinterpret_cast<uint4*>(w + L.tmp);
  const auto* key = static_cast<const int32_t*>(entry_key);
  const auto* eat = static_cast<const int32_t*>(entry_eat);
  cudaError_t err = cudaMemsetAsync(w, 0, L.zeroed * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<(n + kCountThreads - 1) / kCountThreads, kCountThreads, 0,
                 s>>>(key, static_cast<const int32_t*>(entry_rank),
                      static_cast<const int32_t*>(entry_status),
                      static_cast<const int32_t*>(entry_kind), n, E, ks,
                      L.nb, static_cast<unsigned>(write_mask), cnt, slot,
                      start, done);
  if ((err = cudaGetLastError()) != cudaSuccess || steps == 1)
    return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  scatter_kernel<<<blocks, kThreads, 0, s>>>(key, eat, slot, n, E, ks, L.nb,
                                             start, rec);
  if ((err = cudaGetLastError()) != cudaSuccess || steps == 2)
    return static_cast<int>(err);
  sort_kernel<<<(n + kChunk - 1) / kChunk, kSortThreads, 0, s>>>(
      start, L.nb, rec, tmp, arrive);
  if ((err = cudaGetLastError()) != cudaSuccess || steps == 3)
    return static_cast<int>(err);
  search_kernel<<<blocks, kThreads, 0, s>>>(key, eat, n, E, ks, L.nb, start,
                                            rec, static_cast<int32_t*>(succ));
  return static_cast<int>(cudaGetLastError());
}

const char* succ_w_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

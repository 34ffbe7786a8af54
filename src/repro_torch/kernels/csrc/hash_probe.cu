// Dictionary probes of the hash join: for each query key, its position in
// a dict's sorted, front-packed key column and whether it is there; the
// group variant also reads the matching group's size off the CSR offsets.
//
// Replaces the TPU kernels of repro/kernels/hash_probe.py:
//   dict_probe   (_kernel :52, pallas_call :137)        -> (pos, found)
//   group_probe  (_group_kernel :64, pallas_call :101)  -> (pos, found, sizes)
//
// Contract (hash_probe.py:27-29, ref.dict_probe/group_probe): the first
// `count` table keys are sorted ascending (count is read on the card and
// may be negative, a poisoned build: then nothing matches); pos is the
// key's slot, 0 on a miss; sizes = offsets[pos + 1] - offsets[pos], 0 on
// a miss.
//
// Bound on the H100: bytes.  A query reads its 8 B key and writes 5 B
// (9 B with sizes); the table (at most 65,536 keys, 512 KiB) and the
// offsets stay in the 50 MB L2.  At 16-60 M queries against <= 65,536
// keys the streams dominate: 13-17 B per query at 3.35 TB/s.
//
// The TPU compared a block of queries against the whole key tile at once
// (a block x capacity one-hot matrix on its vector unit), which costs
// capacity compares per query.  Here:
//  * dict_probe: each thread runs one lower-bound binary search over the
//    first count keys, ceil(log2 count) dependent loads (the top of the
//    search stays in L1).
//  * group_probe: what bounds a search on this card is the gathers' issue,
//    not their latency: a warp's 32 random 8-byte reads, from L1 or from
//    shared memory alike, cost the SM about 8 cycles a level (a 13-level
//    search of 4,096 splitters in shared memory alone took 0.22 ms for
//    16.7 M queries).  So the design cuts the levels.  A persistent grid,
//    one block of 1,024 threads an SM, walks the queries with a grid
//    stride; each block reads count once and stages in shared memory (up
//    to 227 KB) every S-th of the first count keys, S the least power of
//    two that fits: as 32-bit offsets from the first key where the keys
//    span less than 2^32 - 1 (S = 1 up to 54,000 keys), else as the keys
//    (S = 1 up to 27,000), and a table of 4,096 buckets over the key range
//    (bucket t: the splitters below first + t 2^b).  A query reads its
//    bucket's bounds, searches that bucket's splitters (levels for the
//    largest bucket: 1-3 for dense keys), searches the S - 1 keys after
//    its splitter in the table when S > 1, and on a hit reads its group's
//    two offsets.  The searches are branch-free (clamped loads, masked
//    steps); each thread keeps two queries in flight, their levels
//    interleaved.  The three outputs come from one launch, as on the TPU.
// Either result is a pure function of the inputs: bitwise the same on
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- dict_probe: a binary search a thread -----------------------------------

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dict_search(const long long* __restrict__ table, int cap,
            const long long* __restrict__ count,
            const long long* __restrict__ queries, int64_t n,
            int* __restrict__ pos, unsigned char* __restrict__ found) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  long long c = *count;
  c = c < 0 ? 0 : (c > cap ? cap : c);
  const long long q = queries[i];
  int lo = 0;
  int hi = static_cast<int>(c);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (table[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool hit = lo < c && table[lo] == q;
  pos[i] = hit ? lo : 0;
  found[i] = hit ? 1 : 0;
}

// -- group_probe: a shared-memory splitter index a block --------------------

constexpr int kProbeThreads = 1024;
constexpr int kProbePer = 2;     // queries a thread keeps in flight
constexpr int kBuckets = 4096;   // buckets over the key range
// a block's shared memory (all an SM gives one block): the bucket table
// and the widest bucket's count, then the splitters
constexpr int kProbeSmem = 232448;
constexpr int kBucketBytes = ((kBuckets + 2) * 4 + 15) / 16 * 16;
constexpr int kSplitterBytes = kProbeSmem - kBucketBytes;

// The splitters of one block: every S-th of the first c keys, as 32-bit
// offsets from the first key where the c keys span less than 2^32 - 1
// (narrow), else as the keys.
struct Splitters {
  const unsigned* narrow;  // null when wide
  const long long* wide;
  long long first;
  int m;  // splitters

  // splitter min(max(j, 0), m - 1) < q, for q within [first, the last
  // key] (rel = q - first)
  __device__ __forceinline__ bool below(int j, long long q,
                                        unsigned rel) const {
    j = j < m ? j : m - 1;
    j = j > 0 ? j : 0;
    return narrow ? narrow[j] < rel : wide[j] < q;
  }
  __device__ __forceinline__ long long key(int j) const {
    return narrow ? first + narrow[j] : wide[j];
  }
};

// r[p] (from lo) plus the count of splitters in [r[p], hi[p]) below q[p],
// for P queries at once: binary lifting over `levels` levels (2^levels >=
// hi - lo), each load's index clamped into the splitters and its step
// masked by hi, so that a warp's lanes never part
template <int P>
__device__ __forceinline__ void lift(const Splitters& sp, int (&r)[P],
                                     const int (&hi)[P], int levels,
                                     const long long (&q)[P],
                                     const unsigned (&rel)[P]) {
  for (int l = levels - 1; l >= 0; --l) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int at = r[p] + (1 << l) - 1;
      r[p] += at < hi[p] && sp.below(at, q[p], rel[p]) ? 1 << l : 0;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    r[p] += r[p] < hi[p] && sp.below(r[p], q[p], rel[p]) ? 1 : 0;
  }
}

// the least L with 2^L >= x (0 for x <= 1)
__device__ __forceinline__ int levels_for(int x) {
  return x > 1 ? 32 - __clz(x - 1) : 0;
}

// Each block stages the first c keys (every S-th, S the least power of
// two whose splitters fit kSplitterBytes: S = 1 up to 54,000 narrow or
// 27,000 wide keys) and a table of kBuckets + 1 entries: bucket[t] is the
// count of splitters below first + (t << b), b the least shift that puts
// the last key in a bucket below kBuckets.  A query's bucket bounds its
// splitter search to [bucket[t], bucket[t + 1]), levels_for of the
// largest bucket's count.  With S > 1 the keys between the splitters are
// searched in the table, each load's address clamped into the valid keys.
__global__ void __launch_bounds__(kProbeThreads, 1)
group_search(const long long* __restrict__ table, int cap,
             const long long* __restrict__ count,
             const long long* __restrict__ queries, int64_t n,
             const int* __restrict__ offsets, int* __restrict__ pos,
             unsigned char* __restrict__ found, int* __restrict__ sizes) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* bucket = reinterpret_cast<int*>(smem);
  int& widest = bucket[kBuckets + 1];
  long long c64 = *count;
  c64 = c64 < 0 ? 0 : (c64 > cap ? cap : c64);
  const int c = static_cast<int>(c64);
  const long long first = c > 0 ? table[0] : 0;
  const long long lastkey = c > 0 ? table[c - 1] : 0;
  const unsigned long long span = static_cast<unsigned long long>(lastkey) -
                                  static_cast<unsigned long long>(first);
  const bool narrow = span < 0xffffffffULL;
  const int room = kSplitterBytes / (narrow ? 4 : 8);
  int shift = 0;
  while (((c + (1 << shift) - 1) >> shift) > room) ++shift;
  const int mask = (1 << shift) - 1;
  unsigned* keys32 = reinterpret_cast<unsigned*>(smem + kBucketBytes);
  long long* keys64 = reinterpret_cast<long long*>(smem + kBucketBytes);
  const Splitters sp{narrow ? keys32 : nullptr, keys64, first,
                     (c + mask) >> shift};
  for (int j = threadIdx.x; j < sp.m; j += kProbeThreads) {
    const long long key = table[static_cast<int64_t>(j) << shift];
    if (narrow) {
      keys32[j] = static_cast<unsigned>(key - first);
    } else {
      keys64[j] = key;
    }
  }
  int b = 0;
  while (b < 63 && (span >> b) >= static_cast<unsigned long long>(kBuckets)) {
    ++b;
  }
  const int nb = sp.m > 0 ? static_cast<int>(span >> b) + 1 : 0;  // buckets
  if (threadIdx.x == 0) widest = 0;
  __syncthreads();
  const int all = levels_for(sp.m + 1);
  for (int t = threadIdx.x; t <= nb; t += kProbeThreads) {
    // the splitters below first + (t << b); all of them past the last
    // bucket
    const unsigned long long at = static_cast<unsigned long long>(t) << b;
    int below[1] = {0};
    const int end[1] = {t < nb ? sp.m : 0};
    const long long key[1] = {static_cast<long long>(
        static_cast<unsigned long long>(first) + at)};
    const unsigned rel[1] = {static_cast<unsigned>(at)};
    lift(sp, below, end, all, key, rel);
    bucket[t] = t < nb ? below[0] : sp.m;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nb; t += kProbeThreads) {
    atomicMax(&widest, bucket[t + 1] - bucket[t]);
  }
  __syncthreads();
  const int levels = levels_for(widest);
  const int last = c > 0 ? c - 1 : 0;

  const int64_t step = static_cast<int64_t>(gridDim.x) * kProbeThreads *
                       kProbePer;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kProbeThreads *
                          kProbePer + threadIdx.x;
       base < n; base += step) {
    long long q[kProbePer];
    int r[kProbePer];
#pragma unroll
    for (int p = 0; p < kProbePer; ++p) {
      const int64_t i = base + p * kProbeThreads;
      q[p] = i < n ? queries[i] : 0;
    }
    // r = the splitters below q: those of q's bucket, searched
    int hi[kProbePer];
    unsigned rel[kProbePer];
#pragma unroll
    for (int p = 0; p < kProbePer; ++p) {
      const bool low = q[p] < first || sp.m == 0;
      const bool high = !low && q[p] > lastkey;
      const unsigned long long d = static_cast<unsigned long long>(q[p]) -
                                   static_cast<unsigned long long>(first);
      const int t = low || high ? 0 : static_cast<int>(d >> b);
      r[p] = low ? 0 : (high ? sp.m : bucket[t]);
      hi[p] = low ? 0 : (high ? sp.m : bucket[t + 1]);
      rel[p] = static_cast<unsigned>(d);
    }
    lift(sp, r, hi, levels, q, rel);
    // the keys after splitter r - 1 and before splitter r: the lower
    // bound L is one past the last of them below q (L = 0 when r = 0)
    int lo[kProbePer];
    int end[kProbePer];
#pragma unroll
    for (int p = 0; p < kProbePer; ++p) {
      lo[p] = r[p] > 0 ? (r[p] - 1) << shift : 0;
      end[p] = r[p] > 0 ? min(r[p] << shift, c) : 0;
    }
    for (int l = shift - 1; l >= 0; --l) {
      const int half = 1 << l;
#pragma unroll
      for (int p = 0; p < kProbePer; ++p) {
        const int at = lo[p] + half;
        const long long key = table[at < last ? at : last];
        lo[p] += at < end[p] && key < q[p] ? half : 0;
      }
    }
#pragma unroll
    for (int p = 0; p < kProbePer; ++p) {
      const int64_t i = base + p * kProbeThreads;
      if (i >= n) continue;
      const int at = r[p] > 0 ? lo[p] + 1 : 0;
      const int in = at < c ? at : 0;
      const long long key = (in & mask) == 0 && sp.m > 0
                                ? sp.key(in >> shift)
                                : table[in];
      const bool hit = at < c && key == q[p];
      int size = 0;
      if (hit) size = offsets[at + 1] - offsets[at];
      pos[i] = hit ? at : 0;
      found[i] = hit ? 1 : 0;
      sizes[i] = size;
    }
  }
}

// group_search's grid: one block an SM (its shared memory fills one),
// never more than the queries need; the SM count cached for each device
cudaError_t probe_grid(int64_t n, unsigned* grid) {
  static int sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(group_search,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kProbeSmem);
    if (e != cudaSuccess) return e;
    int count = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms[dev] = count;
  }
  const int64_t per = static_cast<int64_t>(kProbeThreads) * kProbePer;
  const int64_t need = (n + per - 1) / per;
  *grid = static_cast<unsigned>(need < sms[dev] ? need : sms[dev]);
  return cudaSuccess;
}

}  // namespace

// table (cap,) int64, count () int64 on the card, queries (n,) int64;
// pos (n,) int32, found (n,) bool.  Launches on `stream`, allocates
// nothing, does not synchronise; returns the CUDA error (0 = success).
extern "C" int weld_dict_probe(const void* table, int cap, const void* count,
                               const void* queries, long long n, void* pos,
                               void* found, void* stream) {
  if (n <= 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dict_search<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), cap,
      static_cast<const long long*>(count),
      static_cast<const long long*>(queries), n, static_cast<int*>(pos),
      static_cast<unsigned char*>(found));
  return static_cast<int>(cudaGetLastError());
}

// As weld_dict_probe, plus offsets (cap + 1,) int32 and sizes (n,) int32.
extern "C" int weld_group_probe(const void* table, int cap, const void* count,
                                const void* queries, long long n,
                                const void* offsets, void* pos, void* found,
                                void* sizes, void* stream) {
  if (n <= 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  const cudaError_t e = probe_grid(n, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  group_search<<<grid, kProbeThreads, kProbeSmem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), cap,
      static_cast<const long long*>(count),
      static_cast<const long long*>(queries), n,
      static_cast<const int*>(offsets), static_cast<int*>(pos),
      static_cast<unsigned char*>(found), static_cast<int*>(sizes));
  return static_cast<int>(cudaGetLastError());
}

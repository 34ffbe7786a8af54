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
// offsets stay in the 50 MB L2, so the ceil(log2 count) dependent loads
// of a search hit L2, not HBM.  At 16-60 M queries against <= 50,000
// keys the streams dominate: 13-17 B per query at 3.35 TB/s.
//
// Design.  The TPU compared a block of queries against the whole key
// tile at once (a block x capacity one-hot matrix on its vector unit),
// which costs capacity compares per query.  Here each thread runs one
// lower-bound binary search over the first count keys: log2(count)
// loads, and no tile to size.  The three outputs of group_probe come
// from one launch, as on the TPU.  The result is a pure function of the
// inputs, so it is bitwise the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kGroup>
__global__ void __launch_bounds__(kThreads)
probe(const long long* __restrict__ table, int cap,
      const long long* __restrict__ count, const long long* __restrict__ queries,
      int64_t n, const int* __restrict__ offsets, int* __restrict__ pos,
      unsigned char* __restrict__ found, int* __restrict__ sizes) {
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
  if (kGroup) sizes[i] = hit ? offsets[lo + 1] - offsets[lo] : 0;
}

cudaError_t launch(bool group, const void* table, int cap, const void* count,
                   const void* queries, long long n, const void* offsets,
                   void* pos, void* found, void* sizes, cudaStream_t s) {
  if (n <= 0 || cap <= 0) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (group) {
    probe<true><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(table), cap,
        static_cast<const long long*>(count),
        static_cast<const long long*>(queries), n,
        static_cast<const int*>(offsets), static_cast<int*>(pos),
        static_cast<unsigned char*>(found), static_cast<int*>(sizes));
  } else {
    probe<false><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(table), cap,
        static_cast<const long long*>(count),
        static_cast<const long long*>(queries), n, nullptr,
        static_cast<int*>(pos), static_cast<unsigned char*>(found), nullptr);
  }
  return cudaGetLastError();
}

}  // namespace

// table (cap,) int64, count () int64 on the card, queries (n,) int64;
// pos (n,) int32, found (n,) bool.  Launches on `stream`, allocates
// nothing, does not synchronise; returns the CUDA error (0 = success).
extern "C" int weld_dict_probe(const void* table, int cap, const void* count,
                               const void* queries, long long n, void* pos,
                               void* found, void* stream) {
  return static_cast<int>(launch(false, table, cap, count, queries, n, nullptr,
                                 pos, found, nullptr,
                                 static_cast<cudaStream_t>(stream)));
}

// As weld_dict_probe, plus offsets (cap + 1,) int32 and sizes (n,) int32.
extern "C" int weld_group_probe(const void* table, int cap, const void* count,
                                const void* queries, long long n,
                                const void* offsets, void* pos, void* found,
                                void* sizes, void* stream) {
  return static_cast<int>(launch(true, table, cap, count, queries, n, offsets,
                                 pos, found, sizes,
                                 static_cast<cudaStream_t>(stream)));
}

// Slot histogram of the CSR group build: out[s] = #{i : slots[i] == s}
// for s < num_slots; ids outside [0, num_slots) are not counted.
//
// Replaces the TPU kernel of repro/kernels/group_build.py:
//   slot_hist  (_hist_kernel :55, pallas_call :85), called by group_build :95
//
// Bound on the H100.  By bytes, the call reads n int32 slot ids and
// writes num_slots int32 counts (num_slots <= 65,537, 256 KiB, held in
// L2): at the m:n build (200,000 rows) 0.3 us.  What bounds a call is
// fixed cost: the launch, the grid barrier, and the L2 round trips.
//
// Design.  The TPU counted serially into a VMEM tile carried across a
// sequential grid.  Here a warp counts 32 adjacent rows at a time: a
// lane whose counted id differs from its left neighbour's
// (__shfl_up_sync) heads a run of equal ids, and adds the run's length
// (from a __ballot_sync of where runs end) with one integer atomicAdd,
// which is exact in any order, so the counts are the same on every run.
// A join's build rows arrive with equal compact slots side by side:
// partsupp's four suppliers of a part make one add, not four.
// __match_any_sync, which would group equal ids that are not adjacent
// too, measured slower on the card (PERF.md, PR 21).  The TPU padded the
// ragged last block and parked the pad rows in the last slot; here the
// ragged edge is masked.
// The counts must be zero before the first add: one kernel, one launch a
// call, zeroes them with grid-stride stores, waits at a grid-wide
// barrier (cooperative launch; a grid of one block waits at
// __syncthreads and is launched plainly) and counts.  A memset launched
// before the count measured slower (PERF.md, PR 21).  The barrier costs
// more the more blocks arrive at it, so the grid is small: a block a
// kThreads x kRows rows (at least enough blocks to zero kZeroPerThread
// counts a thread), at most what the card holds at once.  Each thread reads its first kRows ids, kThreads x
// gridDim rows apart, before anything else: the reads are independent,
// so they are in flight together while the counts are zeroed and the
// grid waits, and the adds that follow do not wait for their results.
// Rows past those are counted grid-stride.  A per-block shared-memory
// histogram would cut the L2 traffic but does not fit 65,537 counts in
// 227 KB.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// rows a thread reads before the zeroing and the barrier
constexpr int kRows = 4;
constexpr unsigned kAll = 0xffffffffu;
// counts a thread zeroes at most before the grid grows past the rows
constexpr int kZeroPerThread = 4;

__device__ __forceinline__ int id_at(const int* __restrict__ slots,
                                     int64_t i, int64_t n) {
  return i < n ? slots[i] : -1;
}

__device__ __forceinline__ void read_first(const int* __restrict__ slots,
                                           int64_t n, int (&s)[kRows]) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = id_at(slots, i + r * stride, n);
}

// One id a lane of 32 adjacent rows: the head of each run of equal
// counted ids adds the run's length.
__device__ __forceinline__ void tally(int s, int num_slots,
                                      int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const bool counted = s >= 0 && s < num_slots;
  const int prev = __shfl_up_sync(kAll, s, 1);
  const bool head = counted && (lane == 0 || prev != s);
  const unsigned ends = __ballot_sync(kAll, head || !counted);
  if (head) {
    const unsigned later = ends & ~(kAll >> (31 - lane));
    const int next = later ? __ffs(later) - 1 : 32;
    atomicAdd(&out[s], next - lane);
  }
}

// The ids read first, then the rows past them, grid-stride; the loop
// bound is the same for every lane of a warp.
__device__ __forceinline__ void count(const int (&s)[kRows],
                                      const int* __restrict__ slots,
                                      int64_t n, int num_slots,
                                      int* __restrict__ out) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) tally(s[r], num_slots, out);
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x + kRows * stride;
       i - lane < n; i += stride) {
    tally(id_at(slots, i, n), num_slots, out);
  }
}

__global__ void __launch_bounds__(kThreads)
slot_hist(const int* __restrict__ slots, int64_t n, int num_slots,
          int* __restrict__ out) {
  int s[kRows];
  read_first(slots, n, s);
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < num_slots;
       i += stride) {
    out[i] = 0;
  }
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }
  count(s, slots, n, num_slots, out);
}

// Blocks of slot_hist the current device holds at once (cached).
cudaError_t resident_blocks(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slot_hist,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (dev < 64) cached[dev] = *out;
  return cudaSuccess;
}

}  // namespace

// slots (n,) int32, out (num_slots,) int32.  One launch on `stream`;
// allocates nothing, does not synchronise; returns the CUDA error of the
// launch (0 = success).
extern "C" int weld_slot_hist(const void* slots, long long n, int num_slots,
                              void* out, void* stream) {
  if (n < 0 || num_slots <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_blocks =
      (n + kThreads * kRows - 1) / (kThreads * kRows);
  if (row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int* sl = static_cast<const int*>(slots);
  int* o = static_cast<int*>(out);
  const long long zero_blocks =
      (num_slots + kThreads * kZeroPerThread - 1) / (kThreads * kZeroPerThread);
  const long long want = row_blocks > zero_blocks ? row_blocks : zero_blocks;
  if (want == 1) {
    slot_hist<<<1, kThreads, 0, s>>>(sl, n, num_slots, o);
    return static_cast<int>(cudaGetLastError());
  }
  int resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(want < resident ? want : resident);
  int64_t n64 = n;
  void* args[] = {&sl, &n64, &num_slots, &o};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slot_hist),
                                    dim3(grid), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

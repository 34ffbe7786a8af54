// Open-addressing hash-to-slot: every key gets a slot of a power-of-two
// table (linear probing from a Fibonacci hash), so equal keys share a
// slot and distinct keys get distinct slots.
//
// Replaces the TPU kernel of repro/kernels/hash_table.py:
//   hash_to_slot  (_kernel :80, pallas_call :136)
//
// Contract (hash_table.py:24-33): keys are int64 in the packed key
// space; rows equal to EMPTY (INT64_MIN) park at slot cap_table at once;
// table[slot] holds the key that owns the slot (EMPTY when free); `used`
// counts the slots taken, i.e. the distinct valid keys, capped at
// cap_table (a full table parks the rows it cannot place).  Slot numbers
// are implementation-defined: here they are hash positions, and which
// of two colliding keys takes the earlier slot depends on the order the
// atomics land, so they may change from run to run.  Every caller
// renumbers slots into ascending-key compact ids, which are the same on
// every run.
//
// Bound on the H100.  By bytes, the call reads n int64 keys and writes n
// int32 slots and the cap_table x 8 B table: 12 B a row beside a table of
// at most 1 MiB, all of it inside the 50 MB L2.  At the shapes the joins
// build (a few hundred to 200,000 rows) that is a microsecond or less, so
// what bounds a call is fixed cost: the launch, the grid barrier, and the
// chain of dependent L2 round trips a row makes (its key, then one atomic
// a probe).
//
// Design.  The TPU inserted the keys one at a time on a sequential grid,
// because a later row must see an earlier row's insert.  Here the rows
// insert in parallel, a warp 32 adjacent rows at a time:
// * a run of equal keys in adjacent lanes probes once: a lane whose key
//   differs from its left neighbour's (__shfl_up_sync) heads a run, only
//   heads probe, and each lane takes its run head's slot by __shfl_sync
//   (a join's build side repeats each key in adjacent rows: partsupp four
//   times).  Equal keys that are not adjacent probe apart and meet in the
//   table.  __match_any_sync, which would group those too, measured
//   slower on the card (PERF.md, PR 21);
// * a probe is one 64-bit atomicCAS of EMPTY to the key, with no read
//   before it (a fresh table's first probe is usually free): a CAS that
//   returns EMPTY took the slot, one that returns the key found it, any
//   other key moves the probe to the next slot, at most cap_table probes;
// * `used` is counted once a block: each warp adds the __popc of its
//   winning lanes to a shared count, and the block adds that to `used`
//   with one integer atomic, which is exact in any order;
// * each thread reads its first key before anything else, and each step
//   the next step's key before it probes, so the reads overlap the rest.
// The table must hold EMPTY before the first CAS, and one kernel does
// both, one launch a call: the fill as a launch of its own before the
// insert measured slower at every shape timed (PERF.md, PR 21).  Up to
// kThreads rows into up to kSharedSlots
// slots (the m:1 joins' dimension tables), build_small fills and probes
// a table in one block's shared memory and then stores it.  Otherwise
// build_table fills the table (and zeroes `used`) with grid-stride
// stores, waits at a grid-wide barrier (cooperative launch: the grid is
// a block a kThreads rows, at least enough blocks to fill kFillPerThread
// slots a thread, at most what the card holds at once), then inserts the
// rows grid-stride.  A smaller grid of several row sets a thread, their
// first probes issued together (as slot_hist reads several rows a
// thread), measured slower at the m:1 build and hardly faster at the m:n
// one: the unrolled probes cost more than the smaller barrier saves.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned long long kEmpty = 0x8000000000000000ull;  // INT64_MIN
constexpr unsigned long long kGold = 0x9E3779B97F4A7C15ull;
constexpr int kThreads = 512;
constexpr unsigned kAll = 0xffffffffu;
// build_small's table: at most this many slots (32 KB of shared memory)
constexpr int kSharedSlots = 4096;
// table slots a thread fills at most before the grid grows past the rows
constexpr int kFillPerThread = 4;

__device__ __forceinline__ void fill(unsigned long long* __restrict__ table,
                                     int cap_table, int* __restrict__ used) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < cap_table;
       i += stride) {
    table[i] = kEmpty;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *used = 0;
}

// Linear probing from the hash's slot: the slot that holds k (`won` when
// this CAS put it there), or cap_table when every slot holds another key.
__device__ __forceinline__ int probe(unsigned long long k,
                                     unsigned long long* table, int cap_table,
                                     int lg, bool& won) {
  const unsigned mask = static_cast<unsigned>(cap_table) - 1u;
  unsigned h = static_cast<unsigned>((k * kGold) >> (64 - lg));
  for (int t = 0; t < cap_table; ++t) {
    const unsigned long long cur = atomicCAS(&table[h], kEmpty, k);
    if (cur == kEmpty) {
      won = true;
      return static_cast<int>(h);
    }
    if (cur == k) return static_cast<int>(h);
    h = (h + 1u) & mask;
  }
  return cap_table;
}

__device__ __forceinline__ unsigned long long key_at(
    const long long* __restrict__ keys, int64_t i, int64_t n) {
  return i < n ? static_cast<unsigned long long>(keys[i]) : kEmpty;
}

// This thread's first row: the kernels read its key before anything
// else, so that the read overlaps the fill and the barrier.
__device__ __forceinline__ int64_t first_row() {
  return static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
}

// The rows, 32 adjacent ones a warp, grid-stride from first_row(), whose
// key is k; each step reads the next step's key before it probes.  The
// loop bound is the same for every lane of a warp, so the warp stays
// whole for the shuffles.  Returns the keys this thread's warp placed
// first.
__device__ __forceinline__ int insert(unsigned long long k,
                                      const long long* __restrict__ keys,
                                      int64_t n, int cap_table, int lg,
                                      int* __restrict__ slots,
                                      unsigned long long* table) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int placed = 0;
  for (int64_t i = first_row(); i - lane < n; i += stride) {
    const unsigned long long k_next = key_at(keys, i + stride, n);
    const bool valid = k != kEmpty;
    const unsigned long long prev = __shfl_up_sync(kAll, k, 1);
    const bool head = valid && (lane == 0 || prev != k);
    const unsigned heads = __ballot_sync(kAll, head);
    int slot = cap_table;  // parked unless placed below
    bool won = false;
    if (head) slot = probe(k, table, cap_table, lg, won);
    const unsigned below = heads & (kAll >> (31 - lane));
    const int leader = below ? 31 - __clz(below) : lane;
    slot = __shfl_sync(kAll, slot, leader);
    if (!valid) slot = cap_table;
    placed += __popc(__ballot_sync(kAll, won));
    if (i < n) slots[i] = slot;
    k = k_next;
  }
  return placed;
}

// The block's placed keys (the warps' counts summed in shared memory),
// valid in thread 0; every thread of the block has finished its inserts
// when it returns.
__device__ __forceinline__ int block_placed(int placed) {
  __shared__ int sum;
  if (threadIdx.x == 0) sum = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && placed) atomicAdd(&sum, placed);
  __syncthreads();
  return sum;
}

__device__ __forceinline__ void count_used(int placed, int* used) {
  placed = block_placed(placed);
  if (threadIdx.x == 0 && placed) atomicAdd(used, placed);
}

// Many rows or a large table: every block fills a share of the table,
// the grid waits at its barrier, and every block inserts a share of the
// rows (cooperative launch).
__global__ void __launch_bounds__(kThreads)
build_table(const long long* __restrict__ keys, int64_t n, int cap_table,
            int lg, int* __restrict__ slots, unsigned long long* table,
            int* used) {
  const unsigned long long k = key_at(keys, first_row(), n);
  fill(table, cap_table, used);
  cg::this_grid().sync();
  count_used(insert(k, keys, n, cap_table, lg, slots, table), used);
}

// At most kThreads rows and kSharedSlots slots (the m:1 joins' dimension
// tables): one block builds the table in shared memory, where a probe's
// CAS takes no L2 round trip, then stores it and `used`.
__global__ void __launch_bounds__(kThreads)
build_small(const long long* __restrict__ keys, int64_t n, int cap_table,
            int lg, int* __restrict__ slots,
            unsigned long long* __restrict__ table, int* __restrict__ used) {
  __shared__ unsigned long long local[kSharedSlots];
  const unsigned long long k = key_at(keys, first_row(), n);
  for (int i = threadIdx.x; i < cap_table; i += kThreads) local[i] = kEmpty;
  __syncthreads();
  const int placed =
      block_placed(insert(k, keys, n, cap_table, lg, slots, local));
  for (int i = threadIdx.x; i < cap_table; i += kThreads) table[i] = local[i];
  if (threadIdx.x == 0) *used = placed;
}

// Blocks of build_table the current device holds at once (cached).
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, build_table,
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

// keys (n,) int64, slots (n,) int32, table (cap_table,) int64, used ()
// int32; cap_table a power of two in [2, 2^30].  One launch on `stream`;
// allocates nothing, does not synchronise; returns the CUDA error of the
// launch (0 = success).
extern "C" int weld_hash_to_slot(const void* keys, long long n, int cap_table,
                                 void* slots, void* table, void* used,
                                 void* stream) {
  if (n < 0 || cap_table < 2 || cap_table > (1 << 30) ||
      (cap_table & (cap_table - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int lg = 0;
  while ((1 << lg) < cap_table) ++lg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_blocks = (n + kThreads - 1) / kThreads;
  if (row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long* k = static_cast<const long long*>(keys);
  int* sl = static_cast<int*>(slots);
  unsigned long long* tb = static_cast<unsigned long long*>(table);
  int* u = static_cast<int*>(used);
  if (n <= kThreads && cap_table <= kSharedSlots) {
    build_small<<<1, kThreads, 0, s>>>(k, n, cap_table, lg, sl, tb, u);
    return static_cast<int>(cudaGetLastError());
  }
  const long long fill_blocks =
      (cap_table + kThreads * kFillPerThread - 1) / (kThreads * kFillPerThread);
  const long long want = row_blocks > fill_blocks ? row_blocks : fill_blocks;
  int resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(want < resident ? want : resident);
  int64_t n64 = n;
  void* args[] = {&k, &n64, &cap_table, &lg, &sl, &tb, &u};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(build_table),
                                    dim3(grid), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

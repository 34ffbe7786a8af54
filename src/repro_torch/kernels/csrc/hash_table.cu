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
// Bound on the H100: bytes.  The call reads n int64 keys and writes n
// int32 slots and the cap_table x 8 B table: 12 B per row beside a table
// of at most 1 MiB, which stays in the 50 MB L2.  At a load factor of at
// most 0.5 a key finds its slot within one or two probes on average.
//
// Design.  The TPU inserted the keys one at a time on a sequential grid,
// because a later row must see an earlier row's insert.  Here every key
// inserts in parallel, one thread each: a thread reads the slot and, when
// it is free, claims it with a 64-bit atomicCAS; a CAS that wins, or a
// slot that already holds the key (read or returned by a losing CAS),
// gives the row its slot; any other key moves the thread to the next
// slot.  Slots only ever go from EMPTY to a key, so a stale read of
// EMPTY is harmless (the CAS then returns the truth) and a non-EMPTY read
// is final.  A winning CAS adds one to `used` with an integer atomic,
// which is exact in any order.  The fill of the table with EMPTY is a
// launch of its own before the inserts, on the same stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmpty = 0x8000000000000000ull;  // INT64_MIN
constexpr unsigned long long kGold = 0x9E3779B97F4A7C15ull;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fill_table(unsigned long long* __restrict__ table, int cap_table,
           int* __restrict__ used) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < cap_table) table[i] = kEmpty;
  if (i == 0) *used = 0;
}

__global__ void __launch_bounds__(kThreads)
insert_keys(const long long* __restrict__ keys, int64_t n, int cap_table,
            int lg, int* __restrict__ slots, unsigned long long* table,
            int* __restrict__ used) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = static_cast<unsigned long long>(keys[i]);
  int slot = cap_table;  // parked unless placed below
  if (k != kEmpty) {
    const unsigned mask = static_cast<unsigned>(cap_table) - 1u;
    unsigned h = static_cast<unsigned>((k * kGold) >> (64 - lg));
    for (int t = 0; t < cap_table; ++t) {
      unsigned long long cur =
          *reinterpret_cast<volatile unsigned long long*>(&table[h]);
      if (cur == kEmpty) {
        cur = atomicCAS(&table[h], kEmpty, k);
        if (cur == kEmpty) {
          atomicAdd(used, 1);
          slot = static_cast<int>(h);
          break;
        }
      }
      if (cur == k) {
        slot = static_cast<int>(h);
        break;
      }
      h = (h + 1u) & mask;
    }
  }
  slots[i] = slot;
}

}  // namespace

// keys (n,) int64, slots (n,) int32, table (cap_table,) int64, used ()
// int32; cap_table a power of two in [2, 2^30].  Launches on `stream`,
// allocates nothing, does not synchronise; returns the CUDA error of the
// launches (0 = success).
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
  fill_table<<<(cap_table + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<unsigned long long*>(table), cap_table,
      static_cast<int*>(used));
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    insert_keys<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const long long*>(keys), n, cap_table, lg,
        static_cast<int*>(slots), static_cast<unsigned long long*>(table),
        static_cast<int*>(used));
  }
  return static_cast<int>(cudaGetLastError());
}

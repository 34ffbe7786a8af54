// Slot histogram of the CSR group build: out[s] = #{i : slots[i] == s}
// for s < num_slots; ids outside [0, num_slots) are not counted.
//
// Replaces the TPU kernel of repro/kernels/group_build.py:
//   slot_hist  (_hist_kernel :55, pallas_call :85), called by group_build :95
//
// Bound on the H100: bytes.  The call reads n int32 slot ids and writes
// num_slots int32 counts (num_slots <= 65,537, 256 KiB, held in L2).
//
// Design.  The TPU counted serially into a VMEM tile carried across a
// sequential grid.  Here each thread adds one to its row's count with an
// integer atomicAdd: integer adds are exact in any order, so the counts
// are the same on every run.  The TPU padded the ragged last block and
// parked the pad rows in the last slot; here the grid's ragged edge is
// simply masked.  The counts are zeroed on the stream before the adds.
// Keys of an m:n join's build side repeat only a few times each, so the
// atomics rarely contend; a per-block shared-memory histogram would cut
// the L2 traffic but does not fit 65,537 counts in 227 KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slot_hist(const int* __restrict__ slots, int64_t n, int num_slots,
          int* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slots[i];
  if (s >= 0 && s < num_slots) atomicAdd(&out[s], 1);
}

}  // namespace

// slots (n,) int32, out (num_slots,) int32.  Launches on `stream`,
// allocates nothing, does not synchronise; returns the CUDA error of the
// memset and the launch (0 = success).
extern "C" int weld_slot_hist(const void* slots, long long n, int num_slots,
                              void* out, void* stream) {
  if (n < 0 || num_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(num_slots) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    slot_hist<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(slots), n, num_slots, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Segment sum of rows: out[k][c] = sum(vals[r][c] for rows r with seg[r] == k),
// for k < K and c < D; rows whose id lies outside [0, K) are dropped.
// K is unbounded: the keys are taken a window of at most `window` at a
// time, one pass over the rows each (see "Windows" below).
//
// Replaces the TPU kernels of repro/kernels/segment_reduce.py:
//   segment_sum          (_kernel :34, pallas_call :65)         -> D = 1
//   segment_sum_vectors  (_kernel_matrix :79, pallas_call :113)
//
// Bound on the H100: bytes.  The call must read n * (4 + D * sizeof(T))
// bytes (an int32 id and D values per row) and write K * D * sizeof(T);
// its D adds per row cost nothing beside them at 3.35 TB/s.
//
// Design.  The TPU turned the scatter into one-hot matmuls on its
// matrix unit, which is deterministic.  Here the same guarantee comes
// without atomics and without the K-fold one-hot work: every warp owns
// a private K x D accumulator in shared memory and takes 32 rows at a
// time.  Lanes holding the same segment id find each other with
// __match_any_sync, and each lane sums its group's values in ascending
// lane order, one shuffle per group member; the warp runs as many
// rounds as its largest group has members (one or two for uniform keys
// over K = 4096, 32 when every row shares one key).  The group's lowest
// lane adds the sum into the warp's accumulator (distinct groups touch
// distinct slots, so no two lanes write one slot).  After the rows, the
// warps' accumulators are summed in warp order into one partial per
// block in global scratch, and a second launch sums the partials in
// block order.  Every sum therefore runs in a fixed order: for a fixed
// launch shape the result is bitwise the same on every run.
//
// The price is shared memory: K * D * sizeof(T) bytes per warp caps the
// warps per block (3 warps of 64 KiB for K = 4096, D = 2, f64), so few
// warps hide the memory latency.  Each warp therefore loads kUnroll
// tiles' ids and values before it reduces the first of them, keeping
// kUnroll loads per column in flight.
//
// Windows.  The accumulator bounds the keys one pass can hold, so K past
// the caller's window (the wrapper's MAX_K = 4096) is summed in windows
// [k0, k0 + window): each pass reads every row, keeps the rows whose id
// falls in its window and writes that window's slice of `out`.  A pass
// over one window is the single-pass kernel shifted by k0, so K <= window
// runs exactly as before, and every sum keeps its fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // 227 KiB of dynamic shared memory
constexpr int kCombineThreads = 256;
constexpr int kMaxD = 4;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;

// Reduce one 32-row tile (lane holds id s, -1 when dropped, and its D
// values) into the warp's accumulator.
template <typename T, int D>
__device__ __forceinline__ void add_tile(T* mine, int s, const T (&v)[D],
                                         int lane) {
  const unsigned peers = __match_any_sync(kFull, s);
  const unsigned rounds =
      __reduce_max_sync(kFull, s >= 0 ? __popc(peers) : 0u);
  T sum[D];
#pragma unroll
  for (int c = 0; c < D; ++c) sum[c] = T(0);
  unsigned rest = peers;
  for (unsigned r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const T vj = __shfl_sync(kFull, v[c], src);
      if (rest) sum[c] += vj;
    }
    rest &= rest - 1;
  }
  if (s >= 0 && (__ffs(peers) - 1) == lane) {
#pragma unroll
    for (int c = 0; c < D; ++c) mine[s * D + c] += sum[c];
  }
}

template <typename T, int D>
__global__ void seg_partial(const int* __restrict__ seg,
                            const T* __restrict__ vals, int64_t n, int base,
                            int k, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [warps][k * D]
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kd = k * D;
  T* mine = acc + static_cast<int64_t>(warp) * kd;
  for (int j = lane; j < kd; j += 32) mine[j] = T(0);
  __syncwarp();

  const int64_t ntiles = (n + 31) / 32;
  const int64_t tstride = static_cast<int64_t>(gridDim.x) * warps;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * warps + warp;
       t0 < ntiles; t0 += kUnroll * tstride) {
    int s[kUnroll];
    T v[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = (t0 + u * tstride) * 32 + lane;
      const bool in = row < n;
      s[u] = in ? seg[row] : -1;
#pragma unroll
      for (int c = 0; c < D; ++c) v[u][c] = in ? vals[row * D + c] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = s[u] - base;  // rows past n hold -1: dropped
      const int su = (s[u] >= base && r < k) ? r : -1;
      add_tile<T, D>(mine, su, v[u], lane);
    }
  }
  __syncthreads();
  T* out = partials + static_cast<int64_t>(blockIdx.x) * kd;
  for (int j = threadIdx.x; j < kd; j += blockDim.x) {
    T sum = T(0);
    for (int w = 0; w < warps; ++w) sum += acc[static_cast<int64_t>(w) * kd + j];
    out[j] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
seg_combine(const T* __restrict__ partials, int nblocks, int kd,
            T* __restrict__ out) {
  const int j = blockIdx.x * kCombineThreads + threadIdx.x;
  if (j >= kd) return;
  T sum = T(0);
  for (int b = 0; b < nblocks; ++b) {
    sum += partials[static_cast<int64_t>(b) * kd + j];
  }
  out[j] = sum;
}

template <typename T, int D>
cudaError_t launch(const void* seg, const void* vals, int64_t n, int k,
                   int window, int warps, int nblocks, void* partials,
                   void* out, cudaStream_t s) {
  const int64_t smem = static_cast<int64_t>(warps) * window * D * sizeof(T);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      seg_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  for (int k0 = 0; k0 < k; k0 += window) {
    const int kw = k - k0 < window ? k - k0 : window;
    const int64_t wsmem = static_cast<int64_t>(warps) * kw * D * sizeof(T);
    seg_partial<T, D><<<nblocks, warps * 32, static_cast<size_t>(wsmem), s>>>(
        static_cast<const int*>(seg), static_cast<const T*>(vals), n, k0, kw,
        static_cast<T*>(partials));
    const int kd = kw * D;
    seg_combine<T><<<(kd + kCombineThreads - 1) / kCombineThreads,
                     kCombineThreads, 0, s>>>(
        static_cast<const T*>(partials), nblocks, kd,
        static_cast<T*>(out) + static_cast<int64_t>(k0) * D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* seg, const void* vals, int64_t n,
                     int k, int window, int warps, int nblocks,
                     void* partials, void* out, cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(seg, vals, n, k, window, warps, nblocks, partials, out, s);
    case 2: return launch<T, 2>(seg, vals, n, k, window, warps, nblocks, partials, out, s);
    case 3: return launch<T, 3>(seg, vals, n, k, window, warps, nblocks, partials, out, s);
    case 4: return launch<T, 4>(seg, vals, n, k, window, warps, nblocks, partials, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = f64, 2 = i32, 3 = i64.  seg (n,) int32, vals (n, d)
// row-major with 1 <= d <= 4, partials (nblocks, window, d), out (k, d);
// the keys are summed `window` at a time (1 <= window <= k).  Launches on
// `stream`, allocates nothing, does not synchronise; returns the CUDA
// error of the launches (0 = success).
extern "C" int weld_segment_sum(int dtype, const void* seg, const void* vals,
                                long long n, int k, int window, int d,
                                int warps, int nblocks, void* partials,
                                void* out, void* stream) {
  if (n <= 0 || k <= 0 || window < 1 || window > k || d < 1 || d > kMaxD ||
      warps < 1 || warps > 32 || nblocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(d, seg, vals, n, k, window, warps, nblocks, partials, out, s);
    case 1: return dispatch<double>(d, seg, vals, n, k, window, warps, nblocks, partials, out, s);
    case 2: return dispatch<int>(d, seg, vals, n, k, window, warps, nblocks, partials, out, s);
    case 3: return dispatch<long long>(d, seg, vals, n, k, window, warps, nblocks, partials, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

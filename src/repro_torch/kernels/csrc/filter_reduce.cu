// Predicated filter+reduce: out[a] = sum(vals[a][pred]) for a < A.
//
// Replaces the TPU kernels of repro/kernels/filter_reduce.py:
//   filter_reduce_sum        (_kernel :31, pallas_call :56)  -> A = 1
//   filter_reduce_sum_multi  (_kernel_multi :70, pallas_call :102)
//   filter_reduce_q6         (_kernel_fused_pred :116, pallas_call :143)
//     -> weld_filter_reduce_q6 below: the predicate is K range tests
//        lo_k <= cols[k][i] < hi_k computed in the same pass, so it never
//        exists as a column (K * sizeof(T) + sizeof(T) bytes a row).
//
// Bound on the H100: bytes.  One pass reads n * (A * sizeof(T) + 1)
// bytes (the value rows plus a 1-byte predicate) and does at most A
// adds per row; at 3.35 TB/s the reads are the whole cost (an f64 add
// is worth far less than its 8 bytes).
//
// Design: a grid-stride loop in which each thread keeps its A running
// sums in registers and reads four rows per iteration with the value
// loads issued unconditionally (a select, not a branch), so the
// predicate never serialises them.  The TPU carried one running scalar
// across its sequential grid; blocks here run in no order, so each
// block reduces its sums by a fixed tree (warp shuffles, then one warp
// over the warp sums), writes one partial per aggregate to scratch, and
// a one-block combine launch sums the partials in block order.  No
// atomics: for a fixed grid the result is bitwise the same on every
// run.  A <= kMaxA per launch; the wrapper splits wider aggregates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxA = 4;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Fixed-order block sum of each thread's A values; thread 0 writes out[a].
template <typename T, int A>
__device__ __forceinline__ void block_sum(const T (&acc)[A], T* out) {
  __shared__ T smem[kWarps][A];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const T v = warp_sum(acc[a]);
    if (lane == 0) smem[warp][a] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      T v = lane < kWarps ? smem[lane][a] : T(0);
      v = warp_sum(v);
      if (lane == 0) out[a] = v;
    }
  }
}

template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
fr_partial(const T* __restrict__ vals, const uint8_t* __restrict__ pred,
           int64_t n, T* __restrict__ partials) {
  T acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = T(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const bool p0 = pred[i] != 0;
    const bool p1 = pred[i + stride] != 0;
    const bool p2 = pred[i + 2 * stride] != 0;
    const bool p3 = pred[i + 3 * stride] != 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const T* v = vals + a * n;
      const T v0 = v[i];
      const T v1 = v[i + stride];
      const T v2 = v[i + 2 * stride];
      const T v3 = v[i + 3 * stride];
      acc[a] += p0 ? v0 : T(0);
      acc[a] += p1 ? v1 : T(0);
      acc[a] += p2 ? v2 : T(0);
      acc[a] += p3 ? v3 : T(0);
    }
  }
  for (; i < n; i += stride) {
    const bool p = pred[i] != 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const T v = vals[a * n + i];
      acc[a] += p ? v : T(0);
    }
  }
  block_sum<T, A>(acc, partials + static_cast<int64_t>(blockIdx.x) * A);
}

template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
fr_combine(const T* __restrict__ partials, int nblocks, T* __restrict__ out) {
  T acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = T(0);
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] += partials[b * A + a];
  }
  block_sum<T, A>(acc, out);
}

template <typename T, int A>
cudaError_t launch(const void* vals, const void* pred, int64_t n,
                   void* partials, int nblocks, void* out, cudaStream_t s) {
  fr_partial<T, A><<<nblocks, kThreads, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(pred), n,
      static_cast<T*>(partials));
  fr_combine<T, A><<<1, kThreads, 0, s>>>(
      static_cast<const T*>(partials), nblocks, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int a, const void* vals, const void* pred, int64_t n,
                     void* partials, int nblocks, void* out, cudaStream_t s) {
  switch (a) {
    case 1: return launch<T, 1>(vals, pred, n, partials, nblocks, out, s);
    case 2: return launch<T, 2>(vals, pred, n, partials, nblocks, out, s);
    case 3: return launch<T, 3>(vals, pred, n, partials, nblocks, out, s);
    case 4: return launch<T, 4>(vals, pred, n, partials, nblocks, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = f64, 2 = i32, 3 = i64.  vals is (a, n) row-major,
// pred n bytes of 0/1, partials (nblocks, a), out (a,).  Launches on
// `stream`, allocates nothing, does not synchronise; returns the CUDA
// error of the launches (0 = success).
extern "C" int weld_filter_reduce_sum(int dtype, const void* vals,
                                      const void* pred, long long n, int a,
                                      void* partials, int nblocks, void* out,
                                      void* stream) {
  if (n <= 0 || nblocks <= 0 || a < 1 || a > kMaxA) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(a, vals, pred, n, partials, nblocks, out, s);
    case 1: return dispatch<double>(a, vals, pred, n, partials, nblocks, out, s);
    case 2: return dispatch<int>(a, vals, pred, n, partials, nblocks, out, s);
    case 3: return dispatch<long long>(a, vals, pred, n, partials, nblocks, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

constexpr int kMaxQ6 = 8;

// One pass of the hand-fused Q6: every thread tests all K ranges of its
// rows with the column loads and the value load issued unconditionally
// (bitwise AND of the tests, a select for the value), keeps one running
// sum, and the block writes its fixed-tree sum to partials[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
q6_partial(const T* __restrict__ cols, int k, const T* __restrict__ lo,
           const T* __restrict__ hi, const T* __restrict__ val, int64_t n,
           T* __restrict__ partials) {
  T lo_r[kMaxQ6], hi_r[kMaxQ6];
#pragma unroll
  for (int c = 0; c < kMaxQ6; ++c) {
    lo_r[c] = c < k ? lo[c] : T(0);
    hi_r[c] = c < k ? hi[c] : T(0);
  }
  T acc[1] = {T(0)};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    bool keep = true;
#pragma unroll
    for (int c = 0; c < kMaxQ6; ++c) {
      if (c < k) {
        const T x = cols[c * n + i];
        keep = keep & (x >= lo_r[c]) & (x < hi_r[c]);
      }
    }
    const T v = val[i];
    acc[0] += keep ? v : T(0);
  }
  block_sum<T, 1>(acc, partials + blockIdx.x);
}

template <typename T>
cudaError_t launch_q6(const void* cols, int k, const void* lo, const void* hi,
                      const void* val, int64_t n, void* partials, int nblocks,
                      void* out, cudaStream_t s) {
  q6_partial<T><<<nblocks, kThreads, 0, s>>>(
      static_cast<const T*>(cols), k, static_cast<const T*>(lo),
      static_cast<const T*>(hi), static_cast<const T*>(val), n,
      static_cast<T*>(partials));
  fr_combine<T, 1><<<1, kThreads, 0, s>>>(
      static_cast<const T*>(partials), nblocks, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = f64.  cols is (k, n) row-major, lo/hi (k,) on the
// device, val (n,), partials (nblocks,), out a scalar; k <= kMaxQ6.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the CUDA error of the launches (0 = success).
extern "C" int weld_filter_reduce_q6(int dtype, const void* cols, int k,
                                     const void* lo, const void* hi,
                                     const void* val, long long n,
                                     void* partials, int nblocks, void* out,
                                     void* stream) {
  if (n <= 0 || nblocks <= 0 || k < 1 || k > kMaxQ6) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_q6<float>(cols, k, lo, hi, val, n, partials,
                                    nblocks, out, s);
    case 1: return launch_q6<double>(cols, k, lo, hi, val, n, partials,
                                     nblocks, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* weld_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C = A @ B for row-major A (m, k), B (k, n), C (m, n), f32 or f64.
//
// Replaces the TPU kernel of repro/kernels/tiled_matmul.py:
//   tiled_matmul (_kernel :31, pallas_call :55): (bm, bk) x (bk, bn) VMEM
//   tiles on the MXU with a (bm, bn) accumulator carried across the k grid
//   dimension, in the operand dtype (preferred_element_type=o_ref.dtype).
//
// Bound on the H100: a square product is bound by operations (2mnk
// multiply-adds; f64 has no faster path than the FP64 units here, and f32
// must not use TF32: the reference keeps full f32).  A matrix-vector
// product (n = 1, logistic regression's 4,194,304 x 64 scoring) does 2
// operations per 8 bytes of A read once, so it is bound by bytes.
//
// Design, two launch shapes behind one entry:
//  * tiles (n > 1): one 64 x 64 output tile per block of 256 threads, each
//    thread holding a 4 x 4 register micro-tile (rows ty + 16 i, columns
//    tx + 16 j, so shared-memory reads are broadcast or consecutive).  A
//    and B are staged through shared memory 16 columns / rows of k at a
//    time (A transposed, padded by one to keep the stores conflict-free).
//    Edges are masked on load and on store: no host padding.
//  * rows (n = 1): a square tile would leave 63 of 64 columns idle, so a
//    warp takes a row at a time (grid-stride), its lanes read the row
//    coalesced, and a fixed shuffle tree sums the 32 lane sums.
// Both run the k loop in one fixed order with no split-K and no atomics:
// the result is bitwise the same on every run.  No tensor cores (DMMA,
// wgmma) and no TMA: a later step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kTileThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kSide = kBN / kTN;                          // 16
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxRowBlocks = 8192;

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mm_tiles(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
         int64_t m, int64_t n, int64_t k) {
  __shared__ T as[kBK][kBM + 1];  // as[kk][row]: the A tile, transposed
  __shared__ T bs[kBK][kBN];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kBN;
  T acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
  }
  for (int64_t k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kTileThreads; ++q) {
      const int idx = threadIdx.x + q * kTileThreads;
      const int r = idx / kBK;
      const int cc = idx % kBK;
      const int64_t gr = row0 + r;
      const int64_t gc = k0 + cc;
      as[cc][r] = (gr < m && gc < k) ? a[gr * k + gc] : T(0);
    }
#pragma unroll
    for (int q = 0; q < (kBK * kBN) / kTileThreads; ++q) {
      const int idx = threadIdx.x + q * kTileThreads;
      const int r = idx / kBN;
      const int cc = idx % kBN;
      const int64_t gr = k0 + r;
      const int64_t gc = col0 + cc;
      bs[r][cc] = (gr < k && gc < n) ? b[gr * n + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T av[kTM];
      T bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gr = row0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gc = col0 + tx + kSide * j;
      if (gr < m && gc < n) c[gr * n + gc] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
mv_rows(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y,
        int64_t m, int64_t k) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps +
                     threadIdx.x / 32;
       row < m; row += warps) {
    const T* ar = a + row * k;
    T acc = T(0);
    for (int64_t j = lane; j < k; j += 32) acc += ar[j] * x[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) y[row] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int64_t m,
                   int64_t n, int64_t k, cudaStream_t s) {
  if (n == 1) {
    int64_t blocks = (m + kRowWarps - 1) / kRowWarps;
    if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
    mv_rows<T><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), m, k);
  } else {
    const int64_t gm = (m + kBM - 1) / kBM;
    const int64_t gn = (n + kBN - 1) / kBN;
    if (gm > 0x7fffffffLL || gn > 65535) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(gm), static_cast<unsigned>(gn));
    mm_tiles<T><<<grid, kTileThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), m, n, k);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = f64.  a (m, k), b (k, n) and c (m, n) are
// contiguous row-major on the device; m, n, k >= 1.  Launches on
// `stream`, allocates nothing, does not synchronise; returns the CUDA
// error of the launch (0 = success).
extern "C" int weld_tiled_matmul(int dtype, const void* a, const void* b,
                                 void* c, long long m, long long n,
                                 long long k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(a, b, c, m, n, k, s));
    case 1: return static_cast<int>(launch<double>(a, b, c, m, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = A @ B for row-major A (m, k), B (k, n), C (m, n), f32 or f64.
//
// Replaces the TPU kernel of repro/kernels/tiled_matmul.py:
//   tiled_matmul (_kernel :31, pallas_call :55): (bm, bk) x (bk, bn) VMEM
//   tiles on the MXU with a (bm, bn) accumulator carried across the k grid
//   dimension, in the operand dtype (preferred_element_type=o_ref.dtype).
//
// Bound on the H100 SXM: a square product is bound by operations, 2mnk
// over 67 TFLOP/s for f64 (the FP64 tensor cores, DMMA) and for f32 (the
// FP32 CUDA cores: the reference keeps full f32, so no TF32).  At 4096^3
// that is 2.051 ms either way.  A matrix-vector product (n = 1, logistic
// regression's 4,194,304 x 64 scoring) does 2 operations per 8 bytes of A
// read once, so it is bound by bytes: about 2.18 GB over 3.35 TB/s.
//
// Three launch shapes behind one entry:
//  * f64 tiles (n > 1) on the FP64 tensor cores.  wgmma has no f64 form,
//    so the products are DMMA through mma.sync.m16n8k4, a form sm_90
//    added (in a trial on the card the sm_80 form m8n8k4 was much slower
//    and m16n8k8 / m16n8k16 no faster; times in PERF.md).  One 128 x 128
//    output tile per block of 8 warps (4 x 2), each warp holding a
//    32 x 64 tile of f64 accumulators in registers (64 a thread, 240-254
//    registers in all, no spills).  A and B come in k-slabs of 32 through a ring of 3
//    slabs in dynamic shared memory (207 KB), filled by cp.async (16-byte
//    copies where every row starts on 16 bytes, else 8-byte copies) while
//    the warps multiply the slabs before.  A slab row of A is padded to
//    36 doubles and one of B to 132, so the fragment reads (8 bytes a
//    lane; ldmatrix has no 64-bit form) hit 32 distinct banks in each
//    half-warp.  Out-of-range rows and columns are copied with a source
//    size of 0 (zero fill) and masked on store: no host padding.  The tile
//    index is a 1-D grid, rasterised in bands of kGroupM tile rows, so
//    that the blocks in flight share their A and B panels in L2.
//  * f32 tiles (n > 1) on the FP32 CUDA cores: one 64 x 64 output tile
//    per block of 256 threads, each holding a 4 x 4 register micro-tile,
//    A and B staged through shared memory 16 k-columns at a time.
//  * rows (n = 1): a square tile would leave all but one column idle, so
//    a warp takes a row at a time (grid-stride), its lanes read the row
//    coalesced, and a fixed shuffle tree sums the 32 lane sums.
// Every launch sums each output element in one fixed k order, with no
// split-K and no atomics: the result is bitwise the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- f64 on the FP64 tensor cores -------------------------------------------

constexpr int kDBM = 128;
constexpr int kDBN = 128;
constexpr int kDBK = 32;
constexpr int kStages = 3;
constexpr int kDThreads = 256;
constexpr int kWarpsN = 2;                              // 4 x 2 warps
constexpr int kWM = kDBM / (kDThreads / 32 / kWarpsN);  // 32 rows a warp
constexpr int kWN = kDBN / kWarpsN;                     // 64 columns a warp
constexpr int kAStride = kDBK + 4;          // doubles per A slab row
constexpr int kBStride = kDBN + 4;          // doubles per B slab row
constexpr int kAStage = kDBM * kAStride;
constexpr int kBStage = kDBK * kBStride;
constexpr int kDSmemBytes = kStages * (kAStage + kBStage) * 8;
constexpr int kGroupM = 8;
static_assert(kDSmemBytes <= 232448, "a block's shared memory on sm_90");

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool in, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = in ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(gmem), "r"(src_size));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 ::"r"(dst), "l"(gmem), "r"(src_size));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One DMMA atom, d (16 x 8) += a (16 x 4) b (4 x 8), in the fragments of
// the PTX ISA for .f64 (g = lane / 4, t = lane % 4): a holds rows g and
// g + 8 of column t, b row t of column g, d rows g and g + 8 of columns
// 2 t and 2 t + 1.
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4],
                                            const double (&a)[2],
                                            double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Copy k-slab `kt` of A and B into ring slot `slot`.  kVec: every row of
// A and B starts on 16 bytes (k and n even, aligned bases), so a pair of
// doubles never straddles an edge and moves as one 16-byte copy.
template <bool kVec>
__device__ __forceinline__ void load_slab(double* as, double* bs,
                                          const double* __restrict__ a,
                                          const double* __restrict__ b,
                                          int64_t m, int64_t n, int64_t k,
                                          int64_t row0, int64_t col0,
                                          int64_t k0) {
  constexpr int kW = kVec ? 2 : 1;  // doubles a copy
  constexpr int kAPer = kDBM * kDBK / kW / kDThreads;
  constexpr int kBPer = kDBK * kDBN / kW / kDThreads;
#pragma unroll
  for (int q = 0; q < kAPer; ++q) {
    const int idx = threadIdx.x + q * kDThreads;
    const int r = idx / (kDBK / kW);
    const int c = (idx % (kDBK / kW)) * kW;
    const int64_t gr = row0 + r;
    const int64_t gc = k0 + c;
    const bool in = gr < m && gc < k;
    cp_async(as + r * kAStride + c, in ? a + gr * k + gc : a, in, 8 * kW);
  }
#pragma unroll
  for (int q = 0; q < kBPer; ++q) {
    const int idx = threadIdx.x + q * kDThreads;
    const int r = idx / (kDBN / kW);
    const int c = (idx % (kDBN / kW)) * kW;
    const int64_t gr = k0 + r;
    const int64_t gc = col0 + c;
    const bool in = gr < k && gc < n;
    cp_async(bs + r * kBStride + c, in ? b + gr * n + gc : b, in, 8 * kW);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kDThreads, 1)
mm_dmma(const double* __restrict__ a, const double* __restrict__ b,
        double* __restrict__ c, int64_t m, int64_t n, int64_t k) {
  constexpr int kTilesM = kWM / 16;
  constexpr int kTilesN = kWN / 8;
  extern __shared__ __align__(16) double smem[];
  double* as = smem;
  double* bs = smem + kStages * kAStage;

  // rasterise: bands of kGroupM tile rows, walked column by column
  const int64_t tiles_m = (m + kDBM - 1) / kDBM;
  const int64_t tiles_n = (n + kDBN - 1) / kDBN;
  const int64_t t = blockIdx.x;
  const int64_t band = t / (kGroupM * tiles_n);
  const int64_t first = band * kGroupM;
  const int64_t rows = tiles_m - first < kGroupM ? tiles_m - first : kGroupM;
  const int64_t in_band = t - band * kGroupM * tiles_n;
  const int64_t row0 = (first + in_band % rows) * kDBM;
  const int64_t col0 = (in_band / rows) * kDBN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int wr = (warp / kWarpsN) * kWM;
  const int wc = (warp % kWarpsN) * kWN;

  double acc[kTilesM][kTilesN][4];
#pragma unroll
  for (int i = 0; i < kTilesM; ++i) {
#pragma unroll
    for (int j = 0; j < kTilesN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    }
  }

  const int64_t slabs = (k + kDBK - 1) / kDBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) {
      load_slab<kVec>(as + s * kAStage, bs + s * kBStage, a, b, m, n, k,
                      row0, col0, static_cast<int64_t>(s) * kDBK);
    }
    cp_async_commit();
  }
  for (int64_t kt = 0; kt < slabs; ++kt) {
    cp_async_wait<kStages - 2>();
    // slab kt has landed for every thread, and every warp is done with
    // slab kt - 1, whose slot the next copy refills
    __syncthreads();
    const int64_t next = kt + kStages - 1;
    if (next < slabs) {
      const int slot = static_cast<int>(next % kStages);
      load_slab<kVec>(as + slot * kAStage, bs + slot * kBStage, a, b, m, n,
                      k, row0, col0, next * kDBK);
    }
    cp_async_commit();
    const int slot = static_cast<int>(kt % kStages);
    const double* sa = as + slot * kAStage + (wr + g) * kAStride + tq;
    const double* sb = bs + slot * kBStage + tq * kBStride + wc + g;
#pragma unroll
    for (int kk = 0; kk < kDBK; kk += 4) {
      double af[kTilesM][2];
      double bf[kTilesN];
#pragma unroll
      for (int i = 0; i < kTilesM; ++i) {
        af[i][0] = sa[(i * 16) * kAStride + kk];
        af[i][1] = sa[(i * 16 + 8) * kAStride + kk];
      }
#pragma unroll
      for (int j = 0; j < kTilesN; ++j) bf[j] = sb[kk * kBStride + j * 8];
#pragma unroll
      for (int i = 0; i < kTilesM; ++i) {
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) dmma_16x8x4(acc[i][j], af[i], bf[j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTilesM; ++i) {
#pragma unroll
    for (int j = 0; j < kTilesN; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t gr = row0 + wr + i * 16 + 8 * h + g;
        const int64_t gc = col0 + wc + j * 8 + 2 * tq;
        if (gr >= m) continue;
        const double v0 = acc[i][j][2 * h];
        const double v1 = acc[i][j][2 * h + 1];
        double* out = c + gr * n + gc;
        if (kVec && gc + 1 < n) {
          *reinterpret_cast<double2*>(out) = make_double2(v0, v1);
        } else {
          if (gc < n) out[0] = v0;
          if (gc + 1 < n) out[1] = v1;
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch_dmma(const double* a, const double* b, double* c,
                        int64_t m, int64_t n, int64_t k, cudaStream_t s) {
  const int64_t tiles = ((m + kDBM - 1) / kDBM) * ((n + kDBN - 1) / kDBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mm_dmma<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDSmemBytes);
  if (e != cudaSuccess) return e;
  mm_dmma<kVec><<<static_cast<unsigned>(tiles), kDThreads, kDSmemBytes,
                  s>>>(a, b, c, m, n, k);
  return cudaGetLastError();
}

cudaError_t launch_f64_tiles(const void* a, const void* b, void* c,
                             int64_t m, int64_t n, int64_t k,
                             cudaStream_t s) {
  const double* pa = static_cast<const double*>(a);
  const double* pb = static_cast<const double*>(b);
  double* pc = static_cast<double*>(c);
  const bool vec = k % 2 == 0 && n % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(c)) % 16 == 0;
  return vec ? launch_dmma<true>(pa, pb, pc, m, n, k, s)
             : launch_dmma<false>(pa, pb, pc, m, n, k, s);
}

// -- f32 on the CUDA cores --------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kTileThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kSide = kBN / kTN;                          // 16

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mm_tiles(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
         int64_t m, int64_t n, int64_t k) {
  __shared__ T as[kBK][kBM + 1];  // as[kk][row]: the A tile, transposed
  __shared__ T bs[kBK][kBN];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int64_t tiles_m = (m + kBM - 1) / kBM;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) % tiles_m) * kBM;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) / tiles_m) * kBN;
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

// -- n = 1: a warp a row ----------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxRowBlocks = 8192;

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
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 8) {
    return launch_f64_tiles(a, b, c, m, n, k, s);
  } else {
    const int64_t tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    mm_tiles<T><<<static_cast<unsigned>(tiles), kTileThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), m, n, k);
    return cudaGetLastError();
  }
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

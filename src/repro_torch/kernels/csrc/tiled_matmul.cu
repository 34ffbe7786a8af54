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
// Four launch shapes behind one entry:
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
//  * f32 tiles (n > 1) on the FP32 CUDA cores, a register-blocked
//    SGEMM: one 128 x 128 output tile per block of 256 threads, each
//    thread an 8 x 8 micro-tile (64 f32 accumulators), four 128-bit
//    shared loads a k step for 64 FMAs (the design before it, 64 x 64
//    tiles and 4 x 4 micro-tiles, issued one scalar shared load for every
//    two FMAs and was bound by shared-memory issue).  k-slabs of 8 go
//    through two buffers, B by cp.async, A by register prefetch stored
//    transposed; 16-byte copies where every row starts on 16 bytes, else
//    4-byte ones; the same 1-D rasterised grid as the f64 tiles.
//  * two row launches (n = 1), where a square tile would leave all but
//    one column idle: A streamed through shared memory by 1-D bulk copies
//    (mv_bulk), or a warp a row (mv_rows) where A does not start on 16
//    bytes or a row is too long for a stage (see "n = 1" below).
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

// -- f32 on the FP32 CUDA cores ---------------------------------------------

// A register-blocked SGEMM: one 128 x 128 output tile per block of 8 warps
// (4 x 2), each warp a 32 x 64 tile, each thread an 8 x 8 micro-tile of
// f32 accumulators split 2 x (4 x 4): rows lr*4 .. +3 and 16 + lr*4 .. +3
// of its warp's tile, columns lc*4 .. +3 and 32 + lc*4 .. +3 (lane =
// 8 lr + lc).  A k step reads four float4 from shared memory (LDS.128) for
// 64 FMAs: a warp's A reads cover 4 distinct float4 (64 bytes) and its B
// reads 8 (128 bytes), each one wavefront.  A's k-slab is stored
// transposed (k-major, rows padded to 132 floats, so that the transposing
// stores of a warp hit 32 distinct banks); B's row-major.  Slabs of 8 k go
// through two buffers: while the warps multiply one, B's next slab comes
// in by cp.async and A's next by 16-byte register loads, stored
// transposed after the multiply; one __syncthreads a slab.
constexpr int kSBM = 128;
constexpr int kSBN = 128;
constexpr int kSBK = 8;
constexpr int kSThreads = 256;
constexpr int kSWarpsN = 2;                               // 4 x 2 warps
constexpr int kSWM = kSBM / (kSThreads / 32 / kSWarpsN);  // 32 rows a warp
constexpr int kSWN = kSBN / kSWarpsN;                     // 64 columns a warp
constexpr int kLanesN = kSWN / 8;  // lanes along a warp's columns
static_assert((32 / kLanesN) * 8 == kSWM, "8 x 8 per lane fills the warp");
constexpr int kSAStride = kSBM + 4;  // floats per k row of the A slab
constexpr int kSBStride = kSBN;      // floats per k row of the B slab
constexpr int kSAStage = kSBK * kSAStride;
constexpr int kSBStage = kSBK * kSBStride;
constexpr int kSAPer = kSBM * kSBK / 4 / kSThreads;  // float4 of A a thread
constexpr int kSBPer = kSBK * kSBN / 4 / kSThreads;  // float4 of B a thread
static_assert(kSAPer * 4 * kSThreads == kSBM * kSBK, "A slab in float4");
static_assert(kSBPer * 4 * kSThreads == kSBK * kSBN, "B slab in float4");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(gmem), "r"(in ? 4 : 0));
}

// The thread's float4 `q` of A's slab at k0: row (tid + q * kSThreads) /
// (kSBK / 4) of the tile, 4 k columns; zero where out of range.  kVec: k
// is a multiple of 4 and A starts on 16 bytes, so the 4 move as one float4.
template <bool kVec>
__device__ __forceinline__ float4 fetch_a(const float* __restrict__ a,
                                          int64_t m, int64_t k, int64_t gr,
                                          int64_t gc) {
  if (kVec) {
    return gr < m && gc < k
               ? __ldg(reinterpret_cast<const float4*>(a + gr * k + gc))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = (gr < m && gc + i < k) ? __ldg(a + gr * k + gc + i) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 4 floats of B's slab (k row r, columns c .. +3) by cp.async, zero-filled
// out of range.  kVec: n is a multiple of 4 and B starts on 16 bytes: one
// 16-byte copy.
template <bool kVec>
__device__ __forceinline__ void copy_b(float* bs, const float* __restrict__ b,
                                       int64_t n, int64_t k, int r, int c,
                                       int64_t gr, int64_t gc) {
  if (kVec) {
    const bool in = gr < k && gc < n;
    cp_async(bs + r * kSBStride + c, in ? b + gr * n + gc : b, in, 16);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = gr < k && gc + i < n;
      cp_async4(bs + r * kSBStride + c + i, in ? b + gr * n + gc + i : b, in);
    }
  }
}

// float4 `q` of A's slab at k0 (row idx / (kSBK / 4) of the tile, k
// columns (idx % (kSBK / 4)) * 4 .. +3, idx = tid + q * kSThreads)
template <bool kVec>
__device__ __forceinline__ float4 fetch_a_part(const float* __restrict__ a,
                                               int64_t m, int64_t k,
                                               int64_t row0, int64_t k0,
                                               int q) {
  const int idx = threadIdx.x + q * kSThreads;
  return fetch_a<kVec>(a, m, k, row0 + idx / (kSBK / 4),
                       k0 + (idx % (kSBK / 4)) * 4);
}

// float4 `q` of A's slab from registers into `as`, transposed (k-major)
__device__ __forceinline__ void store_a_part(float* as, float4 v, int q) {
  const int idx = threadIdx.x + q * kSThreads;
  const int r = idx / (kSBK / 4);
  const int c = (idx % (kSBK / 4)) * 4;
  as[(c + 0) * kSAStride + r] = v.x;
  as[(c + 1) * kSAStride + r] = v.y;
  as[(c + 2) * kSAStride + r] = v.z;
  as[(c + 3) * kSAStride + r] = v.w;
}

// B's slab at k0 into `bs` by cp.async
template <bool kVec>
__device__ __forceinline__ void copy_b_slab(float* bs,
                                            const float* __restrict__ b,
                                            int64_t n, int64_t k,
                                            int64_t col0, int64_t k0) {
#pragma unroll
  for (int q = 0; q < kSBPer; ++q) {
    const int idx = threadIdx.x + q * kSThreads;
    const int r = idx / (kSBN / 4);
    const int c = (idx % (kSBN / 4)) * 4;
    copy_b<kVec>(bs, b, n, k, r, c, k0 + r, col0 + c);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSThreads, 2)
mm_sgemm(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, int64_t m, int64_t n, int64_t k) {
  __shared__ __align__(16) float as[2][kSAStage];
  __shared__ __align__(16) float bs[2][kSBStage];

  // rasterise as mm_dmma: bands of kGroupM tile rows, column by column
  const int64_t tiles_m = (m + kSBM - 1) / kSBM;
  const int64_t tiles_n = (n + kSBN - 1) / kSBN;
  const int64_t t = blockIdx.x;
  const int64_t band = t / (kGroupM * tiles_n);
  const int64_t first = band * kGroupM;
  const int64_t rows = tiles_m - first < kGroupM ? tiles_m - first : kGroupM;
  const int64_t in_band = t - band * kGroupM * tiles_n;
  const int64_t row0 = (first + in_band % rows) * kSBM;
  const int64_t col0 = (in_band / rows) * kSBN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the thread's first A slab row and B slab column
  const int ar = (warp / kSWarpsN) * kSWM + (lane / kLanesN) * 4;
  const int bc = (warp % kSWarpsN) * kSWN + (lane % kLanesN) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int64_t slabs = (k + kSBK - 1) / kSBK;
  copy_b_slab<kVec>(bs[0], b, n, k, col0, 0);
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < kSAPer; ++q) {
    store_a_part(as[0], fetch_a_part<kVec>(a, m, k, row0, 0, q), q);
  }
  cp_async_wait<0>();
  __syncthreads();

  // The multiply of a slab runs in kSAPer parts (one at 8 k a slab);
  // before each, one float4 of A's next slab is fetched into registers,
  // and after it stored into the other buffer (last read before the
  // barrier that ended slab kt - 1).  One float4 of prefetch live at a
  // time: with two (a 16-deep slab in one part) the thread spills past
  // 128 registers.
  constexpr int kPart = kSBK / kSAPer;  // k steps a part
  for (int64_t kt = 0; kt < slabs; ++kt) {
    const int cur = static_cast<int>(kt & 1);
    const bool more = kt + 1 < slabs;
    const int64_t k0 = (kt + 1) * kSBK;
    if (more) copy_b_slab<kVec>(bs[cur ^ 1], b, n, k, col0, k0);
    cp_async_commit();
    const float* sa = as[cur] + ar;
    const float* sb = bs[cur] + bc;
#pragma unroll
    for (int q = 0; q < kSAPer; ++q) {
      float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
      if (more) next = fetch_a_part<kVec>(a, m, k, row0, k0, q);
#pragma unroll
      for (int kk = q * kPart; kk < (q + 1) * kPart; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(sa + kk * kSAStride);
        const float4 a1 =
            *reinterpret_cast<const float4*>(sa + kk * kSAStride + kSWM / 2);
        const float4 b0 =
            *reinterpret_cast<const float4*>(sb + kk * kSBStride);
        const float4 b1 =
            *reinterpret_cast<const float4*>(sb + kk * kSBStride + kSWN / 2);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
      if (more) store_a_part(as[cur ^ 1], next, q);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gr = row0 + ar + (i < 4 ? i : kSWM / 2 - 4 + i);
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = col0 + bc + kSWN / 2 * h;
      float* out = c + gr * n + gc;
      if (kVec) {
        if (gc < n) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gc + j < n) out[j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

cudaError_t launch_f32_tiles(const void* a, const void* b, void* c,
                             int64_t m, int64_t n, int64_t k,
                             cudaStream_t s) {
  const int64_t tiles = ((m + kSBM - 1) / kSBM) * ((n + kSBN - 1) / kSBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pc = static_cast<float*>(c);
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(c)) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(tiles);
  if (vec) {
    mm_sgemm<true><<<grid, kSThreads, 0, s>>>(pa, pb, pc, m, n, k);
  } else {
    mm_sgemm<false><<<grid, kSThreads, 0, s>>>(pa, pb, pc, m, n, k);
  }
  return cudaGetLastError();
}

// -- n = 1: the rows --------------------------------------------------------
//
// A matrix-vector product reads each element of A once and does one FMA
// with it: it is bound by the bytes of A.  Two row launches, chosen by the
// wrapper from shape and alignment alone (kernels/tiled_matmul.py, plan)
// and passed in as `launch`:
//  * mv_bulk (kLaunchRowsBulk): A streamed through shared memory by
//    Hopper's 1-D bulk copy.  One persistent block of 256 threads an SM
//    walks tiles of kTileRows consecutive rows (blockIdx.x, + gridDim.x,
//    ...).  A tile of a row-major A is one contiguous run of kTileRows * k
//    elements: one elected thread brings it into a ring of 3-8 stages with
//    one cp.async.bulk, whose mbarrier reports the bytes' arrival; the
//    ring keeps up to 192 KB in flight on each SM, and no thread spends a
//    register on an address.  x is staged once a block.  Four threads take
//    a row, each a quarter of its columns from shared memory in one fixed
//    order that starts at a column rotated by lane (lane / 2 mod the
//    quarter), so that a warp's reads spread over the banks; two
//    __shfl_xor_sync steps add the quarters, and lanes 0-7 of each warp
//    store its 8 sums.  A bulk copy takes a 16-byte-aligned source and a
//    multiple of 16 bytes: A must start on 16 bytes (every full tile then
//    does, kTileRows being even) and a row may hold at most
//    kMaxBulkRowBytes (a tile fits a stage of a 3-stage ring).  The
//    partial last tile is read by the same kernel straight from global
//    memory.
//  * mv_rows (kLaunchRowsWarp), for every other A: a warp takes a row at a
//    time (grid-stride), its lanes read the row coalesced, and a fixed
//    shuffle tree sums the 32 lane sums.

constexpr int kLaunchTiles = 0;
constexpr int kLaunchRowsBulk = 1;
constexpr int kLaunchRowsWarp = 2;

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxRowBlocks = 8192;

constexpr int kTileRows = 64;
constexpr int kPartThreads = kRowThreads / kTileRows;  // threads a row
constexpr int kRingBytes = 192 * 1024;
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kMaxBulkRowBytes = kRingBytes / kMinStages / kTileRows;
constexpr int kBarBytes = 128;  // the stages' mbarriers, padded
static_assert(kTileRows % 2 == 0 && kPartThreads == 4,
              "an even tile; 2 shuffle steps add a row's parts");
static_assert(kBarBytes + kMaxBulkRowBytes + kRingBytes <= 232448,
              "the ring, x and the barriers in a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) into
// shared `dst` by one bulk copy that completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads, 1)
mv_bulk(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y,
        int64_t m, int k, int stages) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(bulk_smem);
  T* xs = reinterpret_cast<T*>(bulk_smem + kBarBytes);
  const int x_bytes = (k * static_cast<int>(sizeof(T)) + 127) / 128 * 128;
  unsigned char* ring = bulk_smem + kBarBytes + x_bytes;
  const uint32_t stage_bytes = kTileRows * k * sizeof(T);
  const int64_t full = m / kTileRows;  // tiles the bulk copy brings
  const int64_t tiles = (m + kTileRows - 1) / kTileRows;
  const int64_t mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // the copy of this block's i-th tile into stage i % stages
  auto issue = [&](int64_t i) {
    const int64_t t = blockIdx.x + i * gridDim.x;
    if (t < full) {
      const int s = static_cast<int>(i % stages);
      bulk_load(ring + s * stage_bytes, a + t * kTileRows * k, stage_bytes,
                smem_u32(bars + s));
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = threadIdx.x; j < k; j += kRowThreads) xs[j] = x[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int64_t i = 0; i < stages && i < mine; ++i) issue(i);
  }

  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / kPartThreads;  // the thread's row in a tile
  const int part = (k + kPartThreads - 1) / kPartThreads;
  const int j0 = (threadIdx.x % kPartThreads) * part;
  const int len = max(0, min(part, k - j0));
  const int rot = len > 0 ? (lane / 2) % len : 0;
  const T* xp = xs + j0;
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t t = blockIdx.x + i * gridDim.x;
    const int64_t row0 = t * kTileRows;
    const T* rows;
    if (t < full) {
      const int s = static_cast<int>(i % stages);
      mbar_wait(smem_u32(bars + s), static_cast<uint32_t>((i / stages) & 1));
      rows = reinterpret_cast<const T*>(ring + s * stage_bytes);
    } else {
      rows = a + row0 * k;  // the partial last tile
    }
    T acc = T(0);
    if (row0 + r < m) {
      const T* ap = rows + static_cast<int64_t>(r) * k + j0;
      int j = rot;
#pragma unroll 4
      for (int n = 0; n < len; ++n) {
        acc = fma_t(ap[j], xp[j], acc);
        j = j + 1 == len ? 0 : j + 1;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    // lane l < 8 stores row 8 * warp + l, which lane 4 l summed
    const T v = __shfl_sync(0xffffffffu, acc, (lane % 8) * kPartThreads);
    const int64_t row = row0 + (threadIdx.x / 32) * 8 + lane;
    if (lane < 8 && row < m) y[row] = v;
    __syncthreads();  // every thread is done with this tile's stage
    if (threadIdx.x == 0 && i + stages < mine) issue(i + stages);
  }
}

template <typename T>
cudaError_t launch_rows_bulk(const T* a, const T* x, T* y, int64_t m,
                             int64_t k, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      k * static_cast<int64_t>(sizeof(T)) > kMaxBulkRowBytes) {
    return cudaErrorInvalidValue;
  }
  const int stage_bytes = kTileRows * static_cast<int>(k * sizeof(T));
  int stages = kRingBytes / stage_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  const int x_bytes = (static_cast<int>(k * sizeof(T)) + 127) / 128 * 128;
  const int smem = kBarBytes + x_bytes + stages * stage_bytes;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mv_bulk<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (m + kTileRows - 1) / kTileRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  mv_bulk<T><<<grid, kRowThreads, smem, s>>>(a, x, y, m,
                                             static_cast<int>(k), stages);
  return cudaGetLastError();
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
cudaError_t launch(int which, const void* a, const void* b, void* c,
                   int64_t m, int64_t n, int64_t k, cudaStream_t s) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (which == kLaunchRowsBulk) {
    if (n != 1) return cudaErrorInvalidValue;
    return launch_rows_bulk<T>(pa, pb, pc, m, k, s);
  }
  if (which == kLaunchRowsWarp) {
    if (n != 1) return cudaErrorInvalidValue;
    int64_t blocks = (m + kRowWarps - 1) / kRowWarps;
    if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
    mv_rows<T><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
        pa, pb, pc, m, k);
    return cudaGetLastError();
  }
  if (which != kLaunchTiles) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 8) {
    return launch_f64_tiles(a, b, c, m, n, k, s);
  } else {
    return launch_f32_tiles(a, b, c, m, n, k, s);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = f64.  which: 0 = tiles, 1 = rows by bulk copy
// (n = 1, `a` on 16 bytes, a row of at most kMaxBulkRowBytes), 2 = rows
// a warp each (n = 1); a launch whose condition does not hold is refused
// (cudaErrorInvalidValue), never replaced.  a (m, k), b (k, n) and c (m,
// n) are contiguous row-major on the device; m, n, k >= 1.  Launches on
// `stream`, allocates nothing, does not synchronise; returns the CUDA
// error of the launch (0 = success).
extern "C" int weld_tiled_matmul(int dtype, int which, const void* a,
                                 const void* b, void* c, long long m,
                                 long long n, long long k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(which, a, b, c, m, n, k, s));
    case 1:
      return static_cast<int>(launch<double>(which, a, b, c, m, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

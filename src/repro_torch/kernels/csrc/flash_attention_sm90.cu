// Online-softmax (flash) attention with grouped-query heads for Hopper:
// bf16, any head dimension from 1 to 256, on wgmma and TMA with a
// warp-specialised pipeline.  The wrapper (flash_attention.py) sends every
// bf16 call here; f32 stays on the kernel of flash_attention.cu.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py:74
//   flash_attention (_kernel :28, pallas_call :101), and computes what it
//   computes, in its order: scores in f32 times `scale`, kv padding masked
//   by kj < skv, the causal mask kj <= qi + (skv - sq) (q positions are the
//   last Sq of the sequence), kv head = q head // group, p rounded to v's
//   dtype (bf16) before the PV product, and the output divided by
//   max(l, 1e-30) (here: times its reciprocal, within an f32 rounding).
//
// Bound on the H100 at the serving prefill (B = 4, H = 24, Hkv = 8,
// S = 2048, D = 128, causal): 4 * B * H * D operations per unmasked (q, kv)
// pair over B * H * S (S + 1) / 2 pairs, 1.03e11 operations over the
// 989 TFLOP/s bf16 dense tensor-core peak = 0.1043 ms, against 134 MB of
// q, k, v and o over 3.35 TB/s = 0.040 ms: bound by operations.  Only
// wgmma reaches that rate, so both products run on it, and the loads are
// left to the TMA unit so that the warps that issue wgmma do nothing else.
//
// Design.
//  * A work item is 128 q rows of one (batch, head); its walk runs over the
//    kv tiles in ascending order.  The grid is persistent, one block per
//    SM: block k takes items k, k + grid, ... of a list ordered longest walk
//    first (q tiles in reverse, then heads, then batches), so every SM
//    starts on the longest walks and the next item's Q and first K/V tiles
//    load while the last item's output is stored.  Under the causal mask
//    the kv tiles wholly above an item's diagonal are never loaded, and
//    only the tiles that cross a warpgroup's diagonal or the kv end apply
//    the mask.
//  * Warp specialisation, 3 warpgroups.  The producer (warpgroup 2, one
//    thread, 24 registers after setmaxnreg) issues the TMA loads: an
//    item's Q once, then each K and V tile into a ring of kStages stages in
//    shared memory that runs on across items, each completion signalled on
//    an mbarrier ("full"), each buffer reused once the 8 consumer warps
//    have released it ("empty").  The two consumer warpgroups (240
//    registers) own 64 q rows of each item.
//  * The head dimension is padded with zeros to DP = 64 ceil(D / 64) in
//    shared memory: every tile is stored as DP / 64 panels of 64 head-dim
//    columns (128 bytes a row) in the 128-byte swizzle that TMA writes and
//    the wgmma descriptors read.  A tensor map's row is D columns wide (or
//    the width of a packed copy, below), so TMA fills the columns past it
//    with zeros on every load: they add exact zeros to S and give O
//    columns that are never stored.  TMA needs every row stride and base
//    on 16 bytes; the wrapper first copies an operand that has none (a D
//    of 14, a view of an odd H * D) into zero-padded rows of 8 ceil(D / 8)
//    columns with pack_rows below, one launch for all such operands.
//  * Tiles of 128 kv rows at DP 64 and 128 (Q and two K/V stages take
//    160 KB of dynamic shared memory at DP 128), of 64 kv rows at DP 192
//    and 256 (at 128 rows they would take 240 and 320 KB of the 227 KB;
//    at 64 they take 144 and 192 KB).  A consumer thread holds DP / 2 f32
//    accumulators of O (128 registers at DP 256) and BK / 2 of S.
//  * S = Q K^T: wgmma m64n128k16 (m64n64k16 for 64-row tiles), bf16 in,
//    f32 out, Q and K both K-major from shared memory.  O += P V: wgmma
//    m64n128k16 over each pair of V's panels (m64n64k16 over an odd last
//    one) with P from registers (the S accumulators rounded to bf16, as
//    the TPU kernel's p.astype(v.dtype)) and V from shared memory as an
//    MN-major B operand (the transpose flag of 16-bit types).  The softmax runs on the accumulators in registers,
//    in the log2 domain as flash_attention.cu's, with scale * log2(e)
//    folded into one FMA per score before the SFU's exp2.
//  * Overlap: the warpgroups take turns on the tensor cores (named
//    barriers 1 and 2).  In its turn a warpgroup issues S of tile j and
//    P V of tile j - 1 together, then hands the turn over and runs the
//    softmax of tile j while the other warpgroup's products run, and
//    while its own P V runs (it waits for S alone first).  The softmax is
//    on the critical path, so the scale rides in the exponent's FMA and a
//    warp whose rows kept their maxima skips O's rescale.
//  * Every sum runs in one fixed kv order with no atomics, so two runs are
//    bitwise equal.  TMA zero-fills rows past Sq or Skv on load; the store
//    masks rows >= Sq and columns >= D, two columns a 4-byte store where
//    D is even, one at a time otherwise.  q, k and v are read through
//    their (batch, head, seq) strides: the tensor maps are built from them on the host, so the
//    (B, T, H, D) activations of a layer go in as (B, H, T, D) views
//    without a copy.  The maps are encoded by cuTensorMapEncodeTiled,
//    fetched from the driver through the runtime (cudaGetDriverEntryPoint),
//    so the library does not link libcuda.
#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;      // q rows a block: two consumer warpgroups of 64
constexpr int kStages = 2;    // the K/V ring
constexpr int kPanel = 64;    // head-dim columns of one 128-byte panel row
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr float kMask = -1e30f;  // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  int64_t o_sb, o_sh, o_ss;  // element strides of o's (batch, head, seq)
  int batch, heads, qtiles, group, sq, skv, causal;
  int d;      // the head dimension: columns of o written
  int pairs;  // o's rows take 4-byte stores of two columns (D even)
  float scale;
};

// The kv rows of a tile at padded head dimension DP: what fits two stages
// of K and V beside Q in shared memory.
constexpr int kv_rows(int dp) { return dp <= 128 ? 128 : 64; }

// Byte offsets in the (1024-byte aligned) dynamic shared memory.
template <int DP, int BK>
struct Layout {
  static constexpr int kTile = BK * DP * 2;      // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * DP * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // mbarriers: Q full, Q empty; K full, V full, K empty, V empty per stage
  static constexpr int kBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars;
};

// The dynamic shared memory a block of the DP instantiation takes: its
// layout + the 1024-byte alignment.
template <int DP>
constexpr int block_smem() { return Layout<DP, kv_rows(DP)>::kBytes + 1024; }

// The most dynamic shared memory one block may take on an H100.
constexpr int kSmemLimit = 232448;
static_assert(block_smem<64>() <= kSmemLimit, "DP 64 does not fit");
static_assert(block_smem<128>() <= kSmemLimit, "DP 128 does not fit");
static_assert(block_smem<192>() <= kSmemLimit, "DP 192 does not fit");
static_assert(block_smem<256>() <= kSmemLimit, "DP 256 does not fit");

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// -- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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

// one box of the 4-D map (D, S, H, B) at (c0, c1, c2, c3) into `dst`,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- named barriers: the consumer warpgroups' turns -------------------------

__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// -- wgmma ------------------------------------------------------------------

// A shared-memory matrix descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// K-major tiles: 8-row groups 1024 bytes apart (the stride offset), the
// leading offset unused.  MN-major tiles: the same 8-row (k) groups, and
// 64-column panels `lbo` bytes apart (the leading offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of `r` across an asynchronous
// wgmma that reads or writes it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)
#define F32(d) F16(d, 0), F16(d, 16)
#define F64(d) F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)

// D (64 x 128, f32) {+}= A (64 x 16, shared) B (16 x 128, shared)^T: both
// operands K-major, through their descriptors; `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) {+}= A (64 x 16, shared) B (16 x 64, shared)^T: both
// operands K-major, through their descriptors; `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared): B is
// MN-major (its rows are the k index), hence the transpose flag
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared): B is
// MN-major (its rows are the k index), hence the transpose flag
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp2 on the SFU (ex2.approx.ftz: flushes subnormal results, which are
// below any weight that moves a bf16 output)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile, first half.  A thread holds rows g and
// g + 8 of its warp's 16 (qi0 is row g's causal limit) at columns
// 8i + 2t + {0, 1} (the wgmma accumulator layout): mask when kMasked, take
// the row maxima of the raw scores, update the running max and the
// thread's share of the normaliser, and leave p = exp2(scale log2(e)
// (qk - max)) in `s`, the scale folded into one FMA per score.  Returns O's
// rescale factors for rows g and g + 8 in c0, c1.  It touches neither O
// nor the P fragments, so it runs while the previous tile's P V is in
// flight.
template <bool kMasked, int BK>
__device__ __forceinline__ void softmax_scores(
    const Params& p, float (&s)[BK / 2], float& m0, float& m1, float& l0,
    float& l1, float& c0, float& c1, float sl2, int kv0, int qi0, int t) {
  float mx0 = kMask, mx1 = kMask;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    if constexpr (kMasked) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kv0 + 8 * i + 2 * t + (e & 1);
        const int qi = e < 2 ? qi0 : qi0 + 8;
        if (kj >= p.skv || (p.causal && kj > qi)) s[4 * i + e] = kMask;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  c0 = ex2((m0 - mn0) * sl2);
  c1 = ex2((m1 - mn1) * sl2);
  m0 = mn0;
  m1 = mn1;
  const float b0 = -mn0 * sl2;
  const float b1 = -mn1 * sl2;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    s[4 * i] = ex2(fmaf(s[4 * i], sl2, b0));
    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl2, b0));
    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl2, b1));
    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl2, b1));
    r0 += s[4 * i] + s[4 * i + 1];
    r1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 = l0 * c0 + r0;
  l1 = l1 * c1 + r1;
}

// The second half, once the previous P V has completed: rescale O (skipped
// by a warp none of whose rows raised its max: a product by 1 is exact),
// and round p to bf16 into `pa` as the A fragments of the next P V product
// (k step kk in pa[4 kk .. 4 kk + 3]), the TPU kernel's p.astype(v.dtype).
template <int NO, int BK>
__device__ __forceinline__ void rescale_and_pack(const float (&s)[BK / 2],
                                                 float (&o)[NO],
                                                 uint32_t (&pa)[BK / 4],
                                                 float c0, float c1) {
  if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      o[4 * i] *= c0;
      o[4 * i + 1] *= c0;
      o[4 * i + 2] *= c1;
      o[4 * i + 3] *= c1;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[4 * kk + r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
  }
}

// Work item i of a launch: q tile (longest walks first), then head (the
// heads of a kv group side by side, so their K and V tiles meet in L2), then
// batch.
struct Item {
  int q0, h, b, ntiles;
};

template <int BK>
__device__ __forceinline__ Item item_at(const Params& p, int i) {
  Item it;
  const int hb = p.heads * p.batch;
  it.q0 = (p.qtiles - 1 - i / hb) * kBQ;
  it.h = i % hb % p.heads;
  it.b = i % hb / p.heads;
  int last = p.skv - 1;  // the last kv row the item's q rows see
  if (p.causal) last = min(last, min(it.q0 + kBQ, p.sq) - 1 + p.skv - p.sq);
  it.ntiles = last / BK + 1;
  return it;
}

// one column pair (c, c + 1) of an output row, c even and < d: a 4-byte
// store where the rows allow it, else each column inside the row alone
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c,
                                           const Params& p, float lo,
                                           float hi) {
  if (p.pairs) {
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(lo, hi);
  } else {
    row[c] = __float2bfloat16(lo);
    if (c + 1 < p.d) row[c + 1] = __float2bfloat16(hi);
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Layout<DP, BK>;
  constexpr int kPanels = DP / kPanel;
  extern __shared__ __align__(1024) unsigned char smem[];
  // the swizzle atoms (8 rows x 128 bytes) sit on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full_q = base + L::kBar;
  const uint32_t empty_q = full_q + 8;
  auto full_k = [&](int s) { return full_q + 8 * (2 + s); };
  auto full_v = [&](int s) { return full_q + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (2 + 3 * kStages + s); };
  const int items = p.qtiles * p.heads * p.batch;
  const int offset = p.skv - p.sq;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A persistent block walks items blockIdx.x, + gridDim.x, ...  The K/V
  // ring runs on across items (jt counts this block's tiles), so the next
  // item's Q and first tiles load while the consumers finish the last.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int jt = 0;
      int n = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
        const Item it = item_at<BK>(p, i);
        const int hk = it.h / p.group;
        mbar_wait(empty_q, (n & 1) ^ 1);  // the last item's S is done
        mbar_expect_tx(full_q, kBQ * DP * 2);
        for (int c = 0; c < kPanels; ++c) {
          tma_load(base + L::kQ + c * kBQ * 128, &qmap, full_q, c * kPanel,
                   it.q0, it.h, it.b);
        }
        for (int j = 0; j < it.ntiles; ++j, ++jt) {
          const int s = jt % kStages;
          const uint32_t ph = (jt / kStages) & 1;
          mbar_wait(empty_k(s), ph ^ 1);
          mbar_expect_tx(full_k(s), L::kTile);
          for (int c = 0; c < kPanels; ++c) {
            tma_load(base + L::kK + s * L::kTile + c * BK * 128, &kmap,
                     full_k(s), c * kPanel, j * BK, hk, it.b);
          }
          mbar_wait(empty_v(s), ph ^ 1);
          mbar_expect_tx(full_v(s), L::kTile);
          for (int c = 0; c < kPanels; ++c) {
            tma_load(base + L::kV + s * L::kTile + c * BK * 128, &vmap,
                     full_v(s), c * kPanel, j * BK, hk, it.b);
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 q rows of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const float sl2 = p.scale * kLog2e;
    const uint32_t qa = base + L::kQ + 64 * wg * 128;  // its rows of Q

    float s[BK / 2];
    float o[DP / 2];
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = 0u;
    float m0, m1, l0, l1;
    int row0, first, jt0 = 0;

    // one turn of this warpgroup: S of tile j (kS) and P V of tile j - 1
    // (kPV), issued together as two wgmma groups; then the softmax of tile
    // j, whose first half runs once S has landed, while P V is still in
    // flight.  The flags are compile-time, so no wgmma sits under a
    // data-dependent branch (ptxas would serialise them).  jt0 + j is the
    // tile's place in the ring.
    auto step = [&](auto with_s, auto with_pv, int j) {
      constexpr bool kS = decltype(with_s)::value;
      constexpr bool kPV = decltype(with_pv)::value;
      const int sk = (jt0 + j) % kStages;
      const int sv = (jt0 + j - 1) % kStages;
      if constexpr (kS) mbar_wait(full_k(sk), ((jt0 + j) / kStages) & 1);
      if constexpr (kPV) {
        mbar_wait(full_v(sv), ((jt0 + j - 1) / kStages) & 1);
      }
      turn_wait(1 + wg);
      pin(s);
      pin(o);
      pin(pa);
      wgmma_fence();
      if constexpr (kS) {
        const uint32_t kb = base + L::kK + sk * L::kTile;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;  // 16 columns = 32 bytes
          const uint64_t dq = sw128_desc(qa + (kk / 4) * kBQ * 128 + col, 16);
          const uint64_t dk = sw128_desc(kb + (kk / 4) * BK * 128 + col, 16);
          if constexpr (BK == 128) {
            wgmma_ss_n128(s, dq, dk, kk > 0);
          } else {
            wgmma_ss_n64(s, dq, dk, kk > 0);
          }
        }
        wgmma_commit();
      }
      if constexpr (kPV) {
        const uint32_t vb = base + L::kV + sv * L::kTile;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // O's columns of panel c are o[32 c .. 32 c + 31]
#pragma unroll
          for (int c = 0; c + 2 <= kPanels; c += 2) {
            wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 32 * c),
                          pa + 4 * kk,
                          sw128_desc(vb + c * BK * 128 + kk * 16 * 128,
                                     BK * 128));
          }
          if constexpr (kPanels % 2 == 1) {
            constexpr int c = kPanels - 1;
            wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(o + 32 * c),
                         pa + 4 * kk,
                         sw128_desc(vb + c * BK * 128 + kk * 16 * 128,
                                    BK * 128));
          }
        }
        wgmma_commit();
      }
      // hand the turn to the other warpgroup (its last turn needs none)
      if (kS || wg == 0) turn_pass(2 - wg);
      float c0 = 1.f, c1 = 1.f;
      if constexpr (kS) {
        if constexpr (kPV) {
          wgmma_wait<1>();  // S has landed; P V may still run
        } else {
          wgmma_wait<0>();
        }
        pin(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_k(sk));
        const int kv0 = j * BK;
        if (kv0 + BK > p.skv || (p.causal && kv0 + BK - 1 > first)) {
          softmax_scores<true, BK>(p, s, m0, m1, l0, l1, c0, c1, sl2, kv0,
                                   row0 + offset, t);
        } else {
          softmax_scores<false, BK>(p, s, m0, m1, l0, l1, c0, c1, sl2, kv0,
                                    row0 + offset, t);
        }
      }
      if constexpr (kPV) {
        wgmma_wait<0>();
        pin(o);
        pin(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v(sv));
      }
      if constexpr (kS) rescale_and_pack<DP / 2, BK>(s, o, pa, c0, c1);
    };

    int n = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
      const Item it = item_at<BK>(p, i);
      row0 = it.q0 + 64 * wg + 16 * warp + g;  // and row0 + 8
      first = it.q0 + 64 * wg + offset;  // the warpgroup's first limit
#pragma unroll
      for (int k = 0; k < DP / 2; ++k) o[k] = 0.f;
      m0 = m1 = kMask;
      l0 = l1 = 0.f;

      if (wg == 1) turn_pass(1);  // warpgroup 0 takes the first turn
      mbar_wait(full_q, n & 1);
      step(Flag<true>{}, Flag<false>{}, 0);
      for (int j = 1; j < it.ntiles; ++j) {
        step(Flag<true>{}, Flag<true>{}, j);
      }
      // every S of the item has completed: Q may be reloaded
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_q);
      step(Flag<false>{}, Flag<true>{}, it.ntiles);
      jt0 += it.ntiles;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // O / max(l, 1e-30), as one reciprocal a row and products
      const float d0 = 1.f / fmaxf(l0, 1e-30f);
      const float d1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                          it.b * p.o_sb + it.h * p.o_sh;
#pragma unroll
      for (int k = 0; k < DP / 8; ++k) {
        const int c = 8 * k + 2 * t;
        if (c < p.d) {
          if (row0 < p.sq) {
            store_pair(og + row0 * p.o_ss, c, p, o[4 * k] * d0,
                       o[4 * k + 1] * d0);
          }
          if (row0 + 8 < p.sq) {
            store_pair(og + (row0 + 8) * p.o_ss, c, p, o[4 * k + 2] * d1,
                       o[4 * k + 3] * d1);
          }
        }
      }
    }
  }
}

// -- the packing pass --------------------------------------------------------

// One operand to pack: (B, H, S, D) bf16 rows read through element strides
// (the head dimension's too) into contiguous (B, H, S, W) rows, W = 8
// ceil(D / 8), columns D .. W - 1 zero.
struct PackOp {
  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  int64_t sb, sh, ss, sd;
  int heads, seq;
};

struct PackParams {
  PackOp op[3];
  int batch, d, w;
};

// Operand blockIdx.y: each thread writes 16-byte chunks of the packed rows
// (8 columns), grid-stride, each column read on its own.  Bound by bytes:
// at the prefill's (4, 24/8, 2,048) and D 14, 9.2 MB read and 10.5 MB
// written, 6 us at 3.35 TB/s beside an attention of about 0.1 ms.
__global__ void __launch_bounds__(256) pack_rows(const PackParams p) {
  const PackOp& op = p.op[blockIdx.y];
  const int chunks = p.w / 8;
  const int64_t total =
      static_cast<int64_t>(p.batch) * op.heads * op.seq * chunks;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % chunks);
    const int64_t r = i / chunks;
    const int s = static_cast<int>(r % op.seq);
    const int h = static_cast<int>(r / op.seq % op.heads);
    const int b = static_cast<int>(r / op.seq / op.heads);
    const __nv_bfloat16* row = op.src + b * op.sb + h * op.sh + s * op.ss;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = 8 * c + e;
      v[e] = col < p.d ? row[col * op.sd] : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(op.dst + i * 8) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// -- the host side ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// The 4-D map (W, S, H, B) of a bf16 (B, H, S, W) tensor read through its
// element strides: boxes of 64 columns x `rows` rows in the 128-byte
// swizzle, zeros for columns past W and rows past S.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int batch, int heads, int seq, int width, int rows,
                  long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t run(const CUtensorMap& qm, const CUtensorMap& km,
                const CUtensorMap& vm, const Params& p, cudaStream_t s) {
  constexpr int BK = kv_rows(DP);
  constexpr int smem = block_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  // one persistent block per SM (at most one fits), none idle
  const long long items =
      static_cast<long long>(p.qtiles) * p.heads * p.batch;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  flash_sm90<DP, BK><<<blocks, kThreads, smem, s>>>(qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k and v (B, H / group, Skv, D), o (B, H, Sq, D), all
// bf16, each with the element strides of its batch, head and sequence
// dimensions in `strides` (q, k, v, o in turn: 12 values; those of q, k
// and v multiples of 8) and a unit-stride head dimension; `plan` the
// wrapper's layout of the call (flash_attention.sm90_plan): the columns of
// a row of q, k and v as stored (D, or W = 8 ceil(D / 8) for a packed copy
// whose columns past D are zero), then DP, the kv rows of a tile and the
// block's dynamic shared memory, which must be this file's (a plan that
// disagrees with its layout is refused).  D is any of 1 .. 256, Sq and
// Skv at least 1 and, under the causal mask, Sq <= Skv (without it an item
// walks every kv tile, the partial last one masked by kj < skv); q, k and
// v 16-byte aligned.  Launches on `stream`, allocates nothing, does not
// synchronise.  Returns 0, a CUDA error of the launch, or WELD_TMA_ERROR +
// r when cuTensorMapEncodeTiled returned CUresult r (WELD_TMA_ERROR alone:
// the driver has no such entry point).
#define WELD_TMA_ERROR (1 << 20)
extern "C" int weld_flash_attention_sm90(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides,
                                         const int* plan, int batch,
                                         int heads, int group, int sq, int skv,
                                         int d, int causal, float scale,
                                         void* stream) {
  const int qtiles = (sq + kBQ - 1) / kBQ;
  const int dp = 64 * ((d + 63) / 64);
  bool ok = batch >= 1 && heads >= 1 && group >= 1 && heads % group == 0 &&
            sq >= 1 && skv >= 1 && !(causal && skv < sq) && d >= 1 &&
            d <= 256 &&
            static_cast<long long>(qtiles) * heads * batch <= 0x7fffffff;
  for (int i = 0; i < 3 && ok; ++i) {
    ok = plan[i] == d || (plan[i] == 8 * ((d + 7) / 8) && plan[i] <= dp);
  }
  const int smem = dp == 64    ? block_smem<64>()
                   : dp == 128 ? block_smem<128>()
                   : dp == 192 ? block_smem<192>()
                               : block_smem<256>();
  ok = ok && plan[3] == dp && plan[4] == kv_rows(dp) && plan[5] == smem;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return WELD_TMA_ERROR;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(enc, &qm, q, batch, heads, sq, plan[0], kBQ,
                        strides[0], strides[1], strides[2]);
  if (r == CUDA_SUCCESS) {
    r = make_map(enc, &km, k, batch, heads / group, skv, plan[1], plan[4],
                 strides[3], strides[4], strides[5]);
  }
  if (r == CUDA_SUCCESS) {
    r = make_map(enc, &vm, v, batch, heads / group, skv, plan[2], plan[4],
                 strides[6], strides[7], strides[8]);
  }
  if (r != CUDA_SUCCESS) return WELD_TMA_ERROR + static_cast<int>(r);
  Params p;
  p.o = o;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.batch = batch;
  p.heads = heads;
  p.qtiles = qtiles;
  p.group = group;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.d = d;
  p.pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0 &&
            strides[9] % 2 == 0 && strides[10] % 2 == 0 &&
            strides[11] % 2 == 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dp) {
    case 64: err = run<64>(qm, km, vm, p, s); break;
    case 128: err = run<128>(qm, km, vm, p, s); break;
    case 192: err = run<192>(qm, km, vm, p, s); break;
    default: err = run<256>(qm, km, vm, p, s); break;
  }
  return static_cast<int>(err);
}

// The packing pass before weld_flash_attention_sm90 for the operands TMA
// cannot map: `n` (1 .. 3) operands, each 8 values of `desc`: source and
// destination pointers, heads, seq, and the source's batch, head, seq and
// column element strides.  Every destination is a contiguous (batch,
// heads, seq, w) bf16 buffer on 16 bytes, w = 8 ceil(d / 8).  One launch
// on `stream`; returns its CUDA error.
extern "C" int weld_flash_attention_pack(int n, const long long* desc,
                                         int batch, int d, int w,
                                         void* stream) {
  if (n < 1 || n > 3 || batch < 1 || d < 1 || d > 256 ||
      w != 8 * ((d + 7) / 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackParams p;
  p.batch = batch;
  p.d = d;
  p.w = w;
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    const long long* x = desc + 8 * i;
    PackOp& op = p.op[i];
    op.src = reinterpret_cast<const __nv_bfloat16*>(x[0]);
    op.dst = reinterpret_cast<__nv_bfloat16*>(x[1]);
    op.heads = static_cast<int>(x[2]);
    op.seq = static_cast<int>(x[3]);
    op.sb = x[4];
    op.sh = x[5];
    op.ss = x[6];
    op.sd = x[7];
    if (op.heads < 1 || op.seq < 1 || x[1] % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long chunks = static_cast<long long>(batch) * op.heads *
                             op.seq * (w / 8);
    most = chunks > most ? chunks : most;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (most + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  pack_rows<<<dim3(blocks, n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

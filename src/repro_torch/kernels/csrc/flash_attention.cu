// Online-softmax (flash) attention with grouped-query heads, bf16 and f32.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py:74
//   flash_attention (_kernel :28, pallas_call :101): a (head, q-block,
//   kv-block) grid whose last dimension runs in order, carrying the running
//   max m, the normaliser l and an f32 accumulator in VMEM scratch from one
//   kv block to the next; scores in f32 scaled by d**-0.5, kv padding
//   masked by kj < skv, the causal mask kj <= qi + (skv - sq) (q positions
//   are the last Sq of the sequence), kv head = q head // group in the
//   index map, p cast to v's dtype before the PV product, and the output
//   divided by max(l, 1e-30).
//
// Bound on the H100, at the serving prefill (B = 4, H = 24, Hkv = 8,
// S = 2048, D = 128, bf16, causal): 4 * B * H * D operations per unmasked
// (q, kv) pair, B * H * S (S + 1) / 2 pairs, about 1.03e11 operations over
// the 989 TFLOP/s bf16 dense tensor-core peak = 0.104 ms, against 134 MB of
// q, k, v and o over 3.35 TB/s = 0.040 ms: bound by operations.  So the bf16
// products run on the tensor cores and the kernel keeps the (Sq, Skv)
// scores out of device memory: K and V are read once per q tile.
//
// Design.  There is no sequential grid on the card: one block owns a
// (q tile, head, batch) and walks the kv tiles itself, in ascending order,
// with m, l and the accumulator in registers.  Under the causal mask the kv
// tiles wholly above the diagonal are skipped (they would add exact zeros),
// and the q tiles are handed out last-first so that the longest walks start
// first.  Every sum runs in one fixed order with no atomics, so two runs
// give bitwise equal results.
//  * bf16: 4 warps, 64 q rows (16 a warp) x 64 kv rows a tile.  K and V
//    tiles come into shared memory by cp.async in two stages (tile j + 1
//    loads while tile j computes; rows padded by 16 bytes, so ldmatrix
//    reads them without bank conflicts).  S = Q K^T and O += P V run on
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), their B fragments by
//    ldmatrix (V's transposed); P goes from the S accumulators to the A
//    fragments in registers, rounded to bf16 as the TPU kernel's
//    p.astype(v.dtype).
//    Scores are taken in the log2 domain (exp2 of scale * log2(e) * qk):
//    the same softmax.
//  * f32: the CUDA cores in full f32 (no TF32, which the 67 TFLOP/s FP32
//    bound of this route does not reckon with), expf as the reference's
//    exp.  A register-blocked kernel: 8 warps, 64 q rows x 64 kv rows a
//    tile, each thread a 4 x 4 micro-tile of S and a 4 x (DP / 16) one of
//    O, 128-bit shared loads on XOR-swizzled tiles, K and V by cp.async
//    overlapped with the arithmetic (flash_f32 below).  Bound by
//    operations: 4 D FLOP a pair, about 1.0e11 at the prefill shape over
//    67 TFLOP/s = 1.54 ms.
// The head dimension is padded with zeros to 64, 128 or 256 in shared
// memory (the padded columns add exact zeros); D is any of 1 .. 256, and
// Sq <= Skv under the causal mask (without it any Sq: every q tile walks
// every kv tile, the last one masked by kj < skv).  Rows move in 16-byte
// copies where every row of q, k, v and o starts on 16 bytes and D fills
// whole 16-byte chunks (the VEC kernels); any other operands (qwen2's
// smoke D 14, a (B, T, H, D) view of an odd H * D) move element by
// element, zero-filled up to DP (VEC = false): the entry decides from the
// pointers, strides and D at each launch.  The bf16 route with D 64 or
// 128 has a Hopper kernel of its own (flash_attention_sm90.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e30f;  // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of (batch, head, seq); the head dimension is unit-stride
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int group, sq, skv, d, causal;
  float scale;
};

// The number of kv tiles of width `bk` the q rows [q0, q0 + bq) need.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int bq,
                                        int bk) {
  int last = p.skv - 1;
  if (p.causal) {
    const int qlast = min(q0 + bq, p.sq) - 1 + (p.skv - p.sq);
    last = min(last, qlast);
  }
  return last / bk + 1;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads16 = 128;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// rows [r0, r0 + 64) of a (seq, D) slab into smem rows of `ld` elements,
// zero-filled past `rows` and past column d: by asynchronous 16-byte
// copies (VEC), or element by element with plain loads and stores (a
// bf16 is smaller than cp.async's least copy); the barrier before the
// tile's use orders either
template <int DP, bool VEC>
__device__ __forceinline__ void load_tile16(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src,
                                            int64_t ss, int r0, int rows,
                                            int d) {
  if constexpr (VEC) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks a row
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads16) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      const bool in = r0 + r < rows && c < d;
      const __nv_bfloat16* from = in ? src + (r0 + r) * ss + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * ld + c)),
                   "l"(from), "r"(in ? 16 : 0));
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads16) {
      const int r = idx / DP;
      const int c = idx % DP;
      dst[r * ld + c] = r0 + r < rows && c < d
                            ? src[(r0 + r) * ss + c]
                            : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives (row l / 4, columns 2 (l % 4) + {0, 1}) of each
// (of the transposed matrices with .trans)
__device__ __forceinline__ void ldm_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldm_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// columns c, c + 1 (c < d, c even) of an output row: one 4-byte store
// (VEC), else each column that lies inside the row on its own
template <bool VEC>
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int d,
                                           float lo, float hi) {
  if constexpr (VEC) {
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(lo, hi);
  } else {
    row[c] = __float2bfloat16(lo);
    if (c + 1 < d) row[c + 1] = __float2bfloat16(hi);
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads16)
flash_bf16(const Params p) {
  constexpr int LD = DP + 8;   // smem row: 16 bytes of padding, so the 8
                               // rows of an ldmatrix phase hit 32 banks
  constexpr int KS = DP / 16;  // k steps of S = Q K^T
  constexpr int NT = kBK / 8;  // n tiles of S
  constexpr int DT = DP / 8;   // n tiles of O
  constexpr bool kQRegs = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  // Q, then two stages of (K, V): tile j + 1 loads while tile j computes
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage0 = qs + kBQ * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the 8-row group
  const int t = lane % 4;   // thread within the quad
  const int lm = lane / 8;  // the ldmatrix matrix this lane addresses
  const int lr = lane % 8;  // and its row there
  const int hk = h / p.group;
  const int offset = p.skv - p.sq;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + hk * p.v_sh;

  const int ntiles = kv_tiles(p, q0, kBQ, kBK);
  load_tile16<DP, VEC>(qs, LD, qg, p.q_ss, q0, p.sq, p.d);
  load_tile16<DP, VEC>(stage0, LD, kg, p.k_ss, 0, p.skv, p.d);
  load_tile16<DP, VEC>(stage0 + kBK * LD, LD, vg, p.v_ss, 0, p.skv, p.d);
  cp_commit();

  const int wr = warp * 16;  // this warp's first row in the tile
  // the A fragments of this warp's 16 q rows, k step kk
  const __nv_bfloat16* qa = qs + (wr + (lm % 2) * 8 + lr) * LD + (lm / 2) * 8;
  uint32_t qf[kQRegs ? KS : 1][4];

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }
  // rows g and g + 8 of this warp: running max (log2 domain) and the
  // lane's share of the normaliser
  float m0 = kMask, m1 = kMask, l0 = 0.f, l1 = 0.f;
  const int qi0 = q0 + wr + g + offset;  // causal limit of row g
  const int qi1 = qi0 + 8;
  const float sl2 = p.scale * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * kBK;
    if (j + 1 < ntiles) {
      __nv_bfloat16* next = stage0 + ((j + 1) % 2) * 2 * kBK * LD;
      load_tile16<DP, VEC>(next, LD, kg, p.k_ss, kv0 + kBK, p.skv, p.d);
      load_tile16<DP, VEC>(next + kBK * LD, LD, vg, p.v_ss, kv0 + kBK, p.skv,
                      p.d);
      cp_commit();
      cp_wait<1>();  // everything but the tile just asked for
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = stage0 + (j % 2) * 2 * kBK * LD;
    const __nv_bfloat16* vs = ks + kBK * LD;
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldm_x4(qf[kk], qa + kk * 16);
      }
    }

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // B fragments of n tiles n, n + 1: K rows (n + lm / 2) * 8 + lr
    const __nv_bfloat16* kb = ks + ((lm / 2) * 8 + lr) * LD + (lm % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldm_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldm_x4(bf, kb + n * 8 * LD + kk * 16);
        mma16816(s[n], a, bf[0], bf[1]);
        mma16816(s[n + 1], a, bf[2], bf[3]);
      }
    }

    // scale into the log2 domain, mask, and take the row maxima
    float mx0 = kMask, mx1 = kMask;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kv0 + n * 8 + 2 * t + (e & 1);
        const int qi = e < 2 ? qi0 : qi1;
        float x = s[n][e] * sl2;
        if (kj >= p.skv || (p.causal && kj > qi)) x = kMask;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0);
    const float c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      r0 += s[n][0] + s[n][1];
      r1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + r0;
    l1 = l1 * c1 + r1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= c0; o[i][1] *= c0; o[i][2] *= c1; o[i][3] *= c1;
    }

    // O += P V: the S accumulators of n tiles 2kk, 2kk + 1 are the A
    // fragment of k step kk; V's B fragments come transposed, two d tiles
    // at a time (V rows kk * 16 + (lm % 2) * 8 + lr, columns i * 8 +
    // (lm / 2) * 8)
    const __nv_bfloat16* vb = vs + ((lm % 2) * 8 + lr) * LD + (lm / 2) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        uint32_t bf[4];
        ldm_x4_trans(bf, vb + kk * 16 * LD + i * 8);
        mma16816(o[i], a, bf[0], bf[1]);
        mma16816(o[i + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t;
    if (c < p.d) {
      if (row0 < p.sq) store_pair<VEC>(og + row0 * p.o_ss, c, p.d,
                                       o[i][0] / d0, o[i][1] / d0);
      if (row1 < p.sq) store_pair<VEC>(og + row1 * p.o_ss, c, p.d,
                                       o[i][2] / d1, o[i][3] / d1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

// A register-blocked flash attention in full f32 (no TF32).  A block of
// 8 warps owns 64 q rows and walks kv tiles of 64 rows.  Thread (rg, cg)
// = (tid / 16, tid % 16) holds the scores of q rows 4 rg .. 4 rg + 3
// against kv columns cg + 16 j (j < 4), and the output of the same 4 rows
// at columns 4 cg + 64 h .. + 3 (h < DP / 64): a 4 x 8 micro-tile of O at
// DP = 128.  Every row's 16 threads lie in one half-warp, so the row max
// and sum are __shfl_xor_sync butterflies (offsets 1, 2, 4, 8: the same
// two partial sums meet at each level, so every lane ends with the same
// bits).  S = Q K^T reads, for 4 columns of d, one LDS.128 of each of its
// 4 q rows and 4 kv rows for 64 FFMAs; O += P V one LDS.128 of P (stored
// transposed, kv-major) and DP / 64 of V for 4 DP / 16 FFMAs.  Q, K and V
// are 64 x DP tiles whose 16-byte chunk c of row r sits at chunk c ^ (r &
// 7), so that the reads of a warp (rows 4 apart for Q, consecutive kv
// rows for K, one row for V, 16 kv rows for P's stores) spread over the
// banks without padding.  K and V come by 16-byte cp.async in FA2's
// order, one buffer each: V(j) loads while S(j) is computed, K(j + 1)
// while PV(j) is; two __syncthreads a tile.  At DP = 128 the tiles take
// 112 KB, so two blocks share an SM.
constexpr int kBQ32 = 64;
constexpr int kBK32 = 64;
constexpr int kThreads32 = 256;

// the chunk that holds 16-byte chunk c of tile row r
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

// rows [r0, r0 + 64) of a (seq, D) f32 slab into a 64 x DP tile by
// asynchronous copies (chunk c of row r at chunk swz(r, c)), zero-filled
// past `rows` and past column d.  VEC: 16-byte copies; a thread copies one
// column chunk of every kStep-th row, walking one source pointer (an
// unrolled loop would keep each copy's 64-bit address in registers across
// the kv loop).  Else 4-byte copies, one an element.
template <int DP, bool VEC>
__device__ __forceinline__ void load_tile32(float* dst, const float* src,
                                            int64_t ss, int r0, int rows,
                                            int d) {
  if constexpr (VEC) {
    constexpr int kChunks = DP / 4;
    constexpr int kStep = kThreads32 / kChunks;  // rows a pass of the block
    const int c = threadIdx.x % kChunks;
    const bool col_in = c * 4 < d;
    int r = threadIdx.x / kChunks;
    const float* from = src + (r0 + r) * ss + c * 4;
#pragma unroll 1
    for (; r < 64; r += kStep, from += kStep * ss) {
      const bool in = col_in && r0 + r < rows;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * DP + swz(r, c) * 4)),
                   "l"(in ? from : src), "r"(in ? 16 : 0));
    }
  } else {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads32) {
      const int r = idx / DP;
      const int c = idx % DP;
      const bool in = r0 + r < rows && c < d;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + r * DP + swz(r, c / 4) * 4 + c % 4)),
                   "l"(in ? src + (r0 + r) * ss + c : src), "r"(in ? 4 : 0));
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads32, DP <= 128 ? 2 : 1)
flash_f32(const Params p) {
  constexpr int kChunks = DP / 4;
  constexpr int kOC = DP / 64;  // O chunks (4 columns) a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBQ32 * DP;
  float* vs = ks + kBK32 * DP;
  float* pt = vs + kBK32 * DP;  // P transposed: kv row n, q row r at n, r

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ32;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  const int hk = h / p.group;
  const int qi0 = q0 + 4 * rg + (p.skv - p.sq);  // causal limit of row 4 rg

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile32<DP, VEC>(qs, qg, p.q_ss, q0, p.sq, p.d);
  load_tile32<DP, VEC>(ks, kg, p.k_ss, 0, p.skv, p.d);
  cp_commit();

  // this thread's 4 q rows and 4 kv rows in the tiles, and the chunk
  // swizzles of each (the q rows' are 4 (rg & 1) + i, the kv rows' cg & 7)
  const float* qrow = qs + 4 * rg * DP;
  const float* krow = ks + cg * DP;
  const int qx = 4 * (rg & 1);
  const int kx = cg & 7;

  float o[4][4 * kOC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * kOC; ++e) o[i][e] = 0.f;
  }
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
  }

  const int ntiles = kv_tiles(p, q0, kBQ32, kBK32);
  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * kBK32;
    cp_wait<0>();
    __syncthreads();  // K(j) has landed; V(j - 1) and P(j - 1) are consumed
    load_tile32<DP, VEC>(vs, vg, p.v_ss, kv0, p.skv, p.d);
    cp_commit();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    }
    // unrolled by 2 here and by 16 in O += P V: the fastest of the
    // unrolls tried on the H100 that build without spills at DP = 128
#pragma unroll 2
    for (int c = 0; c < kChunks; ++c) {
      const int kc = (c ^ kx) * 4;
      float4 kv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = lds4(krow + jj * 16 * DP + kc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = lds4(qrow + i * DP + ((c ^ (qx + i)) * 4));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float acc = s[i][jj];
          acc = fmaf(qv.x, kv[jj].x, acc);
          acc = fmaf(qv.y, kv[jj].y, acc);
          acc = fmaf(qv.z, kv[jj].z, acc);
          acc = fmaf(qv.w, kv[jj].w, acc);
          s[i][jj] = acc;
        }
      }
    }

    // scale, mask, the rows' online softmax, and O rescaled to the new
    // row maxima (the PV product below adds this tile)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kMask;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = kv0 + cg + 16 * jj;
        float x = s[i][jj] * p.scale;
        if (kj >= p.skv || (p.causal && kj > qi0 + i)) x = kMask;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = expf(s[i][jj] - mn);
        rs += s[i][jj];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int e = 0; e < 4 * kOC; ++e) o[i][e] *= corr;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = cg + 16 * jj;
      *reinterpret_cast<float4*>(pt + n * kBQ32 + swz(n, rg) * 4) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    }
    cp_wait<0>();
    __syncthreads();  // V(j) has landed and P(j) is stored; K(j) is consumed
    if (j + 1 < ntiles) {
      load_tile32<DP, VEC>(ks, kg, p.k_ss, kv0 + kBK32, p.skv, p.d);
    }
    cp_commit();

#pragma unroll 16
    for (int n = 0; n < kBK32; ++n) {
      const float4 pv = lds4(pt + n * kBQ32 + swz(n, rg) * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int hh = 0; hh < kOC; ++hh) {
        const float4 vv = lds4(vs + n * DP + (16 * hh + (cg ^ (n & 7))) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * hh + 0] = fmaf(pr[i], vv.x, o[i][4 * hh + 0]);
          o[i][4 * hh + 1] = fmaf(pr[i], vv.y, o[i][4 * hh + 1]);
          o[i][4 * hh + 2] = fmaf(pr[i], vv.z, o[i][4 * hh + 2]);
          o[i][4 * hh + 3] = fmaf(pr[i], vv.w, o[i][4 * hh + 3]);
        }
      }
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int hh = 0; hh < kOC; ++hh) {
      const int c = 4 * cg + 64 * hh;
      if constexpr (VEC) {
        if (c < p.d) {
          *reinterpret_cast<float4*>(og + row * p.o_ss + c) = make_float4(
              o[i][4 * hh] / den, o[i][4 * hh + 1] / den,
              o[i][4 * hh + 2] / den, o[i][4 * hh + 3] / den);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < p.d) og[row * p.o_ss + c + e] = o[i][4 * hh + e] / den;
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DP, bool VEC>
cudaError_t run(int dtype, const Params& p, int batch, int heads,
                cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid((p.sq + kBQ - 1) / kBQ, heads, batch);
    const size_t smem = sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * (DP + 8);
    return launch(flash_bf16<DP, VEC>, grid, kThreads16, smem, p, s);
  }
  const dim3 grid((p.sq + kBQ32 - 1) / kBQ32, heads, batch);
  const size_t smem =
      sizeof(float) * ((kBQ32 + 2 * kBK32) * DP + kBK32 * kBQ32);
  // the whole of the SM's unified memory as shared memory: two blocks of
  // 112 KB at DP = 128
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32<DP, VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch(flash_f32<DP, VEC>, grid, kThreads32, smem, p, s);
}

// every row of every operand starts on 16 bytes and D fills whole 16-byte
// chunks: the rows can move in 16-byte copies
bool rows_on_16_bytes(int dtype, const void* const* ptrs,
                      const long long* strides, int d) {
  const int per = dtype == 0 ? 8 : 4;  // elements in 16 bytes
  if (d % per != 0) return false;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  for (int i = 0; i < 12; ++i) {
    if (strides[i] % per != 0) return false;
  }
  return true;
}

template <bool VEC>
cudaError_t run_d(int dtype, const Params& p, int batch, int heads,
                  cudaStream_t s) {
  if (p.d <= 64) return run<64, VEC>(dtype, p, batch, heads, s);
  if (p.d <= 128) return run<128, VEC>(dtype, p, batch, heads, s);
  return run<256, VEC>(dtype, p, batch, heads, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  q (B, H, Sq, D), k and v (B, H / group, Skv,
// D), o (B, H, Sq, D), each with the element strides of its batch, head and
// sequence dimensions in `strides` (q, k, v, o in turn: 12 values; a
// dimension of size 1 may be given any stride) and a unit-stride head
// dimension of any D from 1 to 256.  Rows move in 16-byte copies where
// rows_on_16_bytes holds, else element by element.  Launches on `stream`,
// allocates nothing, does not synchronise; returns the CUDA error of the
// launch (0 = success).
extern "C" int weld_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int batch,
                                    int heads, int group, int sq, int skv,
                                    int d, int causal, float scale,
                                    void* stream) {
  if (batch < 1 || heads < 1 || group < 1 || heads % group != 0 || sq < 1 ||
      skv < 1 || (causal && skv < sq) || d < 1 || d > 256 ||
      heads > 65535 || batch > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.group = group; p.sq = sq; p.skv = skv; p.d = d; p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, o};
  const cudaError_t err =
      rows_on_16_bytes(dtype, ptrs, strides, d)
          ? run_d<true>(dtype, p, batch, heads, s)
          : run_d<false>(dtype, p, batch, heads, s);
  return static_cast<int>(err);
}

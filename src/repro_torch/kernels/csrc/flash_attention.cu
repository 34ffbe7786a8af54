// Online-softmax (flash) attention with grouped-query heads in f32, on the
// CUDA cores.  bf16 runs on the Hopper kernel of flash_attention_sm90.cu.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py:74
//   flash_attention (_kernel :28, pallas_call :101): a (head, q-block,
//   kv-block) grid whose last dimension runs in order, carrying the running
//   max m, the normaliser l and an f32 accumulator in VMEM scratch from one
//   kv block to the next; scores in f32 scaled by d**-0.5, kv padding
//   masked by kj < skv, the causal mask kj <= qi + (skv - sq) (q positions
//   are the last Sq of the sequence), kv head = q head // group in the
//   index map, and the output divided by max(l, 1e-30).
//
// Design.  There is no sequential grid on the card: one block owns a
// (q tile, head, batch) and walks the kv tiles itself, in ascending order,
// with m, l and the accumulator in registers.  Under the causal mask the kv
// tiles wholly above the diagonal are skipped (they would add exact zeros),
// and the q tiles are handed out last-first so that the longest walks start
// first.  Every sum runs in one fixed order with no atomics, so two runs
// give bitwise equal results.  The CUDA cores compute in full f32 (no
// TF32, which the 67 TFLOP/s FP32 bound of this route does not reckon
// with), expf as the reference's exp.  A register-blocked kernel: 8 warps,
// 64 q rows x 64 kv rows a tile, each thread a 4 x 4 micro-tile of S and a
// 4 x (DP / 16) one of O, 128-bit shared loads on XOR-swizzled tiles, K and
// V by cp.async overlapped with the arithmetic (flash_f32 below).  Bound by
// operations: 4 D FLOP a pair, about 1.0e11 at the serving prefill (B = 4,
// H = 24, Hkv = 8, S = 2048, D = 128, causal) over 67 TFLOP/s = 1.54 ms.
// The head dimension is padded with zeros to 64, 128 or 256 in shared
// memory (the padded columns add exact zeros); D is any of 1 .. 256, and
// Sq <= Skv under the causal mask (without it any Sq: every q tile walks
// every kv tile, the last one masked by kj < skv).  Rows move in 16-byte
// copies where every row of q, k, v and o starts on 16 bytes and D fills
// whole 16-byte chunks (the VEC kernels); any other operands (a (B, T, H,
// D) view of an odd H * D) move element by element, zero-filled up to DP
// (VEC = false): the entry decides from the pointers, strides and D at
// each launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e30f;  // the reference's masked score

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
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
cudaError_t run(const Params& p, int batch, int heads, cudaStream_t s) {
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
bool rows_on_16_bytes(const void* const* ptrs, const long long* strides,
                      int d) {
  constexpr int per = 4;  // f32 elements in 16 bytes
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
cudaError_t run_d(const Params& p, int batch, int heads, cudaStream_t s) {
  if (p.d <= 64) return run<64, VEC>(p, batch, heads, s);
  if (p.d <= 128) return run<128, VEC>(p, batch, heads, s);
  return run<256, VEC>(p, batch, heads, s);
}

}  // namespace

// f32 q (B, H, Sq, D), k and v (B, H / group, Skv, D), o (B, H, Sq, D),
// each with the element strides of its batch, head and sequence dimensions
// in `strides` (q, k, v, o in turn: 12 values; a dimension of size 1 may be
// given any stride) and a unit-stride head dimension of any D from 1 to
// 256.  Rows move in 16-byte copies where rows_on_16_bytes holds, else
// element by element.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the CUDA error of the launch (0 = success).
extern "C" int weld_flash_attention(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int batch,
                                    int heads, int group, int sq, int skv,
                                    int d, int causal, float scale,
                                    void* stream) {
  if (batch < 1 || heads < 1 || group < 1 || heads % group != 0 || sq < 1 ||
      skv < 1 || (causal && skv < sq) || d < 1 || d > 256 ||
      heads > 65535 || batch > 65535) {
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
  const cudaError_t err = rows_on_16_bytes(ptrs, strides, d)
                              ? run_d<true>(p, batch, heads, s)
                              : run_d<false>(p, batch, heads, s);
  return static_cast<int>(err);
}

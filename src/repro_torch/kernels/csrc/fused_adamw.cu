// One fused AdamW step over a flat parameter, in place:
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g g
//   p' = p - lr (m' / c1 / (sqrt(v' / c2) + eps) + wd p)
// with c1 = 1 - b1^t and c2 = 1 - b2^t (computed once by the caller, in
// f32).  p is bf16 or f32, g bf16 or f32, m and v f32; all arithmetic is
// f32 and p is rounded to its own dtype (to nearest, ties to even) only
// at the end.
//
// Replaces the TPU kernel of repro/kernels/fused_adamw.py:
//   adamw_update  (_kernel :27, pallas_call :64)
//
// Bound on the H100: bytes.  Each element reads p, g, m, v and writes p,
// m, v once: 2 |p| + |g| + 16 bytes, about 20 flops — two orders of
// magnitude below the card's 295 flops per byte.
//
// Design.  The TPU kernel padded the parameter to a multiple of its
// 16,384-lane block and walked the blocks in a grid, returning new
// arrays.  Here a grid-stride loop of 256-thread blocks (a few per SM)
// covers the array; each thread takes 8 consecutive elements per
// iteration with 16-byte loads and stores (two float4 for an f32 array,
// one uint4 of 8 bf16), and a scalar loop takes the ragged tail.  When
// any of the four pointers is not 16-byte aligned the whole array takes
// the scalar loop.  p, m and v are written in place, so a step needs no
// second copy of the optimizer state.  Every operation is an explicit
// round-to-nearest intrinsic (no fused multiply-add), so the result is
// that of the plain version's separate IEEE operations, and the same on
// every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
// resident blocks per SM the grid is sized for
constexpr int kBlocksPerSm = 8;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, c1, c2;
};

__device__ __forceinline__ float step(float p, float g, float& m, float& v,
                                      const Hyper& h) {
  const float mn = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float vn = __fadd_rn(__fmul_rn(h.b2, v),
                             __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, h.c2)), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(mn, h.c1), den),
                              __fmul_rn(h.wd, p));
  m = mn;
  v = vn;
  return __fsub_rn(p, __fmul_rn(h.lr, upd));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// 8 consecutive elements at a 16-byte aligned address, as f32
__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = w[i];
    const float2 f = __bfloat1622float2(pair);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&x)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_adamw(TP* __restrict__ p, const TG* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, int64_t n,
            bool vec, Hyper h) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t groups = n / kVec;
    for (int64_t i = tid; i < groups; i += stride) {
      const int64_t at = i * kVec;
      float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
      load8(p + at, pp);
      load8(g + at, gg);
      load8(m + at, mm);
      load8(v + at, vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        pp[j] = step(pp[j], gg[j], mm[j], vv[j], h);
      store8(p + at, pp);
      store8(m + at, mm);
      store8(v + at, vv);
    }
    done = groups * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float mm = m[i], vv = v[i];
    const float pn = step(to_f32(p[i]), to_f32(g[i]), mm, vv, h);
    from_f32(pn, p + i);
    m[i] = mm;
    v[i] = vv;
  }
}

template <typename TP, typename TG>
cudaError_t launch(void* p, const void* g, void* m, void* v, int64_t n,
                   const Hyper& h, cudaStream_t s) {
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * (vec ? kVec : 1);
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms[dev]) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  fused_adamw<TP, TG><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, vec, h);
  return cudaGetLastError();
}

}  // namespace

// p (n,) of p_dtype, g (n,) of g_dtype (0 = bf16, 1 = f32), m and v (n,)
// f32; p, m and v are updated in place.  omb1 and omb2 are 1 - b1 and
// 1 - b2 as the caller rounds them to f32; c1 and c2 the bias
// corrections.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the CUDA error of the launch (0 = success).
extern "C" int weld_fused_adamw(int p_dtype, int g_dtype, void* p,
                                const void* g, void* m, void* v, long long n,
                                float lr, float b1, float omb1, float b2,
                                float omb2, float eps, float wd, float c1,
                                float c2, void* stream) {
  if (n < 0 || p_dtype < 0 || p_dtype > 1 || g_dtype < 0 || g_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, c1, c2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p_dtype == 0 && g_dtype == 0)
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, n, h, s);
  else if (p_dtype == 0)
    err = launch<__nv_bfloat16, float>(p, g, m, v, n, h, s);
  else if (g_dtype == 0)
    err = launch<float, __nv_bfloat16>(p, g, m, v, n, h, s);
  else
    err = launch<float, float>(p, g, m, v, n, h, s);
  return static_cast<int>(err);
}

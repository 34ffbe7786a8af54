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
// What held the first version back: the warps an SM holds.  Every warp
// kept a private K x D accumulator in shared memory, so at K = 4096 a
// block held 7 warps (D = 1, f64: B4) or 3 (D = 2, f64: B5).  A warp
// reduced each 32-row tile in a long dependent chain (__match_any_sync,
// __reduce_max_sync, rounds of shuffles, a shared-memory read-modify-
// write), 0.49-0.51 us a tile whatever D and the dtype, which three to
// seven warps could not overlap: B5 f64 ran at 0.148 of its byte bound.
//
// Design.  The TPU turned the scatter into one-hot matmuls on its matrix
// unit, which is deterministic.  Here the same guarantee comes without
// float atomics, and the warps an SM holds no longer shrink with
// K x D x sizeof(T): a block of kWarps warps keeps `replicas` copies of
// the window's K x D accumulator in shared memory (as many as fit beside
// the staged rows; one at K = 4096), and within a replica every key is
// owned by one warp: key kk by owner kk % owners (interleaved, so that a
// skew towards low ids, Zipf, spreads over the owners; each owner's keys
// lie together in the accumulator, so its tiles hit random banks).
//   - Rows come into shared memory a chunk of up to kMaxTiles 32-row
//     tiles at a time, double-buffered with cp.async (16-byte copies,
//     4-byte ones for a ragged tail): the next chunk is in flight while
//     the block reduces this one, and one load serves every owner.
//   - The warps write, for every tile and owner, the 32-bit mask of the
//     rows that owner takes: one ballot of the rows in the window and one
//     a bit of the owner index (log2(owners) + 1 ballots a tile).
//   - Each owner reads the masks of its replica's tiles (one a lane),
//     scans their counts, and gathers its rows in row order into full
//     32-row tiles held in registers (a binary search over the counts
//     finds a lane's tile; a partial tile carries over to the next
//     chunk).  add_tile adds a tile into the owner's slots: each round,
//     for every slot, the lowest lane still holding a row of it, elected
//     by an integer atomicMax on a per-slot tag; a hot slot (8 or more
//     rows left after a round) is summed with __match_any_sync and
//     shuffles instead, which costs more a tile but not a round a row.
// At K = 4096, D = 2, f64 a replica and its tags are 80 KiB, and a block
// of 16 warps with 25-tile chunks takes 112.8 KiB, so an SM holds two
// blocks: 32 warps where the first version held 3.  At small K every
// warp is a replica of its own and owns every key.  The kernel is bound
// by the warp-wide operations a tile takes (ballots, shuffles, the
// rounds), not by its bytes: PERF.md gives the times.  One hot key puts
// its rows on one owner a replica, which then sums them while the other
// owners of its block wait at the chunk's barrier: correct, and slower.
//
// Every sum runs in a fixed order: within a block, a key's rows in row
// order (chunks in order, then tiles, then lanes; a hot slot's rest after
// its first round as one sum in lane order), then the replicas in order
// into one partial per block, then the blocks in a fixed grouping
// (seg_combine).  The launch shape depends only on (n, K, D, dtype)
// (segment_reduce.py's launch_config), so the result is bitwise the same
// on every run.
//
// Windows.  The accumulator bounds the keys one pass can hold, so K past
// the caller's window (the wrapper's MAX_K = 4096) is summed in windows
// [k0, k0 + window): each pass reads every row, keeps the rows whose id
// falls in its window and writes that window's slice of `out`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // 227 KiB of dynamic shared memory
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTiles = 32;   // 32-row tiles of a chunk, at most
constexpr int kMatchFrom = 8;   // rows left after a round: match them
constexpr int kCombineCols = 32;
constexpr int kCombineGroups = 8;
constexpr int kMaxD = 4;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int64_t align16(int64_t b) {
  return (b + 15) & ~int64_t(15);
}

// Slots of one replica: each of its owners holds ceil(k / owners).
__host__ __device__ constexpr int64_t replica_slots(int k, int replicas) {
  return static_cast<int64_t>(kWarps / replicas) *
         ((k + kWarps / replicas - 1) / (kWarps / replicas));
}

// Shared memory of one block: the replicas' accumulators and their
// election tags (a word a slot), two chunk buffers of `tiles` 32-row
// tiles (ids, then values) and the owner masks [tiles][owners].
template <typename T, int D>
__host__ __device__ constexpr int64_t acc_bytes(int k, int replicas) {
  return align16(replicas * replica_slots(k, replicas) * D * sizeof(T));
}
__host__ __device__ constexpr int64_t tag_bytes(int k, int replicas) {
  return align16(replicas * replica_slots(k, replicas) * 4);
}
template <typename T, int D>
__host__ __device__ constexpr int64_t buf_bytes(int tiles) {
  return static_cast<int64_t>(tiles) * 32 * (4 + D * sizeof(T));
}
template <typename T, int D>
__host__ __device__ constexpr int64_t smem_bytes(int k, int replicas,
                                                 int tiles) {
  return acc_bytes<T, D>(k, replicas) + tag_bytes(k, replicas) +
         2 * buf_bytes<T, D>(tiles) +
         static_cast<int64_t>(tiles) * (kWarps / replicas) * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// nbytes (a multiple of 4) from 16-byte-aligned global memory to 16-byte-
// aligned shared memory: 16-byte cp.async, then 4-byte ones for the tail.
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src,
                                      int nbytes) {
  const int n16 = nbytes >> 4;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + 16 * i)),
                 "l"(src + 16 * i));
  }
  for (int i = 4 * n16 + threadIdx.x; i < (nbytes >> 2); i += kThreads) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst + 4 * i)),
                 "l"(src + 4 * i));
  }
}

// Position of the r-th (from 0) set bit of m; m holds more than r.
__device__ __forceinline__ int nth_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// Add one 32-row tile (lane holds slot s, -1 when empty, and its D values)
// into `mine`, each slot's rows in ascending lane order.  A round adds,
// for every slot, the lowest lane still holding a row of it, elected by
// an integer atomicMax of (round << 5 | 31 - lane) on the slot's tag
// (`round` counts the warp's rounds, so an earlier round's tag always
// loses).  When kMatchFrom or more rows are left after a round (a hot
// slot), the rest of each slot is summed in lane order with
// __match_any_sync and shuffles and added at once.  Which path a row
// takes depends only on the tile's ids, so the order is fixed.
template <typename T, int D>
__device__ __forceinline__ void add_tile(T* mine, unsigned* tags, int s,
                                         const T (&v)[D], int lane,
                                         unsigned& round) {
  bool left = s >= 0;
  for (;;) {
    ++round;
    const unsigned tag = (round << 5) | static_cast<unsigned>(31 - lane);
    if (left) atomicMax(tags + s, tag);
    __syncwarp();
    if (left && tags[s] == tag) {
#pragma unroll
      for (int c = 0; c < D; ++c) mine[s * D + c] += v[c];
      left = false;
    }
    __syncwarp();
    const unsigned rest = __ballot_sync(kFull, left);
    if (!rest) return;
    if (__popc(rest) >= kMatchFrom) break;
  }
  const unsigned peers = __match_any_sync(kFull, left ? s : -1);
  const unsigned rounds = __reduce_max_sync(kFull, left ? __popc(peers) : 0u);
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
  if (left && (__ffs(peers) - 1) == lane) {
#pragma unroll
    for (int c = 0; c < D; ++c) mine[s * D + c] += sum[c];
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
seg_partial(const int* __restrict__ seg, const T* __restrict__ vals,
            int64_t n, int base, int k, int replicas, int tiles,
            T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int owners = kWarps / replicas;  // a power of two
  const int obits = __ffs(owners) - 1;
  const int per_owner = (k + owners - 1) >> obits;
  const int rslots = per_owner * owners;  // slots of one replica
  const int chunk = tiles * 32;
  T* acc = reinterpret_cast<T*>(smem);
  unsigned* tags =
      reinterpret_cast<unsigned*>(smem + acc_bytes<T, D>(k, replicas));
  unsigned char* bufs =
      smem + acc_bytes<T, D>(k, replicas) + tag_bytes(k, replicas);
  unsigned* masks =
      reinterpret_cast<unsigned*>(bufs + 2 * buf_bytes<T, D>(tiles));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rep = warp >> obits;
  const int own = warp & (owners - 1);
  const int rtiles = tiles / replicas;  // a replica's tiles of a chunk
  const int t0 = rep * rtiles;
  // the owner's slots: key kk (kk % owners == own) at slot kk / owners
  const int first = rep * rslots + own * per_owner;
  T* mine = acc + static_cast<int64_t>(first) * D;
  unsigned* mytags = tags + first;
  for (int j = threadIdx.x; j < replicas * rslots * D; j += kThreads) {
    acc[j] = T(0);
  }
  for (int j = threadIdx.x; j < replicas * rslots; j += kThreads) tags[j] = 0;

  const int64_t nchunks = (n + chunk - 1) / chunk;
  auto load_chunk = [&](int64_t c, int b) {
    if (c < nchunks) {
      const int64_t r0 = c * chunk;
      const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
      unsigned char* dst = bufs + b * buf_bytes<T, D>(tiles);
      stage(dst, reinterpret_cast<const unsigned char*>(seg + r0), rows * 4);
      stage(dst + chunk * 4,
            reinterpret_cast<const unsigned char*>(vals + r0 * D),
            rows * D * static_cast<int>(sizeof(T)));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int pend = 0;  // lanes [0, pend) hold the owner's next tile
  int pid = -1;
  unsigned round = 0;
  T pv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) pv[c] = T(0);

  int b = 0;
  load_chunk(blockIdx.x, 0);
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x, b ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk c has landed for every thread, and every warp is done with
    // the other buffer and with the masks
    __syncthreads();
    load_chunk(c + gridDim.x, b ^ 1);
    const int64_t r0 = c * chunk;
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int* ids =
        reinterpret_cast<const int*>(bufs + b * buf_bytes<T, D>(tiles));
    const T* vs = reinterpret_cast<const T*>(
        bufs + b * buf_bytes<T, D>(tiles) + chunk * 4);

    // which rows of each tile each owner takes: lane o's mask, from one
    // ballot of the rows in the window and one a bit of the owner index
    for (int t = warp; t < tiles; t += kWarps) {
      const int row = t * 32 + lane;
      const int sl = row < rows ? ids[row] - base : -1;
      unsigned my = __ballot_sync(
          kFull, static_cast<unsigned>(sl) < static_cast<unsigned>(k));
      for (int bit = 0; bit < obits; ++bit) {
        const unsigned set = __ballot_sync(kFull, (sl >> bit) & 1);
        my &= ((lane >> bit) & 1) ? set : ~set;
      }
      if (lane < owners) masks[t * owners + lane] = my;
    }
    __syncthreads();

    // the owner's rows of its replica's tiles, in row order, into tiles
    const unsigned m = lane < rtiles ? masks[(t0 + lane) * owners + own] : 0u;
    int incl = __popc(m);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    for (int done = 0; done < total;) {
      const int take = min(32 - pend, total - done);
      const int q = done + lane - pend;  // the owner's row this lane takes
      int l = 0;  // its tile: the lanes whose inclusive count is <= q
#pragma unroll
      for (int step = 16; step; step >>= 1) {
        if (__shfl_sync(kFull, incl, l + step - 1) <= q) l += step;
      }
      const unsigned ml = __shfl_sync(kFull, m, l);
      const int before = __shfl_sync(kFull, incl, l) - __popc(ml);
      if (lane >= pend && lane < pend + take) {
        const int row = (t0 + l) * 32 + nth_bit(ml, q - before);
        pid = (ids[row] - base) >> obits;
#pragma unroll
        for (int cc = 0; cc < D; ++cc) pv[cc] = vs[row * D + cc];
      }
      pend += take;
      done += take;
      if (pend == 32) {
        add_tile<T, D>(mine, mytags, pid, pv, lane, round);
        pend = 0;
        pid = -1;
      }
    }
  }
  if (pend) add_tile<T, D>(mine, mytags, pid, pv, lane, round);
  __syncthreads();

  // the replicas in order, into the block's partial in key order
  T* out = partials + static_cast<int64_t>(blockIdx.x) * k * D;
  for (int j = threadIdx.x; j < k * D; j += kThreads) {
    const int key = j / D;
    const int slot = (key & (owners - 1)) * per_owner + (key >> obits);
    const int at = slot * D + (j - key * D);
    T sum = T(0);
    for (int r = 0; r < replicas; ++r) sum += acc[r * rslots * D + at];
    out[j] = sum;
  }
}

// out[j] = the blocks' partials summed in a fixed order: group g sums
// blocks g, g + 8, ... in order, then groups 0..7 in order.
template <typename T>
__global__ void __launch_bounds__(kCombineCols * kCombineGroups)
seg_combine(const T* __restrict__ partials, int nblocks, int kd,
            T* __restrict__ out) {
  __shared__ T part[kCombineGroups][kCombineCols];
  const int col = threadIdx.x % kCombineCols;
  const int g = threadIdx.x / kCombineCols;
  const int j = blockIdx.x * kCombineCols + col;
  T sum = T(0);
  if (j < kd) {
    for (int b = g; b < nblocks; b += kCombineGroups) {
      sum += partials[static_cast<int64_t>(b) * kd + j];
    }
  }
  part[g][col] = sum;
  __syncthreads();
  if (g == 0 && j < kd) {
    T total = part[0][col];
#pragma unroll
    for (int gg = 1; gg < kCombineGroups; ++gg) total += part[gg][col];
    out[j] = total;
  }
}

template <typename T, int D>
cudaError_t launch(const void* seg, const void* vals, int64_t n, int k,
                   int window, int replicas, int tiles, int nblocks,
                   void* partials, void* out, cudaStream_t s) {
  if (tiles % replicas || smem_bytes<T, D>(window, replicas, tiles) > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  // set once a device, before any capture, to the most a block may take
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !((attr_set >> dev) & 1u)) {
    err = cudaFuncSetAttribute(seg_partial<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
    attr_set |= 1u << dev;
  }
  for (int k0 = 0; k0 < k; k0 += window) {
    const int kw = k - k0 < window ? k - k0 : window;
    seg_partial<T, D><<<nblocks, kThreads,
                        static_cast<size_t>(smem_bytes<T, D>(kw, replicas, tiles)),
                        s>>>(static_cast<const int*>(seg),
                             static_cast<const T*>(vals), n, k0, kw, replicas,
                             tiles, static_cast<T*>(partials));
    const int kd = kw * D;
    seg_combine<T><<<(kd + kCombineCols - 1) / kCombineCols,
                     kCombineCols * kCombineGroups, 0, s>>>(
        static_cast<const T*>(partials), nblocks, kd,
        static_cast<T*>(out) + static_cast<int64_t>(k0) * D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* seg, const void* vals, int64_t n,
                     int k, int window, int replicas, int tiles, int nblocks,
                     void* partials, void* out, cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    case 2: return launch<T, 2>(seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    case 3: return launch<T, 3>(seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    case 4: return launch<T, 4>(seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = f64, 2 = i32, 3 = i64.  seg (n,) int32, vals (n, d)
// row-major with 1 <= d <= 4, both 16-byte aligned; partials (nblocks,
// window, d), out (k, d); the keys are summed `window` at a time
// (1 <= window <= k), by blocks of 16 warps holding `replicas` (1, 2, 4,
// 8 or 16) accumulators.  Launches on `stream`, allocates nothing, does
// not synchronise; returns the CUDA error of the launches (0 = success).
extern "C" int weld_segment_sum(int dtype, const void* seg, const void* vals,
                                long long n, int k, int window, int d,
                                int replicas, int tiles, int nblocks,
                                void* partials, void* out, void* stream) {
  if (n <= 0 || k <= 0 || window < 1 || window > k || d < 1 || d > kMaxD ||
      replicas < 1 || replicas > kWarps || (replicas & (replicas - 1)) ||
      tiles < 1 || tiles > kMaxTiles || nblocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(seg) | reinterpret_cast<uintptr_t>(vals)) &
      15u) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(d, seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    case 1: return dispatch<double>(d, seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    case 2: return dispatch<int>(d, seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    case 3: return dispatch<long long>(d, seg, vals, n, k, window, replicas, tiles, nblocks, partials, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

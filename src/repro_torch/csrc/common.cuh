// Shared helpers of the repro_torch kernels: dtype conversion, the
// tile -> group search of the grouped products, vectorized tile loads, the
// activations, the bf16 tensor-core (mma.sync, ldmatrix) and cp.async
// helpers, and the split reduction of the fused FFN's ring kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Act { ACT_SWIGLU = 0, ACT_GELU = 1, ACT_RWKV = 2, ACT_SILU = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Activation between the two expert GEMMs (mirrors the JAX _activate):
// swiglu = silu(g) * u, gelu = tanh form (jax.nn.gelu's default),
// rwkv = squared ReLU, silu.
__device__ __forceinline__ float silu_f(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float activate(float g, float u, int act) {
  switch (act) {
    case ACT_SWIGLU: return silu_f(g) * u;
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
    }
    case ACT_RWKV: { float r = fmaxf(g, 0.f); return r * r; }
    default: return silu_f(g);
  }
}

// The activation's gradient, written out: given g (and u for swiglu) and
// the incoming dh of h = activate(g, u), returns dg and, for swiglu, du
// (0 otherwise) — the exact VJP the JAX backward takes with jax.vjp:
//   gelu (tanh form): dh * (0.5 (1 + t) + 0.5 g (1 - t^2) c (1 + 3 a g^2)),
//                     t = tanh(c (g + a g^3)), c = sqrt(2 / pi), a = 0.044715
//   swiglu: dg = dh u silu'(g), du = dh silu(g);   silu: dg = dh silu'(g)
//   rwkv:   dg = 2 relu(g) dh
// with silu'(g) = s (1 + g (1 - s)), s = sigmoid(g).
__device__ __forceinline__ float2 activate_vjp(float g, float u, float dh,
                                               int act) {
  switch (act) {
    case ACT_SWIGLU: {
      const float s = 1.f / (1.f + expf(-g));
      return make_float2(dh * u * (s * (1.f + g * (1.f - s))), dh * silu_f(g));
    }
    case ACT_GELU: {
      const float c = 0.7978845608028654f, a = 0.044715f;
      const float t = tanhf(c * (g + a * g * g * g));
      return make_float2(
          dh * (0.5f * (1.f + t) +
                0.5f * g * (1.f - t * t) * c * (1.f + 3.f * a * g * g)),
          0.f);
    }
    case ACT_RWKV: return make_float2(2.f * fmaxf(g, 0.f) * dh, 0.f);
    default: {
      const float s = 1.f / (1.f + expf(-g));
      return make_float2(dh * (s * (1.f + g * (1.f - s))), 0.f);
    }
  }
}

// The row tile a block owns in a grouped product over rows sorted by group.
// Group e owns ceil(size_e / bm) tiles, in group order; a block whose index
// lies past every group's tiles is a "zero tile": it covers rows
// [total + z*bm, +bm) beyond sum(group_sizes), which come out as zero.
// Empty groups own no tile, so no block ever reads their weights.
struct Tile {
  int group;  // -1 for a zero tile
  int row0, row1;  // rows [row0, row1), clamped to M
};

constexpr unsigned kFullMask = 0xffffffffu;

// Tile b, found by one whole warp (every lane gets the same answer): the
// lanes take 32 groups at a time and prefix-sum their sizes and tile counts
// with shuffles, so a lookup costs ceil(E / 32) short scans.
__device__ __forceinline__ Tile find_tile_warp(const int* __restrict__ group_sizes,
                                               int E, int M, int bm, int b) {
  const int lane = threadIdx.x & 31;
  int off = 0, tiles = 0;  // rows and tiles of the groups before this chunk
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int sz = e < E ? group_sizes[e] : 0;
    const int t = (sz + bm - 1) / bm;
    int rows_incl = sz, tiles_incl = t;  // inclusive prefix sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int r = __shfl_up_sync(kFullMask, rows_incl, d);
      const int u = __shfl_up_sync(kFullMask, tiles_incl, d);
      if (lane >= d) { rows_incl += r; tiles_incl += u; }
    }
    const int first = tiles + tiles_incl - t;  // this group's first tile
    const unsigned hit = __ballot_sync(kFullMask, t > 0 && b >= first && b < first + t);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int g_first = __shfl_sync(kFullMask, first, src);
      const int g_row0 = off + __shfl_sync(kFullMask, rows_incl - sz, src);
      const int g_end = off + __shfl_sync(kFullMask, rows_incl, src);
      const int r0 = g_row0 + (b - g_first) * bm;
      return Tile{e0 + src, min(r0, M), min(min(r0 + bm, g_end), M)};
    }
    off += __shfl_sync(kFullMask, rows_incl, 31);
    tiles += __shfl_sync(kFullMask, tiles_incl, 31);
  }
  const int r0 = off + (b - tiles) * bm;
  return Tile{-1, min(r0, M), min(r0 + bm, M)};
}

// Every row tile of the product, the zero tiles past sum(group_sizes)
// included: sum ceil(size_e / bm) + ceil((M - total) / bm).  One warp.
__device__ __forceinline__ int count_row_tiles_warp(const int* __restrict__ group_sizes,
                                                    int E, int M, int bm) {
  const int lane = threadIdx.x & 31;
  int rows = 0, tiles = 0;
  for (int e = lane; e < E; e += 32) {
    const int sz = group_sizes[e];
    rows += sz;
    tiles += (sz + bm - 1) / bm;
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    rows += __shfl_xor_sync(kFullMask, rows, d);
    tiles += __shfl_xor_sync(kFullMask, tiles, d);
  }
  return tiles + (max(M - rows, 0) + bm - 1) / bm;
}

// The block's tile b: warp 0 finds it and shares it (blockDim.x >= 32).
__device__ __forceinline__ Tile find_tile(const int* __restrict__ group_sizes,
                                          int E, int M, int bm, int b) {
  __shared__ int s[3];
  if (threadIdx.x < 32) {
    const Tile t = find_tile_warp(group_sizes, E, M, bm, b);
    if (threadIdx.x == 0) {
      s[0] = t.group;
      s[1] = t.row0;
      s[2] = t.row1;
    }
  }
  __syncthreads();
  Tile t{s[0], s[1], s[2]};
  __syncthreads();
  return t;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[r * LD + c] = src[r * ld_src + col0 + c] for r < row_lim and
// col0 + c < col_lim, else 0; a ROWS x COLS tile into shared memory, in
// 16-byte chunks where the source allows it.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int ld_src, int row_lim, int col0,
                                          int col_lim) {
  constexpr int V = 16 / sizeof(T);
  static_assert(COLS % V == 0 && (LD * sizeof(T)) % 16 == 0, "tile layout");
  const bool vec = aligned16(src) && (ld_src % V == 0) && (col0 % V == 0);
  for (int i = threadIdx.x; i < ROWS * COLS / V; i += blockDim.x) {
    const int r = i / (COLS / V), c = (i % (COLS / V)) * V;
    T* d = dst + r * LD + c;
    const int col = col0 + c;
    const T* s = src + (size_t)r * ld_src + col;
    if (vec && r < row_lim && col + V <= col_lim) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        d[v] = (r < row_lim && col + v < col_lim) ? s[v] : from_f32<T>(0.f);
    }
  }
}

// y[r] = sum over splits of partial[s][r] (in split order, so the sum is
// deterministic), rounded to the working dtype; rows >= sum(group_sizes)
// are zero.  One block per row.  Used where a row tile's hidden tiles are
// split over several blocks that each write an f32 partial.
template <typename T>
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     const int* __restrict__ group_sizes,
                                     T* __restrict__ y, int M, int N, int E,
                                     int splits) {
  __shared__ int total;
  if (threadIdx.x == 0) {
    int t = 0;
    for (int e = 0; e < E; ++e) t += group_sizes[e];
    total = t;
  }
  __syncthreads();
  const int r = blockIdx.x;
  const bool valid = r < total;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.f;
    if (valid)
      for (int p = 0; p < splits; ++p) s += partial[((size_t)p * M + r) * N + c];
    y[(size_t)r * N + c] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core and asynchronous-copy helpers (sm_80 and later)
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k16, row.col: a thread of the warp (g = lane / 4, t4 = lane
// % 4) holds, of the f32 accumulator tile, rows g and g + 8, columns 2 t4
// and 2 t4 + 1 (c[0], c[1] on row g; c[2], c[3] on row g + 8).  The
// accumulators of two neighbouring 8-wide tiles, packed to bf16 pairs, are
// element for element the A fragment of the 16 x 16 tile they cover, so a
// product's result feeds the next product without leaving registers.

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8.  TRANS delivers each matrix transposed.  The
// usual addresses, for a tile stored row-major with leading dimension LD:
//   A fragment (16 x 16 at row m0, column k0, stored [m][k]):
//     (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8,         TRANS false
//   B fragments of two 8-wide n tiles (n0, n0 + 8) over k0..k0 + 15:
//     stored [n][k]: (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0
//                    + ((lane >> 3) & 1) * 8,                   TRANS false
//     stored [k][n]: (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8, TRANS true
//   r[0], r[1] are the first n tile's B fragment, r[2], r[3] the second's.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !ok (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, asynchronously, through L1; zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// the split reduction of the ring kernels
// ---------------------------------------------------------------------------

// y = bf16(sum over splits of partial), four columns a thread, splits in
// order (deterministic); rows >= sum(group_sizes) are zero.  N % 4 == 0.
static __global__ void __launch_bounds__(256)
reduce_partials_kernel(const float4* __restrict__ partial,
                       const int* __restrict__ group_sizes, bf16* __restrict__ y,
                       int M, int N, int E, int splits) {
  __shared__ int total;
  if (threadIdx.x < 32) {
    int t = 0;
    for (int e = threadIdx.x; e < E; e += 32) t += group_sizes[e];
#pragma unroll
    for (int d = 16; d; d >>= 1) t += __shfl_xor_sync(kFullMask, t, d);
    if (threadIdx.x == 0) total = t;
  }
  __syncthreads();
  const long long n4 = (long long)M * N / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i * 4 / N < total)
      for (int p = 0; p < splits; ++p) {
        const float4 v = partial[(long long)p * n4 + i];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
    *reinterpret_cast<uint2*>(y + i * 4) =
        make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
  }
}

// Launches reduce_partials_kernel over partial (splits, M, N) f32 into y
// (M, N); returns cudaGetLastError().
inline int launch_reduce_partials(const float* partial, const int* group_sizes,
                                  bf16* y, int M, int N, int E, int splits,
                                  cudaStream_t st) {
  const long long n4 = (long long)M * N / 4, blocks = (n4 + 255) / 256;
  reduce_partials_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(
      reinterpret_cast<const float4*>(partial), group_sizes, y, M, N, E, splits);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_EXPORT_ERROR_STRING                                  \
  extern "C" const char* error_string(int code) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

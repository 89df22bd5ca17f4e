// Shared helpers of the repro_torch kernels: dtype conversion, the
// tile -> group search of the grouped products, vectorized tile loads and
// the activations.
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

__device__ __forceinline__ Tile find_tile(const int* __restrict__ group_sizes,
                                          int E, int M, int bm, int b) {
  __shared__ int s[3];
  if (threadIdx.x == 0) {
    int off = 0, tiles = 0, grp = -1, r0 = 0, r1 = 0;
    for (int e = 0; e < E; ++e) {
      int sz = group_sizes[e];
      int t = (sz + bm - 1) / bm;
      if (grp < 0 && b < tiles + t) {
        grp = e;
        r0 = off + (b - tiles) * bm;
        r1 = min(r0 + bm, off + sz);
      }
      off += sz;
      tiles += t;
    }
    if (grp < 0) {
      r0 = off + (b - tiles) * bm;
      r1 = r0 + bm;
    }
    s[0] = grp;
    s[1] = min(r0, M);
    s[2] = min(r1, M);
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

#define REPRO_EXPORT_ERROR_STRING                                  \
  extern "C" const char* error_string(int code) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

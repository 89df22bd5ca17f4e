// Token shuffle kernels — the paper's §4 scatter and gather (Fig 4).
//
// Replaces the Pallas kernels of src/repro/kernels/token_shuffle.py:
//   gather_rows  (:29)  y[i] = x[idx[i]]                        (the scatter)
//   combine_topk (:56)  y[t] = sum_k w[t,k] * src[idx[t,k]]     (the gather)
//
// Bound on the H100: bytes.  Both move rows and do no tensor-core work
// (combine does k multiply-adds per element), so the least time is the
// bytes read and written over 3.35 TB/s.  Design: one block per output row,
// each thread moving 16-byte chunks with neighbouring threads on
// neighbouring addresses, so every row is one coalesced sweep; the row
// indices are read by the block itself (the TPU prefetched them as scalars).
// combine_topk accumulates in f32 in slot order and rounds once.
// An index outside [0, M) reads as a zero row.
#include "common.cuh"

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ x,
                                   const int* __restrict__ idx,
                                   U* __restrict__ y, int M, int units) {
  const int i = blockIdx.x;
  const int src = idx[i];
  U* dst = y + (size_t)i * units;
  if (src < 0 || src >= M) {
    for (int c = threadIdx.x; c < units; c += blockDim.x) dst[c] = U{};
    return;
  }
  const U* s = x + (size_t)src * units;
  for (int c = threadIdx.x; c < units; c += blockDim.x) dst[c] = s[c];
}

template <typename T, int V>
__global__ void combine_topk_kernel(const T* __restrict__ src,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    T* __restrict__ y, int k, int M, int d) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * V; c < d; c += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int s = 0; s < k; ++s) {
      const int r = idx[t * k + s];
      if (r < 0 || r >= M) continue;
      const float ws = w[t * k + s];
      alignas(16) T buf[V];
      if constexpr (V * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(buf) =
            *reinterpret_cast<const uint4*>(src + (size_t)r * d + c);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) buf[v] = src[(size_t)r * d + c + v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += ws * to_f32(buf[v]);
    }
    alignas(16) T out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = from_f32<T>(acc[v]);
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(y + (size_t)t * d + c) =
          *reinterpret_cast<const uint4*>(out);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) y[(size_t)t * d + c + v] = out[v];
    }
  }
}

REPRO_EXPORT_ERROR_STRING

// x (M, row_bytes) any dtype; idx (T,) int32; y (T, row_bytes).
extern "C" int gather_rows(const void* x, const void* idx, void* y, int T,
                           int M, int row_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const int threads = 128;
  if (row_bytes % 16 == 0 && aligned16(x) && aligned16(y)) {
    gather_rows_kernel<uint4><<<T, threads, 0, st>>>(
        static_cast<const uint4*>(x), ix, static_cast<uint4*>(y), M,
        row_bytes / 16);
  } else if (row_bytes % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 4 == 0) &&
             (reinterpret_cast<uintptr_t>(y) % 4 == 0)) {
    gather_rows_kernel<uint32_t><<<T, threads, 0, st>>>(
        static_cast<const uint32_t*>(x), ix, static_cast<uint32_t*>(y), M,
        row_bytes / 4);
  } else {
    gather_rows_kernel<uint8_t><<<T, threads, 0, st>>>(
        static_cast<const uint8_t*>(x), ix, static_cast<uint8_t*>(y), M,
        row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static void launch_combine(const T* src, const int* idx, const float* w, T* y,
                           int T_, int k, int M, int d, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 128;
  if (d % V == 0 && aligned16(src) && aligned16(y))
    combine_topk_kernel<T, V><<<T_, threads, 0, st>>>(src, idx, w, y, k, M, d);
  else
    combine_topk_kernel<T, 1><<<T_, threads, 0, st>>>(src, idx, w, y, k, M, d);
}

// src (M, d); idx (T, k) int32; w (T, k) float32; y (T, d) in src's dtype.
extern "C" int combine_topk(const void* src, const void* idx, const void* w,
                            void* y, int T, int k, int M, int d, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(w);
  if (dtype == DT_BF16)
    launch_combine(static_cast<const bf16*>(src), ix, wf, static_cast<bf16*>(y),
                   T, k, M, d, st);
  else
    launch_combine(static_cast<const float*>(src), ix, wf,
                   static_cast<float*>(y), T, k, M, d, st);
  return static_cast<int>(cudaGetLastError());
}

// Grouped GEMM — FastMoE's FMoELinear: y[i] = x[i] @ w[g(i)] for rows
// sorted by group.
//
// Replaces the Pallas kernel grouped_gemm_tiled
// (src/repro/kernels/grouped_gemm.py:49), which needs the groups padded to
// whole row tiles (pad_to_tiles) and a tile -> group map prefetched as
// scalars.  Here each block finds its own (group, row range) from the group
// sizes (common.cuh find_tile) and masks the ragged tile edge, so the caller
// passes the sorted rows as they are.  Rows >= sum(group_sizes) are written
// as zero by the blocks past the last group's tiles.
//
// Bound on the H100 at the MoE shapes: bytes.  A group's weight w[e]
// (K x N) is read by each of its row tiles, and at decode (1-2 rows per
// expert) or prefill (~21 rows per expert at 1024 tokens) the work per
// weight byte is far below the ~295 FLOP/B where the tensor cores become
// the limit.  So the design reads each touched expert's weights once per
// row tile in coalesced 16-byte chunks and never reads an empty group's
// weights (an empty group owns no tile).  Products: bf16 on the tensor
// cores (wmma 16x16x16, f32 accumulate); f32 on the FMA units, so f32 stays
// f32.  Output is rounded once to the working dtype.
//
// With trans_w the weights are read transposed, y[i] = x[i] @ w[g(i)]^T for
// w (E, N, K): the backward's dX = dy @ w^T runs on the forward's weights
// in place, with no transposed copy of the expert stack.
//
// A simple kernel: synchronous tile loads, 64x64 output tiles, 4 warps.
// wgmma, TMA and a pipelined ring of tiles come later.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, NT = 128;
constexpr int LDA = BK + 8;  // padded shared-memory strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDBT = BK + 8;  // transposed weight tile (BN x BK)
constexpr int BS = BK * LDB > BN * LDBT ? BK * LDB : BN * LDBT;
constexpr int LDC = BN + 4;

template <typename T, bool TW>
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ group_sizes, T* __restrict__ y,
                    int M, int K, int N, int E) {
  __shared__ __align__(128) T As[BM * LDA];
  __shared__ __align__(128) T Bs[BS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const Tile tile = find_tile(group_sizes, E, M, BM, blockIdx.x);
  const int n0 = blockIdx.y * BN;
  const int rows = tile.row1 - tile.row0;
  if (rows <= 0) return;
  const int tid = threadIdx.x;

  if (tile.group < 0) {  // rows beyond sum(group_sizes): zeros
    for (int i = tid; i < rows * BN; i += NT) {
      const int r = i / BN, c = n0 + i % BN;
      if (c < N) y[(size_t)(tile.row0 + r) * N + c] = from_f32<T>(0.f);
    }
    return;
  }

  const T* xa = x + (size_t)tile.row0 * K;
  const T* wb = w + (size_t)tile.group * K * N;
  // B(k, n) = w[g][k][n], or w[g][n][k] with TW; its tile in shared memory
  // is Bs[k * LDB + n], or Bs[n * LDBT + k] with TW
  auto load_b = [&](int k0) {
    if constexpr (TW)
      load_tile<T, BN, BK, LDBT>(Bs, wb + (size_t)n0 * K, K, N - n0, k0, K);
    else
      load_tile<T, BK, BN, LDB>(Bs, wb + (size_t)k0 * N, N, K - k0, n0, N);
  };

  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    using LayoutB = std::conditional_t<TW, wmma::col_major, wmma::row_major>;
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tile<T, BM, BK, LDA>(As, xa, K, rows, k0, K);
      load_b(k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = wc * 32 + j * 16;
          if constexpr (TW)
            wmma::load_matrix_sync(b[j], Bs + n * LDBT + kk, LDBT);
          else
            wmma::load_matrix_sync(b[j], Bs + kk * LDB + n, LDB);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < rows * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      if (n0 + c < N)
        y[(size_t)(tile.row0 + r) * N + n0 + c] = from_f32<T>(Cs[r * LDC + c]);
    }
  } else {
    // f32 on the FMA units: thread (ty, tx) owns rows ty*8..+8, cols tx*4..+4
    const int tx = tid % 16, ty = tid / 16;
    float acc[8][4] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tile<T, BM, BK, LDA>(As, xa, K, rows, k0, K);
      load_b(k0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f32(As[(ty * 8 + i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = to_f32(TW ? Bs[(tx * 4 + j) * LDBT + kk] : Bs[kk * LDB + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r >= rows) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < N) y[(size_t)(tile.row0 + r) * N + c] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const int* gs, void* y, int M, int K,
            int N, int E, bool trans_w, cudaStream_t st) {
  dim3 grid((M + BM - 1) / BM + E + 1, (N + BN - 1) / BN);
  auto kernel = trans_w ? grouped_gemm_kernel<T, true> : grouped_gemm_kernel<T, false>;
  kernel<<<grid, NT, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                              gs, static_cast<T*>(y), M, K, N, E);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (M, K), w (E, K, N) — or (E, N, K) with trans_w —, group_sizes (E,)
// int32, y (M, N); x, w, y share the dtype.  One block per (row tile,
// column tile); row tiles: at most ceil(M / BM) + E + 1 (each group's
// partial tile plus the zero tiles).
extern "C" int grouped_gemm(const void* x, const void* w, const void* group_sizes,
                            void* y, int M, int K, int N, int E, int trans_w,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == DT_BF16)
    launch<bf16>(x, w, gs, y, M, K, N, E, trans_w != 0, st);
  else
    launch<float>(x, w, gs, y, M, K, N, E, trans_w != 0, st);
  return static_cast<int>(cudaGetLastError());
}

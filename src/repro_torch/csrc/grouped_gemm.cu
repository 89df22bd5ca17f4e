// Grouped GEMM — FastMoE's FMoELinear: y[i] = x[i] @ w[g(i)] for rows
// sorted by group.
//
// Replaces the Pallas kernel grouped_gemm_tiled
// (src/repro/kernels/grouped_gemm.py:49), which needs the groups padded to
// whole row tiles (pad_to_tiles) and a tile -> group map prefetched as
// scalars.  Here each block finds its own (group, row range) from the group
// sizes (common.cuh find_tile_warp) and masks the ragged tile edge, so the
// caller passes the sorted rows as they are.  Rows >= sum(group_sizes) are
// written as zero by the tiles past the last group's, and an empty group
// owns no tile, so its weights are never read.
//
// Bound on the H100 at the MoE shapes: bytes.  A group's weight w[e]
// (K x N) is read by each of its row tiles, and at decode (1-2 rows per
// expert), prefill (~21) or training (~43) the work per weight byte is far
// below the ~295 FLOP/B where the tensor cores become the limit.  What
// holds such a kernel back is latency: it must keep enough weight bytes in
// flight to cover the trip to device memory.  So the bf16 kernel
// (grouped_gemm_mma_kernel):
//   - streams the weights through a 3-stage cp.async ring of (BM x 64) A
//     and (64 x BN) B tiles, two stages in flight while one computes: 32 KB
//     of weights a block at BN 128 (2-3 blocks an SM), 16 KB at BN 64 (six
//     blocks an SM, ~96 KB).  A deeper ring costs resident blocks, and at
//     these shapes more blocks hide the latency better than more stages;
//   - multiplies with mma.sync m16n8k16 fed by ldmatrix (.trans for w
//     (E, K, N), plain for trans_w's (E, N, K)), f32 accumulators in
//     registers, and writes the output straight from them;
//   - takes its row-tile height BM in {16, 32, 64} and width BN in {64,
//     128} from the host (kernels/grouped_gemm.py tile_config: the rows per
//     expert, and enough blocks to fill the card), so the decode tile is not
//     97% padding;
//   - runs a grid sized to the card (SMs x resident blocks, from the
//     occupancy calculator) whose blocks stride over the (row tile, column
//     tile) pairs; every warp finds its tile with a warp-wide prefix sum
//     over the group sizes, so no block waits on one thread's serial scan
//     and no launch spends blocks that exit at once.
// It needs K and N multiples of 8 and 16-byte aligned x and w; the host
// sends other shapes, and f32, to the simple kernel below.  Not yet:
// wgmma, TMA, split-K, and a shared-memory epilogue for 16-byte stores.
//
// The simple kernel (grouped_gemm_simple_kernel, the first version): one
// block per (row tile, column tile) of 64 x 64, synchronous 16-byte loads,
// wmma 16x16x16 for bf16, the FMA units for f32 (f32 stays f32).
//
// With trans_w the weights are read transposed, y[i] = x[i] @ w[g(i)]^T for
// w (E, N, K): the backward's dX = dy @ w^T runs on the forward's weights
// in place, with no transposed copy of the expert stack.  Output is
// rounded once from the f32 sums to the working dtype.
#include <mma.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the cp.async ring and mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64, MMA_STAGES = 3, MMA_NT = 128;

template <int BM, int BN, bool TW> struct MmaCfg {
  static constexpr int WR = BM == 16 ? 1 : 2, WC = 4 / WR;  // warp grid
  static constexpr int MI = BM / 16 / WR;   // m16 tiles per warp
  static constexpr int NJ = BN / 8 / WC;    // n8 tiles per warp
  static constexpr int LDA = MMA_BK + 8;    // A stage: BM x 64, [m][k]
  static constexpr int LDB = TW ? MMA_BK + 8 : BN + 8;  // [n][k] or [k][n]
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = TW ? BN * LDB : MMA_BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;  // elements, 16 B multiple
  static constexpr size_t SMEM = sizeof(bf16) * STAGE * MMA_STAGES;
  static_assert(MI >= 1 && NJ % 2 == 0, "warp tiling");
  static_assert((STAGE * sizeof(bf16)) % 16 == 0, "stage alignment");
};

template <int BM, int BN, bool TW>
__global__ void __launch_bounds__(MMA_NT)
grouped_gemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const int* __restrict__ group_sizes,
                        bf16* __restrict__ y, int M, int K, int N, int E) {
  using C = MmaCfg<BM, BN, TW>;
  constexpr int BK = MMA_BK, ST = MMA_STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / C::WC, wc = warp % C::WC;
  const int tiles_n = (N + BN - 1) / BN, nk = (K + BK - 1) / BK;
  const int work = count_row_tiles_warp(group_sizes, E, M, BM) * tiles_n;

  for (int item = blockIdx.x; item < work; item += gridDim.x) {
    const Tile tile = find_tile_warp(group_sizes, E, M, BM, item / tiles_n);
    const int n0 = (item % tiles_n) * BN;
    const int rows = tile.row1 - tile.row0;
    if (rows <= 0) continue;
    if (tile.group < 0) {  // rows beyond sum(group_sizes): zeros, 16 B a store
      const int cols = min(BN, N - n0) / 8;
      for (int i = tid; i < rows * cols; i += MMA_NT)
        *reinterpret_cast<uint4*>(y + (size_t)(tile.row0 + i / cols) * N + n0 +
                                  (i % cols) * 8) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16* xa = x + (size_t)tile.row0 * K;
    const bf16* wb = w + (size_t)tile.group * K * N;

    // ring stage s <- k tile kt: A rows past the tile and columns past K,
    // B rows or columns past K and N, arrive as zeros
    auto load = [&](int s, int kt) {
      bf16* As = smem + s * C::STAGE;
      bf16* Bs = As + C::A_ELEMS;
      const int k0 = kt * BK;
      for (int i = tid; i < BM * (BK / 8); i += MMA_NT) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = r < rows && k0 + c < K;
        cp_async16(As + r * C::LDA + c, ok ? xa + (size_t)r * K + k0 + c : x, ok);
      }
      if constexpr (TW) {  // Bs[n][k] = w[g][n0 + n][k0 + k]
        for (int i = tid; i < BN * (BK / 8); i += MMA_NT) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          const bool ok = n0 + r < N && k0 + c < K;
          cp_async16(Bs + r * C::LDB + c,
                     ok ? wb + (size_t)(n0 + r) * K + k0 + c : w, ok);
        }
      } else {  // Bs[k][n] = w[g][k0 + k][n0 + n]
        for (int i = tid; i < BK * (BN / 8); i += MMA_NT) {
          const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
          const bool ok = k0 + r < K && n0 + c < N;
          cp_async16(Bs + r * C::LDB + c,
                     ok ? wb + (size_t)(k0 + r) * N + n0 + c : w, ok);
        }
      }
    };

    float acc[C::MI][C::NJ][4];
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {  // one group per stage, even if empty
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<ST - 2>();  // k tile kt has landed (this thread's part)
      __syncthreads();          // ... everyone's; stage (kt - 1) % ST is free
      if (kt + ST - 1 < nk) load((kt + ST - 1) % ST, kt + ST - 1);
      cp_async_commit();
      const bf16* As = smem + (kt % ST) * C::STAGE;
      const bf16* Bs = As + C::A_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[C::MI][4];
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
          ldsm_x4<false>(a[i], As + ((wr * C::MI + i) * 16 + (lane & 15)) * C::LDA +
                                   kk + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < C::NJ / 2; ++jp) {
          const int nb = (wc * C::NJ + 2 * jp) * 8;  // first of two n8 tiles
          uint32_t b[4];
          if constexpr (TW)
            ldsm_x4<false>(b, Bs + (nb + (lane >> 4) * 8 + (lane & 7)) * C::LDB +
                                  kk + ((lane >> 3) & 1) * 8);
          else
            ldsm_x4<true>(b, Bs + (kk + (lane & 15)) * C::LDB + nb + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < C::MI; ++i) {
            mma_bf16(acc[i][2 * jp], a[i], b);
            mma_bf16(acc[i][2 * jp + 1], a[i], b + 2);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next item's loads

    // epilogue: bf16 pairs straight from the accumulators, rows masked
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wr * C::MI + i) * 16 + g + h * 8;
        if (r >= rows) continue;
        bf16* yr = y + (size_t)(tile.row0 + r) * N;
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          const int c = n0 + (wc * C::NJ + j) * 8 + 2 * t4;
          if (c < N)
            *reinterpret_cast<uint32_t*>(yr + c) =
                pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
  }
}

template <int BM, int BN, bool TW>
int launch_mma(const bf16* x, const bf16* w, const int* gs, bf16* y, int M,
               int K, int N, int E, cudaStream_t st) {
  auto kernel = grouped_gemm_mma_kernel<BM, BN, TW>;
  constexpr size_t smem = MmaCfg<BM, BN, TW>::SMEM;
  // the grid: as many blocks as the card holds at once (the occupancy
  // calculator's count per SM, cached per device), never more than the
  // most (row tile, column tile) items the input can have
  static int cached_dev = -1, resident = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MMA_NT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_dev = dev;
  }
  const long long items = ((long long)(M + BM - 1) / BM + (E < M ? E : M) + 1) *
                          ((N + BN - 1) / BN);
  const int grid = (int)(items < resident ? items : resident);
  kernel<<<grid, MMA_NT, smem, st>>>(x, w, gs, y, M, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32, and bf16 shapes the ring does not take: the simple kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32, NT = 128;
constexpr int LDA = BK + 8;  // padded shared-memory strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDBT = BK + 8;  // transposed weight tile (BN x BK)
constexpr int BS = BK * LDB > BN * LDBT ? BK * LDB : BN * LDBT;
constexpr int LDC = BN + 4;

template <typename T, bool TW>
__global__ void __launch_bounds__(NT)
grouped_gemm_simple_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
void launch_simple(const void* x, const void* w, const int* gs, void* y, int M, int K,
            int N, int E, bool trans_w, cudaStream_t st) {
  dim3 grid((M + BM - 1) / BM + E + 1, (N + BN - 1) / BN);
  auto kernel = trans_w ? grouped_gemm_simple_kernel<T, true>
                        : grouped_gemm_simple_kernel<T, false>;
  kernel<<<grid, NT, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                              gs, static_cast<T*>(y), M, K, N, E);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (M, K), w (E, K, N) — or (E, N, K) with trans_w —, group_sizes (E,)
// int32, y (M, N), all bf16; K and N multiples of 8, x and w 16-byte
// aligned.  Row tile bm in {16, 32, 64}, column tile bn in {64, 128};
// cudaErrorInvalidValue for any other.
extern "C" int grouped_gemm(const void* x, const void* w, const void* group_sizes,
                            void* y, int M, int K, int N, int E, int trans_w,
                            int bm, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const int* gs = static_cast<const int*>(group_sizes);
  bf16* yb = static_cast<bf16*>(y);
#define MMA(BM_, BN_)                                                         \
  if (bm == BM_ && bn == BN_)                                                 \
    return trans_w ? launch_mma<BM_, BN_, true>(xb, wb, gs, yb, M, K, N, E, st) \
                   : launch_mma<BM_, BN_, false>(xb, wb, gs, yb, M, K, N, E, st);
  MMA(16, 64) MMA(16, 128) MMA(32, 64) MMA(32, 128) MMA(64, 64) MMA(64, 128)
#undef MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// The simple kernel: x, w, y share the dtype (f32 or bf16), any K and N.
// One block per (row tile, column tile); row tiles: at most ceil(M / BM) +
// E + 1 (each group's partial tile plus the zero tiles).
extern "C" int grouped_gemm_simple(const void* x, const void* w,
                                   const void* group_sizes, void* y, int M,
                                   int K, int N, int E, int trans_w, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == DT_BF16)
    launch_simple<bf16>(x, w, gs, y, M, K, N, E, trans_w != 0, st);
  else
    launch_simple<float>(x, w, gs, y, M, K, N, E, trans_w != 0, st);
  return static_cast<int>(cudaGetLastError());
}

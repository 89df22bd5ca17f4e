// Fused expert FFN — grouped GEMM1 + activation + grouped GEMM2 in one
// kernel:  y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g].
//
// Replaces the Pallas kernel fused_ffn_tiled
// (src/repro/kernels/fused_ffn.py:111).  As there, the hidden activation
// never exists at (M, H) in device memory: a block holds one (16, 128)
// hidden tile in shared memory, rounds it to the working dtype (as
// fused_ffn.py:90 does, so fused matches two-pass in bf16) and consumes it
// at once in the second product, accumulating the (16, N) output tile in
// f32 in shared memory.  The hidden tail H % 128 is masked on both sides
// of the second product (its hidden columns are zero and its wo rows are
// read as zero), as fused_ffn.py:92-101 does.
//
// What differs from the TPU: its grid walked the hidden tiles in order on
// one core, carrying the sum in scratch.  Blocks on the H100 run in no
// order, so the hidden tiles of a row tile may be split over `splits`
// blocks (more blocks in flight when few experts are hit, as at decode);
// each writes an f32 partial of its rows, and a second small kernel sums
// the partials in split order (deterministic), rounds to the working dtype
// and writes rows >= sum(group_sizes) as zero.  Groups are found by each
// block from the group sizes (common.cuh find_tile); an empty group owns
// no tile and its weights are never read.
//
// Bound on the H100 at the MoE shapes: bytes — each touched expert's
// wi and wo are read once per (row tile, split), coalesced in 16-byte
// chunks.  Products: bf16 on the tensor cores (wmma, f32 accumulate), f32
// on the FMA units.  A simple kernel: synchronous loads, no wgmma/TMA yet.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BM = 16, BH = 128, BK1 = 32, NT = 256;

template <typename T>
struct Cfg {
  static constexpr int BN2 = sizeof(T) == 2 ? 128 : 64;  // GEMM2 column chunk
  static constexpr int LDW = BH + 8;   // GEMM1 weight tile (BK1 x BH)
  static constexpr int LDO = BN2 + 8;  // GEMM2 weight tile (BH x BN2)
  static constexpr int LDH = BH + 8;   // hidden tile, working dtype
  static constexpr int LDF = BH + 4;   // f32 pre-activation staging (bf16 path)
};

__host__ __device__ inline size_t up128(size_t v) { return (v + 127) / 128 * 128; }

struct Layout {
  int kp, ldx, np, ldacc;
  size_t x, w, f, u, h, acc, total;  // byte offsets into dynamic shared memory
};

template <typename T>
__host__ __device__ inline Layout layout(int K, int N) {
  using C = Cfg<T>;
  Layout L;
  L.kp = (K + BK1 - 1) / BK1 * BK1;
  L.ldx = L.kp + 8;
  L.np = (N + C::BN2 - 1) / C::BN2 * C::BN2;
  L.ldacc = L.np + 4;
  const size_t w1 = 2 * BK1 * C::LDW, w2 = BH * C::LDO;
  L.x = 0;
  L.w = up128(L.x + sizeof(T) * BM * L.ldx);
  L.f = up128(L.w + sizeof(T) * (w1 > w2 ? w1 : w2));  // GEMM1 and GEMM2 tiles alias
  L.u = up128(L.f + sizeof(float) * BM * C::LDF);
  L.h = up128(L.u + sizeof(float) * BM * C::LDF);
  L.acc = up128(L.h + sizeof(T) * BM * C::LDH);
  L.total = up128(L.acc + sizeof(float) * BM * L.ldacc);
  return L;
}

// Xs[r][c] = x[r][c] for r < rows, c < K; zero up to kp columns.
template <typename T>
__device__ void load_x(T* Xs, int ldx, const T* x, int K, int kp, int rows) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(x) && K % V == 0;
  const int chunks = kp / V;
  for (int i = threadIdx.x; i < BM * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * V;
    T* d = Xs + r * ldx + c;
    const T* s = x + (size_t)r * K + c;
    if (vec && r < rows && c + V <= K) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        d[v] = (r < rows && c + v < K) ? s[v] : from_f32<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
fused_ffn_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                 const T* __restrict__ wu, const T* __restrict__ wo,
                 const int* __restrict__ group_sizes, float* __restrict__ partial,
                 int M, int K, int H, int N, int E, int act, int splits) {
  using C = Cfg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<T>(K, N);
  T* Xs = reinterpret_cast<T*>(smem + L.x);
  T* Wgs = reinterpret_cast<T*>(smem + L.w);
  T* Wus = Wgs + BK1 * C::LDW;
  T* Wos = reinterpret_cast<T*>(smem + L.w);
  float* Hf = reinterpret_cast<float*>(smem + L.f);
  float* Uf = reinterpret_cast<float*>(smem + L.u);
  T* Hs = reinterpret_cast<T*>(smem + L.h);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);

  const Tile tile = find_tile(group_sizes, E, M, BM, blockIdx.x);
  const int rows = tile.row1 - tile.row0;
  if (tile.group < 0 || rows <= 0) return;  // the reduce kernel zeroes those rows
  const int tid = threadIdx.x, warp = tid / 32;
  const bool gated = wu != nullptr;
  const int n_h = (H + BH - 1) / BH;
  const int j0 = blockIdx.y * n_h / splits, j1 = (blockIdx.y + 1) * n_h / splits;
  const size_t g = tile.group;
  const T* wg_e = wg + g * K * H;
  const T* wu_e = gated ? wu + g * K * H : nullptr;
  const T* wo_e = wo + g * H * N;

  load_x(Xs, L.ldx, x + (size_t)tile.row0 * K, K, L.kp, rows);
  for (int i = tid; i < BM * L.ldacc; i += NT) Acc[i] = 0.f;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const int h0 = j * BH, hlim = min(BH, H - h0);
    // ---- GEMM1 + activation: Hs = act(Xs @ wi[:, h0:h0+BH]) in the working dtype
    if constexpr (std::is_same<T, bf16>::value) {
      using namespace nvcuda;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fg, fu;
      wmma::fill_fragment(fg, 0.f);
      wmma::fill_fragment(fu, 0.f);
      for (int k0 = 0; k0 < K; k0 += BK1) {
        load_tile<T, BK1, BH, C::LDW>(Wgs, wg_e + (size_t)k0 * H, H, K - k0, h0, H);
        if (gated)
          load_tile<T, BK1, BH, C::LDW>(Wus, wu_e + (size_t)k0 * H, H, K - k0, h0, H);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK1; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, Xs + k0 + kk, L.ldx);
          wmma::load_matrix_sync(b, Wgs + kk * C::LDW + warp * 16, C::LDW);
          wmma::mma_sync(fg, a, b, fg);
          if (gated) {
            wmma::load_matrix_sync(b, Wus + kk * C::LDW + warp * 16, C::LDW);
            wmma::mma_sync(fu, a, b, fu);
          }
        }
        __syncthreads();
      }
      wmma::store_matrix_sync(Hf + warp * 16, fg, C::LDF, wmma::mem_row_major);
      if (gated) wmma::store_matrix_sync(Uf + warp * 16, fu, C::LDF, wmma::mem_row_major);
      __syncthreads();
      for (int i = tid; i < BM * BH; i += NT) {
        const int r = i / BH, c = i % BH;
        const float v = c < hlim
            ? activate(Hf[r * C::LDF + c], gated ? Uf[r * C::LDF + c] : 0.f, act)
            : 0.f;
        Hs[r * C::LDH + c] = from_f32<T>(v);
      }
    } else {
      // f32 on the FMA units: thread owns row tid/16, hidden cols (tid%16)*8..+8
      const int r = tid / 16, c0 = (tid % 16) * 8;
      float fg[8] = {}, fu[8] = {};
      for (int k0 = 0; k0 < K; k0 += BK1) {
        load_tile<T, BK1, BH, C::LDW>(Wgs, wg_e + (size_t)k0 * H, H, K - k0, h0, H);
        if (gated)
          load_tile<T, BK1, BH, C::LDW>(Wus, wu_e + (size_t)k0 * H, H, K - k0, h0, H);
        __syncthreads();
        for (int kk = 0; kk < BK1; ++kk) {
          const float a = to_f32(Xs[r * L.ldx + k0 + kk]);
#pragma unroll
          for (int v = 0; v < 8; ++v) fg[v] += a * to_f32(Wgs[kk * C::LDW + c0 + v]);
          if (gated) {
#pragma unroll
            for (int v = 0; v < 8; ++v) fu[v] += a * to_f32(Wus[kk * C::LDW + c0 + v]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int v = 0; v < 8; ++v)
        Hs[r * C::LDH + c0 + v] =
            from_f32<T>(c0 + v < hlim ? activate(fg[v], fu[v], act) : 0.f);
    }
    __syncthreads();

    // ---- GEMM2: Acc += Hs @ wo[h0:h0+BH, :]; rows past H read as zero
    for (int n0 = 0; n0 < L.np; n0 += C::BN2) {
      load_tile<T, BH, C::BN2, C::LDO>(Wos, wo_e + (size_t)h0 * N, N, hlim, n0, N);
      __syncthreads();
      if constexpr (std::is_same<T, bf16>::value) {
        using namespace nvcuda;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
        float* cp = Acc + n0 + warp * 16;
        wmma::load_matrix_sync(fc, cp, L.ldacc, wmma::mem_row_major);
#pragma unroll
        for (int hh = 0; hh < BH; hh += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, Hs + hh, C::LDH);
          wmma::load_matrix_sync(b, Wos + hh * C::LDO + warp * 16, C::LDO);
          wmma::mma_sync(fc, a, b, fc);
        }
        wmma::store_matrix_sync(cp, fc, L.ldacc, wmma::mem_row_major);
      } else {
        const int r = tid / 16, c0 = (tid % 16) * 4;
        float* cp = Acc + r * L.ldacc + n0 + c0;
        float acc[4] = {cp[0], cp[1], cp[2], cp[3]};
        for (int hh = 0; hh < BH; ++hh) {
          const float a = to_f32(Hs[r * C::LDH + hh]);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += a * to_f32(Wos[hh * C::LDO + c0 + v]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) cp[v] = acc[v];
      }
      __syncthreads();
    }
  }

  float* out = partial + ((size_t)blockIdx.y * M + tile.row0) * N;
  for (int i = tid; i < rows * N; i += NT) {
    const int r = i / N, c = i % N;
    out[(size_t)r * N + c] = Acc[r * L.ldacc + c];
  }
}

template <typename T>
int launch(const T* x, const T* wg, const T* wu, const T* wo, const int* gs,
           float* partial, T* y, int M, int K, int H, int N, int E, int act,
           int splits, cudaStream_t st) {
  const size_t smem = layout<T>(K, N).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + BM - 1) / BM + E, splits);
  fused_ffn_kernel<T><<<grid, NT, smem, st>>>(x, wg, wu, wo, gs, partial, M, K,
                                               H, N, E, act, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_splits_kernel<T><<<M, 128, 0, st>>>(partial, gs, y, M, N, E, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (M, K); wg, wu (E, K, H) — wu null unless swiglu; wo (E, H, N);
// group_sizes (E,) int32; partial (splits, M, N) float32 scratch; y (M, N).
extern "C" int fused_ffn(const void* x, const void* wg, const void* wu,
                         const void* wo, const void* group_sizes, void* partial,
                         void* y, int M, int K, int H, int N, int E, int act,
                         int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float* p = static_cast<float*>(partial);
  if (dtype == DT_BF16)
    return launch(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                  static_cast<const bf16*>(wu), static_cast<const bf16*>(wo), gs,
                  p, static_cast<bf16*>(y), M, K, H, N, E, act, splits, st);
  return launch(static_cast<const float*>(x), static_cast<const float*>(wg),
                static_cast<const float*>(wu), static_cast<const float*>(wo), gs,
                p, static_cast<float*>(y), M, K, H, N, E, act, splits, st);
}

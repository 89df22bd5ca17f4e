// Fused expert-FFN backward — dX and grouped dW of
//   y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g]
// with the hidden activation and its gradient recomputed on chip, never
// written at (M, H) to device memory.
//
// Replaces the Pallas kernels fused_ffn_bwd_dx_tiled
// (src/repro/kernels/fused_ffn_bwd.py:190) and fused_ffn_bwd_dw_tiled
// (:228).  For a block of rows of one expert g and a hidden tile j both
// recompute, in shared memory,
//   g_j = x @ wi[:, j], u_j = x @ wi_up[:, j], dh_j = dy @ wo[j, :]^T  (f32)
//   h_j = act(g_j, u_j) and (dg_j, du_j) = act'(g_j, u_j) dh_j         (f32)
// and round h, dg, du to the working dtype before they enter a product,
// as fused_ffn_bwd.py:57-87 does.  The hidden tail H % 128 is masked on
// both sides: weight columns past H load as zero and h, dg, du are written
// as zero there.
//
// dX (fused_ffn_bwd_dx_kernel): one block per (16-row tile, range of hidden
// tiles); acc (16, K) += dg_j @ wi[:, j]^T [+ du_j @ wi_up[:, j]^T] in f32
// in shared memory.  As in the forward kernel, the hidden tiles of a row
// tile may be split over blocks that write f32 partials, summed in split
// order (deterministic) by reduce_splits_kernel, which also rounds and
// writes the rows >= sum(group_sizes) as zero.
//
// dW (fused_ffn_bwd_dw_kernel): the TPU kernel keeps each expert's f32
// (K, bh) and (bh, N) output blocks in VMEM while it walks the expert's row
// tiles; at K = 1024 such a block is 512 KB, beyond the H100's 227 KB of
// shared memory a block may use.  So here one block owns one (expert,
// hidden tile) pair, walks that expert's row tiles in order, and adds each
// tile's
//   dwo[g][j, :] += h_j^T @ dy,   dwi[g][:, j] += x^T @ dg_j  (dwi_up: du_j)
// in f32 straight into the output in device memory: no other block touches
// those addresses, so no atomics, and the order of the sum is fixed.  An
// expert with no rows writes zeros.
//
// Bound on the H100 at the training shape (d 1024, H 2048, 96 experts,
// ~43 rows per expert): bytes — both kernels read every touched expert's
// weights, and dW writes all of dwi/dwo in f32.  Products: bf16 on the
// tensor cores (wmma 16x16x16, f32 accumulate), f32 on the FMA units.  A
// simple kernel: synchronous loads, products staged through shared memory
// (block_mma); wgmma and TMA come later.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BH = 128, NT = 256;
constexpr int LDH = BH + 8;  // hidden tile in the working dtype
constexpr int LDF = BH + 4;  // hidden tile in f32

__host__ __device__ inline size_t up128(size_t v) { return (v + 127) / 128 * 128; }

// C (M x N, f32, row-major, ldc) = [C +] A (M x KD) @ B (KD x N), every
// operand in shared memory.  A(m, k) = A[m * lda + k], or A[k * lda + m]
// with A_T; B(k, n) = B[k * ldb + n], or B[n * ldb + k] with B_T.  bf16 on
// the tensor cores: M, N, KD multiples of 16, lda and ldb multiples of 8,
// ldc of 4, operands 32-byte aligned.  f32 on the FMA units.  Callers sync
// before and after.
template <typename T, int M, int N, int KD, bool A_T, bool B_T>
__device__ __forceinline__ void block_mma(const T* A, int lda, const T* B,
                                          int ldb, float* C, int ldc,
                                          bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = std::conditional_t<A_T, wmma::col_major, wmma::row_major>;
    using LB = std::conditional_t<B_T, wmma::col_major, wmma::row_major>;
    constexpr int FN = N / 16;
    static_assert(M % 16 == 0 && N % 16 == 0 && KD % 16 == 0, "wmma tiles");
    for (int f = threadIdx.x / 32; f < (M / 16) * FN; f += NT / 32) {
      const int m0 = f / FN * 16, n0 = f % FN * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* cp = C + m0 * ldc + n0;
      if (accumulate)
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int k = 0; k < KD; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, A_T ? A + k * lda + m0 : A + m0 * lda + k, lda);
        wmma::load_matrix_sync(b, B_T ? B + n0 * ldb + k : B + k * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += NT) {
      const int m = i / N, n = i % N;
      float s = accumulate ? C[m * ldc + n] : 0.f;
#pragma unroll 8
      for (int k = 0; k < KD; ++k)
        s += to_f32(A_T ? A[k * lda + m] : A[m * lda + k]) *
             to_f32(B_T ? B[n * ldb + k] : B[k * ldb + n]);
      C[m * ldc + n] = s;
    }
  }
}

// The recompute shared by both kernels, for BM rows (x and dy of those rows
// at xr, dyr; `rows` valid, the rest read as zero) and the hidden tile at
// h0 (hlim valid columns):
//   Gf = x @ wg[:, tile], Uf = x @ wu[:, tile] (if gated), Df = dy @ wo[tile, :]^T
// in f32, over chunks of BK along K (and N).  Chunk buffers: Xc, Yc (BM x
// BK, ld BK + 8), Wgc, Wuc (BK x BH, ld LDH), Woc (BH x BK, ld BK + 8).
template <typename T, int BM, int BK>
__device__ void recompute(const T* xr, const T* dyr, int rows, const T* wg_e,
                          const T* wu_e, const T* wo_e, int h0, int hlim,
                          int K, int H, int N, T* Xc, T* Yc, T* Wgc, T* Wuc,
                          T* Woc, float* Gf, float* Uf, float* Df) {
  constexpr int LDK = BK + 8;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, LDK>(Xc, xr, K, rows, k0, K);
    load_tile<T, BK, BH, LDH>(Wgc, wg_e + (size_t)k0 * H, H, K - k0, h0, H);
    if (wu_e) load_tile<T, BK, BH, LDH>(Wuc, wu_e + (size_t)k0 * H, H, K - k0, h0, H);
    __syncthreads();
    block_mma<T, BM, BH, BK, false, false>(Xc, LDK, Wgc, LDH, Gf, LDF, k0 > 0);
    if (wu_e) block_mma<T, BM, BH, BK, false, false>(Xc, LDK, Wuc, LDH, Uf, LDF, k0 > 0);
    __syncthreads();
  }
  for (int n0 = 0; n0 < N; n0 += BK) {
    load_tile<T, BM, BK, LDK>(Yc, dyr, N, rows, n0, N);
    load_tile<T, BH, BK, LDK>(Woc, wo_e + (size_t)h0 * N, N, hlim, n0, N);
    __syncthreads();
    // dh(r, h) = sum_n dy(r, n) wo(h, n): B(n, h) = Woc[h * LDK + n]
    block_mma<T, BM, BH, BK, false, true>(Yc, LDK, Woc, LDK, Df, LDF, n0 > 0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// dX
// ---------------------------------------------------------------------------

template <typename T>
struct DX {
  static constexpr int BM = 16;
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;   // recompute chunk
  static constexpr int BC = sizeof(T) == 2 ? 128 : 64;  // dX column chunk
  int kp, ldacc;
  size_t acc, chunk, gf, uf, df, dg, du, total;  // byte offsets

  __host__ __device__ DX(int K) {
    kp = (K + BC - 1) / BC * BC;
    ldacc = kp + 4;
    const size_t ldk = BK + 8;
    const size_t c1 = sizeof(T) * (2 * BM * ldk + 2 * BK * LDH + BH * ldk);
    const size_t c3 = sizeof(T) * 2 * BC * LDH;
    acc = 0;
    chunk = up128(acc + sizeof(float) * BM * ldacc);
    gf = up128(chunk + (c1 > c3 ? c1 : c3));
    uf = up128(gf + sizeof(float) * BM * LDF);
    df = up128(uf + sizeof(float) * BM * LDF);
    dg = up128(df + sizeof(float) * BM * LDF);
    du = up128(dg + sizeof(T) * BM * LDH);
    total = up128(du + sizeof(T) * BM * LDH);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
fused_ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                        const T* __restrict__ wu, const T* __restrict__ wo,
                        const T* __restrict__ dy,
                        const int* __restrict__ group_sizes,
                        float* __restrict__ partial, int M, int K, int H,
                        int N, int E, int act, int splits) {
  using L = DX<T>;
  constexpr int BM = L::BM, BK = L::BK, BC = L::BC, LDK = BK + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(K);
  float* Acc = reinterpret_cast<float*>(smem + lay.acc);
  T* Xc = reinterpret_cast<T*>(smem + lay.chunk);
  T* Yc = Xc + BM * LDK;
  T* Wgc = Yc + BM * LDK;
  T* Wuc = Wgc + BK * LDH;
  T* Woc = Wuc + BK * LDH;
  T* Wg2 = reinterpret_cast<T*>(smem + lay.chunk);  // aliases the chunks
  T* Wu2 = Wg2 + BC * LDH;
  float* Gf = reinterpret_cast<float*>(smem + lay.gf);
  float* Uf = reinterpret_cast<float*>(smem + lay.uf);
  float* Df = reinterpret_cast<float*>(smem + lay.df);
  T* Dg = reinterpret_cast<T*>(smem + lay.dg);
  T* Du = reinterpret_cast<T*>(smem + lay.du);

  const Tile tile = find_tile(group_sizes, E, M, BM, blockIdx.x);
  const int rows = tile.row1 - tile.row0;
  if (tile.group < 0 || rows <= 0) return;  // the reduce zeroes those rows
  const bool gated = wu != nullptr;
  const int n_h = (H + BH - 1) / BH;
  const int j0 = blockIdx.y * n_h / splits, j1 = (blockIdx.y + 1) * n_h / splits;
  const size_t g = tile.group;
  const T* wg_e = wg + g * K * H;
  const T* wu_e = gated ? wu + g * K * H : nullptr;
  const T* wo_e = wo + g * H * N;
  const T* xr = x + (size_t)tile.row0 * K;
  const T* dyr = dy + (size_t)tile.row0 * N;

  for (int i = threadIdx.x; i < BM * lay.ldacc; i += NT) Acc[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const int h0 = j * BH, hlim = min(BH, H - h0);
    recompute<T, BM, BK>(xr, dyr, rows, wg_e, wu_e, wo_e, h0, hlim, K, H, N,
                         Xc, Yc, Wgc, Wuc, Woc, Gf, Uf, Df);
    for (int i = threadIdx.x; i < BM * BH; i += NT) {
      const int r = i / BH, c = i % BH;
      float2 d = make_float2(0.f, 0.f);
      if (c < hlim)
        d = activate_vjp(Gf[r * LDF + c], gated ? Uf[r * LDF + c] : 0.f,
                         Df[r * LDF + c], act);
      Dg[r * LDH + c] = from_f32<T>(d.x);
      Du[r * LDH + c] = from_f32<T>(d.y);
    }
    __syncthreads();
    // acc[:, k0:k0+BC] += dg @ wi[k0:k0+BC, tile]^T: B(h, k) = Wg2[k * LDH + h]
    for (int k0 = 0; k0 < lay.kp; k0 += BC) {
      load_tile<T, BC, BH, LDH>(Wg2, wg_e + (size_t)k0 * H, H, K - k0, h0, H);
      if (gated) load_tile<T, BC, BH, LDH>(Wu2, wu_e + (size_t)k0 * H, H, K - k0, h0, H);
      __syncthreads();
      block_mma<T, BM, BC, BH, false, true>(Dg, LDH, Wg2, LDH, Acc + k0, lay.ldacc, true);
      if (gated)
        block_mma<T, BM, BC, BH, false, true>(Du, LDH, Wu2, LDH, Acc + k0, lay.ldacc, true);
      __syncthreads();
    }
  }

  float* out = partial + ((size_t)blockIdx.y * M + tile.row0) * K;
  for (int i = threadIdx.x; i < rows * K; i += NT) {
    const int r = i / K, c = i % K;
    out[(size_t)r * K + c] = Acc[r * lay.ldacc + c];
  }
}

// ---------------------------------------------------------------------------
// grouped dW
// ---------------------------------------------------------------------------

template <typename T>
struct DW {
  static constexpr int BM = sizeof(T) == 2 ? 64 : 32;  // rows per pass
  static constexpr int BK = 32;   // recompute chunk
  static constexpr int BN = 64;   // dwo column chunk
  static constexpr int BKW = 64;  // dwi row chunk
  static constexpr int LDK = BK + 8, LDN = BN + 8, LDW = BKW + 8;
  static constexpr int LDO = BN + 4, LDI = BH + 4;  // f32 output staging
  size_t chunk, gf, uf, df, h, dg, du, total;       // byte offsets
  size_t b2, cs;  // dW phase: operand chunk and f32 staging (alias the above)

  __host__ __device__ DW() {
    const size_t c1 = sizeof(T) * (2 * BM * LDK + 2 * BK * LDH + BH * LDK);
    chunk = 0;
    gf = up128(chunk + c1);
    uf = up128(gf + sizeof(float) * BM * LDF);
    df = up128(uf + sizeof(float) * BM * LDF);
    h = up128(df + sizeof(float) * BM * LDF);
    dg = up128(h + sizeof(T) * BM * LDH);
    du = up128(dg + sizeof(T) * BM * LDH);
    total = up128(du + sizeof(T) * BM * LDH);
    // the dW phase reuses the recompute buffers (launch_dw checks the fit)
    b2 = 0;
    const size_t ob = sizeof(T) * BM * (LDN > LDW ? LDN : LDW);
    cs = up128(b2 + ob);
  }
  __host__ __device__ size_t dw_phase_end() const {
    const size_t st = sizeof(float) * (BH * LDO > BKW * LDI ? BH * LDO : BKW * LDI);
    return cs + st;
  }
};

// Adds (or, on the expert's first row tile, stores) the f32 staging tile
// Cs (rows x cols, ld ldc) into out (ld ldo).
__device__ __forceinline__ void store_or_add(float* out, int ldo,
                                             const float* Cs, int ldc,
                                             int rows, int cols, int width,
                                             bool first) {
  for (int i = threadIdx.x; i < rows * width; i += NT) {
    const int r = i / width, c = i % width;
    if (c >= cols) continue;
    float* p = out + (size_t)r * ldo + c;
    const float v = Cs[r * ldc + c];
    *p = first ? v : *p + v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
fused_ffn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                        const T* __restrict__ wu, const T* __restrict__ wo,
                        const T* __restrict__ dy,
                        const int* __restrict__ group_sizes,
                        float* __restrict__ dwg, float* __restrict__ dwu,
                        float* __restrict__ dwo, int M, int K, int H, int N,
                        int E, int act) {
  using L = DW<T>;
  constexpr int BM = L::BM, BK = L::BK, BN = L::BN, BKW = L::BKW;
  constexpr int LDK = L::LDK, LDN = L::LDN, LDW = L::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay;
  T* Xc = reinterpret_cast<T*>(smem + lay.chunk);
  T* Yc = Xc + BM * LDK;
  T* Wgc = Yc + BM * LDK;
  T* Wuc = Wgc + BK * LDH;
  T* Woc = Wuc + BK * LDH;
  float* Gf = reinterpret_cast<float*>(smem + lay.gf);
  float* Uf = reinterpret_cast<float*>(smem + lay.uf);
  float* Df = reinterpret_cast<float*>(smem + lay.df);
  T* Hs = reinterpret_cast<T*>(smem + lay.h);
  T* Dg = reinterpret_cast<T*>(smem + lay.dg);
  T* Du = reinterpret_cast<T*>(smem + lay.du);
  T* B2 = reinterpret_cast<T*>(smem + lay.b2);        // dy or x chunk
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);  // f32 staging

  const int n_h = (H + BH - 1) / BH;
  const int e = blockIdx.x / n_h, j = blockIdx.x % n_h;
  const int h0 = j * BH, hlim = min(BH, H - h0);
  const bool gated = wu != nullptr;
  __shared__ int span[2];
  if (threadIdx.x == 0) {
    int off = 0;
    for (int i = 0; i < e; ++i) off += group_sizes[i];
    span[0] = min(off, M);
    span[1] = min(off + group_sizes[e], M);
  }
  __syncthreads();
  const int r_begin = span[0], r_end = span[1];
  const size_t g = e;
  const T* wg_e = wg + g * K * H;
  const T* wu_e = gated ? wu + g * K * H : nullptr;
  const T* wo_e = wo + g * H * N;
  float* dwo_j = dwo + (g * H + h0) * N;  // rows h0.., ld N
  float* dwg_j = dwg + g * K * H + h0;    // cols h0.., ld H
  float* dwu_j = gated ? dwu + g * K * H + h0 : nullptr;

  if (r_begin >= r_end) {  // no rows: this expert's gradient is zero
    for (int i = threadIdx.x; i < hlim * N; i += NT)
      dwo_j[(size_t)(i / N) * N + i % N] = 0.f;
    for (int i = threadIdx.x; i < K * hlim; i += NT) {
      const size_t o = (size_t)(i / hlim) * H + i % hlim;
      dwg_j[o] = 0.f;
      if (gated) dwu_j[o] = 0.f;
    }
    return;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += BM) {
    const int rows = min(BM, r_end - r0);
    const bool first = r0 == r_begin;
    const T* xr = x + (size_t)r0 * K;
    const T* dyr = dy + (size_t)r0 * N;
    recompute<T, BM, BK>(xr, dyr, rows, wg_e, wu_e, wo_e, h0, hlim, K, H, N,
                         Xc, Yc, Wgc, Wuc, Woc, Gf, Uf, Df);
    for (int i = threadIdx.x; i < BM * BH; i += NT) {
      const int r = i / BH, c = i % BH;
      float hv = 0.f;
      float2 d = make_float2(0.f, 0.f);
      if (r < rows && c < hlim) {
        const float gv = Gf[r * LDF + c], uv = gated ? Uf[r * LDF + c] : 0.f;
        hv = activate(gv, uv, act);
        d = activate_vjp(gv, uv, Df[r * LDF + c], act);
      }
      Hs[r * LDH + c] = from_f32<T>(hv);
      Dg[r * LDH + c] = from_f32<T>(d.x);
      Du[r * LDH + c] = from_f32<T>(d.y);
    }
    __syncthreads();
    // dwo[tile, n0:n0+BN] += h^T @ dy[:, n0:n0+BN]: A(h, r) = Hs[r * LDH + h]
    for (int n0 = 0; n0 < N; n0 += BN) {
      load_tile<T, BM, BN, LDN>(B2, dyr, N, rows, n0, N);
      __syncthreads();
      block_mma<T, BH, BN, BM, true, false>(Hs, LDH, B2, LDN, Cs, L::LDO, false);
      __syncthreads();
      store_or_add(dwo_j + n0, N, Cs, L::LDO, hlim, N - n0, BN, first);
      __syncthreads();
    }
    // dwi[k0:k0+BKW, tile] += x[:, k0:k0+BKW]^T @ dg: A(k, r) = B2[r * LDW + k]
    for (int k0 = 0; k0 < K; k0 += BKW) {
      load_tile<T, BM, BKW, LDW>(B2, xr, K, rows, k0, K);
      __syncthreads();
      block_mma<T, BKW, BH, BM, true, false>(B2, LDW, Dg, LDH, Cs, L::LDI, false);
      __syncthreads();
      store_or_add(dwg_j + (size_t)k0 * H, H, Cs, L::LDI, min(BKW, K - k0),
                   hlim, BH, first);
      __syncthreads();
      if (gated) {
        block_mma<T, BKW, BH, BM, true, false>(B2, LDW, Du, LDH, Cs, L::LDI, false);
        __syncthreads();
        store_or_add(dwu_j + (size_t)k0 * H, H, Cs, L::LDI, min(BKW, K - k0),
                     hlim, BH, first);
        __syncthreads();
      }
    }
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <typename T>
int launch_dx(const T* x, const T* wg, const T* wu, const T* wo, const T* dy,
              const int* gs, float* partial, T* dx, int M, int K, int H, int N,
              int E, int act, int splits, cudaStream_t st) {
  const size_t smem = DX<T>(K).total;
  int err = set_smem(reinterpret_cast<const void*>(fused_ffn_bwd_dx_kernel<T>), smem);
  if (err) return err;
  dim3 grid((M + DX<T>::BM - 1) / DX<T>::BM + E, splits);
  fused_ffn_bwd_dx_kernel<T><<<grid, NT, smem, st>>>(x, wg, wu, wo, dy, gs,
                                                      partial, M, K, H, N, E,
                                                      act, splits);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_splits_kernel<T><<<M, 128, 0, st>>>(partial, gs, dx, M, K, E, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const T* x, const T* wg, const T* wu, const T* wo, const T* dy,
              const int* gs, float* dwg, float* dwu, float* dwo, int M, int K,
              int H, int N, int E, int act, cudaStream_t st) {
  const DW<T> lay;
  if (lay.dw_phase_end() > lay.h) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(fused_ffn_bwd_dw_kernel<T>),
                     lay.total);
  if (err) return err;
  const int n_h = (H + BH - 1) / BH;
  fused_ffn_bwd_dw_kernel<T><<<E * n_h, NT, lay.total, st>>>(
      x, wg, wu, wo, dy, gs, dwg, dwu, dwo, M, K, H, N, E, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (M, K); wg, wu (E, K, H) — wu null unless swiglu; wo (E, H, N);
// dy (M, N); group_sizes (E,) int32 summing to <= M; partial (splits, M, K)
// f32 scratch; dx (M, K).  x, the weights, dy and dx share the dtype.
extern "C" int fused_ffn_bwd_dx(const void* x, const void* wg, const void* wu,
                                const void* wo, const void* dy,
                                const void* group_sizes, void* partial,
                                void* dx, int M, int K, int H, int N, int E,
                                int act, int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float* p = static_cast<float*>(partial);
  if (dtype == DT_BF16)
    return launch_dx(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                     static_cast<const bf16*>(wu), static_cast<const bf16*>(wo),
                     static_cast<const bf16*>(dy), gs, p, static_cast<bf16*>(dx),
                     M, K, H, N, E, act, splits, st);
  return launch_dx(static_cast<const float*>(x), static_cast<const float*>(wg),
                   static_cast<const float*>(wu), static_cast<const float*>(wo),
                   static_cast<const float*>(dy), gs, p, static_cast<float*>(dx),
                   M, K, H, N, E, act, splits, st);
}

// Same inputs; dwg, dwu (E, K, H) and dwo (E, H, N) f32, every element
// written (zeros for experts without rows); dwu null unless swiglu.
extern "C" int fused_ffn_bwd_dw(const void* x, const void* wg, const void* wu,
                                const void* wo, const void* dy,
                                const void* group_sizes, void* dwg, void* dwu,
                                void* dwo, int M, int K, int H, int N, int E,
                                int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float *a = static_cast<float*>(dwg), *b = static_cast<float*>(dwu),
        *c = static_cast<float*>(dwo);
  if (dtype == DT_BF16)
    return launch_dw(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                     static_cast<const bf16*>(wu), static_cast<const bf16*>(wo),
                     static_cast<const bf16*>(dy), gs, a, b, c, M, K, H, N, E,
                     act, st);
  return launch_dw(static_cast<const float*>(x), static_cast<const float*>(wg),
                   static_cast<const float*>(wu), static_cast<const float*>(wo),
                   static_cast<const float*>(dy), gs, a, b, c, M, K, H, N, E,
                   act, st);
}

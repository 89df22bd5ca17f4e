// Fused expert-FFN backward — dX and grouped dW of
//   y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g]
// with the hidden activation and its gradient recomputed on chip, never
// written at (M, H) to device memory.
//
// Replaces the Pallas kernels fused_ffn_bwd_dx_tiled
// (src/repro/kernels/fused_ffn_bwd.py:190) and fused_ffn_bwd_dw_tiled
// (:228).  For rows of one expert g and a range of hidden columns both
// recompute
//   g_j = x @ wi[:, j], u_j = x @ wi_up[:, j], dh_j = dy @ wo[j, :]^T  (f32)
//   h_j = act(g_j, u_j) and (dg_j, du_j) = act'(g_j, u_j) dh_j         (f32)
// and round h, dg, du to the working dtype before they enter a product,
// as fused_ffn_bwd.py:57-87 does.  The hidden tail is masked on both
// sides: weight columns past H load as zero and h, dg, du are zero there.
// dX sums dg @ wi^T [+ du @ wi_up^T] over the hidden columns in f32 and
// rounds once; rows >= sum(group_sizes) are zero.  dW is
//   dwo[g] = h^T @ dy,  dwi[g] = x^T @ dg  (dwi_up: du)
// in f32, zeros for experts without rows.
//
// Bound on the H100 at the training shape (d 1024, H 2048, 96 experts,
// ~43-56 rows per expert): bytes.  Both kernels read every touched
// expert's weights (0.75-0.81 GB), a few tens of flops a weight byte
// against the ~295 where the tensor cores become the limit; dW also writes
// all of dwi and dwo in f32 (1.61 GB).
//
// bf16 (every model shape; the host's route): the ring kernels, built like
// the forward's fused_ffn_ring_kernel (fused_ffn.cu).  256 threads, two
// blocks an SM; x's and dy's row tiles and the weight tiles stream through
// a cp.async ring; products are mma.sync with f32 accumulators in
// registers.
//   - fused_ffn_bwd_dx_ring_kernel: a block owns one row tile of one
//     expert (BM in {16, 32, 64}: the smallest that holds an average
//     expert, so its weights are streamed once, not once per 16 rows) and
//     HC = 256 hidden columns (the split, kernels/fused_ffn_bwd.py
//     plan_bwd).
//     Phase A walks the chunk in 128-wide sub-tiles: dh = dy wo^T and
//     g [u] = x wi [wi_up] in registers, the activation gradient applied
//     in registers and dg [du] rounded into shared memory, so the whole
//     chunk's dg waits there (BM x HC bf16) and no register budget caps
//     the chunk: a wide chunk means few splits, and each split costs an
//     f32 (M, K) partial written and read back.  Phase B walks dX's K
//     columns in passes of 128, streaming wi's tiles of the chunk again
//     (in reverse, so the tiles phase A read last, likeliest in L2, come
//     first) and writes each pass's f32 sum as the split's partial straight
//     from the registers; reduce_partials_kernel (common.cuh) sums the
//     splits in order (deterministic), rounds, and zeroes the rows past the
//     groups.
//   - fused_ffn_bwd_dw_ring_kernel: a block owns (expert, 128 hidden
//     columns) and walks the expert's rows in batches of 64.  Phase A as
//     in dX over 64-wide sub-tiles leaves h, dg [du] of the batch in shared
//     memory; phase B contracts over the batch's rows (ldmatrix.trans
//     gives the transposed operands): dwo[chunk, n pass] = h^T dy and
//     dwi[k pass, chunk] = x^T dg, dy's and x's tiles streamed through the
//     ring again, each pass's f32 sum stored from the registers in 16-byte
//     stores while the next pass's tiles load.  Each output element is
//     written once; only batches after the first (an expert over 64 rows)
//     read it back and add.  No other block touches those addresses, so the
//     sum's order is fixed.
// f32, and K, H or N not multiples of 8: the first versions
// (fused_ffn_bwd_dx_simple_kernel, fused_ffn_bwd_dw_simple_kernel) —
// synchronous loads, products staged through shared memory (wmma for
// bf16, the FMA units for f32).
#include <mma.h>

#include "common.cuh"

namespace {

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

// ---------------------------------------------------------------------------
// bf16: the ring kernels
// ---------------------------------------------------------------------------

constexpr int Q_NT = 256, Q_NW = Q_NT / 32;  // threads and warps a block
constexpr int Q_BK = 64;                      // depth of a ring step
constexpr int Q_LDT = Q_BK + 8;               // row of a 64-column tile

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The recompute (phase A) of both kernels over BR rows and a hidden
// sub-tile of HS columns.  Warp grid: WR = BR / 16 row strips by WC column
// slices of WA columns.  A ring step holds x's (BR x 64) k tile with wi's
// (64 x HS) tile [and wi_up's] (an x step), or dy's (BR x 64) n tile with
// wo's (HS x 64) tile (a y step).
template <int BR, int HS, bool GATED> struct Recompute {
  static constexpr int WR = BR / 16, WC = Q_NW / WR, WA = HS / WC;
  static constexpr int LDW = HS + 8;
  static constexpr int T_ELEMS = BR * Q_LDT;  // the x or dy tile
  static constexpr int W_ELEMS = Q_BK * LDW;  // a wi tile
  static constexpr int XSTEP = T_ELEMS + W_ELEMS * (GATED ? 2 : 1);
  static constexpr int YSTEP = T_ELEMS + HS * Q_LDT;
  static_assert(WR * WC == Q_NW && WA % 16 == 0, "phase A warp grid");
};

// Rows [0, lim) of a (lim x 64) tile at column c0 of src (row stride ld)
// into dst (row stride Q_LDT), zero past row `valid` and column `cols`;
// `any` is a valid address for the zero-filled copies.
__device__ __forceinline__ void cp_rows64(bf16* dst, const bf16* src, int ld,
                                          int lim, int valid, int c0, int cols,
                                          const bf16* any) {
  for (int c = threadIdx.x; c < lim * (Q_BK / 8); c += Q_NT) {
    const int r = c / (Q_BK / 8), col = (c % (Q_BK / 8)) * 8;
    const bool ok = r < valid && c0 + col < cols;
    cp_async16(dst + r * Q_LDT + col, ok ? src + (size_t)r * ld + c0 + col : any, ok);
  }
}

// A (ROWS x WIDTH) weight tile: rows [0, ROWS) of src (row stride ld) from
// column c0 into dst (row stride LD), zero past row rlim and column clim.
template <int ROWS, int WIDTH, int LD>
__device__ __forceinline__ void cp_weights(bf16* dst, const bf16* src, int ld,
                                           int rlim, int c0, int clim,
                                           const bf16* any) {
  for (int c = threadIdx.x; c < ROWS * (WIDTH / 8); c += Q_NT) {
    const int r = c / (WIDTH / 8), col = (c % (WIDTH / 8)) * 8;
    const bool ok = r < rlim && c0 + col < clim;
    cp_async16(dst + r * LD + col, ok ? src + (size_t)r * ld + c0 + col : any, ok);
  }
}

// An x step: the warp's (16 x WA) g [u] += x tile @ wi tile [wi_up tile].
template <class R, bool GATED>
__device__ __forceinline__ void step_x(const bf16* st, float (*g)[4],
                                       float (*u)[4], int wr, int wc, int lane) {
  const bf16* ws = st + R::T_ELEMS;
#pragma unroll
  for (int kk = 0; kk < Q_BK; kk += 16) {
    uint32_t a[4];
    ldsm_x4<false>(a, st + (wr * 16 + (lane & 15)) * Q_LDT + kk + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < R::WA / 16; ++jp) {
      const int at = (kk + (lane & 15)) * R::LDW + wc * R::WA + jp * 16 + (lane >> 4) * 8;
      uint32_t b[4];
      ldsm_x4<true>(b, ws + at);
      mma_bf16(g[2 * jp], a, b);
      mma_bf16(g[2 * jp + 1], a, b + 2);
      if constexpr (GATED) {
        ldsm_x4<true>(b, ws + R::W_ELEMS + at);
        mma_bf16(u[2 * jp], a, b);
        mma_bf16(u[2 * jp + 1], a, b + 2);
      }
    }
  }
}

// A y step: the warp's (16 x WA) dh += dy tile @ wo tile^T (wo's rows are
// hidden columns: the B operand stored [n][k]).
template <class R>
__device__ __forceinline__ void step_y(const bf16* st, float (*dh)[4], int wr,
                                       int wc, int lane) {
  const bf16* os = st + R::T_ELEMS;
#pragma unroll
  for (int kk = 0; kk < Q_BK; kk += 16) {
    uint32_t a[4];
    ldsm_x4<false>(a, st + (wr * 16 + (lane & 15)) * Q_LDT + kk + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < R::WA / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4<false>(b, os + (wc * R::WA + jp * 16 + (lane >> 4) * 8 + (lane & 7)) * Q_LDT +
                            kk + ((lane >> 3) & 1) * 8);
      mma_bf16(dh[2 * jp], a, b);
      mma_bf16(dh[2 * jp + 1], a, b + 2);
    }
  }
}

// The warp's (16 x WA) accumulators through the activation and its
// gradient, rounded to bf16 into the resident buffers (row stride LDC) at
// chunk column c0: dg [du], and h when H_OUT.  Columns at or past hlim
// (past H) are zero.
template <class R, bool GATED, bool H_OUT, int LDC>
__device__ __forceinline__ void act_grad(float (*g)[4], float (*u)[4],
                                         float (*dh)[4], bf16* Hs, bf16* Dg,
                                         bf16* Du, int c0, int hlim, int act,
                                         int wr, int lane) {
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < R::WA / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int at = (wr * 16 + gq + 8 * hh) * LDC + c;
      float2 d0 = make_float2(0.f, 0.f), d1 = d0;
      float h0 = 0.f, h1 = 0.f;
      if (c < hlim) {
        const float u0 = GATED ? u[j][2 * hh] : 0.f;
        const float u1 = GATED ? u[j][2 * hh + 1] : 0.f;
        d0 = activate_vjp(g[j][2 * hh], u0, dh[j][2 * hh], act);
        d1 = activate_vjp(g[j][2 * hh + 1], u1, dh[j][2 * hh + 1], act);
        if constexpr (H_OUT) {
          h0 = activate(g[j][2 * hh], u0, act);
          h1 = activate(g[j][2 * hh + 1], u1, act);
        }
      }
      *reinterpret_cast<uint32_t*>(Dg + at) = pack_bf16(d0.x, d1.x);
      if constexpr (GATED) *reinterpret_cast<uint32_t*>(Du + at) = pack_bf16(d0.y, d1.y);
      if constexpr (H_OUT) *reinterpret_cast<uint32_t*>(Hs + at) = pack_bf16(h0, h1);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Writes (ADD: adds to) a warp's (16 x 8 NJ) f32 accumulators at out (row
// stride ld): rows r0 + g (+ 8) below rlim, columns c0 + 8 j + 4 (t4 / 2)
// below clim, 16 bytes a lane — lanes 2p and 2p + 1 swap halves, so the
// even lane holds row g and the odd lane row g + 8.  ld, c0 and clim are
// multiples of 4.
template <int NJ>
__device__ __forceinline__ void store_acc(float* out, int ld, float (*acc)[4],
                                          int r0, int rlim, int c0, int clim,
                                          bool add, int lane) {
  const int t4 = lane & 3;
  const bool odd = t4 & 1;
  const int r = r0 + (lane >> 2) + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float x0 = __shfl_xor_sync(kFullMask, odd ? acc[j][0] : acc[j][2], 1);
    const float x1 = __shfl_xor_sync(kFullMask, odd ? acc[j][1] : acc[j][3], 1);
    float4 v = odd ? make_float4(x0, x1, acc[j][2], acc[j][3])
                   : make_float4(acc[j][0], acc[j][1], x0, x1);
    const int c = c0 + 8 * j + 4 * (t4 >> 1);
    if (r < rlim && c < clim) {
      float4* p = reinterpret_cast<float4*>(out + (size_t)r * ld + c);
      if (add) {
        const float4 o = *p;
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      *p = v;
    }
  }
}

// ---- dX ------------------------------------------------------------------

// A block owns one row tile (BM rows of one expert) and HC hidden columns,
// through a ring of ST stages.  Phase A: per HS-wide sub-tile, dh, g [u] in
// registers (WR x WC warps), dg [du] rounded into shared memory (BM x HC);
// phase B: dX's K columns in passes of BN, each streaming wi's (BN x 64)
// tiles [and wi_up's] of the chunk, the warp's (16 x WB) sum written as
// this split's f32 partial.
template <int BM_, int HC_, bool GATED, int HS_, int ST_> struct DxRing {
  static constexpr int BM = BM_, HC = HC_, HS = HS_, BN = 128, ST = ST_;
  using R = Recompute<BM, HS, GATED>;
  static constexpr int NQ = HC / HS, NJ = HC / Q_BK;
  static constexpr int WB = BN / R::WC;  // dX columns a warp, a pass
  static constexpr int BSTEP = BN * Q_LDT * (GATED ? 2 : 1);
  static constexpr int STAGE = cmax(cmax(R::XSTEP, R::YSTEP), BSTEP);
  static constexpr int LDC = HC + 8;
  static constexpr size_t RING = sizeof(bf16) * STAGE * ST;
  static constexpr size_t SMEM = RING + sizeof(bf16) * BM * LDC * (GATED ? 2 : 1);
  static_assert(HC % HS == 0 && WB % 16 == 0, "dX tiling");
  static_assert((STAGE * sizeof(bf16)) % 16 == 0 && SMEM <= 232448, "dX shared memory");
};

// Phase B step: the warp's (16 x WB) dX += dg [du] (hidden columns hc0 ..
// hc0 + 63 of the chunk) @ the step's wi [wi_up] tile^T (rows are dX
// columns: the B operand stored [n][k]).
template <class C, bool GATED>
__device__ __forceinline__ void step_dx(const bf16* st, const bf16* Dg,
                                        const bf16* Du, float (*acc)[4], int hc0,
                                        int wr, int wc, int lane) {
#pragma unroll
  for (int kk = 0; kk < Q_BK; kk += 16) {
    const int at = (wr * 16 + (lane & 15)) * C::LDC + hc0 + kk + (lane >> 4) * 8;
    uint32_t a[4], a2[4];
    ldsm_x4<false>(a, Dg + at);
    if constexpr (GATED) ldsm_x4<false>(a2, Du + at);
#pragma unroll
    for (int jp = 0; jp < C::WB / 16; ++jp) {
      const int bt = (wc * C::WB + jp * 16 + (lane >> 4) * 8 + (lane & 7)) * Q_LDT + kk +
                     ((lane >> 3) & 1) * 8;
      uint32_t b[4];
      ldsm_x4<false>(b, st + bt);
      mma_bf16(acc[2 * jp], a, b);
      mma_bf16(acc[2 * jp + 1], a, b + 2);
      if constexpr (GATED) {
        ldsm_x4<false>(b, st + C::BN * Q_LDT + bt);
        mma_bf16(acc[2 * jp], a2, b);
        mma_bf16(acc[2 * jp + 1], a2, b + 2);
      }
    }
  }
}

template <class C, bool GATED, int MINB>
__global__ void __launch_bounds__(Q_NT, MINB)
fused_ffn_bwd_dx_ring_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                             const bf16* __restrict__ wu, const bf16* __restrict__ wo,
                             const bf16* __restrict__ dy,
                             const int* __restrict__ group_sizes,
                             float* __restrict__ partial, int M, int K, int H,
                             int N, int E, int act) {
  using R = typename C::R;
  constexpr int BM = C::BM, HC = C::HC, ST = C::ST;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* Dg = reinterpret_cast<bf16*>(smem_raw + C::RING);
  bf16* Du = Dg + BM * C::LDC;
  const Tile tile = find_tile(group_sizes, E, M, BM, blockIdx.x);
  const int rows = tile.row1 - tile.row0;
  if (tile.group < 0 || rows <= 0) return;  // the reduction zeroes those rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / R::WC, wc = warp % R::WC;
  const bool live = wr * 16 < rows;                // the warp's strip holds rows
  const int lim = min(BM, (rows + 15) / 16 * 16);  // tile rows loaded
  const int hbase = blockIdx.y * HC, hlim = H - hbase;
  const int nk = (K + Q_BK - 1) / Q_BK, nn = (N + Q_BK - 1) / Q_BK;
  const int npass = (K + C::BN - 1) / C::BN;
  const int LQ = nn + nk, LA = C::NQ * LQ, L = LA + npass * C::NJ;
  const size_t ge = tile.group;
  const bf16* xa = x + (size_t)tile.row0 * K;
  const bf16* dya = dy + (size_t)tile.row0 * N;
  const bf16* wg_e = wg + ge * K * H;
  const bf16* wu_e = GATED ? wu + ge * K * H : nullptr;
  const bf16* wo_e = wo + ge * H * N;

  // ring step it -> stage s.  Phase A (it < LA): sub-tile it / LQ, its nn
  // y steps then its nk x steps; phase B: the passes and, in each, the
  // chunk's 64-wide hidden tiles in reverse, so the wi tiles phase A read
  // last (most likely still in L2) come first.
  auto load = [&](int s, int it) {
    bf16* st = ring + s * C::STAGE;
    if (it < LA) {
      const int j = it % LQ, h0 = hbase + (it / LQ) * C::HS;
      if (j < nn) {
        const int n0 = j * Q_BK;
        cp_rows64(st, dya, N, lim, rows, n0, N, dy);
        cp_weights<C::HS, Q_BK, Q_LDT>(st + R::T_ELEMS, wo_e + (size_t)h0 * N, N,
                                       H - h0, n0, N, wo);
      } else {
        const int k0 = (j - nn) * Q_BK;
        cp_rows64(st, xa, K, lim, rows, k0, K, x);
        cp_weights<Q_BK, C::HS, R::LDW>(st + R::T_ELEMS, wg_e + (size_t)k0 * H, H,
                                        K - k0, h0, H, wg);
        if constexpr (GATED)
          cp_weights<Q_BK, C::HS, R::LDW>(st + R::T_ELEMS + R::W_ELEMS,
                                          wu_e + (size_t)k0 * H, H, K - k0, h0, H, wu);
      }
    } else {
      const int b = it - LA;
      const int k0 = (npass - 1 - b / C::NJ) * C::BN;
      const int h0 = hbase + (C::NJ - 1 - b % C::NJ) * Q_BK;
      cp_weights<C::BN, Q_BK, Q_LDT>(st, wg_e + (size_t)k0 * H, H, K - k0, h0, H, wg);
      if constexpr (GATED)
        cp_weights<C::BN, Q_BK, Q_LDT>(st + C::BN * Q_LDT, wu_e + (size_t)k0 * H, H,
                                       K - k0, h0, H, wu);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {  // one group per stage, even if empty
    if (s < L) load(s, s);
    cp_async_commit();
  }
  int it = 0;  // the ring step consumed next
  // wait for step it, refill the stage step it - 1 used, return step it's
  auto next = [&]() -> const bf16* {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < L) load((it + ST - 1) % ST, it + ST - 1);
    cp_async_commit();
    return ring + (it % ST) * C::STAGE;
  };

  // ---- phase A
  for (int q = 0; q < C::NQ; ++q) {
    float g[R::WA / 8][4], u[R::WA / 8][4], dh[R::WA / 8][4];
    zero_acc<R::WA / 8>(g);
    zero_acc<R::WA / 8>(u);
    zero_acc<R::WA / 8>(dh);
    for (int j = 0; j < nn; ++j, ++it) {
      const bf16* st = next();
      if (live) step_y<R>(st, dh, wr, wc, lane);
    }
    for (int j = 0; j < nk; ++j, ++it) {
      const bf16* st = next();
      if (live) step_x<R, GATED>(st, g, u, wr, wc, lane);
    }
    act_grad<R, GATED, false, C::LDC>(g, u, dh, nullptr, Dg, Du, q * C::HS + wc * R::WA,
                                      hlim, act, wr, lane);
  }

  // ---- phase B (the first step's barrier orders the dg writes before it)
  float* out = partial + ((size_t)blockIdx.y * M + tile.row0) * K;
  for (int b = 0; b < npass; ++b) {
    float acc[C::WB / 8][4];
    zero_acc<C::WB / 8>(acc);
    for (int j = 0; j < C::NJ; ++j, ++it) {
      const bf16* st = next();
      if (live) step_dx<C, GATED>(st, Dg, Du, acc, (C::NJ - 1 - j) * Q_BK, wr, wc, lane);
    }
    if (live)
      store_acc<C::WB / 8>(out, K, acc, wr * 16, rows,
                           (npass - 1 - b) * C::BN + wc * C::WB, K, false, lane);
  }
  cp_async_wait<0>();
}

// ---- grouped dW ----------------------------------------------------------

// A block owns (expert e, HC hidden columns) and walks e's rows in batches
// of BR, through a ring of ST stages.  Phase A: per 64-wide sub-tile, dh,
// g [u] in registers (WR x WC warps), h, dg [du] rounded into shared
// memory (BR x HC each); phase B
// contracts over the batch's rows: dwo[chunk, n pass] = h^T dy (dy's n
// tiles through the ring again) and dwi[k pass, chunk] = x^T dg [dwi_up:
// x^T du], each pass's f32 sum stored (batches after the first: added)
// straight from the registers.
template <int HC_, bool GATED, int BR_, int ST_> struct DwRing {
  static constexpr int HC = HC_, BR = BR_, HS = 64, ST = ST_;
  using R = Recompute<BR, HS, GATED>;
  static constexpr int NQ = HC / HS;
  static constexpr int STAGE = cmax(cmax(R::XSTEP, R::YSTEP), BR * Q_LDT);
  static constexpr int LDC = HC + 8;
  static constexpr size_t RING = sizeof(bf16) * STAGE * ST;
  static constexpr size_t SMEM = RING + sizeof(bf16) * BR * LDC * (GATED ? 3 : 2);
  // dwo passes (HC x 64): OR strips of 16 hidden rows x OC slices of OW
  // columns; dwi passes (64 x HC): IR strips of 16 k rows x IC slices of IW
  static constexpr int OR = HC / 16 < Q_NW ? HC / 16 : Q_NW, OC = Q_NW / OR;
  static constexpr int OW = Q_BK / OC;
  static constexpr int IC = 2, IR = Q_NW / IC, IW = HC / IC;
  static_assert(OR * OC == Q_NW && OW % 16 == 0 && IR * 16 == Q_BK && IW % 16 == 0,
                "dW tiling");
  static_assert((STAGE * sizeof(bf16)) % 16 == 0 && SMEM <= 232448, "dW shared memory");
};

template <class C, bool GATED, int MINB>
__global__ void __launch_bounds__(Q_NT, MINB)
fused_ffn_bwd_dw_ring_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                             const bf16* __restrict__ wu, const bf16* __restrict__ wo,
                             const bf16* __restrict__ dy,
                             const int* __restrict__ group_sizes,
                             float* __restrict__ dwg, float* __restrict__ dwu,
                             float* __restrict__ dwo, int M, int K, int H, int N,
                             int E, int act) {
  using R = typename C::R;
  constexpr int HC = C::HC, BR = C::BR, ST = C::ST;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw + C::RING);
  bf16* Dg = Hs + BR * C::LDC;
  bf16* Du = Dg + BR * C::LDC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_h = (H + HC - 1) / HC;
  const int e = blockIdx.x / n_h, hbase = (blockIdx.x % n_h) * HC, hlim = H - hbase;
  __shared__ int span[2];
  if (warp == 0) {  // the expert's rows: [sum of the sizes before e, + size_e)
    int off = 0;
    for (int i = lane; i < e; i += 32) off += group_sizes[i];
#pragma unroll
    for (int d = 16; d; d >>= 1) off += __shfl_xor_sync(kFullMask, off, d);
    if (lane == 0) {
      span[0] = min(off, M);
      span[1] = min(off + group_sizes[e], M);
    }
  }
  __syncthreads();
  const int r_begin = span[0], r_end = span[1];
  const size_t ge = e;
  float* dwo_c = dwo + (ge * H + hbase) * N;  // this chunk's rows, ld N
  float* dwg_c = dwg + ge * K * H + hbase;    // this chunk's columns, ld H
  float* dwu_c = GATED ? dwu + ge * K * H + hbase : nullptr;

  if (r_begin >= r_end) {  // no rows: this expert's gradient is zero
    const int hc = min(HC, hlim), n4 = N / 4, h4 = hc / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < hc * n4; i += Q_NT)
      reinterpret_cast<float4*>(dwo_c + (size_t)(i / n4) * N)[i % n4] = z;
    for (int i = threadIdx.x; i < K * h4; i += Q_NT) {
      const size_t at = (size_t)(i / h4) * H + (i % h4) * 4;
      *reinterpret_cast<float4*>(dwg_c + at) = z;
      if constexpr (GATED) *reinterpret_cast<float4*>(dwu_c + at) = z;
    }
    return;
  }

  const int nk = (K + Q_BK - 1) / Q_BK, nn = (N + Q_BK - 1) / Q_BK;
  const int LQ = nn + nk, LA = C::NQ * LQ, LT = LA + nn + nk;
  const int nb = (r_end - r_begin + BR - 1) / BR, L = nb * LT;
  const bf16* wg_e = wg + ge * K * H;
  const bf16* wu_e = GATED ? wu + ge * K * H : nullptr;
  const bf16* wo_e = wo + ge * H * N;

  // ring step it -> stage s: batch it / LT; in it, phase A (sub-tile, nn
  // y steps then nk x steps), then nn dy tiles (dwo) and nk x tiles (dwi)
  auto load = [&](int s, int it) {
    bf16* st = ring + s * C::STAGE;
    const int r0 = r_begin + (it / LT) * BR, j = it % LT;
    const int rows = min(BR, r_end - r0), lim = (rows + 15) / 16 * 16;
    const bf16* xr = x + (size_t)r0 * K;
    const bf16* dyr = dy + (size_t)r0 * N;
    if (j < LA) {
      const int jj = j % LQ, h0 = hbase + (j / LQ) * C::HS;
      if (jj < nn) {
        const int n0 = jj * Q_BK;
        cp_rows64(st, dyr, N, lim, rows, n0, N, dy);
        cp_weights<C::HS, Q_BK, Q_LDT>(st + R::T_ELEMS, wo_e + (size_t)h0 * N, N,
                                       H - h0, n0, N, wo);
      } else {
        const int k0 = (jj - nn) * Q_BK;
        cp_rows64(st, xr, K, lim, rows, k0, K, x);
        cp_weights<Q_BK, C::HS, R::LDW>(st + R::T_ELEMS, wg_e + (size_t)k0 * H, H,
                                        K - k0, h0, H, wg);
        if constexpr (GATED)
          cp_weights<Q_BK, C::HS, R::LDW>(st + R::T_ELEMS + R::W_ELEMS,
                                          wu_e + (size_t)k0 * H, H, K - k0, h0, H, wu);
      }
    } else if (j - LA < nn) {
      cp_rows64(st, dyr, N, lim, rows, (j - LA) * Q_BK, N, dy);
    } else {
      cp_rows64(st, xr, K, lim, rows, (j - LA - nn) * Q_BK, K, x);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < L) load(s, s);
    cp_async_commit();
  }
  int it = 0;
  auto next = [&]() -> const bf16* {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < L) load((it + ST - 1) % ST, it + ST - 1);
    cp_async_commit();
    return ring + (it % ST) * C::STAGE;
  };

  const int wr = warp / R::WC, wc = warp % R::WC;  // phase A
  const int os = warp / C::OC, oc = warp % C::OC;  // dwo passes
  const int is = warp / C::IC, ic = warp % C::IC;  // dwi passes
  for (int bt = 0; bt < nb; ++bt) {
    const int rows = min(BR, r_end - r_begin - bt * BR);
    const int lim = (rows + 15) / 16 * 16;  // rows the contractions read
    const bool add = bt > 0, live = wr * 16 < rows;

    // ---- phase A: h, dg [du] of the batch into shared memory (the next
    // step's barrier orders the writes before phase B reads them, and phase
    // B's reads of the previous batch before these writes)
    for (int q = 0; q < C::NQ; ++q) {
      float g[R::WA / 8][4], u[R::WA / 8][4], dh[R::WA / 8][4];
      zero_acc<R::WA / 8>(g);
      zero_acc<R::WA / 8>(u);
      zero_acc<R::WA / 8>(dh);
      for (int j = 0; j < nn; ++j, ++it) {
        const bf16* st = next();
        if (live) step_y<R>(st, dh, wr, wc, lane);
      }
      for (int j = 0; j < nk; ++j, ++it) {
        const bf16* st = next();
        if (live) step_x<R, GATED>(st, g, u, wr, wc, lane);
      }
      act_grad<R, GATED, true, C::LDC>(g, u, dh, Hs, Dg, Du, q * C::HS + wc * R::WA,
                                       hlim, act, wr, lane);
    }

    // ---- dwo[chunk, n pass] (+)= h^T dy: A = h^T from Hs (stored [r][h]),
    // B = the dy tile (stored [r][n]), both through ldmatrix.trans
    for (int p = 0; p < nn; ++p, ++it) {
      const bf16* st = next();
      float acc[C::OW / 8][4];
      zero_acc<C::OW / 8>(acc);
      for (int kk = 0; kk < lim; kk += 16) {
        uint32_t a[4];
        ldsm_x4<true>(a, Hs + (kk + ((lane >> 4) & 1) * 8 + (lane & 7)) * C::LDC + os * 16 +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jp = 0; jp < C::OW / 16; ++jp) {
          uint32_t b[4];
          ldsm_x4<true>(b, st + (kk + (lane & 15)) * Q_LDT + oc * C::OW + jp * 16 +
                               (lane >> 4) * 8);
          mma_bf16(acc[2 * jp], a, b);
          mma_bf16(acc[2 * jp + 1], a, b + 2);
        }
      }
      store_acc<C::OW / 8>(dwo_c, N, acc, os * 16, hlim, p * Q_BK + oc * C::OW, N, add,
                           lane);
    }

    // ---- dwi[k pass, chunk] (+)= x^T dg [dwi_up: x^T du]: A = x^T from
    // the x tile (stored [r][k]), B = dg from Dg (stored [r][h])
    for (int p = 0; p < nk; ++p, ++it) {
      const bf16* st = next();
      float acc[C::IW / 8][4], acc2[C::IW / 8][4];
      zero_acc<C::IW / 8>(acc);
      zero_acc<C::IW / 8>(acc2);
      for (int kk = 0; kk < lim; kk += 16) {
        uint32_t a[4];
        ldsm_x4<true>(a, st + (kk + ((lane >> 4) & 1) * 8 + (lane & 7)) * Q_LDT + is * 16 +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jp = 0; jp < C::IW / 16; ++jp) {
          const int at = (kk + (lane & 15)) * C::LDC + ic * C::IW + jp * 16 + (lane >> 4) * 8;
          uint32_t b[4];
          ldsm_x4<true>(b, Dg + at);
          mma_bf16(acc[2 * jp], a, b);
          mma_bf16(acc[2 * jp + 1], a, b + 2);
          if constexpr (GATED) {
            ldsm_x4<true>(b, Du + at);
            mma_bf16(acc2[2 * jp], a, b);
            mma_bf16(acc2[2 * jp + 1], a, b + 2);
          }
        }
      }
      const int k0 = p * Q_BK;
      store_acc<C::IW / 8>(dwg_c + (size_t)k0 * H, H, acc, is * 16, K - k0, ic * C::IW,
                           hlim, add, lane);
      if constexpr (GATED)
        store_acc<C::IW / 8>(dwu_c + (size_t)k0 * H, H, acc2, is * 16, K - k0, ic * C::IW,
                             hlim, add, lane);
    }
  }
  cp_async_wait<0>();
}

template <class C, bool GATED, int MINB>
int launch_dx_ring(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wo,
                   const bf16* dy, const int* gs, float* partial, bf16* dx, int M,
                   int K, int H, int N, int E, int act, int splits, cudaStream_t st) {
  constexpr int BM = C::BM, HC = C::HC;
  if (splits != (H + HC - 1) / HC) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_ffn_bwd_dx_ring_kernel<C, GATED, MINB>;
  int err = set_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (err) return err;
  // every row tile the groups can have (as the forward's ring kernel)
  dim3 grid((M + BM - 1) / BM + (E < M ? E : M) + 1, splits);
  kernel<<<grid, Q_NT, C::SMEM, st>>>(x, wg, wu, wo, dy, gs, partial, M, K, H, N, E,
                                      act);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce_partials(partial, gs, dx, M, K, E, splits, st);
}

template <class C, bool GATED, int MINB>
int launch_dw_ring(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wo,
                   const bf16* dy, const int* gs, float* dwg, float* dwu, float* dwo,
                   int M, int K, int H, int N, int E, int act, cudaStream_t st) {
  constexpr int HC = C::HC;
  auto kernel = fused_ffn_bwd_dw_ring_kernel<C, GATED, MINB>;
  int err = set_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (err) return err;
  kernel<<<E * ((H + HC - 1) / HC), Q_NT, C::SMEM, st>>>(x, wg, wu, wo, dy, gs, dwg, dwu,
                                                          dwo, M, K, H, N, E, act);
  return static_cast<int>(cudaGetLastError());
}

// The shipped tilings of each instance the host's plan_bwd can pick, chosen
// by timing variants on an H100 at the fastmoe-gpt training rows (4096
// ragged or 96 x 56 capacity rows, d 1024, H 2048, gelu, experts of even
// load): two blocks an SM (at most 128 registers a thread, shared memory
// under half an SM's) beat one block with a deeper ring or a wider chunk —
// dX with 256-wide chunks, 128-wide phase A sub-tiles and a 2-stage ring,
// dW with 64-row batches and a 3-stage ring.  Gated (dg and du, wi and
// wi_up tiles) they need one block an SM.
template <int BM, bool GATED> struct DxShipped {
  using C = DxRing<BM, 256, GATED, 128, GATED ? 3 : 2>;
  static constexpr int MINB = GATED ? 1 : 2;
};
template <bool GATED> struct DwShipped {
  using C = DwRing<128, GATED, 64, 3>;
  static constexpr int MINB = GATED ? 1 : 2;
};


// ---------------------------------------------------------------------------
// the first versions (f32, and shapes the ring kernels do not take)
// ---------------------------------------------------------------------------

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
fused_ffn_bwd_dx_simple_kernel(const T* __restrict__ x, const T* __restrict__ wg,
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
fused_ffn_bwd_dw_simple_kernel(const T* __restrict__ x, const T* __restrict__ wg,
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

template <typename T>
int launch_dx_simple(const T* x, const T* wg, const T* wu, const T* wo, const T* dy,
              const int* gs, float* partial, T* dx, int M, int K, int H, int N,
              int E, int act, int splits, cudaStream_t st) {
  const size_t smem = DX<T>(K).total;
  int err = set_smem(reinterpret_cast<const void*>(fused_ffn_bwd_dx_simple_kernel<T>), smem);
  if (err) return err;
  dim3 grid((M + DX<T>::BM - 1) / DX<T>::BM + E, splits);
  fused_ffn_bwd_dx_simple_kernel<T><<<grid, NT, smem, st>>>(x, wg, wu, wo, dy, gs,
                                                      partial, M, K, H, N, E,
                                                      act, splits);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_splits_kernel<T><<<M, 128, 0, st>>>(partial, gs, dx, M, K, E, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw_simple(const T* x, const T* wg, const T* wu, const T* wo, const T* dy,
              const int* gs, float* dwg, float* dwu, float* dwo, int M, int K,
              int H, int N, int E, int act, cudaStream_t st) {
  const DW<T> lay;
  if (lay.dw_phase_end() > lay.h) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(fused_ffn_bwd_dw_simple_kernel<T>),
                     lay.total);
  if (err) return err;
  const int n_h = (H + BH - 1) / BH;
  fused_ffn_bwd_dw_simple_kernel<T><<<E * n_h, NT, lay.total, st>>>(
      x, wg, wu, wo, dy, gs, dwg, dwu, dwo, M, K, H, N, E, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (M, K); wg, wu (E, K, H) — wu null unless swiglu; wo (E, H, N);
// dy (M, N); group_sizes (E,) int32 summing to <= M.

// The dX ring kernel: bf16; K, H, N multiples of 8; 16-byte aligned
// operands; bm in {16, 32, 64}, splits = ceil(H / 256);
// partial (splits, M, K) f32 scratch; dx (M, K).
extern "C" int fused_ffn_bwd_dx(const void* x, const void* wg, const void* wu,
                                const void* wo, const void* dy,
                                const void* group_sizes, void* partial, void* dx,
                                int M, int K, int H, int N, int E, int act, int bm,
                                int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gated = wu != nullptr;
#define DX(BM_, G_)                                                                \
  if (bm == BM_ && gated == G_)                                                    \
    return launch_dx_ring<typename DxShipped<BM_, G_>::C, G_,                      \
                          DxShipped<BM_, G_>::MINB>(                               \
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg),                 \
        static_cast<const bf16*>(wu), static_cast<const bf16*>(wo),                \
        static_cast<const bf16*>(dy), static_cast<const int*>(group_sizes),        \
        static_cast<float*>(partial), static_cast<bf16*>(dx), M, K, H, N, E, act,  \
        splits, st)
  DX(16, false); DX(32, false); DX(64, false);
  DX(16, true); DX(32, true); DX(64, true);
#undef DX
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dW ring kernel: the same inputs; dwg, dwu (E, K, H) and dwo (E, H, N)
// f32, every element written (zeros for experts without rows); dwu null
// unless swiglu.
extern "C" int fused_ffn_bwd_dw(const void* x, const void* wg, const void* wu,
                                const void* wo, const void* dy,
                                const void* group_sizes, void* dwg, void* dwu,
                                void* dwo, int M, int K, int H, int N, int E,
                                int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DW(G_)                                                                     \
  return launch_dw_ring<DwShipped<G_>::C, G_, DwShipped<G_>::MINB>(                \
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),                   \
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wo),                  \
      static_cast<const bf16*>(dy), static_cast<const int*>(group_sizes),          \
      static_cast<float*>(dwg), static_cast<float*>(dwu), static_cast<float*>(dwo), \
      M, K, H, N, E, act, st)
  if (wu != nullptr) DW(true);
  DW(false);
#undef DW
}

// The dynamic shared memory a ring kernel asks for: kind 0 dX at (bm,
// gated), kind 1 dW at gated (bm ignored); 0 if there is no such instance.
// The host's mirrors (kernels/fused_ffn_bwd.py) are held to it.
extern "C" int fused_ffn_bwd_smem(int kind, int bm, int gated) {
#define DXS(BM_, G_) \
  if (kind == 0 && bm == BM_ && (gated != 0) == G_) return (int)DxShipped<BM_, G_>::C::SMEM
  DXS(16, false); DXS(32, false); DXS(64, false);
  DXS(16, true); DXS(32, true); DXS(64, true);
#undef DXS
  if (kind == 1) return (int)(gated ? DwShipped<true>::C::SMEM : DwShipped<false>::C::SMEM);
  return 0;
}

// The first versions: f32 or bf16, any K, H, N.  dx_simple: partial
// (splits, M, K) f32 scratch, splits from kernels/fused_ffn.py
// simple_splits; dw_simple: outputs as fused_ffn_bwd_dw.  x, the weights,
// dy and dx share the dtype.
extern "C" int fused_ffn_bwd_dx_simple(const void* x, const void* wg, const void* wu,
                                       const void* wo, const void* dy,
                                       const void* group_sizes, void* partial,
                                       void* dx, int M, int K, int H, int N, int E,
                                       int act, int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float* p = static_cast<float*>(partial);
  if (dtype == DT_BF16)
    return launch_dx_simple(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                            static_cast<const bf16*>(wu), static_cast<const bf16*>(wo),
                            static_cast<const bf16*>(dy), gs, p, static_cast<bf16*>(dx),
                            M, K, H, N, E, act, splits, st);
  return launch_dx_simple(static_cast<const float*>(x), static_cast<const float*>(wg),
                          static_cast<const float*>(wu), static_cast<const float*>(wo),
                          static_cast<const float*>(dy), gs, p, static_cast<float*>(dx),
                          M, K, H, N, E, act, splits, st);
}

extern "C" int fused_ffn_bwd_dw_simple(const void* x, const void* wg, const void* wu,
                                       const void* wo, const void* dy,
                                       const void* group_sizes, void* dwg, void* dwu,
                                       void* dwo, int M, int K, int H, int N, int E,
                                       int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float *a = static_cast<float*>(dwg), *b = static_cast<float*>(dwu),
        *c = static_cast<float*>(dwo);
  if (dtype == DT_BF16)
    return launch_dw_simple(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                            static_cast<const bf16*>(wu), static_cast<const bf16*>(wo),
                            static_cast<const bf16*>(dy), gs, a, b, c, M, K, H, N, E,
                            act, st);
  return launch_dw_simple(static_cast<const float*>(x), static_cast<const float*>(wg),
                          static_cast<const float*>(wu), static_cast<const float*>(wo),
                          static_cast<const float*>(dy), gs, a, b, c, M, K, H, N, E,
                          act, st);
}

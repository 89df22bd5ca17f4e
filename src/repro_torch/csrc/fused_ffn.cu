// Fused expert FFN — grouped GEMM1 + activation + grouped GEMM2 in one
// kernel:  y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g].
//
// Replaces the Pallas kernel fused_ffn_tiled
// (src/repro/kernels/fused_ffn.py:111).  As there, the hidden activation
// never exists at (M, H) in device memory, and it is rounded to the working
// dtype before the second product (as fused_ffn.py:90 does, so fused
// matches two-pass in bf16); the hidden tail is masked on both sides of the
// second product (fused_ffn.py:92-101).
//
// What differs from the TPU: its grid walked the hidden tiles in order on
// one core, carrying the sum in scratch.  Blocks on the H100 run in no
// order, so the hidden dimension of a row tile is split over `splits`
// blocks; each writes an f32 partial of its rows, and a second small
// kernel sums the partials in split order (deterministic), rounds to the
// working dtype and writes rows >= sum(group_sizes) as zero.  Groups are
// found by each block from the group sizes (common.cuh find_tile); an empty
// group owns no tile and its weights are never read.
//
// Bound on the H100 at every MoE shape: bytes.  Rows per expert average at
// most ~56 (training), a few tens of flops per weight byte against the
// ~295 where the tensor cores become the limit.  So the bf16 kernel
// (fused_ffn_ring_kernel) is built to keep weight bytes in flight and read
// each expert's weights about once:
//   - a block owns one row tile of one expert (BM in {16, 32, 64}, from the
//     rows per expert, kernels/fused_ffn.py plan: one tile holds an
//     average expert's rows, so its weights are fetched once, not
//     ceil(rows / 16) times) and HC hidden columns (64, 128 or 256: the
//     split, sized so the grid gives every SM at least two blocks);
//   - x's k tiles and the weight tiles stream through a 3-stage cp.async
//     ring, two stages in flight while one computes; three 128-thread
//     blocks fit an SM;
//   - GEMM1 (mma.sync, f32 accumulators in registers) is activated in
//     registers and packed to bf16 as GEMM2's A fragments — the flash
//     forward's S -> P identity — so no pre-activation and no hidden tile
//     goes through shared memory; the block's whole (BM x HC) hidden chunk
//     stays in registers while GEMM2 walks the output in passes of BN
//     columns, each pass's (BM x BN) sum written as the split's partial
//     straight from the accumulators.  Four warps: BM / 16 row strips
//     times 4 / (BM / 16) column slices; the slices of a strip each compute
//     its GEMM1 (at BM 16 and 32 that is redundant work on the tensor
//     cores, which are idle at these shapes, so that no hidden tile is
//     shared through memory).
// It needs bf16, K, H and N multiples of 8 and 16-byte aligned operands
// (every model shape); the host (fused_ffn.py route) sends f32 and other
// shapes to the simple kernel below.
//
// The simple kernel (fused_ffn_simple_kernel, the first version): one
// (16, 128) hidden tile at a time in shared memory, synchronous loads, wmma
// for bf16, the FMA units for f32; its (16, N) f32 output in shared memory.
#include <mma.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32, and shapes the ring does not take: the simple kernel
// ---------------------------------------------------------------------------

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
fused_ffn_simple_kernel(const T* __restrict__ x, const T* __restrict__ wg,
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
      fused_ffn_simple_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + BM - 1) / BM + E, splits);
  fused_ffn_simple_kernel<T><<<grid, NT, smem, st>>>(x, wg, wu, wo, gs, partial, M, K,
                                               H, N, E, act, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_splits_kernel<T><<<M, 128, 0, st>>>(partial, gs, y, M, N, E, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the weight-streaming ring kernel
// ---------------------------------------------------------------------------

constexpr int R_BK = 64, R_HS = 64, R_NT = 128;  // k depth, hidden sub-tile, threads

// BM rows, HC hidden columns a block; WN output columns a warp per GEMM2
// pass; S1 hidden sub-tiles (64 wide) a GEMM1 ring step; ST ring stages.
template <int BM, int HC, bool GATED, int WN, int S1, int ST> struct RingCfg {
  static constexpr int WR = BM / 16, WC = 4 / WR;  // warp grid: row strips x column slices
  static constexpr int BN = WN * WC;               // output columns a GEMM2 pass
  static constexpr int NH = HC / R_HS;             // hidden sub-tiles a block
  static constexpr int N1 = NH / S1;               // GEMM1 sub-tile groups
  static constexpr int LDX = R_BK + 8, LDW = S1 * R_HS + 8, LDO = BN + 8;
  static constexpr int X_ELEMS = BM * LDX, W_ELEMS = R_BK * LDW;
  static constexpr int G1 = X_ELEMS + W_ELEMS * (GATED ? 2 : 1);  // GEMM1 stage
  static constexpr int G2 = R_HS * LDO;                            // GEMM2 stage
  static constexpr int STAGE = G1 > G2 ? G1 : G2;  // elements, 16-byte multiple
  static constexpr size_t SMEM = sizeof(bf16) * STAGE * ST;
  static_assert(WR * WC == 4 && NH % S1 == 0 && WN % 16 == 0, "tiling");
  static_assert((STAGE * sizeof(bf16)) % 16 == 0, "stage alignment");
};

template <int BM, int HC, bool GATED, int WN, int S1, int ST>
__global__ void __launch_bounds__(R_NT, 3)
fused_ffn_ring_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu, const bf16* __restrict__ wo,
                      const int* __restrict__ group_sizes,
                      float* __restrict__ partial, int M, int K, int H, int N,
                      int E, int act) {
  using C = RingCfg<BM, HC, GATED, WN, S1, ST>;
  constexpr int HS1 = S1 * R_HS;  // hidden columns a GEMM1 step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const Tile tile = find_tile(group_sizes, E, M, BM, blockIdx.x);
  const int rows = tile.row1 - tile.row0;
  if (tile.group < 0 || rows <= 0) return;  // the reduction zeroes those rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / C::WC, wc = warp % C::WC;
  const int hbase = blockIdx.y * HC;  // this block's hidden columns
  const int nk = (K + R_BK - 1) / R_BK, npass = (N + C::BN - 1) / C::BN;
  const int L1 = C::N1 * nk, L = L1 + npass * C::NH;  // ring steps: GEMM1, GEMM2
  const size_t ge = tile.group;
  const bf16* xa = x + (size_t)tile.row0 * K;
  const bf16* wg_e = wg + ge * K * H;
  const bf16* wu_e = GATED ? wu + ge * K * H : nullptr;
  const bf16* wo_e = wo + ge * H * N;

  // ring step it -> stage s.  GEMM1 steps (group it / nk, k tile it % nk):
  // the x rows' k tile and wi's (64 x HS1) tile (and wi_up's); GEMM2 steps
  // (pass, sub-tile): wo's (64 hidden x BN) tile.  Past K, H, N and the
  // tile's rows the copies are zero-filled.
  auto load1 = [&](int s, int it) {
    bf16* st = smem + s * C::STAGE;
    const int k0 = (it % nk) * R_BK, h0 = hbase + (it / nk) * HS1;
    for (int c = tid; c < BM * (R_BK / 8); c += R_NT) {
      const int r = c / (R_BK / 8), col = (c % (R_BK / 8)) * 8;
      const bool ok = r < rows && k0 + col < K;
      cp_async16(st + r * C::LDX + col, ok ? xa + (size_t)r * K + k0 + col : x, ok);
    }
    bf16* ws = st + C::X_ELEMS;
    for (int c = tid; c < R_BK * (HS1 / 8); c += R_NT) {
      const int r = c / (HS1 / 8), col = (c % (HS1 / 8)) * 8;
      const bool ok = k0 + r < K && h0 + col < H;
      const size_t at = (size_t)(k0 + r) * H + h0 + col;
      cp_async16(ws + r * C::LDW + col, ok ? wg_e + at : wg, ok);
      if constexpr (GATED)
        cp_async16(ws + C::W_ELEMS + r * C::LDW + col, ok ? wu_e + at : wu, ok);
    }
  };
  auto load2 = [&](int s, int it) {
    bf16* st = smem + s * C::STAGE;
    const int j = it - L1, h0 = hbase + (j % C::NH) * R_HS, n0 = (j / C::NH) * C::BN;
    for (int c = tid; c < R_HS * (C::BN / 8); c += R_NT) {
      const int r = c / (C::BN / 8), col = (c % (C::BN / 8)) * 8;
      const bool ok = h0 + r < H && n0 + col < N;
      cp_async16(st + r * C::LDO + col,
                 ok ? wo_e + (size_t)(h0 + r) * N + n0 + col : wo, ok);
    }
  };
  auto load = [&](int s, int it) {
    if (it < L1) load1(s, it);
    else load2(s, it);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {  // one group per stage, even if empty
    if (s < L) load(s, s);
    cp_async_commit();
  }
  int it = 0;  // the ring step consumed next
  // wait for step it, refill the stage step it - 1 used, return step it's;
  // in GEMM2 every refill is a GEMM2 step (it >= L1), so its loads need
  // none of GEMM1's pointers
  auto next = [&](auto&& refill) -> const bf16* {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < L) refill((it + ST - 1) % ST, it + ST - 1);
    cp_async_commit();
    return smem + (it % ST) * C::STAGE;
  };

  // ---- GEMM1 + activation: the warp's 16 rows of each 64-wide hidden
  // sub-tile, activated in registers, rounded to bf16 and packed as the A
  // fragments of GEMM2 (h[sub][k step][4]); hidden columns >= H are zero
  uint32_t h[C::NH][4][4];
#pragma unroll
  for (int q = 0; q < C::N1; ++q) {
    float a1[8 * S1][4], u1[8 * S1][4];
#pragma unroll
    for (int j = 0; j < 8 * S1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a1[j][e] = u1[j][e] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const bf16* xs = next(load);
      const bf16* ws = xs + C::X_ELEMS;
#pragma unroll
      for (int kk = 0; kk < R_BK; kk += 16) {
        uint32_t a[4];
        ldsm_x4<false>(a, xs + (wr * 16 + (lane & 15)) * C::LDX + kk + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 4 * S1; ++jp) {
          uint32_t b[4];
          ldsm_x4<true>(b, ws + (kk + (lane & 15)) * C::LDW + jp * 16 + (lane >> 4) * 8);
          mma_bf16(a1[2 * jp], a, b);
          mma_bf16(a1[2 * jp + 1], a, b + 2);
          if constexpr (GATED) {
            ldsm_x4<true>(b, ws + C::W_ELEMS + (kk + (lane & 15)) * C::LDW + jp * 16 +
                                 (lane >> 4) * 8);
            mma_bf16(u1[2 * jp], a, b);
            mma_bf16(u1[2 * jp + 1], a, b + 2);
          }
        }
      }
    }
#pragma unroll
    for (int sub = 0; sub < S1; ++sub) {
      const int hc = hbase + (q * S1 + sub) * R_HS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // (row g | g + 8) x (cols 0-7 | 8-15)
          const int j = 8 * sub + 2 * kk + u / 2, e = 2 * (u % 2);
          const int col = hc + 16 * kk + 8 * (u / 2) + 2 * t4;
          const float v0 = col < H ? activate(a1[j][e], u1[j][e], act) : 0.f;
          const float v1 = col + 1 < H ? activate(a1[j][e + 1], u1[j][e + 1], act) : 0.f;
          h[q * S1 + sub][kk][u] = pack_bf16(v0, v1);
        }
    }
  }

  // ---- GEMM2: per pass of BN output columns, the warp's 16 rows x WN
  // columns summed over the block's hidden sub-tiles, written as this
  // split's f32 partial straight from the accumulators
  float* out = partial + ((size_t)blockIdx.y * M + tile.row0) * N;
  for (int pass = 0; pass < npass; ++pass) {
    float acc[WN / 8][4];
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int sub = 0; sub < C::NH; ++sub, ++it) {
      const bf16* os = next(load2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jp = 0; jp < WN / 16; ++jp) {
          uint32_t b[4];
          ldsm_x4<true>(b, os + (kk * 16 + (lane & 15)) * C::LDO + wc * WN + jp * 16 +
                               (lane >> 4) * 8);
          mma_bf16(acc[2 * jp], h[sub][kk], b);
          mma_bf16(acc[2 * jp + 1], h[sub][kk], b + 2);
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wr * 16 + g + hh * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int c = pass * C::BN + wc * WN + 8 * j + 2 * t4;
        if (c < N)
          *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
              make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
    }
  }
  cp_async_wait<0>();
}

template <int BM, int HC, bool GATED, int WN, int S1, int ST>
int launch_ring(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wo,
                const int* gs, float* partial, bf16* y, int M, int K, int H,
                int N, int E, int act, int splits, cudaStream_t st) {
  auto kernel = fused_ffn_ring_kernel<BM, HC, GATED, WN, S1, ST>;
  constexpr size_t smem = RingCfg<BM, HC, GATED, WN, S1, ST>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every row tile the groups can have: sum ceil(size_e / BM) plus the zero
  // tiles past them is at most ceil(M / BM) + min(E, M) + 1
  dim3 grid((M + BM - 1) / BM + (E < M ? E : M) + 1, splits);
  kernel<<<grid, R_NT, smem, st>>>(x, wg, wu, wo, gs, partial, M, K, H, N, E, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce_partials(partial, gs, y, M, N, E, splits, st);
}

// The tiling of each (BM, HC, gated), chosen by timing the variants on an
// H100 at the fastmoe-gpt shapes: at BM 16 (decode) 32 output columns a
// warp and a 4-stage ring (more, smaller blocks' worth of loads in flight);
// at BM 32 and 64, 128 columns a warp (wo rows of 256 bytes or more a
// copy) and, ungated, two hidden sub-tiles a GEMM1 step (x is re-read half
// as often, wi rows of 256 bytes) in a 2-stage ring of large stages.
// Gated: one sub-tile a step and 64 columns a warp (two GEMM1
// accumulators: 128 would spill), 3 stages.
template <int BM, int HC, bool GATED> struct Shipped {
  static constexpr int WN = BM == 16 ? 32 : (GATED ? 64 : 128);
  static constexpr int S1 = GATED || HC == 64 || BM == 16 ? 1 : 2;
  static constexpr int ST = BM == 16 ? 4 : (S1 == 2 ? 2 : 3);
  using C = RingCfg<BM, HC, GATED, WN, S1, ST>;
};

template <int BM, int HC, bool GATED>
int launch_ring_cfg(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wo,
                    const int* gs, float* partial, bf16* y, int M, int K, int H,
                    int N, int E, int act, int splits, cudaStream_t st) {
  using S = Shipped<BM, HC, GATED>;
  return launch_ring<BM, HC, GATED, S::WN, S::S1, S::ST>(
      x, wg, wu, wo, gs, partial, y, M, K, H, N, E, act, splits, st);
}

template <int BM, int HC> int ring_smem(bool gated) {
  if constexpr (HC <= 128) {
    if (gated) return (int)Shipped<BM, HC, true>::C::SMEM;
  } else {
    if (gated) return 0;
  }
  return (int)Shipped<BM, HC, false>::C::SMEM;
}

template <int BM, int HC>
int ring_gated(bool gated, const bf16* x, const bf16* wg, const bf16* wu,
               const bf16* wo, const int* gs, float* partial, bf16* y, int M,
               int K, int H, int N, int E, int act, int splits, cudaStream_t st) {
  if constexpr (HC <= 128) {
    if (gated)
      return launch_ring_cfg<BM, HC, true>(x, wg, wu, wo, gs, partial, y, M, K, H,
                                           N, E, act, splits, st);
  } else {
    if (gated) return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_ring_cfg<BM, HC, false>(x, wg, wu, wo, gs, partial, y, M, K, H, N,
                                        E, act, splits, st);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (M, K); wg, wu (E, K, H) — wu null unless swiglu; wo (E, H, N);
// group_sizes (E,) int32; partial (splits, M, N) float32 scratch; y (M, N).

// The ring kernel: bf16; K, H, N multiples of 8; 16-byte aligned operands;
// bm in {16, 32, 64}, hc in {64, 128, 256} (128 at most when gated),
// splits = ceil(H / hc).
extern "C" int fused_ffn(const void* x, const void* wg, const void* wu,
                         const void* wo, const void* group_sizes, void* partial,
                         void* y, int M, int K, int H, int N, int E, int act,
                         int bm, int hc, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gated = wu != nullptr;
#define RING(BM_, HC_)                                                         \
  if (bm == BM_ && hc == HC_)                                                  \
    return ring_gated<BM_, HC_>(gated, static_cast<const bf16*>(x),            \
                                static_cast<const bf16*>(wg),                  \
                                static_cast<const bf16*>(wu),                  \
                                static_cast<const bf16*>(wo),                  \
                                static_cast<const int*>(group_sizes),          \
                                static_cast<float*>(partial),                  \
                                static_cast<bf16*>(y), M, K, H, N, E, act,     \
                                splits, st)
  RING(16, 64); RING(16, 128); RING(16, 256);
  RING(32, 64); RING(32, 128); RING(32, 256);
  RING(64, 64); RING(64, 128); RING(64, 256);
#undef RING
  return static_cast<int>(cudaErrorInvalidValue);
}

// The simple kernel: f32 or bf16, any K, H, N.
extern "C" int fused_ffn_simple(const void* x, const void* wg, const void* wu,
                                const void* wo, const void* group_sizes,
                                void* partial, void* y, int M, int K, int H,
                                int N, int E, int act, int splits, int dtype,
                                void* stream) {
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

// The dynamic shared memory the ring kernel asks for at (bm, hc, gated);
// 0 if there is no such instance.
extern "C" int fused_ffn_smem(int bm, int hc, int gated) {
#define SM(BM_, HC_) \
  if (bm == BM_ && hc == HC_) return ring_smem<BM_, HC_>(gated != 0)
  SM(16, 64); SM(16, 128); SM(16, 256);
  SM(32, 64); SM(32, 128); SM(32, 256);
  SM(64, 64); SM(64, 128); SM(64, 256);
#undef SM
  return 0;
}

// Flash attention, forward and backward:
//   o = softmax(q k^T / sqrt(d)) v over the keys with 0 <= i - j < window
//   (causal) or i - j < window (not causal), i = q_offset + row, GQA with
//   the kv head h / (H / KV).
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py:73), and, for the backward, the XLA
// autodiff of the jnp blockwise scan the JAX models differentiate
// (src/repro/models/attention.py:67), which has no Pallas kernel.  As
// there, the (S, S) scores never reach device memory, the online-softmax
// statistics (m, l) are f32, and l is floored at 1e-30 before the division.
//
// What differs from the TPU kernel: its grid walked every kv tile in order
// on one core and masked the ones outside the band.  Here a forward block
// owns one (q tile, head, batch) and walks, in a loop, only the kv tiles
// its rows can see, from floor(max(0, i0 - window + 1) / BK) up to the
// diagonal when causal; a backward block owns one (kv tile, kv head,
// batch) and walks only the q tiles that see it.  Tiles outside the band
// are never loaded, and masks are computed only on tiles that cross the
// diagonal, the window edge or the Skv tail.  Any Sq and Skv (no multiple
// of a tile).  The window is a runtime int, so one build serves every
// layer of a stack that mixes windows.
//
// Bound on the H100: operations at long sequences (4 d flops per visible
// (i, j) pair forward, 10 d backward), bytes at short ones.
//
// Forward, bf16 (flash_fwd_wgmma_kernel): FlashAttention-3's layout —
// K and V tiles by TMA into a 2-4 stage mbarrier ring fed by one producer
// warp, consumer warpgroups on wgmma with S, P and O in registers, softmax
// in base 2 with scale log2(e) folded into one multiply.  The reference
// takes P V in f32: the forward splits P into bf16 high and low parts (two
// products, P exact to ~2^-16), so its bf16 output is, element for
// element, nearly always the plain version's.  The tensor work is thus 6 d
// flops a visible pair; the bound counts the 4 d the function needs.
//
// Backward, bf16 (FlashAttention-2's): a prep kernel writes delta =
// rowsum(dO * O); flash_bwd_mma_kernel owns one (64-row kv tile, kv head,
// batch), keeps dK and dV in f32 registers for its whole loop over the G
// query heads of the group and the q tiles that see its kv tile, and per
// (head, q tile) step, with the kv rows as the mma M dimension:
//   S^T = K Q^T and dP^T = V dO^T (f32 accumulators);
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta), in registers;
//   dV += P^T dO, dK += dS^T Q, the accumulators packed to bf16 as the A
//   fragments (the forward's identity), so no S, dP, P or dK/dV tile goes
//   through shared memory;
//   dQ += dS K: dS (bf16) is written once to shared memory, and each warp
//   writes its (16 q rows x 64 d) part, 16 bytes a lane (two lanes pair up
//   their fragments), to an f32 scratch in device memory: where the host
//   gives one slot per kv tile (kernels/flash_attention.py dq_scratch,
//   within a memory budget: every training shape), a plain store to this
//   kv tile's own slot of (kv tiles, B, Sq, H, d); beyond it, an atomic
//   add to one (B, Sq, H, d) scratch.  A last small kernel sums the slots
//   the kv tiles wrote, in kv-tile order, scales by 1/sqrt(d) and rounds
//   to bf16.
// So the work is the 10 d flops per pair the bound counts: no kernel
// recomputes S and dP for dQ.  Q, dO, lse and delta of the next step land
// in a two-stage cp.async ring while this one computes.  Tiles: 64 kv rows
// over 4 warps; 64 q rows a step at d = 64 (the fastmoe-gpt training
// shape is 512 blocks of at most 4 steps), 32 at d = 128 (a thread holds
// 64 + 64 f32 accumulators of dK and dV; two blocks fit an SM).  P and dS
// are rounded to bf16 for their second products, as FlashAttention does.
// The kv tile is the grid's slowest index, so the tiles most q tiles see
// (the first, when causal) start first and the light ones fill in.
// With slots, dq is bitwise reproducible (dk and dv have one owner each
// and a fixed order).  With the atomic adds it is not: their order changes
// from run to run, so dq may differ in its last bits between two runs.
// Still simple: mma.sync rather than wgmma; K and V fragments re-read from
// shared memory each step; ~255 registers a thread, so two blocks an SM;
// at the small fastmoe-gpt shapes (blocks of 1-4 steps) latency, the
// memset of the scratch and three launches weigh most.
//
// f32 (the oracles' dtype): the FMA units (not TF32), every product staged
// through shared memory; the backward as two kernels (dK/dV per kv tile,
// dQ per q tile) with no atomics.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 128;  // four warps
constexpr int BQ = 64;   // q rows per tile (forward; f32 backward)
constexpr int BK32 = 32, PAD32 = 4;  // f32 kernels: kv rows per tile, row padding
constexpr float kNeg = -1e30f;

struct Args {
  int B, Sq, Skv, H, KV, window, q_offset, causal;
  float scale;
};

// Bump allocator over dynamic shared memory; run with base = nullptr on
// the host to size it (the same carving on both sides).
struct Carve {
  unsigned char* base;
  size_t off;
  template <typename U> __host__ __device__ U* take(size_t n) {
    off = (off + 127) / 128 * 128;
    U* p = reinterpret_cast<U*>(base + off);
    off += n * sizeof(U);
    return p;
  }
};

// C (M x N f32, ldc) = or += a product of two f32 tiles in shared memory,
// on the FMA units, one output element per thread at a time, k in order:
//   NT: C[m][n] = sum_k A[m][k] B[n][k]   (A M x KD, B N x KD)
//   NN: C[m][n] = sum_k A[m][k] B[k][n]   (A M x KD, B KD x N)
//   TN: C[m][n] = sum_k A[k][m] B[k][n]   (A KD x M, B KD x N)
enum Op { OP_NT, OP_NN, OP_TN };

template <int OP, bool ACC, int M, int N, int KD>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda,
                                   const float* B, int ldb) {
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int m = e / N, n = e % N;
    float s = ACC ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < KD; ++k) {
      const float a = OP == OP_TN ? A[k * lda + m] : A[m * lda + k];
      const float b = OP == OP_NT ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// Rows [s0, s0 + ROWS) of head h of a (B, S, Hn, D) f32 tensor (batch
// already applied to src) as a ROWS x D tile, in 16-byte chunks; rows past
// S read as zero.  fetch() issues every load of the tile before any is
// used, so the tile costs one memory latency, and a caller can fetch the
// next tile into registers while it computes on the current one; store()
// writes the registers to shared memory.  Needs 16-byte aligned rows (the
// wrapper checks the pointers).
template <int ROWS, int D> struct RowsInFlight {
  static constexpr int V = 4, CH = D / V, N = ROWS * CH / NT;
  static_assert((ROWS * CH) % NT == 0, "tile does not split over the block");
  uint4 buf[N];
  __device__ __forceinline__ void fetch(const float* src, int S, int Hn, int h,
                                        int s0) {
    const float* base = src + ((size_t)s0 * Hn + h) * D;
    const size_t ld = (size_t)Hn * D;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NT, r = i / CH, c = (i % CH) * V;
      buf[u] = s0 + r < S ? *reinterpret_cast<const uint4*>(base + r * ld + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int LD> __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NT, r = i / CH, c = (i % CH) * V;
      *reinterpret_cast<uint4*>(dst + r * LD + c) = buf[u];
    }
  }
};

template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int S,
                                          int Hn, int h, int s0) {
  RowsInFlight<ROWS, D> t;
  t.fetch(src, S, Hn, h, s0);
  t.store<LD>(dst);
}

// Is any (i, j) of the tile outside the band, or past Skv?  Rows
// [i_lo, i_hi] (absolute), keys [j0, j0 + bk).
__device__ __forceinline__ bool needs_mask(long long i_lo, long long i_hi,
                                           int j0, int bk, int Skv, int window,
                                           int causal) {
  return j0 + bk > Skv || (causal && j0 + bk - 1 > i_lo) ||
         i_hi - j0 >= window;
}

__device__ __forceinline__ bool visible(long long i, int j, int Skv, int window,
                                        int causal) {
  const long long d = i - j;
  return j < Skv && d < window && (!causal || d >= 0);
}

// The kv tiles rows [i_lo, i_hi] can see: [*t0, *t1] (empty if t0 > t1).
__device__ __forceinline__ void kv_tiles(long long i_lo, long long i_hi,
                                         int Skv, int window, int causal,
                                         int bk, int* t0, int* t1) {
  long long lo = i_lo - window + 1;
  long long hi = causal ? (i_hi < Skv - 1 ? i_hi : Skv - 1) : Skv - 1;
  if (lo < 0) lo = 0;
  *t0 = (int)(lo / bk);
  *t1 = hi < lo ? *t0 - 1 : (int)(hi / bk);
}

// ---------------------------------------------------------------------------
// forward, f32: the FMA units, every product staged through shared memory
// ---------------------------------------------------------------------------

template <int D> struct FwdSmem {
  static constexpr int BK = BK32, LDT = D + PAD32;
  static constexpr int LDS = BK + 4, LDP = BK + PAD32, LDO = D + 4;
  float *q, *k, *v, *p, *s, *o, *m, *l, *corr;
  __host__ __device__ size_t carve(unsigned char* base) {
    Carve c{base, 0};
    q = c.take<float>(BQ * LDT);
    k = c.take<float>(BK * LDT);
    v = c.take<float>(BK * LDT);
    s = c.take<float>(BQ * LDS);
    p = c.take<float>(BQ * LDP);
    o = c.take<float>(BQ * LDO);
    m = c.take<float>(BQ);
    l = c.take<float>(BQ);
    corr = c.take<float>(BQ);
    return c.off;
  }
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                 int window, int q_offset, int causal, float scale) {
  using L = FwdSmem<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.carve(smem);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const long long i_lo = (long long)q_offset + q0, i_hi = i_lo + rows - 1;
  const float* kb = k + (size_t)b * Skv * KV * D;
  const float* vb = v + (size_t)b * Skv * KV * D;

  load_rows<BQ, D, L::LDT>(sm.q, q + (size_t)b * Sq * H * D, Sq, H, h, q0);
  for (int i = tid; i < BQ * L::LDO; i += NT) sm.o[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) { sm.m[i] = kNeg; sm.l[i] = 0.f; }

  int t0, t1;
  kv_tiles(i_lo, i_hi, Skv, window, causal, BK, &t0, &t1);
  // softmax stage: two threads per row, columns half, half + 2, ...
  const int r = tid >> 1, half = tid & 1;
  const long long i = i_lo + r;
  RowsInFlight<BK, D> kf, vf;
  if (t0 <= t1) {
    kf.fetch(kb, Skv, KV, kvh, t0 * BK);
    vf.fetch(vb, Skv, KV, kvh, t0 * BK);
  }
  for (int t = t0; t <= t1; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile's products are done with k, v, p
    kf.template store<L::LDT>(sm.k);
    vf.template store<L::LDT>(sm.v);
    __syncthreads();
    if (t < t1) {  // the next tile's loads fly while this one computes
      kf.fetch(kb, Skv, KV, kvh, j0 + BK);
      vf.fetch(vb, Skv, KV, kvh, j0 + BK);
    }
    mm<OP_NT, false, BQ, BK, D>(sm.s, L::LDS, sm.q, L::LDT, sm.k, L::LDT);
    __syncthreads();

    const bool mask = needs_mask(i_lo, i_hi, j0, BK, Skv, window, causal);
    float* srow = sm.s + r * L::LDS;
    float mx = -INFINITY;
    for (int c = half; c < BK; c += 2) {
      float s = srow[c] * scale;
      if (mask && !visible(i, j0 + c, Skv, window, causal)) s = -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sm.m[r], m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = half; c < BK; c += 2) {
      const float p = expf(srow[c] - m_new);  // masked: exp(-inf) = 0
      sum += p;
      sm.p[r * L::LDP + c] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_old - m_new);
    for (int c = half; c < D; c += 2) sm.o[r * L::LDO + c] *= corr;
    __syncwarp();
    if (half == 0) {
      sm.m[r] = m_new;
      sm.l[r] = sm.l[r] * corr + sum;
    }
    __syncthreads();
    mm<OP_NN, true, BQ, D, BK>(sm.o, L::LDO, sm.p, L::LDP, sm.v, L::LDT);
  }
  __syncthreads();

  float* ob = o + ((size_t)b * Sq * H + h) * D;
  for (int e = tid; e < rows * D; e += NT) {
    const int rr = e / D, c = e % D;
    const float l = fmaxf(sm.l[rr], 1e-30f);
    ob[(size_t)(q0 + rr) * H * D + c] = sm.o[rr * L::LDO + c] / l;
  }
  for (int rr = tid; rr < rows; rr += NT)
    lse[((size_t)b * H + h) * Sq + q0 + rr] =
        sm.m[rr] + logf(fmaxf(sm.l[rr], 1e-30f));
}

// ---------------------------------------------------------------------------
// forward, bf16: wgmma and TMA, warp-specialised (FlashAttention-3's layout)
// ---------------------------------------------------------------------------
//
// A block owns BQ = 64 NWG q rows of one (head, batch): NWG consumer
// warpgroups of 64 rows each, and a producer (one warp issues every load;
// with NWG = 2 it is a whole warpgroup that gives its registers to the
// consumers by setmaxnreg).  The producer loads the block's Q, then each kv
// tile's K and V by TMA into a ring of ST stages (K and V on barriers of
// their own, so S = Q K^T starts while V lands); Q, K0 and V0 are in
// flight together.  A consumer warpgroup, per kv tile:
//   S = Q K^T by wgmma from shared memory (f32 accumulators);
//   scale by scale log2(e) and mask in one pass, online softmax in base 2
//   (m, l in f32), O rescaled in registers;
//   P split into bf16 high and low parts, each the A operand of
//   O += P V straight from registers (wgmma, V MN-major through the
//   descriptor's transpose bit), so the products' sum carries P to ~2^-16;
//   one arrival per warp frees the stage.
// The products of one tile overlap the softmax of the next: S of tile t
// is issued before P V of tile t - 1, and tile t's softmax runs while P V
// is in flight (FlashAttention-3's intra-warpgroup pipelining); K and V
// stages are freed apart (K once S has landed, V once P V has), so the
// producer stays a tile ahead.  P V for d = 128 is one
// m64n128k16 product over both 64-column boxes of V (the descriptor's
// leading byte offset steps between them).
// The tensor maps are over (B, S, heads, d): a box is 64 columns of one
// head, 128-byte swizzled as wgmma reads it, and rows past S arrive as
// zeros.  The q tile is the grid's slowest index, taken in reverse, so the
// causal blocks that see the most kv tiles start first.  Host choice
// (kernels/flash_attention.py fwd_config): NWG = 2, BK = 128 where the
// grid has many blocks (long sequences); NWG = 1, BK = 64 where it has
// few (the fastmoe-gpt shapes), so that several blocks share an SM.

template <int D, int NWG> struct FwdCfg {
  static constexpr int BQ = 64 * NWG;              // q rows a block
  static constexpr int BK = NWG == 2 ? 128 : 64;   // kv rows a stage
  // K / V ring stages: 3-4, as many as fit, but 2 for one warpgroup at
  // d 128 (two blocks an SM)
  static constexpr int ST = D == 64 ? (NWG == 2 ? 4 : 3) : (NWG == 2 ? 3 : 2);
  static constexpr int DC = D / 64;                // 64-column boxes a row
  static constexpr int NT = 128 * NWG + (NWG == 2 ? 128 : 32);
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : (D == 64 ? 3 : 2);
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // 1024 to align the base (swizzle atoms), Q, the K and V stages, barriers
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 8 * (1 + 4 * ST);
};

template <int BK>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BK == 128) wgmma_ss_n128(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

template <int D, int NWG>
__global__ void __launch_bounds__(FwdCfg<D, NWG>::NT, FwdCfg<D, NWG>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ o, float* __restrict__ lse, int Sq,
                       int Skv, int H, int KV, int window, int q_offset,
                       int causal, float scale_log2) {
  using C = FwdCfg<D, NWG>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, DC = C::DC;
  constexpr int NS = BK / 2;  // S accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);  // DC boxes of BQ x 64
  bf16* ks = qs + BQ * D;                    // ST stages of DC boxes of BK x 64
  bf16* vs = ks + ST * BK * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * BK * D);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;  // K and V stages free up apart: K after
  uint64_t* v_empty = k_empty + ST;  // S lands, V after P V lands

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const long long i_lo = (long long)q_offset + q0, i_hi = i_lo + rows - 1;
  int t0, t1;
  kv_tiles(i_lo, i_hi, Skv, window, causal, BK, &t0, &t1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * NWG);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // ---- producer
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load_4d(qs + c * BQ * 64, &qmap, q_full, c * 64, h, q0, b);
      for (int t = t0; t <= t1; ++t) {
        const int i = t - t0, s = i % ST;
        if (i >= ST) mbar_wait(&k_empty[s], ((i / ST) - 1) & 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load_4d(ks + (s * DC + c) * BK * 64, &kmap, &k_full[s], c * 64,
                      kvh, t * BK, b);
        if (i >= ST) mbar_wait(&v_empty[s], ((i / ST) - 1) & 1);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load_4d(vs + (s * DC + c) * BK * 64, &vmap, &v_full[s], c * 64,
                      kvh, t * BK, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const long long w_lo = i_lo + wg * 64, w_hi = w_lo + 63;
  const long long i_r[2] = {w_lo + wq * 16 + g, w_lo + wq * 16 + g + 8};

  float oacc[D / 2];  // O: 64 rows x D in the accumulator layout
#pragma unroll
  for (int e = 0; e < D / 2; ++e) oacc[e] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // l: this thread's part

  // S = Q K^T of the tile in stage s, over d 16 columns a step (32 bytes
  // into the swizzled rows), issued and committed as one group
  float sacc[NS];
  auto issue_s = [&](int s) {
    const bf16* kt = ks + s * DC * BK * 64;
    fence_regs<NS>(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<BK>(sacc,
                   wgmma_desc(qs + c * BQ * 64 + wg * 64 * 64 + off, 16, 1024),
                   wgmma_desc(kt + c * BK * 64 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    fence_regs<NS>(sacc);
  };
  // scale (base 2), mask and online softmax of kv tile t in place: sacc
  // becomes P = exp2(s - m), m and l move on, corr rescales the older O
  float corr[2];
  auto softmax = [&](int t) {
    const int j0 = t * BK;
    const bool mask = needs_mask(w_lo, w_hi, j0, BK, Skv, window, causal);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = sacc[4 * n + e] * scale_log2;
        if (mask && !visible(i_r[e / 2], j0 + n * 8 + 2 * t4 + (e & 1), Skv,
                             window, causal))
          sv = -INFINITY;
        sacc[4 * n + e] = sv;
        mx[e / 2] = fmaxf(mx[e / 2], sv);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFullMask, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFullMask, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      corr[rr] = exp2f(m_r[rr] - m_new);
      m_r[rr] = m_new;
      l_r[rr] *= corr[rr];
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int rr = (e / 2) & 1;
      sacc[e] = exp2f(sacc[e] - m_r[rr]);  // masked: exp2(-inf) = 0
      l_r[rr] += sacc[e];
    }
  };
  // P split into bf16 high and low A fragments, 16 kv columns a k step
  // (the accumulators of two 8-wide column blocks): u = (row g | g + 8) x
  // (columns 0-7 | 8-15)
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e0 = 8 * kk + 4 * (u / 2) + 2 * (u % 2);
        hi[kk][u] = pack_bf16(sacc[e0], sacc[e0 + 1]);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][u]);
        lo[kk][u] = pack_bf16(sacc[e0] - __low2float(hv),
                              sacc[e0 + 1] - __high2float(hv));
      }
  };
  // O += P V for the tile in stage s: V (kv rows x 64 columns a box) is the
  // MN-major B operand; a k step is 16 kv rows, two 8-row atoms
  auto issue_pv = [&](int s) {
    const bf16* vt = vs + s * DC * BK * 64;
    fence_regs<D / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (D == 128) {  // one product over both boxes, lbo apart
        const uint64_t dv = wgmma_desc(vt + kk * 16 * 64, BK * 128, 1024);
        wgmma_rs_n128_tb(oacc, hi[kk], dv);
        wgmma_rs_n128_tb(oacc, lo[kk], dv);
      } else {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const uint64_t dv = wgmma_desc(vt + c * BK * 64 + kk * 16 * 64, BK * 128, 1024);
          wgmma_rs_n64_tb(oacc + 32 * c, hi[kk], dv);
          wgmma_rs_n64_tb(oacc + 32 * c, lo[kk], dv);
        }
      }
    }
    wgmma_commit();
    fence_regs<D / 2>(oacc);
  };

  auto settle_pv = [&]() {  // P V has landed: its registers are free again
    fence_regs<D / 2>(oacc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      fence_regs<4>(hi[kk]);
      fence_regs<4>(lo[kk]);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oacc[e] *= corr[(e / 2) & 1];
  };

  auto release = [&](uint64_t* empty, int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  mbar_wait(q_full, 0);
  // The tensor cores stay busy through the softmax: step t issues S of
  // tile t, then P V of tile t - 1, and runs tile t's softmax while P V is
  // in flight; O is rescaled once P V has landed.
  if (t0 <= t1) {
    mbar_wait(&k_full[0], 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs<NS>(sacc);
    release(k_empty, 0);
    softmax(t0);
    split_p();
  }
  for (int t = t0 + 1; t <= t1; ++t) {
    const int i = t - t0, ip = i - 1, sp = ip % ST;  // tile t - 1's step, stage
    mbar_wait(&k_full[i % ST], (i / ST) & 1);
    mbar_wait(&v_full[sp], (ip / ST) & 1);
    issue_s(i % ST);
    issue_pv(sp);
    wgmma_wait<1>();  // S of tile t has landed; P V of tile t - 1 still runs
    fence_regs<NS>(sacc);
    release(k_empty, i % ST);
    softmax(t);
    wgmma_wait<0>();
    settle_pv();
    release(v_empty, sp);
    rescale_o();
    split_p();
  }
  if (t0 <= t1) {  // P V of the last tile
    const int ip = t1 - t0, sp = ip % ST;
    mbar_wait(&v_full[sp], (ip / ST) & 1);
    issue_pv(sp);
    wgmma_wait<0>();
    settle_pv();
  }

  const float ln2 = 0.6931471805599453f;
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] += __shfl_xor_sync(kFullMask, l_r[rr], 1);
    l_r[rr] += __shfl_xor_sync(kFullMask, l_r[rr], 2);
    const float l = fmaxf(l_r[rr], 1e-30f);
    inv[rr] = 1.f / l;
    const int row = wg * 64 + wq * 16 + g + rr * 8;
    if (t4 == 0 && row < rows)  // natural log, as the backward reads it
      lse[((size_t)b * H + h) * Sq + q0 + row] = m_r[rr] * ln2 + logf(l);
  }
  bf16* ob = o + ((size_t)b * Sq * H + h) * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = wg * 64 + wq * 16 + g + rr * 8;
    if (row >= rows) continue;
    bf16* orow = ob + (size_t)(q0 + row) * H * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + c * 64 + n * 8 + 2 * t4) =
            pack_bf16(oacc[32 * c + 4 * n + 2 * rr] * inv[rr],
                      oacc[32 * c + 4 * n + 2 * rr + 1] * inv[rr]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// ROWS rows of head h from row s0 into a (ROWS, LD) bf16 tile by cp.async,
// 16 bytes a copy, committed as one group; rows past S are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int S,
                                        int Hn, int h, int s0) {
  constexpr int CH = D / 8;
  const bf16* base = src + ((size_t)s0 * Hn + h) * D;
#pragma unroll
  for (int u = 0; u < ROWS * CH / NT; ++u) {
    const int i = threadIdx.x + u * NT, r = i / CH, c = (i % CH) * 8;
    const bool ok = s0 + r < S;
    cp_async16(dst + r * LD + c, ok ? base + (size_t)r * Hn * D + c : src, ok);
  }
  cp_async_commit();
}


// delta[b, h, i] = sum_c dO[b, i, h, c] O[b, i, h, c] in f32: D / V lanes a
// row, one 16-byte load of each tensor a lane, a shuffle sum over the lanes.
template <typename T, int D> struct Prep {
  static constexpr int V = 16 / sizeof(T), L = D / V, ROWS = NT / L;  // a block
  static_assert(L <= 32 && 32 % L == 0, "a row's lanes within one warp");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int Sq, int H) {
  using P = Prep<T, D>;
  const int part = threadIdx.x % P::L;
  const long long row = (long long)blockIdx.x * P::ROWS + threadIdx.x / P::L;
  const bool ok = row < (long long)B * Sq * H;
  float s = 0.f;
  if (ok) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * P::V);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + row * D + part * P::V);
    const T* pa = reinterpret_cast<const T*>(&a);
    const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < P::V; ++e) s += to_f32(pa[e]) * to_f32(pb[e]);
  }
#pragma unroll
  for (int w = P::L / 2; w; w >>= 1) s += __shfl_xor_sync(kFullMask, s, w);
  if (ok && part == 0) {  // row = (b * Sq + i) * H + h
    const long long h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = s;
  }
}

template <typename T, int D>
void launch_prep(const T* o, const T* dout, float* delta, const Args& a,
                 cudaStream_t st) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long blocks = (rows + Prep<T, D>::ROWS - 1) / Prep<T, D>::ROWS;
  flash_bwd_prep_kernel<T, D><<<(unsigned)blocks, NT, 0, st>>>(o, dout, delta, a.B,
                                                              a.Sq, a.H);
}

// ---- f32: dK, dV per kv tile and dQ per q tile, every product staged
// through shared memory on the FMA units

// lse and delta of rows [q0, q0 + BQ) into shared memory; rows past Sq get
// lse = +inf, so that their recomputed P is exp(-inf) = 0.
__device__ __forceinline__ void load_stats(float* ls, float* ds,
                                           const float* lse, const float* delta,
                                           int q0, int Sq) {
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const bool ok = q0 + r < Sq;
    ls[r] = ok ? lse[q0 + r] : INFINITY;
    ds[r] = ok ? delta[q0 + r] : 0.f;
  }
}

// P = exp(s scale - lse) and dS = P (dP - delta) of a (BQ, BK) tile into
// p (when given) and ds.  s, dp are the raw products.
template <int BK, int LDS, int LDP>
__device__ __forceinline__ void grad_tile(const float* s, const float* dp,
                                          const float* ls, const float* dl,
                                          float* p, float* ds, long long i_lo,
                                          long long i_hi, int j0, int Skv,
                                          int window, int causal, float scale) {
  const bool mask = needs_mask(i_lo, i_hi, j0, BK, Skv, window, causal);
  for (int e = threadIdx.x; e < BQ * BK; e += blockDim.x) {
    const int r = e / BK, c = e % BK;
    float pv = expf(s[r * LDS + c] * scale - ls[r]);
    if (mask && !visible(i_lo + r, j0 + c, Skv, window, causal)) pv = 0.f;
    if (p) p[r * LDP + c] = pv;
    ds[r * LDP + c] = pv * (dp[r * LDS + c] - dl[r]);
  }
}

template <int D> struct DkdvSmem {
  static constexpr int BK = BK32, LDT = D + PAD32;
  static constexpr int LDS = BK + 4, LDP = BK + PAD32, LDA = D + 4;
  float *k, *v, *q, *dout, *p, *ds;
  float *s, *dp, *dk, *dv, *lse, *delta;
  __host__ __device__ size_t carve(unsigned char* base) {
    Carve c{base, 0};
    k = c.take<float>(BK * LDT);
    v = c.take<float>(BK * LDT);
    q = c.take<float>(BQ * LDT);
    dout = c.take<float>(BQ * LDT);
    s = c.take<float>(BQ * LDS);
    dp = c.take<float>(BQ * LDS);
    p = c.take<float>(BQ * LDP);
    ds = c.take<float>(BQ * LDP);
    dk = c.take<float>(BK * LDA);
    dv = c.take<float>(BK * LDA);
    lse = c.take<float>(BQ);
    delta = c.take<float>(BQ);
    return c.off;
  }
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Skv, int H, int KV,
                      int window, int q_offset, int causal, float scale) {
  using L = DkdvSmem<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.carve(smem);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int kv_rows = min(BK, Skv - j0);

  load_rows<BK, D, L::LDT>(sm.k, k + (size_t)b * Skv * KV * D, Skv, KV, kvh, j0);
  load_rows<BK, D, L::LDT>(sm.v, v + (size_t)b * Skv * KV * D, Skv, KV, kvh, j0);
  for (int i = tid; i < BK * L::LDA; i += NT) { sm.dk[i] = 0.f; sm.dv[i] = 0.f; }

  // the query rows that see a key of this tile
  const long long i_max = (long long)j0 + kv_rows - 1 + window - 1;
  long long r_lo = causal ? (long long)j0 - q_offset : 0;
  long long r_hi = i_max - q_offset;
  if (r_lo < 0) r_lo = 0;
  if (r_hi > Sq - 1) r_hi = Sq - 1;

  // steps (g, q tile) over the G heads of the group, flattened so that the
  // next step's q and dO tiles load while this one computes
  const int qt0 = (int)(r_lo / BQ);
  const int nq = r_lo <= r_hi ? (int)(r_hi / BQ) - qt0 + 1 : 0;
  const float* qb = q + (size_t)b * Sq * H * D;
  const float* db = dout + (size_t)b * Sq * H * D;
  RowsInFlight<BQ, D> qf, df;
  if (nq) {
    qf.fetch(qb, Sq, H, kvh * G, qt0 * BQ);
    df.fetch(db, Sq, H, kvh * G, qt0 * BQ);
  }
  for (int n = 0; n < G * nq; ++n) {
    const int h = kvh * G + n / nq, q0 = (qt0 + n % nq) * BQ;
    const int rows = min(BQ, Sq - q0);
    const long long i_lo = (long long)q_offset + q0;
    __syncthreads();  // the previous step's products are done
    qf.template store<L::LDT>(sm.q);
    df.template store<L::LDT>(sm.dout);
    load_stats(sm.lse, sm.delta, lse + ((size_t)b * H + h) * Sq,
               delta + ((size_t)b * H + h) * Sq, q0, Sq);
    __syncthreads();
    if (n + 1 < G * nq) {
      const int h1 = kvh * G + (n + 1) / nq, q1 = (qt0 + (n + 1) % nq) * BQ;
      qf.fetch(qb, Sq, H, h1, q1);
      df.fetch(db, Sq, H, h1, q1);
    }
    mm<OP_NT, false, BQ, BK, D>(sm.s, L::LDS, sm.q, L::LDT, sm.k, L::LDT);
    mm<OP_NT, false, BQ, BK, D>(sm.dp, L::LDS, sm.dout, L::LDT, sm.v, L::LDT);
    __syncthreads();
    grad_tile<BK, L::LDS, L::LDP>(sm.s, sm.dp, sm.lse, sm.delta, sm.p,
                                     sm.ds, i_lo, i_lo + rows - 1, j0, Skv,
                                     window, causal, scale);
    __syncthreads();
    mm<OP_TN, true, BK, D, BQ>(sm.dv, L::LDA, sm.p, L::LDP, sm.dout, L::LDT);
    mm<OP_TN, true, BK, D, BQ>(sm.dk, L::LDA, sm.ds, L::LDP, sm.q, L::LDT);
  }
  __syncthreads();

  const size_t base = ((size_t)b * Skv * KV + kvh) * D;
  for (int e = tid; e < kv_rows * D; e += NT) {
    const int rr = e / D, c = e % D;
    const size_t at = base + (size_t)(j0 + rr) * KV * D + c;
    dk[at] = sm.dk[rr * L::LDA + c] * scale;
    dv[at] = sm.dv[rr * L::LDA + c];
  }
}

template <int D> struct DqSmem {
  static constexpr int BK = BK32, LDT = D + PAD32;
  static constexpr int LDS = BK + 4, LDP = BK + PAD32, LDA = D + 4;
  float *q, *dout, *k, *v, *ds;
  float *s, *dp, *dq, *lse, *delta;
  __host__ __device__ size_t carve(unsigned char* base) {
    Carve c{base, 0};
    q = c.take<float>(BQ * LDT);
    dout = c.take<float>(BQ * LDT);
    k = c.take<float>(BK * LDT);
    v = c.take<float>(BK * LDT);
    s = c.take<float>(BQ * LDS);
    dp = c.take<float>(BQ * LDS);
    ds = c.take<float>(BQ * LDP);
    dq = c.take<float>(BQ * LDA);
    lse = c.take<float>(BQ);
    delta = c.take<float>(BQ);
    return c.off;
  }
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Skv, int H, int KV, int window, int q_offset,
                    int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.carve(smem);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const long long i_lo = (long long)q_offset + q0, i_hi = i_lo + rows - 1;
  const float* kb = k + (size_t)b * Skv * KV * D;
  const float* vb = v + (size_t)b * Skv * KV * D;

  load_rows<BQ, D, L::LDT>(sm.q, q + (size_t)b * Sq * H * D, Sq, H, h, q0);
  load_rows<BQ, D, L::LDT>(sm.dout, dout + (size_t)b * Sq * H * D, Sq, H, h, q0);
  load_stats(sm.lse, sm.delta, lse + ((size_t)b * H + h) * Sq,
             delta + ((size_t)b * H + h) * Sq, q0, Sq);
  for (int i = tid; i < BQ * L::LDA; i += NT) sm.dq[i] = 0.f;

  int t0, t1;
  kv_tiles(i_lo, i_hi, Skv, window, causal, BK, &t0, &t1);
  RowsInFlight<BK, D> kf, vf;
  if (t0 <= t1) {
    kf.fetch(kb, Skv, KV, kvh, t0 * BK);
    vf.fetch(vb, Skv, KV, kvh, t0 * BK);
  }
  for (int t = t0; t <= t1; ++t) {
    const int j0 = t * BK;
    __syncthreads();
    kf.template store<L::LDT>(sm.k);
    vf.template store<L::LDT>(sm.v);
    __syncthreads();
    if (t < t1) {
      kf.fetch(kb, Skv, KV, kvh, j0 + BK);
      vf.fetch(vb, Skv, KV, kvh, j0 + BK);
    }
    mm<OP_NT, false, BQ, BK, D>(sm.s, L::LDS, sm.q, L::LDT, sm.k, L::LDT);
    mm<OP_NT, false, BQ, BK, D>(sm.dp, L::LDS, sm.dout, L::LDT, sm.v, L::LDT);
    __syncthreads();
    grad_tile<BK, L::LDS, L::LDP>(sm.s, sm.dp, sm.lse, sm.delta,
                                  static_cast<float*>(nullptr), sm.ds, i_lo,
                                  i_hi, j0, Skv, window, causal, scale);
    __syncthreads();
    mm<OP_NN, true, BQ, D, BK>(sm.dq, L::LDA, sm.ds, L::LDP, sm.k, L::LDT);
  }
  __syncthreads();

  float* out = dq + ((size_t)b * Sq * H + h) * D;
  for (int e = tid; e < rows * D; e += NT) {
    const int rr = e / D, c = e % D;
    out[(size_t)(q0 + rr) * H * D + c] = sm.dq[rr * L::LDA + c] * scale;
  }
}

// ---------------------------------------------------------------------------
// backward, bf16: FlashAttention-2's loop with mma.sync, dQ by atomic adds
// ---------------------------------------------------------------------------
//
// Warp w owns kv rows [16 w, 16 w + 16) of the block's 64-row kv tile: the
// M dimension of S^T, dP^T, dK and dV.  See the note at the top.

// The q tiles [x, x + y) of BQ rows that see a key of the kv tile at j0
// (kv_rows rows): the bf16 backward's loop, and the dQ sum's test of which
// kv tiles wrote a q tile's slots.
__device__ __forceinline__ int2 bwd_q_tiles(int j0, int kv_rows, int Sq, int window,
                                            int q_offset, int causal, int bq) {
  long long r_lo = causal ? (long long)j0 - q_offset : 0;
  long long r_hi = (long long)j0 + kv_rows - 1 + window - 1 - q_offset;
  if (r_lo < 0) r_lo = 0;
  if (r_hi > Sq - 1) r_hi = Sq - 1;
  const int qt0 = (int)(r_lo / bq);
  return make_int2(qt0, r_lo <= r_hi ? (int)(r_hi / bq) - qt0 + 1 : 0);
}

template <int D> struct BwdCfg {
  static constexpr int BK = 64;                  // kv rows per block
  static constexpr int BQ = D == 128 ? 32 : 64;  // q rows per step
  static constexpr int LD = D + 8;               // K, V, Q, dO rows (bf16)
  static constexpr int LDS = BQ + 8;             // dS^T rows, [kv][q] (bf16)
  static constexpr int K_OFF = 0, V_OFF = K_OFF + BK * LD;
  static constexpr int Q_OFF = V_OFF + BK * LD;        // two stages
  static constexpr int DO_OFF = Q_OFF + 2 * BQ * LD;   // two stages
  static constexpr int DS_OFF = DO_OFF + 2 * BQ * LD;
  static constexpr int STATS_OFF = DS_OFF + BK * LDS;  // then f32 lse, delta
  static constexpr size_t SMEM = sizeof(bf16) * STATS_OFF + sizeof(float) * 4 * BQ;
  static_assert(BK == 16 * (NT / 32), "one 16-row kv strip per warp");
  static_assert((sizeof(bf16) * STATS_OFF) % 16 == 0, "stats alignment");
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq_acc,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                     int Skv, int H, int KV, int window, int q_offset,
                     int causal, float scale, int slots) {
  using C = BwdCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDS = C::LDS;
  constexpr int NQ = BQ / 8, ND = D / 8;  // n8 tiles over q, over d
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = smem + C::K_OFF;
  bf16* vs = smem + C::V_OFF;
  bf16* dss = smem + C::DS_OFF;
  float* stats = reinterpret_cast<float*>(smem + C::STATS_OFF);  // lse[2][BQ], delta[2][BQ]
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  // the kv tile is the grid's slowest index: heavy tiles start first
  const int j0 = blockIdx.z * BK, kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int kv_rows = min(BK, Skv - j0);

  cp_rows<BK, D, LD>(ks, k + (size_t)b * Skv * KV * D, Skv, KV, kvh, j0);
  cp_rows<BK, D, LD>(vs, v + (size_t)b * Skv * KV * D, Skv, KV, kvh, j0);

  // the q tiles that see a key of this tile; steps (head of the group, q
  // tile), flattened
  const int2 qts = bwd_q_tiles(j0, kv_rows, Sq, window, q_offset, causal, BQ);
  const int qt0 = qts.x, nq = qts.y;
  const int steps = G * nq;
  // dQ: this kv tile's slot (plain stores), or the one scratch (atomics)
  float* dq_base = dq_acc + (slots ? (size_t)blockIdx.z * gridDim.y * Sq * H * D : 0);
  const bf16* qb = q + (size_t)b * Sq * H * D;
  const bf16* db = dout + (size_t)b * Sq * H * D;

  // step n's Q, dO, lse and delta into ring stage n & 1: three groups
  auto load_step = [&](int n) {
    const int s = n & 1, h = kvh * G + n / nq, q0 = (qt0 + n % nq) * BQ;
    cp_rows<BQ, D, LD>(smem + C::Q_OFF + s * BQ * LD, qb, Sq, H, h, q0);
    cp_rows<BQ, D, LD>(smem + C::DO_OFF + s * BQ * LD, db, Sq, H, h, q0);
    if (tid < 2 * BQ) {  // rows past Sq: 0 (their Q and dO rows are 0 too)
      const int r = tid % BQ;
      const float* src = (tid < BQ ? lse : delta) + ((size_t)b * H + h) * Sq + q0 + r;
      const bool ok = q0 + r < Sq;
      cp_async4(stats + (tid < BQ ? 0 : 2 * BQ) + s * BQ + r, ok ? src : lse, ok);
    }
    cp_async_commit();
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (steps) load_step(0);
  for (int n = 0; n < steps; ++n) {
    const int s = n & 1, h = kvh * G + n / nq, q0 = (qt0 + n % nq) * BQ;
    const int rows = min(BQ, Sq - q0);
    const long long i_lo = (long long)q_offset + q0;
    if (n + 1 < steps) {  // the next step loads while this one computes
      load_step(n + 1);
      cp_async_wait<3>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = smem + C::Q_OFF + s * BQ * LD;
    const bf16* dot = smem + C::DO_OFF + s * BQ * LD;
    const float* lt = stats + s * BQ;
    const float* dlt = stats + 2 * BQ + s * BQ;

    // S^T = K Q^T and dP^T = V dO^T: A from the K, V rows of this warp,
    // B fragments of two 8-wide q tiles per x4 load
    float sacc[NQ][4], pacc[NQ][4];
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[c][e] = pacc[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int a_at = (w * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldsm_x4<false>(ka, ks + a_at);
      ldsm_x4<false>(va, vs + a_at);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        const int b_at = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4<false>(bq, qt + b_at);
        ldsm_x4<false>(bo, dot + b_at);
        mma_bf16(sacc[2 * np], ka, bq);
        mma_bf16(sacc[2 * np + 1], ka, bq + 2);
        mma_bf16(pacc[2 * np], va, bo);
        mma_bf16(pacc[2 * np + 1], va, bo + 2);
      }
    }

    // P^T = exp(S^T scale - lse) (0 outside the band), dS^T = P^T (dP^T - delta)
    const bool mask = needs_mask(i_lo, i_lo + rows - 1, j0, BK, Skv, window, causal);
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c * 8 + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + c * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 8 + 2 * t4 + (e & 1);
        float p = expf(sacc[c][e] * scale - ((e & 1) ? l2.y : l2.x));
        if (mask && !visible(i_lo + col, j0 + w * 16 + g + (e >> 1) * 8, Skv,
                             window, causal))
          p = 0.f;
        sacc[c][e] = p;
        pacc[c][e] = p * (pacc[c][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q: the accumulators of two neighbouring q
    // tiles are the A fragment; B = dO, Q rows [q][d] through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const float* p0 = sacc[2 * kk];
      const float* p1 = sacc[2 * kk + 1];
      const float* s0 = pacc[2 * kk];
      const float* s1 = pacc[2 * kk + 1];
      const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                              pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      const uint32_t sa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                              pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        const int b_at = (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4<true>(bo, dot + b_at);
        ldsm_x4<true>(bq, qt + b_at);
        mma_bf16(dv_acc[2 * np], pa, bo);
        mma_bf16(dv_acc[2 * np + 1], pa, bo + 2);
        mma_bf16(dk_acc[2 * np], sa, bq);
        mma_bf16(dk_acc[2 * np + 1], sa, bq + 2);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // dS^T, bf16, for dQ
        const int row = w * 16 + g + hh * 8;
        *reinterpret_cast<uint32_t*>(dss + row * LDS + kk * 16 + 2 * t4) = sa[hh];
        *reinterpret_cast<uint32_t*>(dss + row * LDS + kk * 16 + 8 + 2 * t4) = sa[2 + hh];
      }
    }
    __syncthreads();  // dS is whole; every warp is done with this stage's Q, dO

    // dQ (BQ x D) += dS K: warp w takes q rows [16 (w % STRIPS), +16) and
    // d columns [DW (w / STRIPS), +DW); A = dS from dS^T by ldmatrix.trans
    constexpr int STRIPS = BQ / 16, DW = D / (NT / 32 / STRIPS), NJ = DW / 8;
    const int strip = w % STRIPS, col0 = (w / STRIPS) * DW;
    float qacc[NJ][4];
#pragma unroll
    for (int c = 0; c < NJ; ++c) qacc[c][0] = qacc[c][1] = qacc[c][2] = qacc[c][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4<true>(a, dss + (kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDS +
                           strip * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4<true>(bk, ks + (kk * 16 + (lane & 15)) * LD + col0 + np * 16 +
                              (lane >> 4) * 8);
        mma_bf16(qacc[2 * np], a, bk);
        mma_bf16(qacc[2 * np + 1], a, bk + 2);
      }
    }
    // 16 bytes a lane: lanes t4 = 2p and 2p + 1 swap halves, so the even
    // lane holds row g, columns 4p..4p+3 and the odd lane row g + 8
    const bool odd = t4 & 1;
    const int row = strip * 16 + g + (odd ? 8 : 0);
    float* dq_row = dq_base + (((size_t)b * Sq + q0 + row) * H + h) * D + col0 + (t4 >> 1) * 4;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const float x0 = __shfl_xor_sync(kFullMask, odd ? qacc[c][0] : qacc[c][2], 1);
      const float x1 = __shfl_xor_sync(kFullMask, odd ? qacc[c][1] : qacc[c][3], 1);
      const float4 add = odd ? make_float4(x0, x1, qacc[c][2], qacc[c][3])
                             : make_float4(qacc[c][0], qacc[c][1], x0, x1);
      if (row < rows) {
        if (slots)
          *reinterpret_cast<float4*>(dq_row + c * 8) = add;
        else
          atomicAdd(reinterpret_cast<float4*>(dq_row + c * 8), add);
      }
    }
  }
  cp_async_wait<0>();

  // dK (scaled) and dV, rounded once, straight from the accumulators
  const size_t base = ((size_t)b * Skv * KV + kvh) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w * 16 + g + hh * 8;
    if (row >= kv_rows) continue;
    const size_t at = base + (size_t)(j0 + row) * KV * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + n * 8) =
          pack_bf16(dk_acc[n][2 * hh] * scale, dk_acc[n][2 * hh + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + n * 8) =
          pack_bf16(dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
    }
  }
}

// dq = bf16(acc * scale), four elements a thread.  With slots (one (B, Sq,
// H, D) slot per kv tile) acc is the sum of the slots the kv tiles that see
// the element's q tile wrote (flash_bwd_mma_kernel's own loop bounds), in
// kv-tile order; the others were never written and are skipped.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_round_kernel(const float4* __restrict__ acc, bf16* __restrict__ dq,
                          long long n4, float scale, int slots, int Sq, int Skv,
                          int H, int window, int q_offset, int causal) {
  using C = BwdCfg<D>;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!slots) {
      a = acc[i];
    } else {
      const int qt = (int)(i * 4 / ((long long)H * D) % Sq) / C::BQ;
      for (int t = 0; t < slots; ++t) {
        const int j0 = t * C::BK;
        const int2 r = bwd_q_tiles(j0, min(C::BK, Skv - j0), Sq, window, q_offset,
                                   causal, C::BQ);
        if (qt >= r.x && qt < r.x + r.y) {
          const float4 v = acc[(long long)t * n4 + i];
          a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
        }
      }
    }
    *reinterpret_cast<uint2*>(dq + 4 * i) =
        make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
  }
}


// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}


template <int D, int NWG>
int fwd_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
              Args a, cudaStream_t st) {
  using C = FwdCfg<D, NWG>;
  CUtensorMap qm, km, vm;
  if (!encode_rows_map(&qm, q, a.B, a.Sq, a.H, D, C::BQ) ||
      !encode_rows_map(&km, k, a.B, a.Skv, a.KV, D, C::BK) ||
      !encode_rows_map(&vm, v, a.B, a.Skv, a.KV, D, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_wgmma_kernel<D, NWG>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.H, a.B, (a.Sq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, C::SMEM, st>>>(qm, km, vm, o, lse, a.Sq, a.Skv, a.H,
                                       a.KV, a.window, a.q_offset, a.causal,
                                       a.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_f32(const float* q, const float* k, const float* v, float* o,
            float* lse, Args a, cudaStream_t st) {
  const size_t smem = FwdSmem<D>().carve(nullptr);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<D><<<grid, NT, smem, st>>>(
      q, k, v, o, lse, a.Sq, a.Skv, a.H, a.KV, a.window, a.q_offset,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_f32(const float* q, const float* k, const float* v, const float* o,
            const float* lse, const float* dout, float* dq, float* dk,
            float* dv, float* delta, Args a, cudaStream_t st) {
  launch_prep<float, D>(o, dout, delta, a, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t s_kv = DkdvSmem<D>().carve(nullptr);
  err = allow_smem(flash_bwd_dkdv_kernel<D>, s_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 g_kv((a.Skv + BK32 - 1) / BK32, a.KV, a.B);
  flash_bwd_dkdv_kernel<D><<<g_kv, NT, s_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, a.Sq, a.Skv, a.H, a.KV, a.window,
      a.q_offset, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t s_q = DqSmem<D>().carve(nullptr);
  err = allow_smem(flash_bwd_dq_kernel<D>, s_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 g_q((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<D><<<g_q, NT, s_q, st>>>(
      q, k, v, dout, lse, delta, dq, a.Sq, a.Skv, a.H, a.KV, a.window,
      a.q_offset, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// dq_acc: slots == 0: (B, Sq, H, D) f32, zero on entry; else (slots, B,
// Sq, H, D) f32, slots = ceil(Skv / 64), any contents.
template <int D>
int bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
             const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
             float* delta, float* dq_acc, int slots, Args a, cudaStream_t st) {
  if (slots && slots != (a.Skv + BwdCfg<D>::BK - 1) / BwdCfg<D>::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_prep<bf16, D>(o, dout, delta, a, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = BwdCfg<D>::SMEM;
  err = allow_smem(flash_bwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.KV, a.B, (a.Skv + BwdCfg<D>::BK - 1) / BwdCfg<D>::BK);
  flash_bwd_mma_kernel<D><<<grid, NT, smem, st>>>(
      q, k, v, dout, lse, delta, dq_acc, dk, dv, a.Sq, a.Skv, a.H, a.KV,
      a.window, a.q_offset, a.causal, a.scale, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n4 = (long long)a.B * a.Sq * a.H * D / 4;
  const long long blocks = (n4 + 255) / 256;
  flash_bwd_dq_round_kernel<D><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                                 st>>>(reinterpret_cast<const float4*>(dq_acc), dq,
                                       n4, a.scale, slots, a.Sq, a.Skv, a.H,
                                       a.window, a.q_offset, a.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q (B, Sq, H, d); k, v (B, Skv, KV, d); o (B, Sq, H, d) in q's dtype; lse
// (B, H, Sq) f32.  d in {64, 128}; H % KV == 0; window >= 1; bq, the bf16
// kernel's q rows a block, 64 or 128 (kernels/flash_attention.py
// fwd_config; ignored for f32).  Returns cudaErrorInvalidValue for a d or
// bq without an instance, or a tensor map the driver refuses.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv,
                                   int H, int KV, int d, int window,
                                   int q_offset, int causal, int dtype, int bq,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{B, Sq, Skv, H, KV, window, q_offset, causal, 1.f / sqrtf((float)d)};
  float* l = static_cast<float*>(lse);
#define FWD_BF16(D, NWG)                                                        \
  return fwd_wgmma<D, NWG>(static_cast<const bf16*>(q), static_cast<const bf16*>(k), \
                           static_cast<const bf16*>(v), static_cast<bf16*>(o), l, a, st)
#define FWD_F32(D)                                                              \
  return fwd_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k), \
                    static_cast<const float*>(v), static_cast<float*>(o), l, a, st)
  if (dtype == DT_BF16) {
    if (d == 64 && bq == 64) FWD_BF16(64, 1);
    if (d == 64 && bq == 128) FWD_BF16(64, 2);
    if (d == 128 && bq == 64) FWD_BF16(128, 1);
    if (d == 128 && bq == 128) FWD_BF16(128, 2);
  } else {
    if (d == 64) FWD_F32(64);
    if (d == 128) FWD_F32(128);
  }
#undef FWD_BF16
#undef FWD_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory the bf16 forward asks for at head dim d and bq
// q rows a block (0 if no instance): the host's fwd_config mirrors it.
extern "C" int flash_attention_fwd_smem(int d, int bq) {
  if (d == 64 && bq == 64) return (int)FwdCfg<64, 1>::SMEM;
  if (d == 64 && bq == 128) return (int)FwdCfg<64, 2>::SMEM;
  if (d == 128 && bq == 64) return (int)FwdCfg<128, 1>::SMEM;
  if (d == 128 && bq == 128) return (int)FwdCfg<128, 2>::SMEM;
  return 0;
}

// The gradients of flash_attention_fwd: dO (B, Sq, H, d) -> dq, dk, dv in
// the inputs' shapes and dtype; delta (B, H, Sq) f32 scratch; for bf16,
// dq_acc f32 scratch (unused for f32): dq_slots = ceil(Skv / 64) slots of
// (B, Sq, H, d), any contents, each kv tile's dQ in its own (summed in
// order: deterministic), or dq_slots = 0 and one (B, Sq, H, d), zero on
// entry, that the kv tiles add into by atomics.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, void* dq_acc, int B,
                                   int Sq, int Skv, int H, int KV, int d,
                                   int window, int q_offset, int causal,
                                   int dtype, int dq_slots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{B, Sq, Skv, H, KV, window, q_offset, causal, 1.f / sqrtf((float)d)};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define BWD_BF16(D)                                                            \
  return bwd_bf16<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k), \
                     static_cast<const bf16*>(v), static_cast<const bf16*>(o), \
                     l, static_cast<const bf16*>(dout), static_cast<bf16*>(dq), \
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), dl,        \
                     static_cast<float*>(dq_acc), dq_slots, a, st)
#define BWD_F32(D)                                                             \
  return bwd_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k), \
                    static_cast<const float*>(v), static_cast<const float*>(o), \
                    l, static_cast<const float*>(dout), static_cast<float*>(dq), \
                    static_cast<float*>(dk), static_cast<float*>(dv), dl, a, st)
  if (dtype == DT_BF16) {
    if (d == 64) BWD_BF16(64);
    if (d == 128) BWD_BF16(128);
  } else {
    if (d == 64) BWD_F32(64);
    if (d == 128) BWD_F32(128);
  }
#undef BWD_BF16
#undef BWD_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

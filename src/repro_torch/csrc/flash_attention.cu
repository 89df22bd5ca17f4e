// Flash attention, forward and backward:
//   o = softmax(q k^T / sqrt(d)) v over the keys with 0 <= i - j < window
//   (causal) or i - j < window (not causal), i = q_offset + row, GQA with
//   the kv head h / (H / KV).
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py:73), and, for the backward, the XLA
// autodiff of the jnp blockwise scan the JAX models differentiate
// (src/repro/models/attention.py:67), which has no Pallas kernel.  As
// there, the (S, S) scores never reach device memory: a block keeps one
// (64, BK) score tile in shared memory with the online-softmax statistics
// (m, l) in f32, and l is floored at 1e-30 before the division.
//
// What differs from the TPU kernel: its grid walked every kv tile in order
// on one core and masked the ones outside the band.  Here a block owns one
// (q tile, head, batch) and walks, in a loop, only the kv tiles its rows
// can see, from floor(max(0, i0 - window + 1) / BK) up to the diagonal when
// causal; tiles outside the band are never loaded, and masks are computed
// only on tiles that cross the diagonal, the window edge or the Skv tail.
// Any Sq and Skv (no multiple of a tile).  The window is a runtime int, so
// one build serves every layer of a stack that mixes windows.
//
// Backward (FlashAttention-2): prep writes delta = rowsum(dO * O); dkdv owns
// one (kv tile, kv head, batch), loops over the G query heads of its group
// and over the q tiles that see its kv tile, recomputes P = exp(s - lse)
// and accumulates dV += P^T dO, dK += dS^T Q with dS = P (dO V^T - delta);
// dq owns one (q tile, head, batch) and accumulates dQ += dS K.  No
// atomics: every output element has one owner and a fixed summation order.
//
// Bound on the H100: operations at long sequences (4 d flops per visible
// (i, j) pair forward, 10 d backward), bytes at short ones.  bf16 products
// run on the tensor cores with f32 accumulation: the forward as
// FlashAttention-2 lays it out (mma.sync m16n8k16, Q, S, P and O in
// registers, K and V tiles double-buffered by cp.async); the backward, a
// simpler first version, with wmma 16x16x16 and every product staged
// through shared memory.  The reference takes P V in f32: the forward
// splits P into bf16 high and low parts (two products, P exact to ~2^-16),
// so its bf16 output is, element for element, nearly always the plain
// version's.  The backward rounds P and dS to bf16 for its second
// products, as FlashAttention does.  f32 runs on the FMA units (not TF32),
// every product staged through shared memory.  No wgmma or TMA yet.
#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int NT = 128;  // four warps
constexpr int BQ = 64;   // q rows per tile
constexpr float kNeg = -1e30f;

template <typename T> struct Tiles {
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // kv rows per tile
  static constexpr int PAD = 16 / sizeof(T);           // row padding, elements
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

// C (M x N f32, ldc) = or += a product of two tiles of T in shared memory:
//   NT: C[m][n] = sum_k A[m][k] B[n][k]   (A M x KD, B N x KD)
//   NN: C[m][n] = sum_k A[m][k] B[k][n]   (A M x KD, B KD x N)
//   TN: C[m][n] = sum_k A[k][m] B[k][n]   (A KD x M, B KD x N)
// bf16 on the tensor cores, one 16x16 output tile per warp at a time; f32
// one output element per thread at a time, k in order.
enum Op { OP_NT, OP_NN, OP_TN };

template <int OP, bool ACC, int M, int N, int KD, typename T>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda,
                                   const T* B, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    static_assert(M % 16 == 0 && N % 16 == 0 && KD % 16 == 0, "wmma tiles");
    using LA = typename std::conditional<OP == OP_TN, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<OP == OP_NT, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x / 32, nw = blockDim.x / 32;
    for (int t = warp; t < (M / 16) * (N / 16); t += nw) {
      const int m0 = (t / (N / 16)) * 16, n0 = (t % (N / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC)
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll 4
      for (int k0 = 0; k0 < KD; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, OP == OP_TN ? A + k0 * lda + m0
                                              : A + m0 * lda + k0, lda);
        wmma::load_matrix_sync(b, OP == OP_NT ? B + n0 * ldb + k0
                                              : B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
      const int m = e / N, n = e % N;
      float s = ACC ? C[m * ldc + n] : 0.f;
      for (int k = 0; k < KD; ++k) {
        const float a = to_f32(OP == OP_TN ? A[k * lda + m] : A[m * lda + k]);
        const float b = to_f32(OP == OP_NT ? B[n * ldb + k] : B[k * ldb + n]);
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
}

// Rows [s0, s0 + ROWS) of head h of a (B, S, Hn, D) tensor (batch already
// applied to src) as a ROWS x D tile, in 16-byte chunks; rows past S read
// as zero.  fetch() issues every load of the tile before any is used, so
// the tile costs one memory latency, and a caller can fetch the next tile
// into registers while it computes on the current one; store() writes the
// registers to shared memory.  Needs 16-byte aligned rows (the wrapper
// checks the pointers).
template <typename T, int ROWS, int D> struct RowsInFlight {
  static constexpr int V = 16 / sizeof(T), CH = D / V, N = ROWS * CH / NT;
  static_assert((ROWS * CH) % NT == 0, "tile does not split over the block");
  uint4 buf[N];
  __device__ __forceinline__ void fetch(const T* src, int S, int Hn, int h,
                                        int s0) {
    const T* base = src + ((size_t)s0 * Hn + h) * D;
    const size_t ld = (size_t)Hn * D;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NT, r = i / CH, c = (i % CH) * V;
      buf[u] = s0 + r < S ? *reinterpret_cast<const uint4*>(base + r * ld + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int LD> __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NT, r = i / CH, c = (i % CH) * V;
      *reinterpret_cast<uint4*>(dst + r * LD + c) = buf[u];
    }
  }
};

template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int S, int Hn,
                                          int h, int s0) {
  RowsInFlight<T, ROWS, D> t;
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
  static constexpr int BK = Tiles<float>::BK, LDT = D + Tiles<float>::PAD;
  static constexpr int LDS = BK + 4, LDP = BK + Tiles<float>::PAD, LDO = D + 4;
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

  load_rows<float, BQ, D, L::LDT>(sm.q, q + (size_t)b * Sq * H * D, Sq, H, h, q0);
  for (int i = tid; i < BQ * L::LDO; i += NT) sm.o[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) { sm.m[i] = kNeg; sm.l[i] = 0.f; }

  int t0, t1;
  kv_tiles(i_lo, i_hi, Skv, window, causal, BK, &t0, &t1);
  // softmax stage: two threads per row, columns half, half + 2, ...
  const int r = tid >> 1, half = tid & 1;
  const long long i = i_lo + r;
  RowsInFlight<float, BK, D> kf, vf;
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
// forward, bf16: mma.sync m16n8k16 with everything but the K, V tiles in
// registers (FlashAttention-2's layout)
// ---------------------------------------------------------------------------
//
// Warp w owns q rows [16 w, 16 w + 16) of the tile; a thread holds rows
// g = lane / 4 and g + 8, columns 2 (lane % 4) + {0, 1} of every 8-wide
// accumulator tile.  Q stays in registers as A fragments, S = Q K^T and
// O in f32 accumulators; the S accumulators of two neighbouring 8-wide
// tiles are, element for element, the A fragment of P for the next
// product, so P never leaves registers.  P is split into bf16 high and low
// parts (two products).  K and V tiles land in shared memory by cp.async,
// double-buffered: the next tile loads while this one computes.

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8.  TRANS delivers each matrix transposed.
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

// ROWS rows of head h from row s0 into a (ROWS, LD) bf16 tile by cp.async,
// 16 bytes a copy; rows past S are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int S,
                                        int Hn, int h, int s0) {
  constexpr int CH = D / 8;
  const bf16* base = src + ((size_t)s0 * Hn + h) * D;
#pragma unroll
  for (int u = 0; u < ROWS * CH / NT; ++u) {
    const int i = threadIdx.x + u * NT, r = i / CH, c = (i % CH) * 8;
    const bool ok = s0 + r < S;
    const bf16* g = ok ? base + (size_t)r * Hn * D + c : src;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(g), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n");
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                     int window, int q_offset, int causal, float scale) {
  constexpr int BK = 64, LD = D + 8, NS = BK / 8, NO = D / 8;
  static_assert(BQ == 16 * (NT / 32), "one 16-row strip of the q tile per warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks[2] = {reinterpret_cast<bf16*>(smem),
                 reinterpret_cast<bf16*>(smem) + BK * LD};
  bf16* vs[2] = {ks[1] + BK * LD, ks[1] + 2 * BK * LD};
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const long long i_lo = (long long)q_offset + q0, i_hi = i_lo + rows - 1;
  const long long i_r[2] = {i_lo + w * 16 + g, i_lo + w * 16 + g + 8};
  const bf16* kb = k + (size_t)b * Skv * KV * D;
  const bf16* vb = v + (size_t)b * Skv * KV * D;

  // Q through shared memory (the second K buffer) into A fragments
  uint32_t qa[D / 16][4];
  cp_rows<BQ, D, LD>(ks[1], q + (size_t)b * Sq * H * D, Sq, H, h, q0);
  asm volatile("cp.async.wait_group 0;\n");
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4<false>(qa[kk], ks[1] + (w * 16 + (lane & 15)) * LD + kk * 16 +
                               (lane >> 4) * 8);
  __syncthreads();

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // l: this thread's part

  int t0, t1;
  kv_tiles(i_lo, i_hi, Skv, window, causal, BK, &t0, &t1);
  if (t0 <= t1) {
    cp_rows<BK, D, LD>(ks[0], kb, Skv, KV, kvh, t0 * BK);
    cp_rows<BK, D, LD>(vs[0], vb, Skv, KV, kvh, t0 * BK);
  }
  for (int t = t0; t <= t1; ++t) {
    const int j0 = t * BK, buf = (t - t0) & 1;
    if (t < t1) {  // the next tile loads while this one computes
      cp_rows<BK, D, LD>(ks[buf ^ 1], kb, Skv, KV, kvh, j0 + BK);
      cp_rows<BK, D, LD>(vs[buf ^ 1], vb, Skv, KV, kvh, j0 + BK);
      asm volatile("cp.async.wait_group 2;\n");
    } else {
      asm volatile("cp.async.wait_group 0;\n");
    }
    __syncthreads();
    const bf16* kt = ks[buf];
    const bf16* vt = vs[buf];

    // S = Q K^T: for 16 kv rows at a time, one x4 load gives the B
    // fragments of two 8-wide tiles
    float sacc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4<false>(bk, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * np], qa[kk], bk);
        mma_bf16(sacc[2 * np + 1], qa[kk], bk + 2);
      }
    }

    // scale, mask, online softmax on the thread's two rows
    const bool mask = needs_mask(i_lo, i_hi, j0, BK, Skv, window, causal);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = sacc[n][e] * scale;
        if (mask && !visible(i_r[e / 2], j0 + n * 8 + 2 * t4 + (e & 1), Skv,
                             window, causal))
          sv = -INFINITY;
        sacc[n][e] = sv;
        mx[e / 2] = fmaxf(mx[e / 2], sv);
      }
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      corr[rr] = expf(m_r[rr] - m_new);
      m_r[rr] = m_new;
      l_r[rr] *= corr[rr];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= corr[0]; oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1]; oacc[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(sacc[n][e] - m_r[e / 2]);  // masked: exp(-inf) = 0
        sacc[n][e] = pv;
        l_r[e / 2] += pv;
      }
    }

    // O += P V, 16 kv rows at a time; P = hi + lo in bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float* p0 = sacc[2 * kk];
      const float* p1 = sacc[2 * kk + 1];
      uint32_t hi[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                        pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      uint32_t lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* pp = u < 2 ? p0 : p1;
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi[u]);
        lo[u] = pack_bf16(pp[2 * (u & 1)] - __low2float(hv),
                          pp[2 * (u & 1) + 1] - __high2float(hv));
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4<true>(bv, vt + (kk * 16 + (lane & 15)) * LD + np * 16 +
                              (lane >> 4) * 8);
        mma_bf16(oacc[2 * np], hi, bv);
        mma_bf16(oacc[2 * np + 1], hi, bv + 2);
        mma_bf16(oacc[2 * np], lo, bv);
        mma_bf16(oacc[2 * np + 1], lo, bv + 2);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 1);
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 2);
    const float l = fmaxf(l_r[rr], 1e-30f);
    inv[rr] = 1.f / l;
    const int row = w * 16 + g + rr * 8;
    if (t4 == 0 && row < rows)
      lse[((size_t)b * H + h) * Sq + q0 + row] = m_r[rr] + logf(l);
  }
  bf16* ob = o + ((size_t)b * Sq * H + h) * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = w * 16 + g + rr * 8;
    if (row >= rows) continue;
    bf16* orow = ob + (size_t)(q0 + row) * H * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          pack_bf16(oacc[n][2 * rr] * inv[rr], oacc[n][2 * rr + 1] * inv[rr]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[b, h, i] = sum_c dO[b, i, h, c] O[b, i, h, c] in f32; one warp a row.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int Sq, int H, int D) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= (long long)B * Sq * H) return;
  const int lane = threadIdx.x % 32;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f32(op[c]) * to_f32(dp[c]);
#pragma unroll
  for (int w = 16; w; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {  // row = (b * Sq + i) * H + h
    const long long h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = s;
  }
}

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

// P = exp(s scale - lse) and dS = P (dP - delta) of a (BQ, BK) tile, both
// rounded to T into p (when given) and ds.  s, dp are the raw products.
template <typename T, int BK, int LDS, int LDP>
__device__ __forceinline__ void grad_tile(const float* s, const float* dp,
                                          const float* ls, const float* dl,
                                          T* p, T* ds, long long i_lo,
                                          long long i_hi, int j0, int Skv,
                                          int window, int causal, float scale) {
  const bool mask = needs_mask(i_lo, i_hi, j0, BK, Skv, window, causal);
  for (int e = threadIdx.x; e < BQ * BK; e += blockDim.x) {
    const int r = e / BK, c = e % BK;
    float pv = expf(s[r * LDS + c] * scale - ls[r]);
    if (mask && !visible(i_lo + r, j0 + c, Skv, window, causal)) pv = 0.f;
    if (p) p[r * LDP + c] = from_f32<T>(pv);
    ds[r * LDP + c] = from_f32<T>(pv * (dp[r * LDS + c] - dl[r]));
  }
}

template <typename T, int D> struct DkdvSmem {
  static constexpr int BK = Tiles<T>::BK, LDT = D + Tiles<T>::PAD;
  static constexpr int LDS = BK + 4, LDP = BK + Tiles<T>::PAD, LDA = D + 4;
  T *k, *v, *q, *dout, *p, *ds;
  float *s, *dp, *dk, *dv, *lse, *delta;
  __host__ __device__ size_t carve(unsigned char* base) {
    Carve c{base, 0};
    k = c.take<T>(BK * LDT);
    v = c.take<T>(BK * LDT);
    q = c.take<T>(BQ * LDT);
    dout = c.take<T>(BQ * LDT);
    s = c.take<float>(BQ * LDS);
    dp = c.take<float>(BQ * LDS);
    p = c.take<T>(BQ * LDP);
    ds = c.take<T>(BQ * LDP);
    dk = c.take<float>(BK * LDA);
    dv = c.take<float>(BK * LDA);
    lse = c.take<float>(BQ);
    delta = c.take<float>(BQ);
    return c.off;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                      int window, int q_offset, int causal, float scale) {
  using L = DkdvSmem<T, D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.carve(smem);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int kv_rows = min(BK, Skv - j0);

  load_rows<T, BK, D, L::LDT>(sm.k, k + (size_t)b * Skv * KV * D, Skv, KV, kvh, j0);
  load_rows<T, BK, D, L::LDT>(sm.v, v + (size_t)b * Skv * KV * D, Skv, KV, kvh, j0);
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
  const T* qb = q + (size_t)b * Sq * H * D;
  const T* db = dout + (size_t)b * Sq * H * D;
  RowsInFlight<T, BQ, D> qf, df;
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
    grad_tile<T, BK, L::LDS, L::LDP>(sm.s, sm.dp, sm.lse, sm.delta, sm.p,
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
    dk[at] = from_f32<T>(sm.dk[rr * L::LDA + c] * scale);
    dv[at] = from_f32<T>(sm.dv[rr * L::LDA + c]);
  }
}

template <typename T, int D> struct DqSmem {
  static constexpr int BK = Tiles<T>::BK, LDT = D + Tiles<T>::PAD;
  static constexpr int LDS = BK + 4, LDP = BK + Tiles<T>::PAD, LDA = D + 4;
  T *q, *dout, *k, *v, *ds;
  float *s, *dp, *dq, *lse, *delta;
  __host__ __device__ size_t carve(unsigned char* base) {
    Carve c{base, 0};
    q = c.take<T>(BQ * LDT);
    dout = c.take<T>(BQ * LDT);
    k = c.take<T>(BK * LDT);
    v = c.take<T>(BK * LDT);
    s = c.take<float>(BQ * LDS);
    dp = c.take<float>(BQ * LDS);
    ds = c.take<T>(BQ * LDP);
    dq = c.take<float>(BQ * LDA);
    lse = c.take<float>(BQ);
    delta = c.take<float>(BQ);
    return c.off;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Skv, int H, int KV, int window, int q_offset,
                    int causal, float scale) {
  using L = DqSmem<T, D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  L sm;
  sm.carve(smem);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const long long i_lo = (long long)q_offset + q0, i_hi = i_lo + rows - 1;
  const T* kb = k + (size_t)b * Skv * KV * D;
  const T* vb = v + (size_t)b * Skv * KV * D;

  load_rows<T, BQ, D, L::LDT>(sm.q, q + (size_t)b * Sq * H * D, Sq, H, h, q0);
  load_rows<T, BQ, D, L::LDT>(sm.dout, dout + (size_t)b * Sq * H * D, Sq, H, h, q0);
  load_stats(sm.lse, sm.delta, lse + ((size_t)b * H + h) * Sq,
             delta + ((size_t)b * H + h) * Sq, q0, Sq);
  for (int i = tid; i < BQ * L::LDA; i += NT) sm.dq[i] = 0.f;

  int t0, t1;
  kv_tiles(i_lo, i_hi, Skv, window, causal, BK, &t0, &t1);
  RowsInFlight<T, BK, D> kf, vf;
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
    grad_tile<T, BK, L::LDS, L::LDP>(sm.s, sm.dp, sm.lse, sm.delta,
                                     static_cast<T*>(nullptr), sm.ds, i_lo,
                                     i_hi, j0, Skv, window, causal, scale);
    __syncthreads();
    mm<OP_NN, true, BQ, D, BK>(sm.dq, L::LDA, sm.ds, L::LDP, sm.k, L::LDT);
  }
  __syncthreads();

  T* out = dq + ((size_t)b * Sq * H + h) * D;
  for (int e = tid; e < rows * D; e += NT) {
    const int rr = e / D, c = e % D;
    out[(size_t)(q0 + rr) * H * D + c] = from_f32<T>(sm.dq[rr * L::LDA + c] * scale);
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

struct Args {
  int B, Sq, Skv, H, KV, window, q_offset, causal;
  float scale;
};

template <typename T, int D>
int fwd(const T* q, const T* k, const T* v, T* o, float* lse, Args a,
        cudaStream_t st) {
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = 4 * 64 * (D + 8) * sizeof(bf16);  // K, V double-buffered
    err = allow_smem(flash_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_mma_kernel<D><<<grid, NT, smem, st>>>(
        q, k, v, o, lse, a.Sq, a.Skv, a.H, a.KV, a.window, a.q_offset,
        a.causal, a.scale);
  } else {
    const size_t smem = FwdSmem<D>().carve(nullptr);
    err = allow_smem(flash_fwd_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<D><<<grid, NT, smem, st>>>(
        q, k, v, o, lse, a.Sq, a.Skv, a.H, a.KV, a.window, a.q_offset,
        a.causal, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const T* q, const T* k, const T* v, const T* o, const float* lse,
        const T* dout, T* dq, T* dk, T* dv, float* delta, Args a,
        cudaStream_t st) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_prep_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                             0, st>>>(o, dout, delta, a.B, a.Sq, a.H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t s_kv = DkdvSmem<T, D>().carve(nullptr);
  err = allow_smem(flash_bwd_dkdv_kernel<T, D>, s_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 g_kv((a.Skv + Tiles<T>::BK - 1) / Tiles<T>::BK, a.KV, a.B);
  flash_bwd_dkdv_kernel<T, D><<<g_kv, NT, s_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, a.Sq, a.Skv, a.H, a.KV, a.window,
      a.q_offset, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t s_q = DqSmem<T, D>().carve(nullptr);
  err = allow_smem(flash_bwd_dq_kernel<T, D>, s_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 g_q((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<g_q, NT, s_q, st>>>(
      q, k, v, dout, lse, delta, dq, a.Sq, a.Skv, a.H, a.KV, a.window,
      a.q_offset, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q (B, Sq, H, d); k, v (B, Skv, KV, d); o (B, Sq, H, d) in q's dtype; lse
// (B, H, Sq) f32.  d in {64, 128}; H % KV == 0; window >= 1.  Returns
// cudaErrorInvalidValue for a d without an instance.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv,
                                   int H, int KV, int d, int window,
                                   int q_offset, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{B, Sq, Skv, H, KV, window, q_offset, causal, 1.f / sqrtf((float)d)};
  float* l = static_cast<float*>(lse);
#define FWD(T, D)                                                              \
  return fwd<T, D>(static_cast<const T*>(q), static_cast<const T*>(k),         \
                   static_cast<const T*>(v), static_cast<T*>(o), l, a, st)
  if (dtype == DT_BF16) {
    if (d == 64) FWD(bf16, 64);
    if (d == 128) FWD(bf16, 128);
  } else {
    if (d == 64) FWD(float, 64);
    if (d == 128) FWD(float, 128);
  }
#undef FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradients of flash_attention_fwd: dO (B, Sq, H, d) -> dq, dk, dv in
// the inputs' shapes and dtype; delta (B, H, Sq) f32 scratch.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq,
                                   int Skv, int H, int KV, int d, int window,
                                   int q_offset, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{B, Sq, Skv, H, KV, window, q_offset, causal, 1.f / sqrtf((float)d)};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define BWD(T, D)                                                              \
  return bwd<T, D>(static_cast<const T*>(q), static_cast<const T*>(k),         \
                   static_cast<const T*>(v), static_cast<const T*>(o), l,      \
                   static_cast<const T*>(dout), static_cast<T*>(dq),           \
                   static_cast<T*>(dk), static_cast<T*>(dv), dl, a, st)
  if (dtype == DT_BF16) {
    if (d == 64) BWD(bf16, 64);
    if (d == 128) BWD(bf16, 128);
  } else {
    if (d == 64) BWD(float, 64);
    if (d == 128) BWD(float, 128);
  }
#undef BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Token shuffle kernels — the paper's §4 scatter and gather (Fig 4).
//
// Replaces the Pallas kernels of src/repro/kernels/token_shuffle.py:
//   gather_rows  (:29)  y[i] = x[idx[i]]                        (the scatter)
//   combine_topk (:56)  y[t] = sum_k w[t,k] * src[idx[t,k]]     (the gather)
//
// Bound on the H100: bytes.  Both move rows and do no tensor-core work
// (combine does k multiply-adds per element), so the least time is each
// input row read once and each output row written once, over 3.35 TB/s.
//
// Every kernel here gives a warp one work item: a row's chunks base + lane
// + 32 r (16 bytes each where the rows allow it) for r < PL, every load of
// the item issued before its first store or multiply-add, WARPS items a
// block.  A wide row splits into several items rather than a warp walking
// it, and where the items would fill fewer blocks than the card has SMs (a
// decode step's rows) a lane takes one chunk (PL 1), so four times the
// warps share the rows.
//
// gather_rows, two kernels:
// * source-major (gather_rows_by_source): given the inverse table
//   slot_rows (T, k) of a gather that takes every source row k times (the
//   ragged plan's), y[slot_rows[t, j]] = x[t].  The ragged dispatch sends
//   a token's k copies to k expert groups far apart in y, so a kernel that
//   walks destination rows reads each token k times, from HBM once the
//   tokens outgrow the 50 MB L2 (deepseek-v2's prefill: 84 MB of tokens
//   read six times).  Walking source rows reads each token once into
//   registers and stores it k times, the bytes of the bound.  Needs
//   16-byte rows and k <= 32 (lane j holds slot j's row, shared by
//   shuffles); the host sends other shapes to the per-destination kernel.
//   A design on the bulk copy engine (cp.async.bulk rows through a ring of
//   shared-memory buffers, one thread a block issuing) measured no faster
//   at deepseek-v2's rows and slower at fastmoe-gpt's, and is not kept.
// * per destination (gather_rows): any idx, any row width.
//
// combine_topk: each lane reads one slot's index and weight (weights f32 or
// bf16 as stored, widened in registers, which is exact; or none, for
// weights of 1) and the warp shares them by shuffles.  An item issues the
// loads of KB slots x PL chunks a lane before any multiply-add, adds them
// in slot order with f32 fused multiply-adds and rounds once: the sum of
// the first version, term for term.
//
// An index outside the source's rows reads as a zero row (gather_rows) or
// adds nothing (the combine); a slot_rows entry outside y is not stored.
#include <type_traits>

#include "common.cuh"

constexpr int WARPS = 8;     // warps (work items) a 256-thread block
constexpr int INFLIGHT = 4;  // loads a lane issues before its stores
constexpr unsigned FULL = 0xffffffffu;

// A warp's work item: row `row`, chunks base + lane + 32 r for r <
// per_lane, each row splitting into `rounds` items.
struct Item {
  int row, base;
};

__device__ __forceinline__ Item warp_item(int rounds, int per_lane) {
  const long long it = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  return {(int)(it / rounds), (int)(it % rounds) * 32 * per_lane};
}

template <typename U, int PL>
__global__ void __launch_bounds__(WARPS * 32)
gather_rows_kernel(const U* __restrict__ x, const int* __restrict__ idx,
                   U* __restrict__ y, int T, int M, int units, int rounds) {
  const int lane = threadIdx.x & 31;
  const Item w = warp_item(rounds, PL);
  if (w.row >= T) return;
  const int src = idx[w.row];
  const bool valid = src >= 0 && src < M;
  const U* s = x + (size_t)(valid ? src : 0) * units;
  U* dst = y + (size_t)w.row * units;
  U buf[PL];
#pragma unroll
  for (int r = 0; r < PL; ++r) {
    const int c = w.base + 32 * r + lane;
    buf[r] = (valid && c < units) ? s[c] : U{};
  }
#pragma unroll
  for (int r = 0; r < PL; ++r) {
    const int c = w.base + 32 * r + lane;
    if (c < units) dst[c] = buf[r];
  }
}

// y[slot_rows[t, j]] = x[t], a warp per (source row t, round) item of PL
// chunks a lane (k <= 32: lane j holds slot j's row and the warp shares it
// by shuffles).
template <int PL>
__global__ void __launch_bounds__(WARPS * 32)
gather_rows_by_source_kernel(const uint4* __restrict__ x,
                             const int* __restrict__ slot_rows,
                             uint4* __restrict__ y, int T, int k, int n_rows,
                             int units, int rounds) {
  const int lane = threadIdx.x & 31;
  const Item w = warp_item(rounds, PL);
  if (w.row >= T) return;  // the whole warp: the item is the warp's
  const int mine = lane < k ? slot_rows[(size_t)w.row * k + lane] : -1;
  const uint4* s = x + (size_t)w.row * units;
  uint4 buf[PL];
#pragma unroll
  for (int r = 0; r < PL; ++r) {
    const int c = w.base + 32 * r + lane;
    if (c < units) buf[r] = s[c];
  }
  for (int j = 0; j < k; ++j) {
    const int row = __shfl_sync(FULL, mine, j);
    if (row < 0 || row >= n_rows) continue;
    uint4* dst = y + (size_t)row * units;
#pragma unroll
    for (int r = 0; r < PL; ++r) {
      const int c = w.base + 32 * r + lane;
      if (c < units) dst[c] = buf[r];
    }
  }
}

template <typename T, int V>
using Raw = std::conditional_t<V == 1, T, uint4>;

// Weight i as f32: stored f32 (code DT_F32), bf16 (DT_BF16), or none (1).
template <int WT>
__device__ __forceinline__ float weight_at(const void* w, size_t i) {
  if constexpr (WT == DT_F32) return static_cast<const float*>(w)[i];
  else if constexpr (WT == DT_BF16)
    return __bfloat162float(static_cast<const bf16*>(w)[i]);
  else return 1.f;
}

// A warp per (output row, round) item: chunks of V elements, R a lane.
template <typename T, int WT, int V, int KB, int R>
__global__ void __launch_bounds__(WARPS * 32)
combine_topk_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                    const void* __restrict__ w, T* __restrict__ y, int Tn,
                    int k, int M, int d, int rounds) {
  using RT = Raw<T, V>;
  const int lane = threadIdx.x & 31;
  const Item it = warp_item(rounds, R);
  if (it.row >= Tn) return;  // the whole warp
  const int chunks = d / V;
  const size_t slot0 = (size_t)it.row * k;
  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  for (int s0 = 0; s0 < k; s0 += 32) {
    const bool has = s0 + lane < k;
    const int mine = has ? idx[slot0 + s0 + lane] : -1;
    const float mw = has ? weight_at<WT>(w, slot0 + s0 + lane) : 0.f;
    const int ns = min(32, k - s0);
    for (int s1 = 0; s1 < ns; s1 += KB) {
      int row[KB];
      float ws[KB];
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        row[q] = __shfl_sync(FULL, mine, (s1 + q) & 31);
        ws[q] = __shfl_sync(FULL, mw, (s1 + q) & 31);
        if (s1 + q >= ns || row[q] < 0 || row[q] >= M) row[q] = -1;
      }
      RT buf[KB][R];
#pragma unroll
      for (int q = 0; q < KB; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int c = it.base + 32 * r + lane;
          if (row[q] >= 0 && c < chunks)
            buf[q][r] = *reinterpret_cast<const RT*>(
                src + (size_t)row[q] * d + (size_t)c * V);
        }
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        if (row[q] < 0) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T* e = reinterpret_cast<const T*>(&buf[q][r]);
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[r][v] = fmaf(ws[q], to_f32(e[v]), acc[r][v]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = it.base + 32 * r + lane;
    if (c >= chunks) continue;
    RT out;
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = from_f32<T>(acc[r][v]);
    *reinterpret_cast<RT*>(y + (size_t)it.row * d + (size_t)c * V) = out;
  }
}

REPRO_EXPORT_ERROR_STRING

// Blocks for `rows` rows of `units` chunks, per_lane chunks a lane an item;
// sets `rounds`, the items a row.
static unsigned item_blocks(int rows, int units, int per_lane, int& rounds) {
  rounds = (units + 32 * per_lane - 1) / (32 * per_lane);
  return (unsigned)(((long long)rows * rounds + WARPS - 1) / WARPS);
}

// Whether items of per_lane chunks a lane would give fewer blocks than the
// card has SMs (a decode step's rows): then a lane takes one chunk, so
// four times the warps share the rows and their loads.
static bool few_items(int rows, int units, int per_lane, int sms) {
  int rounds;
  return item_blocks(rows, units, per_lane, rounds) < (unsigned)sms;
}

template <typename U>
static void launch_gather(const void* x, const int* idx, void* y, int T,
                          int M, int units, int sms, cudaStream_t st) {
  int rounds;
  const U* xs = static_cast<const U*>(x);
  U* ys = static_cast<U*>(y);
  if (few_items(T, units, INFLIGHT, sms))
    gather_rows_kernel<U, 1><<<item_blocks(T, units, 1, rounds), WARPS * 32,
                               0, st>>>(xs, idx, ys, T, M, units, rounds);
  else
    gather_rows_kernel<U, INFLIGHT>
        <<<item_blocks(T, units, INFLIGHT, rounds), WARPS * 32, 0, st>>>(
            xs, idx, ys, T, M, units, rounds);
}

// x (M, row_bytes) any dtype; idx (T,) int32; y (T, row_bytes).
extern "C" int gather_rows(const void* x, const void* idx, void* y, int T,
                           int M, int row_bytes, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (row_bytes % 16 == 0 && aligned16(x) && aligned16(y))
    launch_gather<uint4>(x, ix, y, T, M, row_bytes / 16, sms, st);
  else if (row_bytes % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 4 == 0) &&
           (reinterpret_cast<uintptr_t>(y) % 4 == 0))
    launch_gather<uint32_t>(x, ix, y, T, M, row_bytes / 4, sms, st);
  else
    launch_gather<uint8_t>(x, ix, y, T, M, row_bytes, sms, st);
  return static_cast<int>(cudaGetLastError());
}

// x (T, row_bytes) any dtype; slot_rows (T, k) int32; y (T * k, row_bytes).
// Needs 16-byte rows and k <= 32 (the host's shape check).
extern "C" int gather_rows_by_source(const void* x, const void* slot_rows,
                                     void* y, int T, int k, int row_bytes,
                                     int sms, void* stream) {
  if (row_bytes % 16 || !aligned16(x) || !aligned16(y) || k < 1 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sr = static_cast<const int*>(slot_rows);
  const uint4* xs = static_cast<const uint4*>(x);
  uint4* ys = static_cast<uint4*>(y);
  const int units = row_bytes / 16;
  int rounds;
  if (few_items(T, units, INFLIGHT, sms))
    gather_rows_by_source_kernel<1>
        <<<item_blocks(T, units, 1, rounds), WARPS * 32, 0, st>>>(
            xs, sr, ys, T, k, T * k, units, rounds);
  else
    gather_rows_by_source_kernel<INFLIGHT>
        <<<item_blocks(T, units, INFLIGHT, rounds), WARPS * 32, 0, st>>>(
            xs, sr, ys, T, k, T * k, units, rounds);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int WT, int V, int KB, int R>
static void launch_combine_r(const T* src, const int* idx, const void* w,
                             T* y, int T_, int k, int M, int d, int sms,
                             cudaStream_t st) {
  int rounds;
  if (few_items(T_, d / V, R, sms))
    combine_topk_kernel<T, WT, V, KB, 1>
        <<<item_blocks(T_, d / V, 1, rounds), WARPS * 32, 0, st>>>(
            src, idx, w, y, T_, k, M, d, rounds);
  else
    combine_topk_kernel<T, WT, V, KB, R>
        <<<item_blocks(T_, d / V, R, rounds), WARPS * 32, 0, st>>>(
            src, idx, w, y, T_, k, M, d, rounds);
}

// KB slots' loads in flight together (k's own count up to 8), R chunks a
// lane each: 4-16 loads a lane.
template <typename T, int WT, int V>
static void launch_combine_kb(const T* src, const int* idx, const void* w,
                              T* y, int T_, int k, int M, int d, int sms,
                              cudaStream_t st) {
  if (k <= 1)
    launch_combine_r<T, WT, V, 1, 4>(src, idx, w, y, T_, k, M, d, sms, st);
  else if (k <= 2)
    launch_combine_r<T, WT, V, 2, 4>(src, idx, w, y, T_, k, M, d, sms, st);
  else if (k <= 4)
    launch_combine_r<T, WT, V, 4, 4>(src, idx, w, y, T_, k, M, d, sms, st);
  else if (k <= 6)
    launch_combine_r<T, WT, V, 6, 2>(src, idx, w, y, T_, k, M, d, sms, st);
  else
    launch_combine_r<T, WT, V, 8, 2>(src, idx, w, y, T_, k, M, d, sms, st);
}

template <typename T, int WT>
static void launch_combine(const T* src, const int* idx, const void* w, T* y,
                           int T_, int k, int M, int d, int sms,
                           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (d % V == 0 && aligned16(src) && aligned16(y))
    launch_combine_kb<T, WT, V>(src, idx, w, y, T_, k, M, d, sms, st);
  else
    launch_combine_kb<T, WT, 1>(src, idx, w, y, T_, k, M, d, sms, st);
}

template <typename T>
static void combine_by_weights(const T* src, const int* idx, const void* w,
                               int wcode, T* y, int T_, int k, int M, int d,
                               int sms, cudaStream_t st) {
  if (wcode == DT_F32)
    launch_combine<T, DT_F32>(src, idx, w, y, T_, k, M, d, sms, st);
  else if (wcode == DT_BF16)
    launch_combine<T, DT_BF16>(src, idx, w, y, T_, k, M, d, sms, st);
  else
    launch_combine<T, -1>(src, idx, w, y, T_, k, M, d, sms, st);
}

// src (M, d); idx (T, k) int32; w (T, k) float32 (wcode 0) or bfloat16
// (wcode 1), or null with wcode -1 for weights of 1; y (T, d) in src's dtype.
extern "C" int combine_topk(const void* src, const void* idx, const void* w,
                            void* y, int T, int k, int M, int d, int dtype,
                            int wcode, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == DT_BF16)
    combine_by_weights(static_cast<const bf16*>(src), ix, w, wcode,
                       static_cast<bf16*>(y), T, k, M, d, sms, st);
  else
    combine_by_weights(static_cast<const float*>(src), ix, w, wcode,
                       static_cast<float*>(y), T, k, M, d, sms, st);
  return static_cast<int>(cudaGetLastError());
}

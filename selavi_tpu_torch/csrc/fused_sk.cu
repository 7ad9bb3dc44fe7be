// Fused log-domain Sinkhorn-Knopp iteration for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel selavi_tpu/ops/sinkhorn_pallas.py:97
// (fused_sk_iteration, body _fused_sk_kernel_with_scalars). Given
// log_alpha_i it computes, in one read of M [N, K]:
//
//   log_beta_{i+1}[n] = -log N - LSE_k(M[n, k] + log_alpha_i[k])      (rows)
//   err              = sum_n |exp(log_beta_i[n] - log_beta_{i+1}[n]) - 1|
//   log_alpha_{i+1}  = log_r - LSE_n(M[n, k] + log_beta_{i+1}[n])     (cols)
//
// Bound: bytes. At N=170752, K=309 one iteration reads M once (211.0 MB
// fp32, 105.5 MB bf16) plus log_beta in and out (1.4 MB): ~63 us fp32 or
// ~32 us bf16 at an H100 SXM's 3.35 TB/s. The arithmetic is two exps an
// element (105 M), which the SFUs (16 a clock an SM) issue in ~25 us at
// 1.98 GHz: under the fp32 bound, close to the bf16 one, so the loop has to
// stay lean for bf16 to reach its bound.
//
// Design against that bound:
// * Persistent blocks, one a SM: block b walks the row tiles b, b + G, ...
//   (a static assignment, so every sum below runs in a fixed order and err,
//   which decides the solver's exit, is bit-identical from run to run; no
//   float atomics anywhere).
// * A ring of tiles in shared memory. A tile of whole rows is contiguous
//   in M, so one producer thread moves it with a single 1D bulk copy
//   (cp.async.bulk onto an mbarrier; no tensor map, whose 16-byte row
//   stride K=309 does not meet). A tile has a multiple of 8 rows, so every
//   full tile is a multiple of 16 bytes in fp32 and bf16 and starts on a
//   16-byte boundary (the wrapper checks M's start); the last tile's bytes
//   past its last 16-byte multiple are copied by ordinary loads.
// * Twelve consumer warps, four rows of a tile each (48-row tiles; two rows
//   and 24-row tiles past 384 columns, so that fp32 keeps 3 stages). A
//   warp reads its rows from shared memory once into registers (lane j
//   holds columns j, j+32, ...; conflict-free), releases the stage at once,
//   and carries the four rows' chains together: the warp-wide max and sum
//   of the four rows take 5 + 3 shuffles each, not 4 x 5 (the first steps
//   hand half of a lane's rows to its partner), and each row's log and
//   error are taken once, in the lane that holds its total.
// * The column LSE tile by tile, as the TPU kernel does it: a max over the
//   warp's rows, one rescale of the running (max, sum) pair (by exactly 1
//   where the max did not move, so no branch), then a sum of exps. The bulk
//   row and column exps and the rescales are ex2.approx of a log2(e)-scaled
//   argument; the error term and every merge keep the accurate expf.
// * One launch an iteration: each block writes its partial column LSEs and
//   error; the last block of each group of kGroup blocks (a ticket) merges
//   the group's partials in block order, and the last group merges the
//   groups in order and writes log_alpha_{i+1} and err. The tickets are
//   the only atomics; the counters are reset by the blocks that finish
//   them, so the caller zeroes them once per solve.
// * The TPU kernel's arithmetic is kept: log_c = -log(n), exp(x) - 1 (not
//   expm1) in the error, the colsum > 0 guard on rescaling and the 1e-38
//   floor before the final log.
//
// Plain C interface, loaded with ctypes by selavi_tpu_torch/ops/sinkhorn_fused.py,
// whose plan() mirrors sk_plan below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 12;                         // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;        // + one producer warp
constexpr int kInFlightCap = 4;     // rows a warp carries through one pass
constexpr int kMaxStages = 8;
// The ring holds about this many bytes (at least 3 stages): deeper rings
// (7 stages of bf16 rows at K=309) ran slower, the first tiles of every
// block queueing behind the rest.
constexpr int kRingBytes = 96 * 1024;
constexpr int kHeaderBytes = 256;   // 2 x kMaxStages mbarriers, the ticket flag
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr int kMaxKpl = 16;         // columns a lane holds: K <= 512
constexpr int kGroup = 16;          // blocks merged by one group ticket
constexpr int kMaxGrid = kGroup * kGroup;
constexpr bool kTicket = true;      // false: a second kernel merges
constexpr bool kFastExp = true;     // ex2.approx for the bulk exps

// Rows of a tile each consumer warp takes: 4, or 2 for rows of more than
// 384 columns, so that a ring of at least 3 tiles fits in fp32 up to K=512.
// A tile is kWarps x that: 48 or 24 rows, multiples of 8.
__host__ __device__ constexpr int rows_per_warp(int kpl) {
  return kpl > 12 ? 2 : 4;
}
__host__ __device__ constexpr int in_flight(int kpl) {
  return rows_per_warp(kpl) < kInFlightCap ? rows_per_warp(kpl) : kInFlightCap;
}
static_assert((kWarps * rows_per_warp(kMaxKpl)) % 8 == 0 &&
                  (kWarps * rows_per_warp(1)) % 8 == 0,
              "a tile must be a multiple of 8 rows: 16 bytes in fp32 and bf16");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// This thread's arrival on bar, and `bytes` more for its phase to await.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// Until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned); they complete bar's phase.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - ref): the bulk exps of the row and column sums.
__device__ __forceinline__ float exp_from(float x, float ref) {
  if (kFastExp) return exp2_approx(fmaf(x, kLog2e, -ref * kLog2e));
  return expf(x - ref);
}

// exp(d): the rescale of a running column pair. d = 0 (the max did not
// move) gives exactly 1, so the sums do not drift.
__device__ __forceinline__ float exp_of(float d) {
  if (kFastExp) return exp2_approx(d * kLog2e);
  return expf(d);
}

// The ticket of a block: an atomic increment that releases the block's
// writes (ordered before it by a barrier) and acquires those of the blocks
// whose tickets came before.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// The reductions over the warp of F rows' values x[F] at once: the first
// log2(F) butterfly steps each hand half of a lane's rows to its partner,
// so F rows take 5 + F - 1 shuffles (not 5 F). On return lane L holds the
// total of row L >> (5 - log2 F). Each pair is combined in one fixed order
// (op commutes), so the result is the same from run to run.
template <int F, class Op>
__device__ __forceinline__ float rows_reduce(const float (&x)[F], int lane,
                                             Op op) {
  float y[F];
#pragma unroll
  for (int i = 0; i < F; ++i) y[i] = x[i];
  int off = 16;
#pragma unroll
  for (int width = F / 2; width >= 1; width /= 2, off /= 2) {
    const bool hi = lane & off;
#pragma unroll
    for (int j = 0; j < width; ++j) {
      const float send = hi ? y[j] : y[j + width];
      const float keep = hi ? y[j + width] : y[j];
      y[j] = op(keep, __shfl_xor_sync(0xffffffffu, send, off));
    }
  }
#pragma unroll
  for (; off > 0; off /= 2) y[0] = op(y[0], __shfl_xor_sync(0xffffffffu, y[0], off));
  return y[0];
}

template <int F>
__device__ __forceinline__ constexpr int log2_of() {
  return F >= 4 ? 2 : F >= 2 ? 1 : 0;
}

// One warp's RPW rows of a stage (rows [0, nrows) valid; all of them
// unless MASKED), F at a time. A group of rows is read into registers
// once; the stage is released as soon as the last group is read.
template <typename T, int KPL, bool MASKED>
__device__ __forceinline__ void warp_rows(
    const T* __restrict__ rows, int k, int nrows, int lane, uint32_t empty,
    const float (&la)[KPL], float (&cmax)[KPL], float (&csum)[KPL],
    float& err, float log_c, const float* __restrict__ log_beta,
    float* __restrict__ beta_out) {
  constexpr int RPW = rows_per_warp(KPL);
  constexpr int F = in_flight(KPL);
  constexpr int kShift = 5 - log2_of<F>();  // lane L reduces row L >> kShift
  const bool last_ok = lane < k - (KPL - 1) * 32;  // lane's last column
  const int my_row = lane >> kShift;
  const bool leader = (lane & ((1 << kShift) - 1)) == 0;
#pragma unroll
  for (int g = 0; g < RPW; g += F) {
    const bool mine_ok = leader && (!MASKED || g + my_row < nrows);
    const float lb_old = mine_ok ? log_beta[g + my_row] : 0.f;
    float v[F][KPL];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const bool row_ok = !MASKED || g + i < nrows;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const bool ok = row_ok && (c < KPL - 1 || last_ok);
        v[i][c] = ok ? to_f(rows[(g + i) * k + c * 32 + lane]) : kNeg;
      }
    }
    if (g + F == RPW) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    }

    // Row LSE of M + log_alpha, the group's rows side by side.
    float zmax[F], zsum[F], lb[F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      zmax[i] = kNeg;
#pragma unroll
      for (int c = 0; c < KPL; ++c) zmax[i] = fmaxf(zmax[i], v[i][c] + la[c]);
    }
    const float zmax_mine = rows_reduce<F>(zmax, lane, MaxOp());
#pragma unroll
    for (int i = 0; i < F; ++i) {
      zmax[i] = __shfl_sync(0xffffffffu, zmax_mine, i << kShift);
      zsum[i] = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c)
        zsum[i] += exp_from(v[i][c] + la[c], zmax[i]);
    }
    const float zsum_mine = rows_reduce<F>(zsum, lane, SumOp());
    const float lb_mine = log_c - (zmax_mine + logf(zsum_mine));
    if (mine_ok) {
      beta_out[g + my_row] = lb_mine;
      err += fabsf(expf(lb_old - lb_mine) - 1.f);
    }
#pragma unroll
    for (int i = 0; i < F; ++i) {
      lb[i] = __shfl_sync(0xffffffffu, lb_mine, i << kShift);
      if (MASKED && g + i >= nrows) lb[i] = kNeg;  // no column share
    }

    // Column LSE of M + log_beta_new: the group's max, one rescale of the
    // running pair (by exactly 1 where the max did not move: no branch),
    // then the sum.
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
#pragma unroll
      for (int i = 0; i < F; ++i) v[i][c] += lb[i];
      float nmax = cmax[c];
#pragma unroll
      for (int i = 0; i < F; ++i) nmax = fmaxf(nmax, v[i][c]);
      csum[c] = csum[c] > 0.f ? csum[c] * exp_of(cmax[c] - nmax) : 0.f;
      cmax[c] = nmax;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < F; ++i) s += exp_from(v[i][c], nmax);
      csum[c] += s;
    }
  }
}

// Merge rows [r0, r1) (at most kGroup) of the partial LSEs lse [.][k] and
// of err, in row order: max, then the sum of exps. With log_r it writes
// log_r - LSE (the next log_alpha), otherwise the merged LSE.
__device__ void merge_rows(const float* lse, const float* err, int r0, int r1,
                           int k, const float* __restrict__ log_r,
                           float* out, float* err_out) {
  for (int col = threadIdx.x; col < k; col += blockDim.x) {
    // Every load issued before any is used (rows past r1 read row r1 - 1).
    float l[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      l[r] = __ldcg(lse + static_cast<size_t>(min(r0 + r, r1 - 1)) * k + col);
    float m = kNeg;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (r0 + r < r1) m = fmaxf(m, l[r]);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (r0 + r < r1) s += expf(l[r] - m);
    out[col] = log_r ? log_r[col] - (m + logf(fmaxf(s, 1e-38f)))
                     : m + logf(s);
  }
  if (threadIdx.x == 0) {
    float l[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) l[r] = __ldcg(err + min(r0 + r, r1 - 1));
    float e = 0.f;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (r0 + r < r1) e += l[r];
    *err_out = e;
  }
}

// Scratch (floats): the blocks' partial LSEs [G][k] and errors [G], then
// the groups' [ceil(G / kGroup)][k] and [ceil(G / kGroup)].
struct Scratch {
  float* lse;
  float* err;
  float* group_lse;
  float* group_err;
};

__device__ __forceinline__ Scratch scratch_of(float* base, int k, int grid) {
  const int groups = (grid + kGroup - 1) / kGroup;
  Scratch s;
  s.lse = base;
  s.err = base + static_cast<size_t>(grid) * k;
  s.group_lse = s.err + grid;
  s.group_err = s.group_lse + static_cast<size_t>(groups) * k;
  return s;
}

// The whole merge in one block: the second kernel of the two-launch form.
__global__ void __launch_bounds__(kThreads)
sk_finalize(float* __restrict__ scratch, const float* __restrict__ log_r,
            float* __restrict__ alpha_out, float* __restrict__ err_out, int k,
            int grid) {
  const Scratch sc = scratch_of(scratch, k, grid);
  const int groups = (grid + kGroup - 1) / kGroup;
  for (int q = 0; q < groups; ++q)
    merge_rows(sc.lse, sc.err, q * kGroup, min(grid, (q + 1) * kGroup), k,
               nullptr, sc.group_lse + static_cast<size_t>(q) * k,
               sc.group_err + q);
  __syncthreads();
  merge_rows(sc.group_lse, sc.group_err, 0, groups, k, log_r, alpha_out,
             err_out);
}

template <typename T, int KPL>
__global__ void __launch_bounds__(kThreads, 1)
sk_iteration(const T* __restrict__ m, const float* __restrict__ log_alpha,
             const float* __restrict__ log_beta,
             const float* __restrict__ log_r, float* __restrict__ alpha_out,
             float* __restrict__ beta_out, float* __restrict__ err_out,
             float* __restrict__ scratch, unsigned* __restrict__ counters,
             int n, int k, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);  // full[s] at 8 s, empty[s] after
  int* flag = reinterpret_cast<int*>(smem + 128);
  T* ring = reinterpret_cast<T*>(smem + kHeaderBytes);
  constexpr int RPW = rows_per_warp(KPL);
  constexpr int kTileRows = kWarps * RPW;
  const int stage_elems = kTileRows * k;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grid = gridDim.x;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float cmax[KPL], csum[KPL];
  float err = 0.f;
  if (warp == kWarps) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += grid, ++i) {
        const int s = i % stages;
        mbar_wait(empty(s), ((i / stages) & 1) ^ 1);
        const size_t first = static_cast<size_t>(t) * stage_elems;
        const int elems = min(kTileRows, n - t * kTileRows) * k;
        const uint32_t bulk = (elems * static_cast<int>(sizeof(T))) & ~15;
        T* dst = ring + static_cast<size_t>(s) * stage_elems;
        for (int e = bulk / sizeof(T); e < elems; ++e) dst[e] = m[first + e];
        if (bulk > 0) {
          mbar_expect_tx(full(s), bulk);
          bulk_load(smem_u32(dst), m + first, bulk, full(s));
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // Consumers.
    const float log_c = -logf(static_cast<float>(n));
    float la[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      const int col = c * 32 + lane;
      la[c] = col < k ? log_alpha[col] : 0.f;
      cmax[c] = kNeg;
      csum[c] = 0.f;
    }
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += grid, ++i) {
      const int s = i % stages;
      mbar_wait(full(s), (i / stages) & 1);
      const int nw = min(RPW, n - t * kTileRows - warp * RPW);
      const int row0 = t * kTileRows + warp * RPW;
      const T* rows =
          ring + static_cast<size_t>(s) * stage_elems + warp * RPW * k;
      if (nw == RPW) {
        warp_rows<T, KPL, false>(rows, k, nw, lane, empty(s), la, cmax, csum,
                                 err, log_c, log_beta + row0, beta_out + row0);
      } else if (nw > 0) {
        warp_rows<T, KPL, true>(rows, k, nw, lane, empty(s), la, cmax, csum,
                                err, log_c, log_beta + row0, beta_out + row0);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
    }
    err = warp_sum(err);
  }

  // The block's partials: every stage has been consumed, so the ring holds
  // the warps' (max, sum) pairs [kWarps][k] and errors now.
  __syncthreads();
  float* s_max = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* s_sum = s_max + kWarps * k;
  float* s_err = s_sum + kWarps * k;
  if (warp < kWarps) {
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      const int col = c * 32 + lane;
      if (col < k) {
        s_max[warp * k + col] = cmax[c];
        s_sum[warp * k + col] = csum[c];
      }
    }
    if (lane == 0) s_err[warp] = err;
  }
  __syncthreads();
  const Scratch sc = scratch_of(scratch, k, grid);
  for (int col = threadIdx.x; col < k; col += kThreads) {
    float bm = kNeg;
    for (int w = 0; w < kWarps; ++w)
      if (s_sum[w * k + col] > 0.f) bm = fmaxf(bm, s_max[w * k + col]);
    float bs = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float ws = s_sum[w * k + col];
      bs += ws > 0.f ? ws * expf(s_max[w * k + col] - bm) : 0.f;
    }
    // The block took at least one row, so bs >= 1.
    sc.lse[static_cast<size_t>(blockIdx.x) * k + col] = bm + logf(bs);
  }
  if (threadIdx.x == 0) {
    float e = 0.f;
    for (int w = 0; w < kWarps; ++w) e += s_err[w];
    sc.err[blockIdx.x] = e;
  }
  if (!kTicket) return;

  // Tickets: the last block of each group merges the group, the last group
  // merges the groups.
  const int groups = (grid + kGroup - 1) / kGroup;
  const int q = blockIdx.x / kGroup;
  const int g0 = q * kGroup, g1 = min(grid, g0 + kGroup);
  // The block's writes are ordered before its ticket by the barrier and
  // the ticket's release; the block that draws the last ticket acquires
  // what the earlier ones published.
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = take_ticket(counters + q) == static_cast<unsigned>(g1 - g0 - 1);
  __syncthreads();
  if (!*flag) return;
  merge_rows(sc.lse, sc.err, g0, g1, k, nullptr,
             sc.group_lse + static_cast<size_t>(q) * k, sc.group_err + q);
  __syncthreads();
  if (threadIdx.x == 0) {
    counters[q] = 0;
    *flag = take_ticket(counters + groups) == static_cast<unsigned>(groups - 1);
  }
  __syncthreads();
  if (!*flag) return;
  merge_rows(sc.group_lse, sc.group_err, 0, groups, k, log_r, alpha_out,
             err_out);
  if (threadIdx.x == 0) counters[groups] = 0;
}

struct Plan {
  int tile_rows, grid, stage_bytes, stages, smem_bytes, tiles;
  int bulk_bytes_last, rest_bytes_last, groups, scratch_floats;
};

int plan_of(int n, int k, int elem, int sm_count, Plan* p) {
  if (n <= 0 || k <= 0 || k > 32 * kMaxKpl || sm_count <= 0) return 1;
  p->tile_rows = kWarps * rows_per_warp((k + 31) / 32);
  p->tiles = (n + p->tile_rows - 1) / p->tile_rows;
  p->grid = min(min(sm_count, p->tiles), kMaxGrid);
  p->stage_bytes = p->tile_rows * k * elem;
  p->stages = min(min(kMaxStages, max(3, kRingBytes / p->stage_bytes)),
                  (kSmemLimit - kHeaderBytes) / p->stage_bytes);
  p->smem_bytes = kHeaderBytes + p->stages * p->stage_bytes;
  const int last = (n - (p->tiles - 1) * p->tile_rows) * k * elem;
  p->bulk_bytes_last = last & ~15;
  p->rest_bytes_last = last - p->bulk_bytes_last;
  p->groups = (p->grid + kGroup - 1) / kGroup;
  p->scratch_floats = (p->grid + p->groups) * (k + 1);
  return 0;
}

template <typename T, int KPL>
cudaError_t launch(const void* m, const float* la, const float* lb,
                   const float* lr, float* alpha_out, float* beta_out,
                   float* err_out, float* scratch, unsigned* counters, int n,
                   int k, const Plan& p, cudaStream_t stream) {
  auto kernel = sk_iteration<T, KPL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  kernel<<<p.grid, kThreads, p.smem_bytes, stream>>>(
      static_cast<const T*>(m), la, lb, lr, alpha_out, beta_out, err_out,
      scratch, counters, n, k, p.stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* m, const float* la, const float* lb,
                     const float* lr, float* alpha_out, float* beta_out,
                     float* err_out, float* scratch, unsigned* counters, int n,
                     int k, const Plan& p, cudaStream_t stream) {
  switch ((k + 31) / 32) {
#define SK_CASE(KPL)                                                       \
  case KPL:                                                                \
    return launch<T, KPL>(m, la, lb, lr, alpha_out, beta_out, err_out,     \
                          scratch, counters, n, k, p, stream);
    SK_CASE(1) SK_CASE(2) SK_CASE(3) SK_CASE(4) SK_CASE(5) SK_CASE(6)
    SK_CASE(7) SK_CASE(8) SK_CASE(9) SK_CASE(10) SK_CASE(11) SK_CASE(12)
    SK_CASE(13) SK_CASE(14) SK_CASE(15) SK_CASE(16)
#undef SK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
const void* kernel_at(int k) {
  switch ((k + 31) / 32) {
#define SK_CASE(KPL) \
  case KPL:          \
    return reinterpret_cast<const void*>(sk_iteration<T, KPL>);
    SK_CASE(1) SK_CASE(2) SK_CASE(3) SK_CASE(4) SK_CASE(5) SK_CASE(6)
    SK_CASE(7) SK_CASE(8) SK_CASE(9) SK_CASE(10) SK_CASE(11) SK_CASE(12)
    SK_CASE(13) SK_CASE(14) SK_CASE(15) SK_CASE(16)
#undef SK_CASE
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

int sk_max_k() { return 32 * kMaxKpl; }

// Kernel launches an iteration makes: 1, or 2 with the separate merge.
int sk_launches_per_iteration() { return kTicket ? 1 : 2; }

// The tiling of an iteration over M [n, k] (m_is_bf16: bf16, else fp32) on
// a card of sm_count SMs, into out[10]: tile rows, grid, bytes a stage,
// stages, dynamic shared memory, tiles, the last tile's bulk-copied bytes
// and the bytes past them, groups of the merge, scratch floats. Returns 0,
// or 1 on a shape the kernel does not take.
int sk_plan(int n, int k, int m_is_bf16, int sm_count, int* out) {
  Plan p;
  if (plan_of(n, k, m_is_bf16 ? 2 : 4, sm_count, &p)) return 1;
  const int v[10] = {p.tile_rows,  p.grid,  p.stage_bytes,
                     p.stages,     p.smem_bytes, p.tiles,
                     p.bulk_bytes_last, p.rest_bytes_last, p.groups,
                     p.scratch_floats};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// Registers a thread and local memory (spills) of the kernel instance that
// an M with k columns takes, into out[2]; returns the cudaError_t.
int sk_kernel_info(int k, int m_is_bf16, int* out) {
  const void* fn = m_is_bf16 ? kernel_at<__nv_bfloat16>(k) : kernel_at<float>(k);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}

// One fused iteration. m: [n, k] row-major, 16-byte aligned, fp32
// (m_is_bf16 == 0) or bf16. scratch: the plan's scratch floats; counters:
// groups + 1 unsigned ints, zero before the first call (the kernel leaves
// them zero). The launch goes to card `device` (made current for it, and
// the caller's current card restored after), on `stream`. Returns the
// cudaError_t of the launches (0 on success); nothing is synchronised.
int sk_fused_iteration(const void* m, int m_is_bf16, const float* log_alpha,
                       const float* log_beta, const float* log_r,
                       float* alpha_out, float* beta_out, float* err_out,
                       float* scratch, unsigned* counters, int n, int k,
                       int sm_count, int device, void* stream) {
  Plan p;
  if (plan_of(n, k, m_is_bf16 ? 2 : 4, sm_count, &p) ||
      reinterpret_cast<uintptr_t>(m) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = m_is_bf16 ? dispatch<__nv_bfloat16>(m, log_alpha, log_beta, log_r,
                                          alpha_out, beta_out, err_out,
                                          scratch, counters, n, k, p, s)
                : dispatch<float>(m, log_alpha, log_beta, log_r, alpha_out,
                                  beta_out, err_out, scratch, counters, n, k,
                                  p, s);
  if (e == cudaSuccess && !kTicket) {
    sk_finalize<<<1, kThreads, 0, s>>>(scratch, log_r, alpha_out, err_out,
                                       k, p.grid);
    e = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}

}  // extern "C"

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
// ~32 us bf16 at an H100 SXM's 3.35 TB/s (a PCIe card is slower; the
// smoke script takes the rate of the card it runs on). The arithmetic is
// two exp per element (~105 M; the column rescale exp only fires when a
// column max moves) and a handful of FP32 adds/maxes: ~105 M SFU ops at
// 16/clk/SM x 132 SMs is ~25-30 us, close to the bf16 byte bound, and the
// FP32 work is far below the 67 TFLOP/s line.
//
// Design against that bound:
// * M is read exactly once, straight from the caller's tensor: no padding
//   copy (the TPU wrapper's jnp.pad copies M every call). Ragged N and K
//   are masked here. Each warp owns whole rows; lane j holds columns
//   j, j+32, ... of its row in registers, so the row LSE, the error term
//   and the column update all reuse the one load. bf16 M is upcast per
//   element.
// * The TPU grid runs in order and carries the column (max, sum) pair in
//   VMEM across steps; Hopper blocks run in parallel, so each warp keeps
//   an online (max, sum) pair per column in registers, the block merges
//   its warps in shared memory and writes one partial pair per column.
//   A small second kernel merges the partials of all blocks and emits
//   log_alpha_{i+1}.
// * No float atomics: every merge and the error sum run in a fixed order,
//   so err (which decides the stopping iteration) is bit-identical from
//   run to run.
// * The TPU kernel's arithmetic is kept: log_c = -log(n), exp(x) - 1 (not
//   expm1) in the error, the colsum > 0 guard on rescaling and the 1e-38
//   floor before the final log.
//
// Plain C interface, loaded with ctypes by selavi_tpu_torch/ops/sinkhorn_fused.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;            // warps per row block
constexpr int kFinalizeThreads = 256;
constexpr int kMaxKpl = 16;          // columns per lane: K <= 512

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Merge the online-LSE pair (m2, s2) into (m, s). A pair whose sum is 0
// holds nothing (the TPU kernel's colsum > 0 guard). Symmetric in its two
// arguments bit for bit, so a butterfly merge is deterministic.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float nm = fmaxf(m, m2);
  const float a = s > 0.f ? s * expf(m - nm) : 0.f;
  const float b = s2 > 0.f ? s2 * expf(m2 - nm) : 0.f;
  m = nm;
  s = a + b;
}

// Pass 1. Block g owns rows [g*rows_per_block, (g+1)*rows_per_block);
// warp w of the block takes every kWarps-th of them. Writes log_beta_new
// for its rows, one partial (max, sum) per column into colmax/colsum
// [K, G] (column-major, so pass 2 reads each column's partials
// contiguously) and one partial error into err_part [G].
template <typename T, int KPL>
__global__ void __launch_bounds__(kWarps * 32)
sk_rows_kernel(const T* __restrict__ m, const float* __restrict__ log_alpha,
               const float* __restrict__ log_beta,
               float* __restrict__ beta_out, float* __restrict__ colmax,
               float* __restrict__ colsum, float* __restrict__ err_part,
               int n, int k, int rows_per_block) {
  extern __shared__ float smem[];  // [kWarps][k] max, [kWarps][k] sum, [kWarps] err
  float* s_max = smem;
  float* s_sum = smem + kWarps * k;
  float* s_err = smem + 2 * kWarps * k;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const int n_blocks = gridDim.x;
  const float log_c = -logf(static_cast<float>(n));

  float la[KPL], cmax[KPL], csum[KPL];
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    const int col = c * 32 + lane;
    la[c] = col < k ? log_alpha[col] : 0.f;
    cmax[c] = kNeg;
    csum[c] = 0.f;
  }
  float err = 0.f;

  const int r0 = g * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const T* mrow = m + static_cast<size_t>(row) * k;
    float v[KPL];
    float zmax = kNeg;
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      const int col = c * 32 + lane;
      v[c] = col < k ? load_f(mrow + col) : 0.f;
      if (col < k) zmax = fmaxf(zmax, v[c] + la[c]);
    }
    zmax = warp_max(zmax);
    float zsum = 0.f;
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      if (c * 32 + lane < k) zsum += expf(v[c] + la[c] - zmax);
    }
    zsum = warp_sum(zsum);
    const float lb_new = log_c - (zmax + logf(zsum));
    if (lane == 0) {
      beta_out[row] = lb_new;
      err += fabsf(expf(log_beta[row] - lb_new) - 1.f);
    }
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      if (c * 32 + lane < k) {
        const float w = v[c] + lb_new;
        if (w > cmax[c]) {
          csum[c] = (csum[c] > 0.f ? csum[c] * expf(cmax[c] - w) : 0.f) + 1.f;
          cmax[c] = w;
        } else {
          csum[c] += expf(w - cmax[c]);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    const int col = c * 32 + lane;
    if (col < k) {
      s_max[warp * k + col] = cmax[c];
      s_sum[warp * k + col] = csum[c];
    }
  }
  if (lane == 0) s_err[warp] = err;
  __syncthreads();

  for (int col = threadIdx.x; col < k; col += blockDim.x) {
    float bm = kNeg, bs = 0.f;
    for (int w = 0; w < kWarps; ++w)
      lse_merge(bm, bs, s_max[w * k + col], s_sum[w * k + col]);
    colmax[static_cast<size_t>(col) * n_blocks + g] = bm;
    colsum[static_cast<size_t>(col) * n_blocks + g] = bs;
  }
  if (threadIdx.x == 0) {
    float e = 0.f;
    for (int w = 0; w < kWarps; ++w) e += s_err[w];
    err_part[g] = e;
  }
}

// Pass 2. Block c < k merges column c's n_blocks partials and writes
// log_alpha_next[c]; block k sums the partial errors. Fixed order
// throughout: strided per thread, butterfly per warp, warps in order.
__global__ void __launch_bounds__(kFinalizeThreads)
sk_finalize_kernel(const float* __restrict__ colmax,
                   const float* __restrict__ colsum,
                   const float* __restrict__ err_part,
                   const float* __restrict__ log_r,
                   float* __restrict__ alpha_out, float* __restrict__ err_out,
                   int k, int n_blocks) {
  __shared__ float s_m[kFinalizeThreads / 32];
  __shared__ float s_s[kFinalizeThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x;

  if (col == k) {
    float e = 0.f;
    for (int g = threadIdx.x; g < n_blocks; g += blockDim.x) e += err_part[g];
    e = warp_sum(e);
    if (lane == 0) s_s[warp] = e;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kFinalizeThreads / 32; ++w) total += s_s[w];
      *err_out = total;
    }
    return;
  }

  const float* pm = colmax + static_cast<size_t>(col) * n_blocks;
  const float* ps = colsum + static_cast<size_t>(col) * n_blocks;
  float m = kNeg, s = 0.f;
  for (int g = threadIdx.x; g < n_blocks; g += blockDim.x)
    lse_merge(m, s, pm[g], ps[g]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = kNeg, bs = 0.f;
    for (int w = 0; w < kFinalizeThreads / 32; ++w)
      lse_merge(bm, bs, s_m[w], s_s[w]);
    alpha_out[col] = log_r[col] - (bm + logf(fmaxf(bs, 1e-38f)));
  }
}

template <typename T, int KPL>
cudaError_t launch_rows(const void* m, const float* la, const float* lb,
                        float* beta_out, float* colmax, float* colsum,
                        float* err_part, int n, int k, int rows_per_block,
                        int n_blocks, cudaStream_t stream) {
  const size_t smem = (2 * kWarps * static_cast<size_t>(k) + kWarps) *
                      sizeof(float);
  sk_rows_kernel<T, KPL><<<n_blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(m), la, lb, beta_out, colmax, colsum, err_part,
      n, k, rows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* m, const float* la, const float* lb,
                          float* beta_out, float* colmax, float* colsum,
                          float* err_part, int n, int k, int rows_per_block,
                          int n_blocks, cudaStream_t stream) {
  switch ((k + 31) / 32) {
#define SK_CASE(KPL)                                                        \
  case KPL:                                                                 \
    return launch_rows<T, KPL>(m, la, lb, beta_out, colmax, colsum,         \
                               err_part, n, k, rows_per_block, n_blocks,    \
                               stream);
    SK_CASE(1) SK_CASE(2) SK_CASE(3) SK_CASE(4) SK_CASE(5) SK_CASE(6)
    SK_CASE(7) SK_CASE(8) SK_CASE(9) SK_CASE(10) SK_CASE(11) SK_CASE(12)
    SK_CASE(13) SK_CASE(14) SK_CASE(15) SK_CASE(16)
#undef SK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int sk_max_k() { return 32 * kMaxKpl; }

// One fused iteration. m: [n, k] row-major, fp32 (m_is_bf16 == 0) or bf16.
// Scratch: colmax/colsum [k * n_blocks], err_part [n_blocks], with
// n_blocks == ceil(n / rows_per_block). Returns the cudaError_t of the
// launches (0 on success); nothing is synchronised.
int sk_fused_iteration(const void* m, int m_is_bf16, const float* log_alpha,
                       const float* log_beta, const float* log_r,
                       float* alpha_out, float* beta_out, float* err_out,
                       float* colmax, float* colsum, float* err_part, int n,
                       int k, int rows_per_block, int n_blocks,
                       void* stream) {
  if (n <= 0 || k <= 0 || k > 32 * kMaxKpl || rows_per_block <= 0 ||
      n_blocks != (n + rows_per_block - 1) / rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      m_is_bf16
          ? dispatch_rows<__nv_bfloat16>(m, log_alpha, log_beta, beta_out,
                                         colmax, colsum, err_part, n, k,
                                         rows_per_block, n_blocks, s)
          : dispatch_rows<float>(m, log_alpha, log_beta, beta_out, colmax,
                                 colsum, err_part, n, k, rows_per_block,
                                 n_blocks, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  sk_finalize_kernel<<<k + 1, kFinalizeThreads, 0, s>>>(
      colmax, colsum, err_part, log_r, alpha_out, err_out, k, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// 3x3 stride-1 "same" convolution, channels last, for Hopper (sm_90a): the
// forward (which the data gradient reuses) and the weight gradient, as
// implicit GEMMs.
//
// Replaces the Pallas TPU kernels of experiments/pallas_conv3x3.py:
// * conv3x3_pallas (pallas_call at :94, body _conv_kernel at :33), which
//   conv3x3_dgrad_pallas (:194) reuses with the weights rotated and
//   io-transposed: conv3x3_fwd below;
// * conv3x3_wgrad_pallas (pallas_call at :162, body _wgrad_kernel at :126):
//   conv3x3_wgrad below.
//
// With A = im2col(x) [M, 9C] (M = N*H*W output pixels; columns in the JAX
// w.reshape(9C, Co) order: dy, then dx, then channel) the forward is
// y = A @ W [M, Co] and the weight gradient is dW = A^T @ G [9C, Co].
//
// Bound: operations. At the probe's bench shape, x [480,56,56,64] -> 128
// in bf16, each kernel does 2*1505280*576*128 = 2.22e11 FLOP: 0.224 ms at
// the H100 SXM's 989 TFLOP/s dense bf16, against 0.173 ms for the 578 MB
// that the forward must move at 3.35 TB/s. In fp32 (FMAs on the CUDA
// cores, no TF32) the same FLOP take 3.31 ms at 67 TFLOP/s.
//
// Design (right and simple first; wgmma, TMA and a producer/consumer ring
// are later work):
// * x is read in place: the JAX wrapper pads x with jnp.pad (a full copy
//   of the activation on every call); here the gather masks the 1-pixel
//   border. Ragged M, K and Co are masked or zero-filled, so any C and Co
//   work (the probe's small check shape has C = 8, K = 72).
// * The reduction walks the 9 taps, then slices of C, so each row of the
//   A tile is a run of contiguous channels of one source pixel: 16-byte
//   loads when C and Co are multiples of 16 bytes and the pointers are
//   16-byte aligned, element loads otherwise.
// * bf16 runs on the tensor cores through nvcuda::wmma (16x16x16, fp32
//   accumulate); fp32 runs as FMAs on the CUDA cores in full fp32.
// * The global loads of the next slice are issued into registers before
//   the current slice is multiplied out of shared memory.
// * Weight gradient: the TPU kernel accumulates every grid step into one
//   output block, which works only because the TPU grid runs in order.
//   Here M is cut into S fixed pixel ranges; block (tile, s) writes an
//   fp32 partial tile, and a second kernel sums the S partials of each
//   output in the order s = 0..S-1. No float atomics: the result is
//   bit-identical from run to run.
//
// Plain C interface, loaded with ctypes by selavi_tpu_torch/ops/conv3x3.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdRows = 128;   // output pixels per forward block
constexpr int kWgradRows = 64;  // channels of one tap per weight-gradient block
constexpr int kReduceThreads = 256;
constexpr int kMaxReduceBlocks = 1024;

// A 16-byte chunk of T, and the reduction depth of one slice (64 bytes of
// a row: 32 bf16 or 16 fp32 values).
template <typename T>
struct Elems {
  static constexpr int kChunk = 16 / sizeof(T);
  static constexpr int kDepth = 64 / sizeof(T);
};

// Output columns per block: 64 when Co <= 64, else 128.
inline int tile_cols(int co) { return co <= 64 ? 64 : 128; }

inline int64_t round_up(int64_t v, int64_t to) { return (v + to - 1) / to * to; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

struct Pixel {
  int n, h, w;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(int m, int m_end, int h, int w) {
  Pixel p;
  p.ok = m < m_end;
  const int hw = h * w;
  p.n = m / hw;
  const int r = m - p.n * hw;
  p.h = r / w;
  p.w = r - p.h * w;
  return p;
}

// The row of `dim` channels of pixel p shifted by tap (dy, dx) in the NHWC
// tensor t, or nullptr where the tap falls on the zero border (or p is
// past the end). dy = dx = 1 is the pixel itself.
template <typename T>
__device__ __forceinline__ const T* shifted_row(const T* t, Pixel p, int dy,
                                                int dx, int h, int w,
                                                int dim) {
  const int hh = p.h + dy - 1;
  const int ww = p.w + dx - 1;
  if (!p.ok || hh < 0 || hh >= h || ww < 0 || ww >= w) return nullptr;
  return t + ((static_cast<int64_t>(p.n) * h + hh) * w + ww) * dim;
}

// Channels [c, c + kChunk) of `row` (a row of `dim` channels; nullptr reads
// zeros), zero past dim. With VEC, dim and c are multiples of kChunk and
// row is 16-byte aligned, so a chunk lies wholly inside or wholly past it.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int dim) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row == nullptr) return r;
  if constexpr (VEC) {
    if (c < dim) r = __ldg(reinterpret_cast<const uint4*>(row + c));
  } else {
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int q = 0; q < Elems<T>::kChunk; ++q)
      if (c + q < dim) e[q] = row[c + q];
  }
  return r;
}

// The forward's global -> register stage. Slice s is tap s / c_slices and
// channels [c0, c0 + kDepth), c0 = (s % c_slices) * kDepth. A tile:
// kFwdRows pixels x kDepth channels; B tile: kDepth weight rows x BN
// output channels.
template <typename T, int BN, bool VEC>
struct FwdStage {
  static constexpr int kChunk = Elems<T>::kChunk;
  static constexpr int kDepth = Elems<T>::kDepth;
  static constexpr int kARowChunks = kDepth / kChunk;
  static constexpr int kA = kFwdRows * kARowChunks / kThreads;
  static constexpr int kBRowChunks = BN / kChunk;
  static constexpr int kB = kDepth * kBRowChunks / kThreads;
  static_assert(kA * kThreads == kFwdRows * kARowChunks, "A tile split");
  static_assert(kB * kThreads == kDepth * kBRowChunks, "B tile split");

  Pixel pix[kA];
  int a_row[kA], a_col[kA], b_row[kB], b_col[kB];
  uint4 a[kA], b[kB];

  __device__ FwdStage(int m0, int m_total, int h, int w) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int v = threadIdx.x + i * kThreads;
      a_row[i] = v / kARowChunks;
      a_col[i] = (v % kARowChunks) * kChunk;
      pix[i] = pixel_of(m0 + a_row[i], m_total, h, w);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int v = threadIdx.x + i * kThreads;
      b_row[i] = v / kBRowChunks;
      b_col[i] = (v % kBRowChunks) * kChunk;
    }
  }

  __device__ __forceinline__ void load(const T* x, const T* w2, int s,
                                       int c_slices, int h, int w, int c,
                                       int co, int co0) {
    const int tap = s / c_slices;
    const int c0 = (s - tap * c_slices) * kDepth;
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
#pragma unroll
    for (int i = 0; i < kA; ++i)
      a[i] = load_chunk<T, VEC>(shifted_row(x, pix[i], dy, dx, h, w, c),
                                c0 + a_col[i], c);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int k = c0 + b_row[i];
      const T* row =
          k < c ? w2 + (static_cast<int64_t>(tap) * c + k) * co : nullptr;
      b[i] = load_chunk<T, VEC>(row, co0 + b_col[i], co);
    }
  }
};

// Forward, bf16 on the tensor cores. Block: kFwdRows pixels x BN output
// channels; 8 warps as 4 (pixels) x 2 (channels), 32 x BN/2 each.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w2,
              bf16* __restrict__ y, int n, int h, int w, int c, int co) {
  using Stage = FwdStage<bf16, BN, VEC>;
  constexpr int kDepth = Stage::kDepth;
  constexpr int kLdA = kDepth + 8;
  constexpr int kLdB = BN + 8;
  constexpr int kWarpCols = BN / 2;
  constexpr int kFn = kWarpCols / 16;
  __shared__ __align__(128) bf16 As[kFwdRows * kLdA];  // As[pixel][k]
  __shared__ __align__(128) bf16 Bs[kDepth * kLdB];    // Bs[k][co]
  __shared__ __align__(128) float Cs[kWarps * 256];    // epilogue, per warp

  const int m_total = n * h * w;
  const int m0 = blockIdx.x * kFwdRows;
  const int co0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int c_slices = (c + kDepth - 1) / kDepth;
  const int steps = 9 * c_slices;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFn];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFn; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st(m0, m_total, h, w);
  st.load(x, w2, 0, c_slices, h, w, c, co, co0);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < Stage::kA; ++i)
      *reinterpret_cast<uint4*>(&As[st.a_row[i] * kLdA + st.a_col[i]]) =
          st.a[i];
#pragma unroll
    for (int i = 0; i < Stage::kB; ++i)
      *reinterpret_cast<uint4*>(&Bs[st.b_row[i] * kLdB + st.b_col[i]]) =
          st.b[i];
    __syncthreads();
    if (s + 1 < steps) st.load(x, w2, s + 1, c_slices, h, w, c, co, co0);
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[kFn];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * kLdA + kk],
                               kLdA);
#pragma unroll
      for (int j = 0; j < kFn; ++j)
        wmma::load_matrix_sync(fb[j],
                               &Bs[kk * kLdB + wn * kWarpCols + j * 16],
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kFn; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each 16x16 accumulator goes through the warp's fp32 tile in
  // shared memory; lane l writes 8 channels of row l / 2, rounded to bf16.
  float* cs = Cs + warp * 256;
  const int r = lane / 2;
  const int cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kFn; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int col = co0 + wn * kWarpCols + j * 16 + cc;
      if (m < m_total) {
        bf16* dst = y + static_cast<int64_t>(m) * co + col;
        if constexpr (VEC) {
          if (col < co) {
            alignas(16) bf16 v[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] = __float2bfloat16(cs[r * 16 + cc + q]);
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (col + q < co) dst[q] = __float2bfloat16(cs[r * 16 + cc + q]);
        }
      }
      __syncwarp();
    }
  }
}

// Forward, fp32 on the CUDA cores. Block: kFwdRows pixels x BN output
// channels; 16 x 16 threads, 8 pixels x BN/16 channels each.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_fwd_f32(const float* __restrict__ x, const float* __restrict__ w2,
             float* __restrict__ y, int n, int h, int w, int c, int co) {
  using Stage = FwdStage<float, BN, VEC>;
  constexpr int kDepth = Stage::kDepth;
  constexpr int kLdA = kFwdRows + 4;
  constexpr int kLdB = BN + 4;
  constexpr int kTn = BN / 16;
  __shared__ __align__(16) float As[kDepth * kLdA];  // As[k][pixel]
  __shared__ __align__(16) float Bs[kDepth * kLdB];  // Bs[k][co]

  const int m_total = n * h * w;
  const int m0 = blockIdx.x * kFwdRows;
  const int co0 = blockIdx.y * BN;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int c_slices = (c + kDepth - 1) / kDepth;
  const int steps = 9 * c_slices;

  float acc[8][kTn];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;

  Stage st(m0, m_total, h, w);
  st.load(x, w2, 0, c_slices, h, w, c, co, co0);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < Stage::kA; ++i) {
      const float* e = reinterpret_cast<const float*>(&st.a[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        As[(st.a_col[i] + q) * kLdA + st.a_row[i]] = e[q];
    }
#pragma unroll
    for (int i = 0; i < Stage::kB; ++i)
      *reinterpret_cast<uint4*>(&Bs[st.b_row[i] * kLdB + st.b_col[i]]) =
          st.b[i];
    __syncthreads();
    if (s + 1 < steps) st.load(x, w2, s + 1, c_slices, h, w, c, co, co0);
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k * kLdA + ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k * kLdA + ty * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[kTn];
#pragma unroll
      for (int q = 0; q < kTn / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            &Bs[k * kLdB + tx * kTn + 4 * q]);
        bv[4 * q] = b4.x;
        bv[4 * q + 1] = b4.y;
        bv[4 * q + 2] = b4.z;
        bv[4 * q + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= m_total) continue;
    float* dst = y + static_cast<int64_t>(m) * co;
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      const int col = co0 + tx * kTn + j;
      if (col < co) dst[col] = acc[i][j];
    }
  }
}

// The weight gradient's global -> register stage. Slice s is pixels
// [p0, p0 + kDepth), p0 = p_begin + s * kDepth. A tile: kDepth pixels x
// kWgradRows channels of x shifted by the tap; G tile: kDepth pixels x BN
// output channels of g.
template <typename T, int BN, bool VEC>
struct WgradStage {
  static constexpr int kChunk = Elems<T>::kChunk;
  static constexpr int kDepth = Elems<T>::kDepth;
  static constexpr int kARowChunks = kWgradRows / kChunk;
  static constexpr int kA = kDepth * kARowChunks / kThreads;
  static constexpr int kBRowChunks = BN / kChunk;
  static constexpr int kB = kDepth * kBRowChunks / kThreads;
  static_assert(kA * kThreads == kDepth * kARowChunks, "A tile split");
  static_assert(kB * kThreads == kDepth * kBRowChunks, "G tile split");

  int a_row[kA], a_col[kA], b_row[kB], b_col[kB];
  uint4 a[kA], b[kB];

  __device__ WgradStage() {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int v = threadIdx.x + i * kThreads;
      a_row[i] = v / kARowChunks;
      a_col[i] = (v % kARowChunks) * kChunk;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int v = threadIdx.x + i * kThreads;
      b_row[i] = v / kBRowChunks;
      b_col[i] = (v % kBRowChunks) * kChunk;
    }
  }

  __device__ __forceinline__ void load(const T* x, const T* g, int p0,
                                       int p_end, int dy, int dx, int c0,
                                       int co0, int h, int w, int c, int co) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const Pixel p = pixel_of(p0 + a_row[i], p_end, h, w);
      a[i] = load_chunk<T, VEC>(shifted_row(x, p, dy, dx, h, w, c),
                                c0 + a_col[i], c);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const Pixel p = pixel_of(p0 + b_row[i], p_end, h, w);
      b[i] = load_chunk<T, VEC>(shifted_row(g, p, 1, 1, h, w, co),
                                co0 + b_col[i], co);
    }
  }
};

// Which tap, channel block, output-channel block and pixel range a
// weight-gradient block owns. blockIdx.x = tap * c_blocks + channel block
// (fastest, so the blocks that read the same pixels run side by side),
// blockIdx.y = output-channel block, blockIdx.z = split.
struct WgradTile {
  int tap, dy, dx, c0, co0, split, p_begin, p_end, steps;

  __device__ WgradTile(int c, int co_tile, int m_total, int pixels_per_split,
                       int depth) {
    const int c_blocks = (c + kWgradRows - 1) / kWgradRows;
    tap = blockIdx.x / c_blocks;
    c0 = (blockIdx.x - tap * c_blocks) * kWgradRows;
    dy = tap / 3;
    dx = tap - 3 * dy;
    co0 = blockIdx.y * co_tile;
    split = blockIdx.z;
    p_begin = split * pixels_per_split;
    p_end = static_cast<int>(min(static_cast<int64_t>(m_total),
                                 static_cast<int64_t>(p_begin) + pixels_per_split));
    steps = p_end > p_begin ? (p_end - p_begin + depth - 1) / depth : 0;
  }

  // This block's partial tile: partial[split][tap][c0..][co0..] of the
  // padded [S, 9, cpad, copad] scratch.
  __device__ float* out(float* partial, int cpad, int copad) const {
    return partial +
           ((static_cast<int64_t>(split) * 9 + tap) * cpad + c0) * copad + co0;
  }
};

// Weight gradient partials, bf16 on the tensor cores. Block: kWgradRows
// channels x BN output channels; 8 warps as 2 (channels) x 4 (output
// channels), 32 x BN/4 each.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                float* __restrict__ partial, int n, int h, int w, int c,
                int co, int cpad, int copad, int pixels_per_split) {
  using Stage = WgradStage<bf16, BN, VEC>;
  constexpr int kDepth = Stage::kDepth;
  constexpr int kLdA = kWgradRows + 8;
  constexpr int kLdB = BN + 8;
  constexpr int kWarpCols = BN / 4;
  constexpr int kFn = kWarpCols / 16;
  __shared__ __align__(128) bf16 As[kDepth * kLdA];  // As[pixel][channel]
  __shared__ __align__(128) bf16 Bs[kDepth * kLdB];  // Bs[pixel][co]

  const WgradTile t(c, BN, n * h * w, pixels_per_split, kDepth);
  const int warp = threadIdx.x / 32;
  const int wm = warp % 2;
  const int wn = warp / 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFn];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFn; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  if (t.steps > 0)
    st.load(x, g, t.p_begin, t.p_end, t.dy, t.dx, t.c0, t.co0, h, w, c, co);
  for (int s = 0; s < t.steps; ++s) {
#pragma unroll
    for (int i = 0; i < Stage::kA; ++i)
      *reinterpret_cast<uint4*>(&As[st.a_row[i] * kLdA + st.a_col[i]]) =
          st.a[i];
#pragma unroll
    for (int i = 0; i < Stage::kB; ++i)
      *reinterpret_cast<uint4*>(&Bs[st.b_row[i] * kLdB + st.b_col[i]]) =
          st.b[i];
    __syncthreads();
    if (s + 1 < t.steps)
      st.load(x, g, t.p_begin + (s + 1) * kDepth, t.p_end, t.dy, t.dx, t.c0,
              t.co0, h, w, c, co);
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      // A^T sits pixel-major in As, so it is read as a column-major A.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[kFn];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk * kLdA + wm * 32 + i * 16],
                               kLdA);
#pragma unroll
      for (int j = 0; j < kFn; ++j)
        wmma::load_matrix_sync(fb[j],
                               &Bs[kk * kLdB + wn * kWarpCols + j * 16],
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kFn; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The scratch is padded to whole tiles, so the store needs no mask.
  float* out = t.out(partial, cpad, copad);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFn; ++j)
      wmma::store_matrix_sync(
          out + static_cast<int64_t>(wm * 32 + i * 16) * copad +
              wn * kWarpCols + j * 16,
          acc[i][j], copad, wmma::mem_row_major);
}

// Weight gradient partials, fp32 on the CUDA cores. Block: kWgradRows
// channels x BN output channels; 16 x 16 threads, 4 x BN/16 each.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_f32(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ partial, int n, int h, int w, int c,
               int co, int cpad, int copad, int pixels_per_split) {
  using Stage = WgradStage<float, BN, VEC>;
  constexpr int kDepth = Stage::kDepth;
  constexpr int kLdA = kWgradRows + 4;
  constexpr int kLdB = BN + 4;
  constexpr int kTn = BN / 16;
  __shared__ __align__(16) float As[kDepth * kLdA];  // As[pixel][channel]
  __shared__ __align__(16) float Bs[kDepth * kLdB];  // Bs[pixel][co]

  const WgradTile t(c, BN, n * h * w, pixels_per_split, kDepth);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[4][kTn];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;

  Stage st;
  if (t.steps > 0)
    st.load(x, g, t.p_begin, t.p_end, t.dy, t.dx, t.c0, t.co0, h, w, c, co);
  for (int s = 0; s < t.steps; ++s) {
#pragma unroll
    for (int i = 0; i < Stage::kA; ++i)
      *reinterpret_cast<uint4*>(&As[st.a_row[i] * kLdA + st.a_col[i]]) =
          st.a[i];
#pragma unroll
    for (int i = 0; i < Stage::kB; ++i)
      *reinterpret_cast<uint4*>(&Bs[st.b_row[i] * kLdB + st.b_col[i]]) =
          st.b[i];
    __syncthreads();
    if (s + 1 < t.steps)
      st.load(x, g, t.p_begin + (s + 1) * kDepth, t.p_end, t.dy, t.dx, t.c0,
              t.co0, h, w, c, co);
#pragma unroll
    for (int p = 0; p < kDepth; ++p) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[p * kLdA + ty * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      float bv[kTn];
#pragma unroll
      for (int q = 0; q < kTn / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            &Bs[p * kLdB + tx * kTn + 4 * q]);
        bv[4 * q] = b4.x;
        bv[4 * q + 1] = b4.y;
        bv[4 * q + 2] = b4.z;
        bv[4 * q + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = t.out(partial, cpad, copad);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j)
      out[static_cast<int64_t>(ty * 4 + i) * copad + tx * kTn + j] = acc[i][j];
}

// dW[tap, ch, col] = sum over s = 0..S-1, in that order, of the partials.
__global__ void __launch_bounds__(kReduceThreads)
wgrad_reduce(const float* __restrict__ partial, float* __restrict__ out,
             int c, int co, int cpad, int copad, int splits) {
  const int total = 9 * c * co;
  const int64_t slice = static_cast<int64_t>(9) * cpad * copad;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int k = idx / co;
    const int col = idx - k * co;
    const int tap = k / c;
    const int ch = k - tap * c;
    const float* p =
        partial + (static_cast<int64_t>(tap) * cpad + ch) * copad + col;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += p[s * slice];
    out[idx] = sum;
  }
}

template <typename T, int BN, bool VEC>
void launch_fwd(const void* x, const void* w2, void* y, int n, int h, int w,
                int c, int co, cudaStream_t stream) {
  const int m_total = n * h * w;
  const dim3 grid((m_total + kFwdRows - 1) / kFwdRows, (co + BN - 1) / BN);
  if constexpr (std::is_same<T, bf16>::value)
    conv_fwd_bf16<BN, VEC><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w2),
        static_cast<bf16*>(y), n, h, w, c, co);
  else
    conv_fwd_f32<BN, VEC><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w2),
        static_cast<float*>(y), n, h, w, c, co);
}

template <typename T>
void dispatch_fwd(const void* x, const void* w2, void* y, int n, int h,
                  int w, int c, int co, cudaStream_t stream) {
  constexpr int kChunk = Elems<T>::kChunk;
  const bool vec = c % kChunk == 0 && co % kChunk == 0 && aligned16(x) &&
                   aligned16(w2) && aligned16(y);
  if (tile_cols(co) == 64) {
    if (vec) launch_fwd<T, 64, true>(x, w2, y, n, h, w, c, co, stream);
    else launch_fwd<T, 64, false>(x, w2, y, n, h, w, c, co, stream);
  } else {
    if (vec) launch_fwd<T, 128, true>(x, w2, y, n, h, w, c, co, stream);
    else launch_fwd<T, 128, false>(x, w2, y, n, h, w, c, co, stream);
  }
}

template <typename T, int BN, bool VEC>
void launch_wgrad(const void* x, const void* g, float* partial, int n, int h,
                  int w, int c, int co, int cpad, int copad, int splits,
                  int pixels_per_split, cudaStream_t stream) {
  const dim3 grid(9 * ((c + kWgradRows - 1) / kWgradRows),
                  (co + BN - 1) / BN, splits);
  if constexpr (std::is_same<T, bf16>::value)
    conv_wgrad_bf16<BN, VEC><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, n,
        h, w, c, co, cpad, copad, pixels_per_split);
  else
    conv_wgrad_f32<BN, VEC><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), partial,
        n, h, w, c, co, cpad, copad, pixels_per_split);
}

template <typename T>
void dispatch_wgrad(const void* x, const void* g, float* partial, int n,
                    int h, int w, int c, int co, int cpad, int copad,
                    int splits, int pixels_per_split, cudaStream_t stream) {
  constexpr int kChunk = Elems<T>::kChunk;
  const bool vec =
      c % kChunk == 0 && co % kChunk == 0 && aligned16(x) && aligned16(g);
  if (tile_cols(co) == 64) {
    if (vec)
      launch_wgrad<T, 64, true>(x, g, partial, n, h, w, c, co, cpad, copad,
                                splits, pixels_per_split, stream);
    else
      launch_wgrad<T, 64, false>(x, g, partial, n, h, w, c, co, cpad, copad,
                                 splits, pixels_per_split, stream);
  } else {
    if (vec)
      launch_wgrad<T, 128, true>(x, g, partial, n, h, w, c, co, cpad, copad,
                                 splits, pixels_per_split, stream);
    else
      launch_wgrad<T, 128, false>(x, g, partial, n, h, w, c, co, cpad, copad,
                                  splits, pixels_per_split, stream);
  }
}

bool shape_ok(int n, int h, int w, int c, int co) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || co <= 0) return false;
  const int64_t pixels = static_cast<int64_t>(n) * h * w;
  const int64_t widest = c > co ? c : co;
  // Pixel indices and their tile overhangs stay in int.
  return pixels <= (1 << 30) && pixels * widest <= INT32_MAX &&
         static_cast<int64_t>(9) * c * co <= INT32_MAX;
}

}  // namespace

extern "C" {

// y [n, h, w, co] = conv3x3(x [n, h, w, c], w2 [9c, co]), all of one dtype:
// fp32 (is_bf16 == 0) or bf16, contiguous. Returns the cudaError_t of the
// launch (0 on success); nothing is synchronised.
int conv3x3_fwd(const void* x, const void* w2, void* y, int is_bf16, int n,
                int h, int w, int c, int co, void* stream) {
  if (!shape_ok(n, h, w, c, co)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dispatch_fwd<bf16>(x, w2, y, n, h, w, c, co, s);
  else
    dispatch_fwd<float>(x, w2, y, n, h, w, c, co, s);
  return static_cast<int>(cudaGetLastError());
}

// Floats of fp32 scratch that conv3x3_wgrad needs for `splits` splits.
long long conv3x3_wgrad_scratch(int c, int co, int splits) {
  return static_cast<long long>(splits) * 9 * round_up(c, kWgradRows) *
         round_up(co, tile_cols(co));
}

// out [9c, co] fp32 = im2col(x)^T @ g for x [n, h, w, c] and g [n, h, w, co]
// of one dtype (fp32 or bf16), contiguous. Pixel range s of
// [s * pixels_per_split, (s + 1) * pixels_per_split) goes to its own
// partial in `partial` (conv3x3_wgrad_scratch floats); the partials are
// then summed in order. Returns the cudaError_t of the launches.
int conv3x3_wgrad(const void* x, const void* g, float* partial,
                  long long partial_floats, float* out, int is_bf16, int n,
                  int h, int w, int c, int co, int splits,
                  int pixels_per_split, void* stream) {
  if (!shape_ok(n, h, w, c, co) || splits <= 0 || splits > 65535 ||
      pixels_per_split <= 0 ||
      static_cast<int64_t>(splits) * pixels_per_split <
          static_cast<int64_t>(n) * h * w ||
      static_cast<int64_t>(splits - 1) * pixels_per_split >=
          static_cast<int64_t>(n) * h * w ||
      partial_floats < conv3x3_wgrad_scratch(c, co, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpad = static_cast<int>(round_up(c, kWgradRows));
  const int copad = static_cast<int>(round_up(co, tile_cols(co)));
  if (is_bf16)
    dispatch_wgrad<bf16>(x, g, partial, n, h, w, c, co, cpad, copad, splits,
                         pixels_per_split, s);
  else
    dispatch_wgrad<float>(x, g, partial, n, h, w, c, co, cpad, copad, splits,
                          pixels_per_split, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = 9 * c * co;
  int blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > kMaxReduceBlocks) blocks = kMaxReduceBlocks;
  wgrad_reduce<<<blocks, kReduceThreads, 0, s>>>(partial, out, c, co, cpad,
                                                 copad, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

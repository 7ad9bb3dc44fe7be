// 3x3 stride-1 "same" convolution, channels last, for Hopper (sm_90a): the
// forward (which the data gradient reuses) and the weight gradient, as
// implicit GEMMs.
//
// Replaces the Pallas TPU kernels of experiments/pallas_conv3x3.py:
// * conv3x3_pallas (pallas_call at :94, body _conv_kernel at :33), which
//   conv3x3_dgrad_pallas (:194) reuses with the weights rotated and
//   io-transposed: conv3x3_fwd below, whose bf16 route for C, Co % 8 == 0
//   with weights that fit in shared memory is the wgmma kernel
//   conv_fwd_wgmma;
// * conv3x3_wgrad_pallas (pallas_call at :162, body _wgrad_kernel at :126):
//   conv3x3_wgrad below, whose bf16 route for C, Co % 8 == 0 is the
//   wgmma kernel conv_wgrad_wgmma.
//
// With A = im2col(x) [M, 9C] (M = N*H*W output pixels; columns in the JAX
// w.reshape(9C, Co) order: dy, then dx, then channel) the forward is
// y = A @ W [M, Co] and the weight gradient is dW = A^T @ G [9C, Co].
//
// Bound: operations. At the probe's bench shape, x [480,56,56,64] -> 128
// in bf16, each kernel does 2*1505280*576*128 = 2.22e11 FLOP: 0.2244 ms at
// the H100 SXM's 989 TFLOP/s dense bf16, against 0.173 ms for the 578 MB
// that the forward must move at 3.35 TB/s. In fp32 (FMAs on the CUDA
// cores, no TF32) the same FLOP take 3.31 ms at 67 TFLOP/s.
//
// conv_fwd_wgmma<BN>, the bf16 forward (and data gradient) for C and Co
// multiples of 8, 16-byte aligned tensors and 9 * ceil(C / 64) * 64 * BN
// bf16 weights that fit in shared memory beside the ring (BN = 64 for
// Co <= 64, else 128; the wrapper picks it by shape, other bf16 shapes take
// conv_fwd_bf16, fp32 conv_fwd_f32). The bench shape's 578 MB (x 193 MB,
// y 385 MB) take 0.173 ms, near the 0.2244 ms of its operations, so the
// output stores have to overlap the products:
// * Persistent blocks, one per SM. The block's BN columns of all 9 * C
//   weight rows (144 KB at both bench shapes) stay in shared memory, read
//   once per block (132 x 147 KB of L2 reads per call, where re-reading
//   them per tile would take 1.7 GB).
// * Its two warpgroups work apart, each on its own 64-pixel x BN tiles with
//   its own ring, so one's epilogue runs while the other's products keep
//   the tensor cores busy (they fall out of step by themselves: holding
//   one a stage behind the other timed the same).
// * A ring of 3 halo tiles per warpgroup, one per (dy, 64-channel slice):
//   the tile's 64 pixels shifted by dy rows, plus one pixel on each side,
//   one TMA copy of consecutive rows of x (zero outside the tensor). The
//   three dx taps read it at row offsets 0, 1, 2: each thread loads its
//   wgmma A operand into registers with ldmatrix (K-major, as a pixel's
//   channels are), and a tap that falls off the image reads a zeroed row
//   instead. So x is read 3 times from L2 (0.6 GB), not 9 times, and no dx
//   tile is rebuilt in shared memory, as conv_wgrad_wgmma's are.
// * wgmma.m64n{BN}k16 (A registers, B the resident weights), three groups
//   of 4 in flight, one group per dx. A tile's first product starts its
//   sums (accumulate = 0), and the epilogue reads the accumulators only
//   once the products have drained: ptxas serializes every wgmma of a
//   kernel in which other instructions write or read accumulators that
//   wgmma has in flight.
// * The epilogue writes the tile, bf16, by stmatrix into the staging tile
//   and one TMA store per 64 channels: whole lines, clipped at M and Co.
//   Per-lane stores (4 or 16 bytes) of the fragments reached only 1 TB/s.
//
// conv_wgrad_wgmma, the bf16 weight gradient for C and Co multiples of 8
// with 16-byte aligned tensors (the wrapper picks it by shape; the other
// bf16 shapes take conv_wgrad_bf16, fp32 takes conv_wgrad_f32):
// * Block: one tap row dy, 64 channels of C, 128 of Co and one pixel range
//   (split). Three consumer warpgroups, one for each dx, each hold a 64x128
//   fp32 accumulator and issue wgmma.m64n128k16 (bf16 in, fp32 out) with
//   both operands in shared memory. The reduction runs over pixels, so
//   both are MN-major (transposed) tiles in the 128-byte swizzle.
// * A ring of 4 stages in dynamic shared memory (173 KB), 3 slices of
//   copies in flight. A stage is 64 pixels: the g tile (64 x 128, 16 KB),
//   read by all three warpgroups, and one x tile of the 64 pixels shifted
//   by dy, with a halo row on each side (66 x 64). Every 16-byte chunk is a
//   cp.async that zero-fills on the image's top and bottom border, past
//   the split's pixels (g) or the last pixel (x), and past C or Co. So each
//   block reads its pixels of x and g once from L2: 3x their size in all
//   (1.75 GB at the bench shape), where the previous design read them for
//   each of the 9 taps (5.2 GB). Gathering one x tile per dx and counting
//   on L1 for the overlap measured no L1 hits (cp.async .ca timed as .cg).
// * The dx = 1 tile is the halo tile itself. The dx = 0 and dx = 2 tiles
//   are built from its rows r - 1 and r + 1 by shared-memory copies, zero
//   where pixel r is the first or last of its image row, while the tensor
//   cores work on the previous slice: a one-row shift cannot be a
//   descriptor offset, since the swizzle and the border both differ per dx.
// * Split-K with no atomics: S ranges of pixels, S from the shape alone
//   (3 * S blocks fill the 132 SMs in one wave at the bench shape: S = 44,
//   13 MB of partials), summed in order by wgrad_reduce.
//
// Design of the other kernels (right and simple first; wgmma, TMA and a
// producer/consumer ring are later work):
// * x is read in place: the JAX wrapper pads x with jnp.pad (a full copy
//   of the activation on every call); here the gather masks the 1-pixel
//   border. Ragged M, K and Co are masked or zero-filled, so any C and Co
//   work (the probe's small check shape has C = 8, K = 72).
// * The reduction walks the 9 taps, then slices of C, so each row of the
//   A tile is a run of contiguous channels of one source pixel: 16-byte
//   loads when C and Co are multiples of 16 bytes and the pointers are
//   16-byte aligned, element loads otherwise.
// * bf16 runs on the tensor cores through nvcuda::wmma (16x16x16, fp32
//   accumulate), fp32 as FMAs on the CUDA cores in full fp32 (wgmma has no
//   fp32 input; TF32 would change the numbers).
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

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// Weight gradient partials, bf16 on wgmma (see the header). Tiles are 64
// pixel rows x 128 bytes in the 128-byte swizzle: 16-byte chunk q of row r
// at r * 128 + (q ^ r % 8) * 16 from a 1024-byte aligned base. A stage
// holds g's columns co0.. and co0 + 64.. (kWgG, two tiles), x's channels
// c0.. at the pixels of the slice shifted by dy (kWgX1: the dx = 1 tile,
// with one halo row on each side, the pixels before and after the slice),
// and the dx = 0 and dx = 2 tiles built from it (kWgX0, kWgX2).

constexpr int kWgSlice = 64;     // pixels per stage: 4 wgmma k-steps of 16
constexpr int kWgStages = 4;
constexpr int kWgAhead = 3;      // slices whose copies are in flight
constexpr int kWgThreads = 384;  // three warpgroups, one per dx
constexpr int kWgCols = 128;     // output channels per block: wgmma N
constexpr int kWgTileBytes = kWgSlice * 128;
constexpr int kWgG = 0;
constexpr int kWgX1 = 2 * kWgTileBytes + 1024;  // halo row -1 at kWgX1 - 128
constexpr int kWgX0 = kWgX1 + kWgTileBytes + 1024;  // room for halo row 64
constexpr int kWgX2 = kWgX0 + kWgTileBytes;
constexpr int kWgStageBytes = kWgX2 + kWgTileBytes;
constexpr int kWgSmemBytes = kWgStages * kWgStageBytes + 1024;  // + align
constexpr int kWgRows = 4;  // rows of a tile that one thread copies
static_assert(kWgAhead + 1 <= kWgStages, "a stage for the slice in use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of chunk q of row r (r may be -1 or 64: the halo rows) in a
// swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int q) {
  return r * 128 + ((q ^ (r & 7)) << 4);
}

// 16 bytes from global to shared, or 16 zeros where !full; through L2 only
// (every block reads its x and g once).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes (cp.async lands through the
// generic proxy) visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of an MN-major operand in the 128-byte
// swizzle: 64 elements of M (or N) per 128-byte row, one row per k; the
// next 8 rows of k sit 1024 bytes on (stride byte offset), the next 64
// columns of N one tile (kWgTileBytes) on (leading byte offset).
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(kWgTileBytes >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16 in, fp32 accumulators in the
// wgmma fragment layout; A and B both MN-major (transpose bits set).
__device__ __forceinline__ void wgmma_m64n128k16_tt(float (&d)[64],
                                                    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// blockIdx.x = (dy * co_blocks + output-channel block) * c_blocks +
// channel block, blockIdx.y = split: the blocks that read the same pixels
// are neighbours in launch order.
__global__ void __launch_bounds__(kWgThreads, 1)
conv_wgrad_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 float* __restrict__ partial, int n, int h, int w, int c,
                 int co, int cpad, int copad, int pixels_per_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int c_blocks = (c + kWgradRows - 1) / kWgradRows;
  const int co_blocks = (co + kWgCols - 1) / kWgCols;
  const int c0 = (blockIdx.x % c_blocks) * kWgradRows;
  const int co0 = (blockIdx.x / c_blocks % co_blocks) * kWgCols;
  const int dy = blockIdx.x / (c_blocks * co_blocks);
  const int split = blockIdx.y;
  const int m_total = n * h * w;
  const int p_begin = split * pixels_per_split;
  const int p_end = static_cast<int>(
      min(static_cast<int64_t>(m_total),
          static_cast<int64_t>(p_begin) + pixels_per_split));
  const int steps =
      p_end > p_begin ? (p_end - p_begin + kWgSlice - 1) / kWgSlice : 0;

  // Copies: thread t of warpgroup 0 or 1 copies chunk q of rows r0 + 16 i
  // (i < kWgRows) of g tile dx, and of warpgroup 2 the same chunks of the
  // x tile (rows 0..63 of kWgX1); its threads t < 16 also copy halo row -1
  // (t < 8) or 64. A row's pixel is tracked as (hh, ww) from slice to
  // slice, so the loop divides nothing.
  const int dx = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int q = t % 8;
  const int r0 = t / 8;
  const int halo = t < 8 ? -1 : kWgSlice;  // for t < 16 of warpgroup 2
  const int64_t x_shift =
      static_cast<int64_t>(dy - 1) * w * c + c0 + 8 * q;
  const bool x_cols = c0 + 8 * q < c;
  const int g_col = co0 + 64 * dx + 8 * q;
  const bool g_cols = dx < 2 && g_col < co;
  const int step_w = kWgSlice % w;
  const int step_h = (kWgSlice / w) % h;
  // (hh, ww) of pixel p, or of the last pixel of the image for p = -1.
  auto coords = [&](int p, int& hh, int& ww) {
    const int row = p < 0 ? h - 1 : p / w;
    ww = p < 0 ? w - 1 : p - row * w;
    hh = row % h;
  };
  auto advance = [&](int& hh, int& ww) {
    ww += step_w;
    hh += step_h;
    if (ww >= w) {
      ww -= w;
      ++hh;
    }
    if (hh >= h) hh -= h;
  };
  int hh[kWgRows + 1], ww[kWgRows + 1];  // [kWgRows]: the halo row
#pragma unroll
  for (int i = 0; i < kWgRows; ++i)
    coords(p_begin + r0 + 16 * i, hh[i], ww[i]);
  coords(p_begin + halo, hh[kWgRows], ww[kWgRows]);

  // x at pixel p shifted by dy (column dx = 1): zero on the border rows of
  // the image and past its last pixel.
  auto copy_x = [&](uint32_t dst, int p, int hh_p) {
    const bool in = p >= 0 && p < m_total && x_cols &&
                    static_cast<unsigned>(hh_p + dy - 1) <
                        static_cast<unsigned>(h);
    cp_async16(dst, in ? x + (static_cast<int64_t>(p) * c + x_shift) : x,
               in);
  };
  auto issue = [&](int slice) {
    const uint32_t stage = smem + (slice % kWgStages) * kWgStageBytes;
    const int pb = p_begin + slice * kWgSlice;
    if (dx < 2) {
#pragma unroll
      for (int i = 0; i < kWgRows; ++i) {
        const int p = pb + r0 + 16 * i;
        const bool in = p < p_end && g_cols;
        cp_async16(stage + kWgG + dx * kWgTileBytes + swizzled(r0 + 16 * i, q),
                   in ? g + (static_cast<int64_t>(p) * co + g_col) : g, in);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kWgRows; ++i) {
      copy_x(stage + kWgX1 + swizzled(r0 + 16 * i, q), pb + r0 + 16 * i,
             hh[i]);
      advance(hh[i], ww[i]);
    }
    if (t < 16) {
      copy_x(stage + kWgX1 + swizzled(halo, q), pb + halo, hh[kWgRows]);
      advance(hh[kWgRows], ww[kWgRows]);
    }
  };

  // The dx = 0 and dx = 2 tiles of a slice, from its kWgX1 rows r - 1 and
  // r + 1: zero where pixel r is the first (dx = 0) or last (dx = 2) of
  // its image row. Thread v builds chunk v % 8 of rows v / 8 + 48 i, and
  // tracks the column bw of each.
  constexpr int kBuildRows = (kWgSlice * 8 + kWgThreads - 1) / kWgThreads;
  const int bq = threadIdx.x % 8;
  const int br = threadIdx.x / 8;
  int bw[kBuildRows];
#pragma unroll
  for (int i = 0; i < kBuildRows; ++i) bw[i] = (p_begin + br + 48 * i) % w;
  auto build = [&](int slice) {
    const uint32_t stage = smem + (slice % kWgStages) * kWgStageBytes;
#pragma unroll
    for (int i = 0; i < kBuildRows; ++i) {
      const int r = br + 48 * i;
      if (r < kWgSlice) {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        const uint4 left = ld_shared16(stage + kWgX1 + swizzled(r - 1, bq));
        const uint4 right = ld_shared16(stage + kWgX1 + swizzled(r + 1, bq));
        st_shared16(stage + kWgX0 + swizzled(r, bq), bw[i] == 0 ? zero : left);
        st_shared16(stage + kWgX2 + swizzled(r, bq),
                    bw[i] == w - 1 ? zero : right);
      }
      bw[i] += step_w;
      if (bw[i] >= w) bw[i] -= w;
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int s = 0; s < kWgAhead; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  if (steps > 0) {
    cp_async_wait<kWgAhead - 1>();
    __syncthreads();
    build(0);
  }
  const uint32_t a_tile = dx == 0 ? kWgX0 : dx == 1 ? kWgX1 : kWgX2;
  for (int s = 0; s < steps; ++s) {
    // Slices s and s + 1 have landed for every thread, slice s's dx tiles
    // are built, and every warpgroup is done with slice s - 1, whose stage
    // the copies of slice s + kWgAhead overwrite.
    cp_async_wait<kWgAhead - 2>();
    fence_proxy_async();
    __syncthreads();

    const uint32_t stage = smem + (s % kWgStages) * kWgStageBytes;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWgSlice / 16; ++k)
      wgmma_m64n128k16_tt(acc, desc_mn_sw128(stage + a_tile + k * 2048),
                          desc_mn_sw128(stage + kWgG + k * 2048));
    wgmma_commit();
    // While the tensor cores work: the copies of slice s + kWgAhead, and
    // the dx tiles of slice s + 1.
    if (s + kWgAhead < steps) issue(s + kWgAhead);
    cp_async_commit();
    if (s + 1 < steps) build(s + 1);
    wgmma_wait<0>();
    fence_operands(acc);
  }

  // Fragment layout: warp v of the warpgroup holds rows 16 v + lane / 4
  // (+ 8); acc[4 j + 2 half + e] is column 8 j + 2 (lane % 4) + e. Rows
  // past C and columns past Co are not stored (and never read).
  const int lane = t % 32;
  const int row0 = (t / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float* out = partial +
               ((static_cast<int64_t>(split) * 9 + dy * 3 + dx) * cpad + c0) *
                   copad + co0;
#pragma unroll
  for (int j = 0; j < kWgCols / 8; ++j) {
    const int col = 8 * j + col0;
    if (co0 + col >= co) continue;  // co is even: col + 1 < co too
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (c0 + row < c)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * copad +
                                   col) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward, bf16 on wgmma (see the header): conv_fwd_wgmma<BN>.
//
// Shared memory, from a 1024-byte aligned base:
// * B: the block's BN columns of w2 for the whole reduction, resident for
//   the kernel's life. Rows are k = tap * c_pad + channel (c_pad: C rounded
//   up to 64, zero rows past C), in 64-row blocks of BN * 128 bytes; a block
//   holds BN / 64 MN-major tiles of 64 k-rows x 64 columns in the 128-byte
//   swizzle (desc_mn_sw128: the next 64 columns kWgTileBytes on, a k-step
//   2 KB on), zero past Co.
// * For each warpgroup, its output tile (64 x BN bf16 in BN / 64 boxes of
//   64 x 64 in the 128-byte swizzle), which one TMA store per box takes to
//   y, and a ring of kFwdStages halo tiles with an mbarrier each. Stage (dy,
//   channel slice cs) of a tile at pixel m0 holds the flat pixel rows m0 - 1
//   + (dy - 1) * W + j, j < kFwdHaloRows, channels cs * 64.. (128 bytes in
//   the 128-byte swizzle), zero outside [0, M) and past C: one TMA copy of a
//   box of consecutive rows of x.
// * One 128-byte row of zeros.
// Output row r of the tile takes tap (dy, dx) from halo row r + dx, or from
// the zero row where that tap falls off the image (a border in h or w, or r
// past M). Each thread loads its wgmma A fragments (registers, K-major)
// with ldmatrix from those rows, so the three dx taps share one copy and
// every border zero is an address.
constexpr int kFwdTile = 64;  // output pixels per tile: one warpgroup's
constexpr int kFwdThreads = 256;  // two warpgroups
constexpr int kFwdStages = 3;  // halo stages in each warpgroup's ring
constexpr int kFwdAhead = 2;  // stages whose copies are in flight
constexpr int kFwdHaloRows = kFwdTile + 2;
constexpr int kFwdStageBytes = kFwdHaloRows * 128;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
static_assert(kFwdAhead + 1 <= kFwdStages, "a stage for the slice in use");

// Dynamic shared memory of conv_fwd_wgmma for C -> Co channels.
inline int64_t fwd_wgmma_smem(int c, int co) {
  return 1024 + static_cast<int64_t>(9) * round_up(c, 64) * tile_cols(co) * 2 +
         2 * tile_cols(co) * 128 + 2 * kFwdStages * kFwdStageBytes + 128 +
         2 * kFwdStages * 8;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same for registers that wgmma reads (its A fragments).
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x BN] = A[64 x 16] B[16 x BN] (+ d if accumulate): A from registers
// (the fragment of mma.m16n8k16 for each warp's 16 rows), B an MN-major
// shared-memory tile (transpose bit set), bf16 in, fp32 accumulators.
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// A box of the tensor that `map` describes, from shared memory at src, to
// coordinates (x0, x1), innermost first; the copy engine leaves out what
// falls past the tensor's bounds.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int x0, int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x0), "r"(x1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until this thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A box of the tensor that `map` describes, at coordinates (x0, x1)
// (innermost first; may lie partly outside the tensor, which reads as
// zeros), into shared memory at dst; its bytes complete bar's phase.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x0, int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Persistent: block b owns output-channel block b % co_blocks. Its two
// warpgroups work apart, each on its own 64-pixel tiles (worker 2 (b /
// co_blocks) + wg walks tiles worker, + 2 gridDim.x / co_blocks, ...) with
// its own ring of halo stages and its own named barrier: while one drains
// its products and stores a tile, the other's products keep the tensor
// cores busy. A warpgroup's stages run on across its tiles (3 * c_pad / 64
// per tile: dy, then channel slice), so the copies of its next tile's first
// stages are in flight during a tile's last products and its epilogue. No
// split: each output sums its taps in one fixed order, so repeats are
// bit-identical.
template <int BN>
__global__ void __launch_bounds__(kFwdThreads, 1)
conv_fwd_wgmma(const __grid_constant__ CUtensorMap x_map,
               const bf16* __restrict__ w2,
               const __grid_constant__ CUtensorMap y_map, int n, int h,
               int w, int c, int co) {
  constexpr int kAcc = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int c_slices = (c + 63) / 64;
  const int b_bytes = 9 * c_slices * BN * 128;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t128 = tid % 128;
  const int lane = tid % 32;
  // The warpgroup's output tile, 64 rows x BN in BN / 64 boxes of 64 x 64
  // in the 128-byte swizzle, on its way to y.
  const uint32_t staging = smem + b_bytes + wg * BN * 128;
  const uint32_t ring =
      smem + b_bytes + 2 * BN * 128 + wg * kFwdStages * kFwdStageBytes;
  const uint32_t zero_row =
      smem + b_bytes + 2 * BN * 128 + 2 * kFwdStages * kFwdStageBytes;
  // One mbarrier for each stage of the warpgroup's ring: its halo tile has
  // landed.
  const uint32_t full = zero_row + 128 + wg * kFwdStages * 8;

  const int m_total = n * h * w;
  const int m_tiles = (m_total + kFwdTile - 1) / kFwdTile;
  const int co_blocks = (co + BN - 1) / BN;
  const int co0 = (blockIdx.x % co_blocks) * BN;
  const int workers = 2 * (gridDim.x / co_blocks);
  const int worker = 2 * (blockIdx.x / co_blocks) + wg;
  const int per_tile = 3 * c_slices;
  const int my_tiles =
      worker < m_tiles ? (m_tiles - worker + workers - 1) / workers : 0;
  const int total = my_tiles * per_tile;
  auto tile_m0 = [&](int t) { return (worker + t * workers) * kFwdTile; };

  // The resident weights, by all threads: chunk v is column chunk q of
  // k-row r of 64-row block kb (tap, slice) in column tile a. They land,
  // and are made visible to wgmma, before either warpgroup starts.
  if (tid < 8) st_shared16(zero_row + tid * 16, make_uint4(0u, 0u, 0u, 0u));
  if (tid == 0) {
    for (int i = 0; i < 2 * kFwdStages; ++i)
      mbar_init(zero_row + 128 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int v = tid; v < b_bytes / 16; v += kFwdThreads) {
    const int q = v % 8;
    const int r = v / 8 % 64;
    const int a = v / 512 % (BN / 64);
    const int kb = v / (8 * BN);
    const int tap = kb / c_slices;
    const int ch = (kb - tap * c_slices) * 64 + r;
    const int col = co0 + a * 64 + 8 * q;
    const bool in = ch < c && col < co;
    cp_async16(smem + kb * (BN * 128) + a * kWgTileBytes + swizzled(r, q),
               in ? w2 + (static_cast<int64_t>(tap) * c + ch) * co + col : w2,
               in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // Stage s of the warpgroup: the halo rows tile_m0 - 1 + (dy - 1) * W ..
  // + 65, channels cs * 64 .., one TMA copy that one thread issues; rows
  // outside [0, M) and channels past C read as zeros.
  const bool producer = t128 == 0;
  auto issue = [&](int s) {
    const int t_idx = s / per_tile;
    const int rem = s - t_idx * per_tile;
    const int dy = rem / c_slices;
    const int slot = s % kFwdStages;
    mbar_expect_tx(full + 8 * slot, kFwdStageBytes);
    tma_load_2d(ring + slot * kFwdStageBytes, &x_map, full + 8 * slot,
                (rem - dy * c_slices) * 64, tile_m0(t_idx) - 1 + (dy - 1) * w);
  };
  if (producer)
    for (int s = 0; s < kFwdAhead && s < total; ++s) issue(s);

  // Lane l of warp v of the warpgroup gives ldmatrix the address of tile
  // row 16 v + l % 8 + 8 (l / 8 % 2), chunk 2 k + l / 16 of k-step k: the
  // four 8x8 matrices of the fragment.
  const int my_row = (t128 / 32) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_half = lane >> 4;
  int ok_dy = 0, ok_dx = 0;  // bit d: tap dy (dx) = d stays on the image
  uint32_t a[3][4][4];  // [dx][k-step][fragment register]

  // The products of stage s into acc: three groups of 4, one per dx. Each
  // tile starts its sums with accumulate = 0, so no instruction but wgmma
  // writes the accumulators: ptxas serializes every wgmma otherwise.
  auto products = [&](float (&acc)[kAcc], int s) {
    // The whole warpgroup is done reading stage s - 1, whose slot the copy
    // of s + kFwdAhead takes; then stage s has landed.
    named_bar_sync(1 + wg, 128);
    if (producer && s + kFwdAhead < total) issue(s + kFwdAhead);
    mbar_wait(full + 8 * (s % kFwdStages), s / kFwdStages & 1);

    const int rem = s % per_tile;
    const int dy = rem / c_slices;
    const int cs = rem - dy * c_slices;
    if (rem == 0) {
      const int p = tile_m0(s / per_tile) + my_row;
      const int pw = p % w;
      const int ph = p / w % h;
      ok_dy = p < m_total ? (ph > 0) | 2 | (ph < h - 1) << 2 : 0;
      ok_dx = (pw > 0) | 2 | (pw < w - 1) << 2;
    }
    const uint32_t stage = ring + (s % kFwdStages) * kFwdStageBytes;
    const bool row_dy = (ok_dy >> dy) & 1;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      // The products that last read a[dx] (three groups back) are done.
      wgmma_wait<2>();
      fence_regs(a[dx][0]);
      fence_regs(a[dx][1]);
      fence_regs(a[dx][2]);
      fence_regs(a[dx][3]);
      // The copy engine swizzles by the absolute shared address: chunk q
      // of the 128-byte row at address a lands at chunk q ^ (a / 128 % 8).
      const bool ok = row_dy && ((ok_dx >> dx) & 1);
      const uint32_t row = ok ? stage + (my_row + dx) * 128 : zero_row;
      const int phase = ok ? (row >> 7) & 7 : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ldmatrix_x4(a[dx][k], row + (((2 * k + k_half) ^ phase) << 4));
      fence_operands(acc);
      wgmma_fence();
      const uint32_t b =
          smem + ((dy * 3 + dx) * c_slices + cs) * (BN * 128);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_rs<BN>(acc, a[dx][k], desc_mn_sw128(b + k * 2048),
                     rem > 0 || dx > 0 || k > 0);
      wgmma_commit();
    }
  };

  // Epilogue: stmatrix lane l of warp v addresses row 16 v + 8 (l / 8 % 2)
  // + l % 8 of matrix l / 8, whose columns are chunk j + l / 16.
  const int st_row = (t128 / 32) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int st_chunk = lane >> 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int t = 0; t < my_tiles; ++t) {
    for (int i = 0; i < per_tile; ++i) products(acc, t * per_tile + i);
    // The epilogue reads the accumulators once the products have drained
    // (reading them with products in flight serializes every wgmma too),
    // and writes the staging tile once the previous tile's store has read
    // it. Fragment layout: warp v holds rows 16 v + l / 4 (+ 8); acc[4 j +
    // 2 half + e] is column 8 j + 2 (l % 4) + e.
    wgmma_wait<0>();
    if (t128 == 0) bulk_wait_read();
    named_bar_sync(1 + wg, 128);
    fence_operands(acc);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      const int chunk = j + st_chunk;
      stmatrix_x4(staging + (chunk / 8) * 8192 +
                      swizzled(st_row, chunk % 8),
                  pack_bf16x2(acc[4 * j], acc[4 * j + 1]),
                  pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]),
                  pack_bf16x2(acc[4 * j + 4], acc[4 * j + 5]),
                  pack_bf16x2(acc[4 * j + 6], acc[4 * j + 7]));
    }
    fence_proxy_async();  // the staging tile, for the copy engine
    named_bar_sync(1 + wg, 128);
    if (t128 == 0) {
#pragma unroll
      for (int box = 0; box < BN / 64; ++box)
        if (co0 + 64 * box < co)
          tma_store_2d(&y_map, staging + box * 8192, co0 + 64 * box,
                       tile_m0(t));
      bulk_commit();
    }
  }
  if (t128 == 0) bulk_wait();
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

template <typename T, bool VEC>
void dispatch_wgrad(const void* x, const void* g, float* partial, int n,
                    int h, int w, int c, int co, int cpad, int copad,
                    int splits, int pixels_per_split, cudaStream_t stream) {
  if (tile_cols(co) == 64)
    launch_wgrad<T, 64, VEC>(x, g, partial, n, h, w, c, co, cpad, copad,
                             splits, pixels_per_split, stream);
  else
    launch_wgrad<T, 128, VEC>(x, g, partial, n, h, w, c, co, cpad, copad,
                              splits, pixels_per_split, stream);
}

cudaError_t launch_wgrad_wgmma(const void* x, const void* g, float* partial,
                               int n, int h, int w, int c, int co, int cpad,
                               int copad, int splits, int pixels_per_split,
                               cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(3 * ((c + kWgradRows - 1) / kWgradRows) *
                      ((co + kWgCols - 1) / kWgCols),
                  splits);
  conv_wgrad_wgmma<<<grid, kWgThreads, kWgSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, n,
      h, w, c, co, cpad, copad, pixels_per_split);
  return cudaGetLastError();
}

// A tensor map of t [m_total, ch] bf16 for conv_fwd_wgmma's TMA copies:
// boxes of box_rows pixels x 64 channels in the 128-byte swizzle (x: the
// halo stages; y: the output tiles). cuTensorMapEncodeTiled is looked up
// through the runtime (cudaGetDriverEntryPoint), so nothing more is linked.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t pixel_map(CUtensorMap* map, const void* t, int m_total, int ch,
                      int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ch),
                              static_cast<cuuint64_t>(m_total)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ch) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(t), dims,
      strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch_fwd_wgmma_bn(const void* x, const void* w2, void* y, int n,
                                int h, int w, int c, int co,
                                cudaStream_t stream) {
  CUtensorMap x_map, y_map;
  cudaError_t e = pixel_map(&x_map, x, n * h * w, c, kFwdHaloRows);
  if (e == cudaSuccess) e = pixel_map(&y_map, y, n * h * w, co, kFwdTile);
  if (e != cudaSuccess) return e;
  const int64_t smem = fwd_wgmma_smem(c, co);
  e = cudaFuncSetAttribute(
      conv_fwd_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  // One block per SM, each warpgroup walking its tiles; warpgroup 0 of
  // every block gets a tile.
  const int m_tiles = (n * h * w + kFwdTile - 1) / kFwdTile;
  const int co_blocks = (co + BN - 1) / BN;
  int per_co = sms / co_blocks;
  if (per_co < 1) per_co = 1;
  if (per_co > (m_tiles + 1) / 2) per_co = (m_tiles + 1) / 2;
  conv_fwd_wgmma<BN><<<per_co * co_blocks, kFwdThreads, smem, stream>>>(
      x_map, static_cast<const bf16*>(w2), y_map, n, h, w, c, co);
  return cudaGetLastError();
}

cudaError_t launch_fwd_wgmma(const void* x, const void* w2, void* y, int n,
                             int h, int w, int c, int co,
                             cudaStream_t stream) {
  return tile_cols(co) == 64
             ? launch_fwd_wgmma_bn<64>(x, w2, y, n, h, w, c, co, stream)
             : launch_fwd_wgmma_bn<128>(x, w2, y, n, h, w, c, co, stream);
}

// The kernels of each function, by its `route` argument (the wrapper's
// ROUTES order).
enum Route { kRouteF32 = 0, kRouteWmma = 1, kRouteWgmma = 2 };

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

// Bytes of dynamic shared memory that the wgmma forward needs for C -> Co
// channels (it takes the shape only if they fit kSmemLimit).
long long conv3x3_fwd_wgmma_smem(int c, int co) {
  return static_cast<long long>(fwd_wgmma_smem(c, co));
}

// y [n, h, w, co] = conv3x3(x [n, h, w, c], w2 [9c, co]), all of one dtype,
// contiguous, through the kernel that `route` names: 0 fp32 (CUDA cores),
// 1 bf16 on wmma (any c and co), 2 bf16 on wgmma (c and co multiples of 8,
// x, w2 and y 16-byte aligned, conv3x3_fwd_wgmma_smem(c, co) within the
// block's limit). Returns the cudaError_t of the launch (0 on success);
// nothing is synchronised.
int conv3x3_fwd(const void* x, const void* w2, void* y, int route, int n,
                int h, int w, int c, int co, void* stream) {
  if (!shape_ok(n, h, w, c, co) || route < kRouteF32 || route > kRouteWgmma ||
      (route == kRouteWgmma &&
       (c % 8 != 0 || co % 8 != 0 || !aligned16(x) || !aligned16(w2) ||
        !aligned16(y) || fwd_wgmma_smem(c, co) > kSmemLimit)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma)
    return static_cast<int>(launch_fwd_wgmma(x, w2, y, n, h, w, c, co, s));
  if (route == kRouteWmma)
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
// of one dtype, contiguous, through the kernel that `route` names: 0 fp32
// (CUDA cores), 1 bf16 on wmma (any c and co), 2 bf16 on wgmma (c and co
// multiples of 8, x and g 16-byte aligned). Pixel range s of
// [s * pixels_per_split, (s + 1) * pixels_per_split) goes to its own
// partial in `partial` (conv3x3_wgrad_scratch floats); the partials are
// then summed in order. Returns the cudaError_t of the launches.
int conv3x3_wgrad(const void* x, const void* g, float* partial,
                  long long partial_floats, float* out, int route, int n,
                  int h, int w, int c, int co, int splits,
                  int pixels_per_split, void* stream) {
  if (!shape_ok(n, h, w, c, co) || splits <= 0 || splits > 65535 ||
      pixels_per_split <= 0 ||
      static_cast<int64_t>(splits) * pixels_per_split <
          static_cast<int64_t>(n) * h * w ||
      static_cast<int64_t>(splits - 1) * pixels_per_split >=
          static_cast<int64_t>(n) * h * w ||
      partial_floats < conv3x3_wgrad_scratch(c, co, splits) ||
      route < kRouteF32 || route > kRouteWgmma ||
      (route == kRouteWgmma &&
       (c % 8 != 0 || co % 8 != 0 || !aligned16(x) || !aligned16(g))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpad = static_cast<int>(round_up(c, kWgradRows));
  const int copad = static_cast<int>(round_up(co, tile_cols(co)));
  cudaError_t e = cudaSuccess;
  if (route == kRouteWgmma) {
    e = launch_wgrad_wgmma(x, g, partial, n, h, w, c, co, cpad, copad,
                           splits, pixels_per_split, s);
  } else if (route == kRouteWmma) {
    // The shapes that reach it have C or Co % 8 != 0 (or unaligned
    // tensors): element loads.
    dispatch_wgrad<bf16, false>(x, g, partial, n, h, w, c, co, cpad, copad,
                                splits, pixels_per_split, s);
    e = cudaGetLastError();
  } else {
    constexpr int kChunk = Elems<float>::kChunk;
    if (c % kChunk == 0 && co % kChunk == 0 && aligned16(x) && aligned16(g))
      dispatch_wgrad<float, true>(x, g, partial, n, h, w, c, co, cpad, copad,
                                  splits, pixels_per_split, s);
    else
      dispatch_wgrad<float, false>(x, g, partial, n, h, w, c, co, cpad,
                                   copad, splits, pixels_per_split, s);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = 9 * c * co;
  int blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > kMaxReduceBlocks) blocks = kMaxReduceBlocks;
  wgrad_reduce<<<blocks, kReduceThreads, 0, s>>>(partial, out, c, co, cpad,
                                                 copad, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// cores, no TF32) the same FLOP take 3.31 ms at 67 TFLOP/s, against 0.345
// ms for the forward's 1.16 GB (each input read once, the output written
// once): every fp32 kernel is bound by its FMA issue rate.
//
// conv_fwd_f32<Tile>, conv_fwd_f32_halo<Tile> and conv_wgrad_f32, the fp32
// kernels (every fp32 shape). The FMAs bound them, so the design keeps everything else off the
// FMA pipe's way:
// * One SIMT main loop: 256 threads, each with a block of outputs held in
//   registers (16 x 8 or 8 x 8 in the forward, 12 x 8 in the weight
//   gradient), so each 16-byte shared-memory load feeds 16 to 32 FMAs. A
//   warp is 4 x 8 threads, each holding float4 groups of rows and columns
//   half a tile (or a quarter) apart, so its loads of B read 128
//   contiguous bytes and its loads of A 64: no bank conflicts. One block a
//   SM, with no register cap: capped for two, ptxas spilled and every loop
//   ran slower.
// * Slices 32 values deep in a ring of cp.async stages in dynamic shared
//   memory that zero-fill at the borders and ragged edges, one
//   __syncthreads per slice, no register staging.
// * The forward's A tile is k-major ([32 k][pixels]), so the loop reads A
//   as it reads B, along the pixels; each float of x lands in place by a
//   4-byte .ca copy (a warp copies 4 pixels x 8 channels, on distinct
//   banks). Kept pixel-major, as 16-byte copies land it, A needed a float4
//   along k for each of the 8 pixels: 32 more registers, and the FMA loop
//   alone ran slower. B comes by 16-byte .cg copies (4-byte where C or Co %
//   4 != 0 or a tensor is not 16-byte aligned). For Co > 64 (the forward at
//   the bench shape) a slice is one tap and 32 channels, the tile 256
//   pixels x 128 channels, 16 x 8 outputs a thread (half the weight copies
//   of a 128 x 128 tile at 8 x 8). For Co <= 64 (its dgrad, which reads
//   128 channels of g) the tile is 256 x 64, 8 x 8 a thread, and a slice
//   is one tap row dy and 32 channels: the A tile is the halo of the
//   block's pixels (one more on each side) shifted by dy, and each dx a row
//   offset into it, as in the bf16 forward, so g is read 3 times, not 9. A
//   float4 and a float2 of a halo row give a thread's four pixels their
//   three dx taps; a tap where the pixel starts (dx = 0) or ends (dx = 2)
//   its image row takes a zero by a select (one per pixel group and k when
//   W % 4 == 0, four otherwise): conv_fwd_f32_halo. Each design measured
//   slower on the other tile: the halo's FMA loop runs slower than the
//   taps' and gains back only where the copies are large.
// * The weight gradient's block owns a tap row dy and all three dx (as
//   conv_wgrad_wgmma's does): its x tile is the slice's 32 pixels plus one
//   on each side, shifted by dy, and each dx is a row offset into it, the
//   zero row where the pixel starts (dx = 0) or ends (dx = 2) its image
//   row. So x and g are read 3 times, not 9. Its slice loop is unrolled 8
//   times (fully, it ran 4% slower). Its splits fill the 132 SMs once, as
//   the wgmma kernel's do (split_plan), summed in a fixed order by
//   wgrad_reduce.
//
// conv_fwd_wgmma<BN>, the bf16 forward (and data gradient) for C and Co
// multiples of 8, 16-byte aligned tensors and 9 * ceil(C / 64) * 64 * BN
// bf16 weights that fit in shared memory beside the ring (BN = 64 for
// Co <= 64, else 128; the wrapper picks it by shape, other bf16 shapes take
// conv_fwd_bf16). The bench shape's 578 MB (x 193 MB,
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
// bf16 shapes take conv_wgrad_bf16):
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
// conv_fwd_bf16 and conv_wgrad_bf16, the other bf16 shapes, on wmma (right
// and simple first):
// * x is read in place: the JAX wrapper pads x with jnp.pad (a full copy
//   of the activation on every call); here the gather masks the 1-pixel
//   border. Ragged M, K and Co are masked or zero-filled, so any C and Co
//   work (the probe's small check shape has C = 8, K = 72).
// * The reduction walks the 9 taps, then slices of C, so each row of the
//   A tile is a run of contiguous channels of one source pixel: 16-byte
//   loads when C and Co are multiples of 8 and the pointers are 16-byte
//   aligned, element loads otherwise.
// * nvcuda::wmma (16x16x16, fp32 accumulate); the global loads of the next
//   slice are issued into registers before the current slice is
//   multiplied out of shared memory.
//
// Weight gradient, every route: the TPU kernel accumulates every grid step
// into one output block, which works only because the TPU grid runs in
// order. Here M is cut into S fixed pixel ranges; block (tile, s) writes an
// fp32 partial tile, and a second kernel sums the S partials of each output
// in the order s = 0..S-1. No float atomics: the result is bit-identical
// from run to run.
//
// Plain C interface, loaded with ctypes by selavi_tpu_torch/ops/conv3x3.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdRows = 128;   // output pixels per forward block
constexpr int kWgradRows = 64;  // channels of one tap per weight-gradient block
constexpr int kReduceThreads = 256;
constexpr int kMaxReduceBlocks = 1024;

// bf16 values in a 16-byte chunk, and the reduction depth of one wmma
// slice (64 bytes of a row).
constexpr int kChunk = 8;
constexpr int kDepth = 32;

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
__device__ __forceinline__ const bf16* shifted_row(const bf16* t, Pixel p,
                                                   int dy, int dx, int h,
                                                   int w, int dim) {
  const int hh = p.h + dy - 1;
  const int ww = p.w + dx - 1;
  if (!p.ok || hh < 0 || hh >= h || ww < 0 || ww >= w) return nullptr;
  return t + ((static_cast<int64_t>(p.n) * h + hh) * w + ww) * dim;
}

// Channels [c, c + kChunk) of `row` (a row of `dim` channels; nullptr reads
// zeros), zero past dim. With VEC, dim and c are multiples of kChunk and
// row is 16-byte aligned, so a chunk lies wholly inside or wholly past it.
template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const bf16* row, int c, int dim) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row == nullptr) return r;
  if constexpr (VEC) {
    if (c < dim) r = __ldg(reinterpret_cast<const uint4*>(row + c));
  } else {
    bf16* e = reinterpret_cast<bf16*>(&r);
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (c + q < dim) e[q] = row[c + q];
  }
  return r;
}

// The forward's global -> register stage. Slice s is tap s / c_slices and
// channels [c0, c0 + kDepth), c0 = (s % c_slices) * kDepth. A tile:
// kFwdRows pixels x kDepth channels; B tile: kDepth weight rows x BN
// output channels.
template <int BN, bool VEC>
struct FwdStage {
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

  __device__ __forceinline__ void load(const bf16* x, const bf16* w2, int s,
                                       int c_slices, int h, int w, int c,
                                       int co, int co0) {
    const int tap = s / c_slices;
    const int c0 = (s - tap * c_slices) * kDepth;
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
#pragma unroll
    for (int i = 0; i < kA; ++i)
      a[i] = load_chunk<VEC>(shifted_row(x, pix[i], dy, dx, h, w, c),
                                c0 + a_col[i], c);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int k = c0 + b_row[i];
      const bf16* row =
          k < c ? w2 + (static_cast<int64_t>(tap) * c + k) * co : nullptr;
      b[i] = load_chunk<VEC>(row, co0 + b_col[i], co);
    }
  }
};

// Forward, bf16 on the tensor cores. Block: kFwdRows pixels x BN output
// channels; 8 warps as 4 (pixels) x 2 (channels), 32 x BN/2 each.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w2,
              bf16* __restrict__ y, int n, int h, int w, int c, int co) {
  using Stage = FwdStage<BN, VEC>;
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

// The weight gradient's global -> register stage. Slice s is pixels
// [p0, p0 + kDepth), p0 = p_begin + s * kDepth. A tile: kDepth pixels x
// kWgradRows channels of x shifted by the tap; G tile: kDepth pixels x BN
// output channels of g. Elements are loaded one by one (the shapes that
// conv_wgrad_wgmma does not take).
template <int BN>
struct WgradStage {
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

  __device__ __forceinline__ void load(const bf16* x, const bf16* g, int p0,
                                       int p_end, int dy, int dx, int c0,
                                       int co0, int h, int w, int c, int co) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const Pixel p = pixel_of(p0 + a_row[i], p_end, h, w);
      a[i] = load_chunk<false>(shifted_row(x, p, dy, dx, h, w, c),
                                c0 + a_col[i], c);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const Pixel p = pixel_of(p0 + b_row[i], p_end, h, w);
      b[i] = load_chunk<false>(shifted_row(g, p, 1, 1, h, w, co),
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
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                float* __restrict__ partial, int n, int h, int w, int c,
                int co, int cpad, int copad, int pixels_per_split) {
  using Stage = WgradStage<BN>;
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

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores (see the header): conv_fwd_f32<Tile>,
// conv_fwd_f32_halo<Tile> and conv_wgrad_f32. All run one SIMT main loop: 256 threads, each holding a
// block of fp32 outputs in registers, fed from a ring of 32-deep slices
// that cp.async lands in dynamic shared memory, one __syncthreads per
// slice. A warp is 4 x 8 threads: its B reads (two float4 per thread,
// BN / 2 apart) cover 128 contiguous bytes and its A reads 64, so no load
// conflicts on a bank. One block a SM: capped at two (128 registers),
// ptxas spilled in all three loops, and each ran slower than uncapped.

constexpr int kF32Threads = 256;
constexpr int kF32Depth = 32;  // reduction values per slice

// 4 bytes from global to shared, or 4 zeros where !full.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// Floats idx .. idx + 3 of t into shared memory at dst, as zeros from float
// `valid` on (all four where valid <= 0). With VEC one 16-byte copy (valid
// is then <= 0 or >= 4, and t + idx 16-byte aligned), else four of 4 bytes.
template <bool VEC>
__device__ __forceinline__ void copy4(uint32_t dst, const float* t,
                                      int64_t idx, int valid) {
  if constexpr (VEC) {
    cp_async16(dst, valid > 0 ? t + idx : t, valid > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + 4 * e, e < valid ? t + idx + e : t, e < valid);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[0..7] += a * (b0, b1): one row of a thread's outputs.
__device__ __forceinline__ void fma_row(float* acc, float a, const float4& b0,
                                        const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

// The forward's tile: BM output pixels x BN output channels, 256 threads
// of 4 PX pixels x 8 channels, run by conv_fwd_f32 (one tap a slice) or,
// with HALO, by conv_fwd_f32_halo (one tap row a slice); a slice is 32
// channels deep. Its A tile is k-major, [32 k][BM + 4]: each
// float of x lands at its own place by a 4-byte copy, and the pad puts the
// 4 pixels x 8 channels of a warp's copy on distinct banks. With taps it
// holds the block's pixels shifted by the tap and B [32 k][BN] the tap's
// weight rows; with the halo it holds the pixels - 1 .. + BM shifted by dy
// and B [3 dx][32 k][BN]. More stages timed the same or slower: they take
// L1 from the 4-byte .ca copies.
template <int BM, int BN, int PX, bool HALO>
struct F32FwdTile {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kPx = PX;  // float4 groups of pixels a thread holds
  static constexpr bool kHalo = HALO;
  static constexpr int kDx = HALO ? 3 : 1;  // taps of a slice
  static constexpr int kStages = 2;
  static constexpr int kLdA = BM + 4;
  static constexpr int kABytes = kF32Depth * kLdA * 4;
  static constexpr int kStageBytes = kABytes + kDx * kF32Depth * BN * 4;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static constexpr int kTx = BN / 8;         // threads along the channels
  static constexpr int kTy = BM / (4 * PX);  // threads along the pixels
  static_assert(kTx * kTy == kF32Threads, "4 PX x 8 outputs a thread");
  static_assert(kTx % 8 == 0, "a warp is 4 x 8 threads");
  static_assert(kSmemBytes <= kSmemLimit, "within a block's shared memory");
};
// Co > 64 (the forward at the bench shape): 16 x 8 a thread, one tap a
// slice. Co <= 64 (the dgrad): 8 x 8 a thread, the halo. Each took the
// other design slower at the bench shape (f32_ablation's halo_wide and
// taps_narrow): the halo's loop, with its three B tiles and dx selects,
// loses more to its FMA loop than it saves in copies, except where the
// copies are twice the forward's (the dgrad's 128 channels of g).
using F32FwdWide = F32FwdTile<256, 128, 4, false>;
using F32FwdNarrow = F32FwdTile<256, 64, 2, true>;

// Forward (and dgrad), fp32. Slice s is tap s / c_slices and channels
// c0 .. c0 + 31, c0 = (s % c_slices) * 32: the A tile is the BM pixels
// shifted by the tap (zero where it leaves the image, past M or past C),
// the B tile the matching 32 rows of w2. Thread (ty, tx) holds pixels
// g BM / PX + 4 ty .. + 3 (g < PX), and channels 4 tx .. + 3 and
// BN / 2 + 4 tx .. + 3.
template <class Tile, bool VEC>
__global__ void __launch_bounds__(kF32Threads, 1)
conv_fwd_f32(const float* __restrict__ x, const float* __restrict__ w2,
             float* __restrict__ y, int n, int h, int w, int c, int co) {
  constexpr int BM = Tile::kBM;
  constexpr int BN = Tile::kBN;
  constexpr int PX = Tile::kPx;
  constexpr int kStages = Tile::kStages;
  constexpr int kLdA = Tile::kLdA;
  constexpr int kARows = BM / 32;  // A pixels a thread copies, 4 floats each
  constexpr int kBChunks = BN / 4;
  constexpr int kBStep = kF32Threads / kBChunks;
  constexpr int kBRows = kF32Depth / kBStep;  // B rows a thread copies
  static_assert(!Tile::kHalo, "one tap a slice");
  extern __shared__ __align__(16) float smem_f32[];
  const uint32_t smem = smem_u32(smem_f32);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m_total = n * h * w;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int c_slices = (c + kF32Depth - 1) / kF32Depth;
  const int steps = 9 * c_slices;

  // Copies: channels ak + 8 j (j < 4) of A pixels ar + 32 i, so that a warp
  // copies 4 pixels x 8 channels; chunk bq of B rows br + kBStep i. Bit
  // dy * 3 + dx of tap_ok[i]: tap (dy, dx) of pixel i lies on the image
  // (none past M), found once, so that a slice tests one bit.
  const int ak = lane % 8;
  const int ar = 4 * warp + lane / 8;
  const int bq = tid % kBChunks;
  const int br = tid / kBChunks;
  int tap_ok[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int p = m0 + ar + 32 * i;
    const int pw = p % w;
    const int ph = p / w % h;
    const int ok_h = (ph > 0) | 2 | (ph < h - 1) << 2;
    const int ok_w = (pw > 0) | 2 | (pw < w - 1) << 2;
    int bits = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      bits |= ((ok_h >> (t / 3)) & (ok_w >> (t % 3)) & 1) << t;
    tap_ok[i] = p < m_total ? bits : 0;
  }
  int next_tap = 0, next_cs = 0;  // the next slice to copy
  auto issue = [&](int slot) {
    const uint32_t a_s = smem + slot * Tile::kStageBytes;
    const uint32_t b_s = a_s + Tile::kABytes;
    const int tap = next_tap;
    const int c0 = next_cs * kF32Depth;
    const int dy = tap / 3;
    const int shift = (dy - 1) * w + (tap - 3 * dy) - 1;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = ar + 32 * i;
      const bool row = (tap_ok[i] >> tap) & 1;
      // 64-bit: rows past M or off the image overhang the tensor (read
      // only where the copy is `in`)
      const float* src =
          x + static_cast<int64_t>(m0 + r + shift) * c + c0 + ak;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row && c0 + ak + 8 * j < c;
        cp_async4(a_s + ((ak + 8 * j) * kLdA + r) * 4, in ? src + 8 * j : x,
                  in);
      }
    }
    const int col = co0 + 4 * bq;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int k = br + kBStep * i;
      copy4<VEC>(b_s + (k * BN + 4 * bq) * 4, w2,
                 static_cast<int64_t>(tap * c + c0 + k) * co + col,
                 c0 + k < c ? co - col : 0);
    }
    if (++next_cs == c_slices) {
      next_cs = 0;
      ++next_tap;
    }
  };

  const int tx = (warp % (Tile::kTx / 8)) * 8 + lane % 8;
  const int ty = (warp / (Tile::kTx / 8)) * 4 + lane / 8;
  float acc[4 * PX][8];
#pragma unroll
  for (int i = 0; i < 4 * PX; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // Slice s has landed for every thread, and every thread is done with
    // slice s - 1, whose stage the copies of slice s + kStages - 1 take.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) issue((s + kStages - 1) % kStages);
    cp_async_commit();

    const float* stage = smem_f32 + (s % kStages) * (Tile::kStageBytes / 4);
    const float* as = stage + 4 * ty;
    const float* bs = stage + Tile::kABytes / 4 + 4 * tx;
#pragma unroll
    for (int k = 0; k < kF32Depth; ++k) {
      float4 a[PX];
#pragma unroll
      for (int g = 0; g < PX; ++g)
        a[g] = *reinterpret_cast<const float4*>(as + k * kLdA + g * (BM / PX));
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * BN + BN / 2);
#pragma unroll
      for (int g = 0; g < PX; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma_row(acc[4 * g + i], lane_of(a[g], i), b0, b1);
    }
  }

#pragma unroll
  for (int i = 0; i < 4 * PX; ++i) {
    const int p = m0 + (i / 4) * (BM / PX) + 4 * ty + i % 4;
    if (p >= m_total) continue;
    float* dst = y + static_cast<int64_t>(p) * co;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = co0 + half * (BN / 2) + 4 * tx;
      const float* v = acc[i] + 4 * half;
      if constexpr (VEC) {
        if (col < co)
          *reinterpret_cast<float4*>(dst + col) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < co) dst[col + e] = v[e];
      }
    }
  }
}

// Forward (and dgrad), fp32, on the halo. Slice s is tap row dy = s /
// c_slices and channels c0 .. c0 + 31, c0 = (s % c_slices) * 32: the A
// tile is the halo (zero where its row shifted by dy leaves the image,
// outside [0, M) or past C), the B tile the matching 32 rows of w2 for
// each dx. Thread
// (ty, tx) holds pixels g BM / PX + 4 ty .. + 3 (g < PX), and channels
// 4 tx .. + 3 and BN / 2 + 4 tx .. + 3. Its pixel i takes tap (dy, dx)
// from halo row g BM / PX + 4 ty + i + dx: one float4 and one float2 of a
// halo row serve the three dx, and zeros stand in where the pixel starts
// (dx = 0) or ends (dx = 2) its image row. With ROW4 (W % 4 == 0) a
// thread's four pixels lie in one image row, so only the first can start
// it and only the last can end it.
template <class Tile, bool VEC, bool ROW4>
__global__ void __launch_bounds__(kF32Threads, 1)
conv_fwd_f32_halo(const float* __restrict__ x,
                  const float* __restrict__ w2, float* __restrict__ y, int n,
                  int h, int w, int c, int co) {
  constexpr int BM = Tile::kBM;
  constexpr int BN = Tile::kBN;
  constexpr int PX = Tile::kPx;
  constexpr int kStages = Tile::kStages;
  constexpr int kLdA = Tile::kLdA;
  constexpr int kARows = BM / 32;  // halo rows a thread copies, 4 floats each
  constexpr int kBChunks = BN / 4;
  constexpr int kBStep = kF32Threads / kBChunks;
  constexpr int kBRows = Tile::kDx * kF32Depth / kBStep;  // B rows to copy
  static_assert(Tile::kHalo, "one tap row a slice");
  static_assert(kF32Depth % kBStep == 0, "a copy's B rows share their dx");
  extern __shared__ __align__(16) float smem_f32[];
  const uint32_t smem = smem_u32(smem_f32);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m_total = n * h * w;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int c_slices = (c + kF32Depth - 1) / kF32Depth;
  const int steps = 3 * c_slices;

  // Copies: channels ak + 8 j (j < 4) of halo rows ar + 32 i, so that a
  // warp copies 4 rows x 8 channels, and for tid < 64 channel tid % 32 of
  // row BM + tid / 32 (i = kARows). Halo row r holds pixel m0 - 1 + r; bit
  // dy of row_ok[i]: that pixel lies in [0, M) and its image row shifted by
  // dy on the image, found once, so that a slice tests one bit.
  const int ak = lane % 8;
  const int ar = 4 * warp + lane / 8;
  const int bq = tid % kBChunks;
  const int br = tid / kBChunks;
  int row_ok[kARows + 1];
#pragma unroll
  for (int i = 0; i <= kARows; ++i) {
    const int q = m0 - 1 + (i < kARows ? ar + 32 * i : BM + tid / 32);
    const int qh = q < 0 ? 0 : q / w % h;
    row_ok[i] = q >= 0 && q < m_total
                    ? (qh > 0) | 2 | (qh < h - 1) << 2
                    : 0;
  }
  int next_dy = 0, next_cs = 0;  // the next slice to copy
  auto issue = [&](int slot) {
    const uint32_t a_s = smem + slot * Tile::kStageBytes;
    const uint32_t b_s = a_s + Tile::kABytes;
    const int dy = next_dy;
    const int c0 = next_cs * kF32Depth;
    const int shift = (dy - 1) * w - 1;  // halo row r: pixel m0 + r + shift
#pragma unroll
    for (int i = 0; i <= kARows; ++i) {
      if (i == kARows && tid >= 64) break;
      const int r = i < kARows ? ar + 32 * i : BM + tid / 32;
      const bool row = (row_ok[i] >> dy) & 1;
      // 64-bit: rows past M or off the image overhang the tensor (read only
      // where the copy is `in`)
      const float* src = x + static_cast<int64_t>(m0 + r + shift) * c + c0;
#pragma unroll
      for (int j = 0; j < (i < kARows ? 4 : 1); ++j) {
        const int k = i < kARows ? ak + 8 * j : tid % 32;
        const bool in = row && c0 + k < c;
        cp_async4(a_s + (k * kLdA + r) * 4, in ? src + k : x, in);
      }
    }
    const int col = co0 + 4 * bq;
    const float* wt = w2 + static_cast<int64_t>(3 * dy * c + c0) * co + col;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int dx = kBStep * i / kF32Depth;
      const int k = kBStep * i % kF32Depth + br;
      copy4<VEC>(b_s + ((dx * kF32Depth + k) * BN + 4 * bq) * 4, wt,
                 static_cast<int64_t>(dx * c + k) * co,
                 c0 + k < c ? co - col : 0);
    }
    if (++next_cs == c_slices) {
      next_cs = 0;
      ++next_dy;
    }
  };

  const int tx = (warp % (Tile::kTx / 8)) * 8 + lane % 8;
  const int ty = (warp / (Tile::kTx / 8)) * 4 + lane / 8;
  // Bit i of first[g] (last[g]): pixel g BM / PX + 4 ty + i starts (ends)
  // its image row.
  int first[PX], last[PX];
#pragma unroll
  for (int g = 0; g < PX; ++g) {
    first[g] = last[g] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pw = (m0 + g * (BM / PX) + 4 * ty + i) % w;
      first[g] |= (pw == 0) << i;
      last[g] |= (pw == w - 1) << i;
    }
  }
  float acc[4 * PX][8];
#pragma unroll
  for (int i = 0; i < 4 * PX; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // Slice s has landed for every thread, and every thread is done with
    // slice s - 1, whose stage the copies of slice s + kStages - 1 take.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) issue((s + kStages - 1) % kStages);
    cp_async_commit();

    const float* stage = smem_f32 + (s % kStages) * (Tile::kStageBytes / 4);
    const float* as = stage + 4 * ty;
    const float* bs = stage + Tile::kABytes / 4 + 4 * tx;
#pragma unroll
    for (int k = 0; k < kF32Depth; ++k) {
      float4 a0[PX];
      float2 a1[PX];
#pragma unroll
      for (int g = 0; g < PX; ++g) {
        const float* row = as + k * kLdA + g * (BM / PX);
        a0[g] = *reinterpret_cast<const float4*>(row);
        a1[g] = *reinterpret_cast<const float2*>(row + 4);
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* b = bs + (dx * kF32Depth + k) * BN;
        const float4 b0 = *reinterpret_cast<const float4*>(b);
        const float4 b1 = *reinterpret_cast<const float4*>(b + BN / 2);
#pragma unroll
        for (int g = 0; g < PX; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i + dx;
            float a = e < 4 ? lane_of(a0[g], e) : e == 4 ? a1[g].x : a1[g].y;
            if (dx == 0 && (!ROW4 || i == 0) && (first[g] >> i & 1)) a = 0.f;
            if (dx == 2 && (!ROW4 || i == 3) && (last[g] >> i & 1)) a = 0.f;
            fma_row(acc[4 * g + i], a, b0, b1);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4 * PX; ++i) {
    const int p = m0 + (i / 4) * (BM / PX) + 4 * ty + i % 4;
    if (p >= m_total) continue;
    float* dst = y + static_cast<int64_t>(p) * co;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = co0 + half * (BN / 2) + 4 * tx;
      const float* v = acc[i] + 4 * half;
      if constexpr (VEC) {
        if (col < co)
          *reinterpret_cast<float4*>(dst + col) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < co) dst[col + e] = v[e];
      }
    }
  }
}

// The weight gradient's block: one tap row dy, 64 channels of C (for each
// of the three dx) and 128 of Co, over one pixel range. A stage is a slice
// of 32 pixels: X, the halo tile [34][64] of x at the slice's pixels - 1 ..
// + 32 shifted by dy rows (zero where that row leaves the image, outside
// [0, M) or past C), and G [32][128] of g (zero past the range or Co).
constexpr int kF32WgRows = 64;
constexpr int kF32WgCols = 128;
constexpr int kF32WgHalo = kF32Depth + 2;
constexpr int kF32WgXBytes = kF32WgHalo * kF32WgRows * 4;
constexpr int kF32WgStageBytes = kF32WgXBytes + kF32Depth * kF32WgCols * 4;
constexpr int kF32WgStages = 6;
// + one row of zeros, which a dx tap that leaves the image reads
constexpr int kF32WgSmemBytes =
    kF32WgStages * kF32WgStageBytes + kF32WgRows * 4;
static_assert(kF32WgSmemBytes <= kSmemLimit, "within a block's shared memory");

// Weight gradient partials, fp32. Pixel r of a slice takes tap (dy, dx)
// from halo row r + dx, or from the zero row where r is the first (dx = 0)
// or last (dx = 2) pixel of its image row. Thread (ty, tx) holds, for each
// dx, channels 4 ty .. + 3 against output channels 4 tx .. + 3 and
// 64 + 4 tx .. + 3: 12 x 8 outputs. blockIdx.x = (dy * co_blocks +
// output-channel block) * c_blocks + channel block, blockIdx.y = split: the
// blocks that read the same pixels are neighbours in launch order.
template <bool VEC>
__global__ void __launch_bounds__(kF32Threads, 1)
conv_wgrad_f32(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ partial, int n, int h, int w, int c,
               int co, int cpad, int copad, int pixels_per_split) {
  extern __shared__ __align__(16) float smem_f32[];
  const uint32_t smem = smem_u32(smem_f32);
  float* zero_row = smem_f32 + kF32WgStages * kF32WgStageBytes / 4;

  const int tid = threadIdx.x;
  const int c_blocks = (c + kF32WgRows - 1) / kF32WgRows;
  const int co_blocks = (co + kF32WgCols - 1) / kF32WgCols;
  const int c0 = (blockIdx.x % c_blocks) * kF32WgRows;
  const int co0 = (blockIdx.x / c_blocks % co_blocks) * kF32WgCols;
  const int dy = blockIdx.x / (c_blocks * co_blocks);
  const int split = blockIdx.y;
  const int m_total = n * h * w;
  const int p_begin = split * pixels_per_split;
  const int p_end = static_cast<int>(
      min(static_cast<int64_t>(m_total),
          static_cast<int64_t>(p_begin) + pixels_per_split));
  const int steps =
      p_end > p_begin ? (p_end - p_begin + kF32Depth - 1) / kF32Depth : 0;
  if (tid < kF32WgRows) zero_row[tid] = 0.f;

  // Copies: chunk gq of G rows gr + 8 i; chunk xq of halo rows xr + 16 i
  // (i < 2), and for tid < 32 of halo row 32 + xr. A halo row's pixel is
  // tracked as (hh, ww) from slice to slice, so the loop divides nothing;
  // pixel -1 (before the first) counts as the last pixel of an image.
  const int gq = tid % 32;
  const int gr = tid / 32;
  const int xq = tid % 16;
  const int xr = tid / 16;
  const int step_w = kF32Depth % w;
  const int step_h = (kF32Depth / w) % h;
  auto advance = [&](int& hh, int& ww) {
    ww += step_w;
    hh += step_h;
    if (ww >= w) {
      ww -= w;
      ++hh;
    }
    if (hh >= h) hh -= h;
  };
  int hh[3], ww[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int p = p_begin - 1 + (i < 2 ? xr + 16 * i : 32 + xr);
    const int row = p < 0 ? h - 1 : p / w;
    ww[i] = p < 0 ? w - 1 : p - row * w;
    hh[i] = row % h;
  }
  const int x_shift = (dy - 1) * w;
  const int x_valid = c - c0 - 4 * xq;
  const int g_col = co0 + 4 * gq;
  int ps_next = p_begin;  // the first pixel of the next slice to copy
  int slot_next = 0;
  auto issue = [&]() {
    const uint32_t x_s = smem + slot_next * kF32WgStageBytes;
    const uint32_t g_s = x_s + kF32WgXBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gr + 8 * i;
      const int p = ps_next + r;
      copy4<VEC>(g_s + (r * kF32WgCols + 4 * gq) * 4, g,
                 static_cast<int64_t>(p) * co + g_col,
                 p < p_end ? co - g_col : 0);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < 2 || tid < 32) {
        const int j = i < 2 ? xr + 16 * i : 32 + xr;
        const int p = ps_next - 1 + j;
        const bool in = p >= 0 && p < m_total &&
                        static_cast<unsigned>(hh[i] + dy - 1) <
                            static_cast<unsigned>(h);
        copy4<VEC>(x_s + (j * kF32WgRows + 4 * xq) * 4, x,
                   static_cast<int64_t>(p + x_shift) * c + c0 + 4 * xq,
                   in ? x_valid : 0);
        advance(hh[i], ww[i]);
      }
    }
    ps_next += kF32Depth;
    slot_next = slot_next + 1 == kF32WgStages ? 0 : slot_next + 1;
  };

  // Lane l tracks the column of pixel l of the warp's current slice: the
  // warp's ballots give the slice's image-row starts and ends.
  const int warp = tid / 32;
  const int lane = tid % 32;
  int lane_w = (p_begin + lane) % w;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  float acc[3][4][8];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[d][i][j] = 0.f;

  for (int s = 0; s < kF32WgStages - 1; ++s) {
    if (s < steps) issue();
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kF32WgStages - 2>();
    __syncthreads();
    if (s + kF32WgStages - 1 < steps) issue();
    cp_async_commit();

    const unsigned first = __ballot_sync(0xffffffffu, lane_w == 0);
    const unsigned last = __ballot_sync(0xffffffffu, lane_w == w - 1);
    lane_w += step_w;
    if (lane_w >= w) lane_w -= w;
    const float* stage =
        smem_f32 + (s % kF32WgStages) * (kF32WgStageBytes / 4);
    const float* xs = stage + 4 * ty;
    const float* gs = stage + kF32WgXBytes / 4 + 4 * tx;
    const float* zs = zero_row + 4 * ty;
#pragma unroll 8
    for (int r = 0; r < kF32Depth; ++r) {
      const float4 b0 = *reinterpret_cast<const float4*>(gs + r * kF32WgCols);
      const float4 b1 =
          *reinterpret_cast<const float4*>(gs + r * kF32WgCols + 64);
      float4 a[3];
      a[0] = *reinterpret_cast<const float4*>(
          (first >> r) & 1 ? zs : xs + r * kF32WgRows);
      a[1] = *reinterpret_cast<const float4*>(xs + (r + 1) * kF32WgRows);
      a[2] = *reinterpret_cast<const float4*>(
          (last >> r) & 1 ? zs : xs + (r + 2) * kF32WgRows);
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma_row(acc[d][i], lane_of(a[d], i), b0, b1);
    }
  }

  // The scratch is padded to whole 64-channel rows and columns (copad is
  // 64 when Co <= 64): columns past it are not stored.
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float* out = partial +
                 ((static_cast<int64_t>(split) * 9 + dy * 3 + d) * cpad + c0 +
                  4 * ty) * copad + co0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = half * 64 + 4 * tx;
        const float* v = acc[d][i] + 4 * half;
        if (co0 + col < copad)
          *reinterpret_cast<float4*>(out + static_cast<int64_t>(i) * copad +
                                     col) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
  }
}

template <class Tile, bool VEC, bool ROW4>
cudaError_t launch_fwd_f32_tile(const void* x, const void* w2, void* y, int n,
                                int h, int w, int c, int co,
                                cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float*, int, int, int, int, int);
  if constexpr (Tile::kHalo)
    kernel = conv_fwd_f32_halo<Tile, VEC, ROW4>;
  else
    kernel = conv_fwd_f32<Tile, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((n * h * w + Tile::kBM - 1) / Tile::kBM,
                  (co + Tile::kBN - 1) / Tile::kBN);
  kernel<<<grid, kF32Threads, Tile::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w2),
      static_cast<float*>(y), n, h, w, c, co);
  return cudaGetLastError();
}

// ROW4 matters only to the halo: the taps' tile takes one instance.
template <class Tile>
cudaError_t launch_fwd_f32_for(const void* x, const void* w2, void* y, int n,
                               int h, int w, int c, int co, bool vec,
                               cudaStream_t stream) {
  if (!Tile::kHalo || w % 4 == 0)
    return vec ? launch_fwd_f32_tile<Tile, true, true>(x, w2, y, n, h, w, c,
                                                       co, stream)
               : launch_fwd_f32_tile<Tile, false, true>(x, w2, y, n, h, w, c,
                                                        co, stream);
  if constexpr (Tile::kHalo)
    return vec ? launch_fwd_f32_tile<Tile, true, false>(x, w2, y, n, h, w, c,
                                                        co, stream)
               : launch_fwd_f32_tile<Tile, false, false>(x, w2, y, n, h, w,
                                                         c, co, stream);
  return cudaErrorInvalidValue;  // not reached
}

cudaError_t launch_fwd_f32(const void* x, const void* w2, void* y, int n,
                           int h, int w, int c, int co, cudaStream_t stream) {
  const bool vec = c % 4 == 0 && co % 4 == 0 && aligned16(x) &&
                   aligned16(w2) && aligned16(y);
  return co <= 64 ? launch_fwd_f32_for<F32FwdNarrow>(x, w2, y, n, h, w, c, co,
                                                     vec, stream)
                  : launch_fwd_f32_for<F32FwdWide>(x, w2, y, n, h, w, c, co,
                                                   vec, stream);
}

template <bool VEC>
cudaError_t launch_wgrad_f32_vec(const void* x, const void* g,
                                 float* partial, int n, int h, int w, int c,
                                 int co, int cpad, int copad, int splits,
                                 int pixels_per_split, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_wgrad_f32<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kF32WgSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(3 * ((c + kF32WgRows - 1) / kF32WgRows) *
                      ((co + kF32WgCols - 1) / kF32WgCols),
                  splits);
  conv_wgrad_f32<VEC><<<grid, kF32Threads, kF32WgSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), partial, n,
      h, w, c, co, cpad, copad, pixels_per_split);
  return cudaGetLastError();
}

cudaError_t launch_wgrad_f32(const void* x, const void* g, float* partial,
                             int n, int h, int w, int c, int co, int cpad,
                             int copad, int splits, int pixels_per_split,
                             cudaStream_t stream) {
  if (c % 4 == 0 && co % 4 == 0 && aligned16(x) && aligned16(g))
    return launch_wgrad_f32_vec<true>(x, g, partial, n, h, w, c, co, cpad,
                                      copad, splits, pixels_per_split,
                                      stream);
  return launch_wgrad_f32_vec<false>(x, g, partial, n, h, w, c, co, cpad,
                                     copad, splits, pixels_per_split, stream);
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

template <int BN, bool VEC>
void launch_fwd_bf16(const void* x, const void* w2, void* y, int n, int h,
                     int w, int c, int co, cudaStream_t stream) {
  const int m_total = n * h * w;
  const dim3 grid((m_total + kFwdRows - 1) / kFwdRows, (co + BN - 1) / BN);
  conv_fwd_bf16<BN, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w2),
      static_cast<bf16*>(y), n, h, w, c, co);
}

void dispatch_fwd_bf16(const void* x, const void* w2, void* y, int n, int h,
                       int w, int c, int co, cudaStream_t stream) {
  const bool vec = c % kChunk == 0 && co % kChunk == 0 && aligned16(x) &&
                   aligned16(w2) && aligned16(y);
  if (tile_cols(co) == 64) {
    if (vec) launch_fwd_bf16<64, true>(x, w2, y, n, h, w, c, co, stream);
    else launch_fwd_bf16<64, false>(x, w2, y, n, h, w, c, co, stream);
  } else {
    if (vec) launch_fwd_bf16<128, true>(x, w2, y, n, h, w, c, co, stream);
    else launch_fwd_bf16<128, false>(x, w2, y, n, h, w, c, co, stream);
  }
}

// The wmma weight gradient takes the bf16 shapes that wgmma does not: C or
// Co % 8 != 0, or unaligned tensors, so it loads elements.
template <int BN>
void launch_wgrad_bf16(const void* x, const void* g, float* partial, int n,
                       int h, int w, int c, int co, int cpad, int copad,
                       int splits, int pixels_per_split,
                       cudaStream_t stream) {
  const dim3 grid(9 * ((c + kWgradRows - 1) / kWgradRows),
                  (co + BN - 1) / BN, splits);
  conv_wgrad_bf16<BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, n, h,
      w, c, co, cpad, copad, pixels_per_split);
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
  if (route == kRouteF32)
    return static_cast<int>(launch_fwd_f32(x, w2, y, n, h, w, c, co, s));
  dispatch_fwd_bf16(x, w2, y, n, h, w, c, co, s);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory of the fp32 kernels: the weight gradient's
// (wgrad != 0) or the forward's for `co` output channels.
long long conv3x3_f32_smem(int wgrad, int co) {
  if (wgrad) return kF32WgSmemBytes;
  return co <= 64 ? F32FwdNarrow::kSmemBytes : F32FwdWide::kSmemBytes;
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
    if (tile_cols(co) == 64)
      launch_wgrad_bf16<64>(x, g, partial, n, h, w, c, co, cpad, copad,
                            splits, pixels_per_split, s);
    else
      launch_wgrad_bf16<128>(x, g, partial, n, h, w, c, co, cpad, copad,
                             splits, pixels_per_split, s);
    e = cudaGetLastError();
  } else {
    e = launch_wgrad_f32(x, g, partial, n, h, w, c, co, cpad, copad, splits,
                         pixels_per_split, s);
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

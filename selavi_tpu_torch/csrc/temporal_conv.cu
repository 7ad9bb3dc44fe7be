// Temporal (3,1,1) convolution of R(2+1)D, forward, for Hopper (sm_90a):
// bf16 in, fp32 sums, channels last (NDHWC) in and out.
//
//   y[b, t, p, o] = sum_{k < 3, c} W[o, c, k] * x[b, s * t + k - 1, p, c]
//
// with p the pixel (h, w) of an H x W plane, stride s in T of 1 or 2, zero
// padding of one frame at each end of T, and y rounded once to bf16.
//
// It replaces no TPU kernel: the JAX package leaves this conv to XLA. It was
// added because cuDNN runs these convs, when autocast hands them bf16
// channels_last_3d inputs, as an fp32 FFMA kernel on NCDHW data between
// bf16 <-> fp32 layout copies (sm80_xmma_fprop_implicit_gemm_indexed_f32f32
// ..._nchwkcrs), whatever the dtype, layout or cudnn.benchmark setting.
//
// As a GEMM: M = the output positions (b, t, p), N = Co, K = 3 * C, tap-major.
// Row (b, t, p) of tap k's A operand is the input row (b, s t + k - 1, p): C
// contiguous bf16 values of NDHWC.
//
// Bound: bytes. At layer1 of the tower (C = 144 -> Co = 64, 30 x 56 x 56,
// batch 128) a call moves 3.47 GB of x and 1.54 GB of y, 1.50 ms at 3.35
// TB/s, against 0.67 ms for its 0.67 TFLOP at 989 TFLOP/s dense bf16 (K = 432
// against N = 64: 133 operations a byte). The stem's and layer1's five convs
// are 22.7 GB, 6.8 ms. So every input row should leave device memory once,
// not once for each of the three taps that read it.
//
// The design (one algorithm; the host picks its parameters from C, Co, T,
// H * W, the stride and x's alignment alone, plan_of):
// * A block is one warpgroup (128 threads). It owns a tile of BN output
//   channels (BN = 64 for Co <= 64, else 128) and walks items: a clip and a
//   tile of 64 pixels of its H x W plane. For an item it walks T: output
//   frame t is three taps over the tiles of input frames s t - 1 .. s t + 1.
// * A ring of stages in shared memory, filled ahead of the products. Where
//   the block's weights (3 * ceil(C / 64) * 64 x BN bf16) fit beside a ring
//   of kFrameStages whole input frames (the stem and layer1 in both
//   midplanes modes), the weights stay resident, a stage is one input frame
//   of the tile (all its channels), and each frame stays in the ring for the
//   three outputs that read it: x leaves device memory once. A frame
//   outside [0, T) is a stage of zeros. Elsewhere (layers
//   2-4, C >= 230, whose weights do not fit) a stage is one tap and one
//   64-channel slice for two outputs, 2 t and 2 t + 1: their two input
//   tiles beside the weight slice they share (read from L2 once for 128
//   output rows, not 64: these layers are bound by L2 traffic). The other
//   taps' reads of the same rows come a few stages later, from L2, and a
//   padding frame's tile reads as zeros. The ring is as deep as fits
//   (kMaxStages at most) without fewer blocks on an SM.
// * The A tiles are 64 rows x 64 channels in the 128-byte swizzle. They
//   land by one TMA copy a tile where C % 8 == 0 and x is 16-byte aligned,
//   from a 4D map of x [B, T, H*W, C] (frames -1 and T, pixels past H * W
//   and channels past C read as zeros). TMA cannot address rows that are
//   not whole 16-byte chunks: where 2C and x are 8- or 4-byte aligned (C =
//   460, 230 in parity mode) every thread copies its chunks of the tile with
//   cp.async of that size, zeros past C; where they are only 2-byte aligned
//   (C = 45, 921) it copies the 16-byte chunks that hold each row into a
//   staging area, and the warpgroup then shifts each row into the swizzled
//   tile (four 32-bit reads and a funnel shift a chunk), zeros past C.
// * Weights come by TMA from w2 [3, C, Co] (Co contiguous), MN-major tiles
//   of 64 k-rows x 64 columns in the 128-byte swizzle, zero past C and Co.
// * wgmma.m64n{BN}k16 reads both operands from shared memory: A K-major (a
//   pixel's channels are contiguous, so a tile is a K-major operand as it
//   lands), B MN-major; fp32 accumulators in registers. Every k-step of a
//   64-channel slice runs, those past C on zeros: no branch around a wgmma
//   (ptxas serializes them all where one has one).
// * The epilogue rounds the accumulators once to bf16, stmatrix's them into
//   a staging tile and stores it with one TMA store per 64 channels, into a
//   3D map of y [B * T_out, H * W, Co]: rows past the plane are clipped, so
//   y stays channels_last_3d for the BatchNorm that follows.
// * Persistent blocks (as many as fit on each SM), blocks b, b + co_blocks,
//   ... on one channel tile; the ring runs on across a block's items, so the
//   next item's first frames are in flight during an item's last outputs.
//   With one warpgroup an SM, the loops' integer work is on the critical
//   path: cursors advance the ring and the items without divisions.
//   Each output sums its taps in one fixed order: repeats are bit-identical.
//
// Plain C interface, loaded with ctypes by selavi_tpu_torch/ops/temporal_conv.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // one warpgroup
constexpr int kRows = 64;        // output pixels of a tile: wgmma's M
constexpr int kTileBytes = 8192; // 64 rows x 64 channels of bf16
constexpr int kFrameStages = 5;  // resident: input frames in the ring, least
constexpr int kStreamStages = 4; // streamed: (tap, slice) stages, least
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr int64_t kSmemPerSm = 233472;  // an SM's, 1 KB of it kept per block
constexpr int kMaxDevices = 64;
constexpr int kSizesKept = 8;  // shared memory sizes kept a kernel and device

// How the A tiles land: TMA (C % 8 == 0, x 16-byte aligned); cp.async
// copies of 8 or 4 bytes straight into the swizzled tile; or 16-byte
// cp.async copies of the chunks that hold each row, then shifted into the
// tile by the warpgroup (rows only 2-byte aligned: C odd).
enum Load { kLoadTma = 0, kLoadDirect = 1, kLoadStaged = 2 };

struct Params {
  const bf16* x;
  int batch, t_in, hw, c, co, t_out, stride;
  int c_slices;   // 64-channel slices of C
  int co_blocks;  // BN-column tiles of Co
  int p_tiles;    // 64-pixel tiles of a plane
  int resident;   // weights resident and whole frames in the ring
  int stages;     // ring depth
  int a_bytes;    // A tiles of a stage
  int stage_bytes;
  int pitch;      // staging bytes of a row (staged path)
  int flat;       // staged, resident: a tile's rows land by one bulk copy
  int64_t x_end;  // address one past x's last byte
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// `bytes` (0..16) bytes from global to shared, zeros for the rest of 16.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most n of this thread's cp.async groups are pending (n is
// clamped to what the ring can hold; waiting for fewer is always safe).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 4;\n" ::: "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's reads of a shifted tile, the TMA store of the
// output tile).
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

// Shared-memory matrix descriptor of an MN-major B operand in the 128-byte
// swizzle: 64 columns of N per 128-byte row, one row per k; the next 8 rows
// of k 1024 bytes on, the next 64 columns one tile (8 KB) on.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(kTileBytes >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Shared-memory matrix descriptor of a K-major A operand in the 128-byte
// swizzle: 64 channels (one 16-channel k-step every 32 bytes) per 128-byte
// row, one row per output pixel, the next 8 rows 1024 bytes on.
__device__ __forceinline__ uint64_t desc_k_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d[64 x BN] = A[64 x 16] B[16 x BN] (+ d if accumulate), both from shared
// memory: A K-major, B MN-major (transpose bit set); bf16 in, fp32
// accumulators.
template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
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
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
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

// Until the phase of bar with this parity has completed. A copy that never
// lands (a fault) traps after 2^28 tries instead of hanging the card. The
// loop stays inside the asm: a branch on a per-thread value that the
// compiler can see makes ptxas serialize every wgmma of the kernel.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      ".reg .u32 tries;\n"
      "mov.u32 tries, 0;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE_%=;\n"
      "add.u32 tries, tries, 1;\n"
      "setp.lt.u32 done, tries, 268435456;\n"
      "@done bra WAIT_%=;\n"
      "trap;\n"
      "DONE_%=:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A box of the tensor that `map` describes, at coordinates innermost first
// (outside the tensor reads as zeros), into shared memory at dst; its bytes
// complete bar's phase.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x0, int x1,
                                            int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(x2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x0, int x1,
                                            int x2, int x3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(x2),
      "r"(x3), "r"(bar)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned) in one bulk copy; its bytes complete bar's phase.
__device__ __forceinline__ void bulk_load(uint32_t dst, int64_t src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A box from shared memory at src to the tensor that `map` describes; the
// copy engine leaves out what falls past the tensor's bounds.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int x0, int x1,
                                             int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x0), "r"(x1), "r"(x2), "r"(src)
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

// Shared memory of a block (offsets from the 1024-aligned base):
// * resident weights: 3 * c_slices blocks (tap, slice) of BN / 64 tiles of
//   64 k-rows x 64 columns (none where the weights stream);
// * the ring: `stages` stages of stage_bytes, each its A tiles (a whole
//   frame's c_slices tiles, or one) and, where the weights stream, the
//   stage's weight block (BN / 64 tiles) after them;
// * the output staging tile, BN / 64 boxes of 64 x 64;
// * on the staged path, each stage's rows as they were copied, a row's
//   bytes at a pitch of `pitch`;
// * an mbarrier for each stage, and one for the resident weights.
struct Layout {
  uint32_t weights, ring, out, staging, bars;
};

__host__ __device__ inline int64_t weight_bytes(int c_slices, int bn) {
  return static_cast<int64_t>(3) * c_slices * bn * 128;
}

template <int BN>
__device__ __forceinline__ Layout layout_of(const Params& p, uint32_t base) {
  Layout l;
  l.weights = base;
  l.ring = base + (p.resident ? weight_bytes(p.c_slices, BN) : 0);
  l.out = l.ring + p.stages * p.stage_bytes;
  l.staging = l.out + BN * 128;
  const int rows = p.a_bytes / kTileBytes * kRows;
  l.bars = l.staging + p.stages * rows * p.pitch;
  return l;
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// cp-size 8 or 4 bytes from global to shared, `bytes` of them read and
// the rest zeros.
template <int kSize>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src,
                                               int bytes) {
  if (kSize == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// Persistent: block b owns output-channel tile b % co_blocks and walks the
// items (clip, pixel tile) worker, worker + workers, ... (worker = b /
// co_blocks). Its stages run on across its items: per item, a frame each
// (resident: frames -1 .. s (t_out - 1) + 1), or a (t, slice, tap) each
// (streamed); a padding frame's tile reads as zeros.
template <int BN, int kLoad, int kGran>
__global__ void __launch_bounds__(kThreads)
temporal_conv_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap y_map,
                     const Params p) {
  constexpr int kAcc = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Layout l = layout_of<BN>(p, smem);
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  const int co0 = (blockIdx.x % p.co_blocks) * BN;
  const int workers = gridDim.x / p.co_blocks;
  const int worker = blockIdx.x / p.co_blocks;
  const int items = p.batch * p.p_tiles;
  const int my_items =
      worker < items ? (items - worker + workers - 1) / workers : 0;
  const int t_pairs = (p.t_out + 1) / 2;  // streamed: outputs 2 t, 2 t + 1
  const int per_item = p.resident ? p.stride * (p.t_out - 1) + 3
                                  : t_pairs * 3 * p.c_slices;
  const int total = my_items * per_item;
  const int w_blocks = 3 * p.c_slices;
  const int a_tiles = p.a_bytes / kTileBytes;
  const uint32_t w_bar = l.bars + 8 * p.stages;

  if (tid == 0) {
    for (int i = 0; i <= p.stages; ++i) mbar_init(l.bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (p.resident && tid == 0) {
    mbar_expect_tx(w_bar, static_cast<int>(weight_bytes(p.c_slices, BN)));
    for (int kb = 0; kb < w_blocks; ++kb)
#pragma unroll
      for (int a = 0; a < BN / 64; ++a)
        tma_load_3d(l.weights + (kb * (BN / 64) + a) * kTileBytes, &w_map,
                    w_bar, co0 + 64 * a, (kb % p.c_slices) * 64,
                    kb / p.c_slices);
  }

  // A cursor over the block's stages, advanced without divisions (the
  // loops run with one warpgroup an SM, so their integer work is on the
  // critical path): the item (clip, first pixel), the input frame, the
  // slice and tap (streamed; t the pair of outputs 2 t, 2 t + 1), and the
  // ring slot and round.
  struct Cursor {
    int item, clip, p0, t, slice, tap, frame, slot, round;
  };
  auto set_item = [&](Cursor& c, int item) {
    c.item = item;
    c.clip = item / p.p_tiles;
    c.p0 = (item - c.clip * p.p_tiles) * kRows;
  };
  auto start = [&]() {
    Cursor c;
    set_item(c, worker);
    c.t = c.slice = c.tap = c.slot = c.round = 0;
    c.frame = -1;
    return c;
  };
  auto advance = [&](Cursor& c) {
    if (++c.slot == p.stages) {
      c.slot = 0;
      ++c.round;
    }
    if (p.resident) {
      if (++c.frame == per_item - 1) {
        c.frame = -1;
        set_item(c, c.item + workers);
      }
      return;
    }
    if (++c.tap == 3) {
      c.tap = 0;
      if (++c.slice == p.c_slices) {
        c.slice = 0;
        if (++c.t == t_pairs) {
          c.t = 0;
          set_item(c, c.item + workers);
        }
      }
    }
    c.frame = 2 * p.stride * c.t + c.tap - 1;
  };
  auto bar_of = [&](int slot) { return l.bars + 8 * slot; };
  auto stage_of = [&](int slot) { return l.ring + slot * p.stage_bytes; };

  // Tile i of a stage: its input frame (padding frames included) and
  // slice, its first input row and its rows of x (0 on a padding frame).
  auto tile_frame = [&](const Cursor& c, int i) {
    return p.resident ? c.frame : c.frame + i * p.stride;
  };
  auto tile_slice = [&](const Cursor& c, int i) {
    return p.resident ? i : c.slice;
  };
  auto first_row = [&](const Cursor& c, int frame) {
    return (static_cast<int64_t>(c.clip) * p.t_in + frame) * p.hw + c.p0;
  };
  auto rows_of = [&](const Cursor& c, int frame) {
    return frame >= 0 && frame < p.t_in ? min(kRows, p.hw - c.p0) : 0;
  };

  // Issue a stage's copies: thread 0 the TMA ones (and its mbarrier's
  // arrival); on the other paths every thread its share of the rows, one
  // cp.async group per stage. A thread's chunks share their column q = tid
  // % 8 (8 chunks of 16 bytes a row, 16 rows at a time).
  int issued = 0;
  Cursor prod = start();
  auto issue = [&](const Cursor& c) {
    const uint32_t stage = stage_of(c.slot);
    const uint32_t bar = bar_of(c.slot);
    if (kLoad == kLoadStaged && p.flat) {
      // The tile's rows are one 16-byte aligned run of x: one bulk copy.
      if (tid == 0) {
        const int bytes = rows_of(c, c.frame) * p.c * 2;
        mbar_expect_tx(bar, bytes);
        if (bytes)
          bulk_load(l.staging + c.slot * a_tiles * kRows * p.pitch,
                    reinterpret_cast<int64_t>(p.x) +
                        first_row(c, c.frame) * p.c * 2,
                    bytes, bar);
      }
      return;
    }
    if (tid == 0) {
      const int b_bytes = p.resident ? 0 : BN * 128;
      mbar_expect_tx(bar, (kLoad == kLoadTma ? p.a_bytes : 0) + b_bytes);
      if (kLoad == kLoadTma)
        for (int i = 0; i < a_tiles; ++i)
          tma_load_4d(stage + i * kTileBytes, &x_map, bar,
                      tile_slice(c, i) * 64, c.p0, tile_frame(c, i), c.clip);
      if (!p.resident)
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load_3d(stage + p.a_bytes + a * kTileBytes, &w_map, bar,
                      co0 + 64 * a, c.slice * 64, c.tap);
    }
    if (kLoad == kLoadTma) return;
    const int q = tid % 8;
    if (kLoad == kLoadDirect) {
      // Each 16-byte chunk of the swizzled tile by cp.async copies of
      // kGran bytes (the rows' alignment), zeros past the row and on
      // padding rows.
#pragma unroll 4
      for (int v = tid / 8; v < a_tiles * kRows; v += kThreads / 8) {
        const int r = v % kRows;
        const int f = tile_frame(c, v / kRows);
        const int ch0 = tile_slice(c, v / kRows) * 64 + 8 * q;
        const int len = r < rows_of(c, f) ? 2 * max(0, min(8, p.c - ch0)) : 0;
        const int64_t src = reinterpret_cast<int64_t>(p.x) +
                            ((first_row(c, f) + r) * p.c + ch0) * 2;
        const uint32_t dst = stage + v / kRows * kTileBytes + r * 128 +
                             ((q ^ (r & 7)) << 4);
#pragma unroll
        for (int j = 0; j < 16; j += kGran) {
          const int bytes = max(0, min(kGran, len - j));
          cp_async_small<kGran>(dst + j,
                                bytes ? reinterpret_cast<const void*>(src + j)
                                      : static_cast<const void*>(p.x),
                                bytes);
        }
      }
    } else {
      // The 16-byte chunks that hold each row's bytes, into the staging.
      const int chunks = p.pitch / 16;
      const uint32_t stg = l.staging + c.slot * a_tiles * kRows * p.pitch;
#pragma unroll 4
      for (int v = tid / 8; v < a_tiles * kRows; v += kThreads / 8) {
        const int r = v % kRows;
        const int f = tile_frame(c, v / kRows);
        if (r >= rows_of(c, f)) continue;
        const int ch0 = tile_slice(c, v / kRows) * 64;
        const int64_t from = reinterpret_cast<int64_t>(p.x) +
                             ((first_row(c, f) + r) * p.c + ch0) * 2;
        const int64_t to = from + 2 * min(64, p.c - ch0);
        for (int k = q; k < chunks; k += 8) {
          const int64_t chunk = (from & ~static_cast<int64_t>(15)) + 16 * k;
          if (chunk >= to) break;
          const int64_t left = p.x_end - chunk;  // the tensor ends
          const int bytes = left < 0 ? 0 : left > 16 ? 16 : static_cast<int>(left);
          cp_async16(stg + v * p.pitch + 16 * k,
                     reinterpret_cast<const void*>(chunk), bytes);
        }
      }
    }
    cp_async_commit();
  };
  auto pump = [&](int limit) {
    if (limit > total) limit = total;
    for (; issued < limit; ++issued) {
      issue(prod);
      advance(prod);
    }
  };

  // Not TMA: once a stage's copies have landed (the cp.async group of
  // stage `index`), its A tiles are made visible to wgmma; on the staged
  // path the warpgroup first shifts each row into the swizzled tiles,
  // zeros past C and on padding rows.
  int made = 0;
  Cursor ready = start();
  auto make_ready = [&]() {
    if (kLoad == kLoadStaged && p.flat) {
      mbar_wait(bar_of(ready.slot), ready.round & 1);
    } else {
      cp_async_wait_at_most(issued - 1 - made);
      if (kLoad == kLoadStaged) __syncthreads();
    }
    if (kLoad == kLoadStaged) {
      const Cursor& c = ready;
      const uint32_t stage = stage_of(c.slot);
      const uint32_t stg = l.staging + c.slot * a_tiles * kRows * p.pitch;
      const int q = tid % 8;
#pragma unroll 4
      for (int v = tid / 8; v < a_tiles * kRows; v += kThreads / 8) {
        const int r = v % kRows;
        const int f = tile_frame(c, v / kRows);
        const int ch0 = tile_slice(c, v / kRows) * 64;
        // The chunk's 16 bytes start `off` bytes into the row's staging,
        // at an even offset: four 32-bit words, shifted by 16 bits where
        // the offset is 2 mod 4; values past C are zeros.
        const int n = r < rows_of(c, f) ? min(8, max(0, p.c - ch0 - 8 * q)) : 0;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (n > 0) {
          const int64_t from = reinterpret_cast<int64_t>(p.x) +
                               ((first_row(c, f) + r) * p.c + ch0) * 2;
          const uint32_t off =
              p.flat ? (r * p.c + ch0) * 2 + 16 * q
                     : v * p.pitch + static_cast<uint32_t>(from & 15) + 16 * q;
          const uint32_t at = stg + (off & ~3u);
          uint32_t u[5];
#pragma unroll
          for (int i = 0; i < 5; ++i) u[i] = ld_shared_u32(at + 4 * i);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            word[i] = (off & 2) ? __funnelshift_r(u[i], u[i + 1], 16) : u[i];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            word[i] &= 2 * i + 1 < n ? 0xFFFFFFFFu
                                     : (2 * i < n ? 0x0000FFFFu : 0u);
        }
        st_shared16(stage + v / kRows * kTileBytes + r * 128 +
                        ((q ^ (r & 7)) << 4),
                    make_uint4(word[0], word[1], word[2], word[3]));
      }
    }
    fence_proxy_async();  // the tiles, for wgmma
    __syncthreads();
    advance(ready);
    ++made;
  };

  // The products of one 64-channel slice of one tap into acc: A the tile
  // at `tile` (a k-step 32 bytes on within its swizzled rows), B the weight
  // block at `b`. Both are read by the tensor cores asynchronously: a
  // stage's slot is refilled only once its products are done. All four
  // k-steps run, past C too (zeros in A and B): ptxas serializes every
  // wgmma of a kernel that branches around one.
  auto products = [&](float (&acc)[kAcc], uint32_t tile, uint32_t b,
                      bool first) {
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss<BN>(acc, desc_k_sw128(tile + 32 * k),
                   desc_mn_sw128(b + k * 2048), !first || k > 0);
  };

  // Epilogue of output t of (clip, p0) once its products are done (t past
  // T_out is not stored: a streamed pair's second output): stmatrix
  // lane l of warp
  // v addresses row 16 v + 8 (l / 8 % 2) + l % 8 of matrix l / 8, whose
  // columns are chunk j + l / 16. Fragment layout: warp v holds rows 16 v +
  // l / 4 (+ 8); acc[4 j + 2 half + e] is column 8 j + 2 (l % 4) + e.
  const int st_row = (tid / 32) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int st_chunk = lane >> 4;
  auto epilogue = [&](float (&acc)[kAcc], int clip, int p0, int t) {
    wgmma_wait<0>();
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    fence_operands(acc);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      const int chunk = j + st_chunk;
      stmatrix_x4(l.out + (chunk / 8) * kTileBytes + st_row * 128 +
                      (((chunk % 8) ^ (st_row & 7)) << 4),
                  pack_bf16x2(acc[4 * j], acc[4 * j + 1]),
                  pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]),
                  pack_bf16x2(acc[4 * j + 4], acc[4 * j + 5]),
                  pack_bf16x2(acc[4 * j + 6], acc[4 * j + 7]));
    }
    fence_proxy_async();  // the staging tile, for the copy engine
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int box = 0; box < BN / 64; ++box)
        if (co0 + 64 * box < p.co && t < p.t_out)
          tma_store_3d(&y_map, l.out + box * kTileBytes, co0 + 64 * box, p0,
                       clip * p.t_out + t);
      bulk_commit();
    }
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  if (p.resident) {
    // Output t of an item reads frames s t - 1 .. s t + 1, the stages from
    // first = base + s t on. The products of the earlier outputs are done
    // (each epilogue waits for them), so the stages before first are free
    // for the copies of the stages up to first + stages - 1.
    mbar_wait(w_bar, 0);
    int clip = worker / p.p_tiles;
    int p0 = (worker - clip * p.p_tiles) * kRows;
    int item = worker, first = 0, slot = 0, round = 0;
    for (int it = 0; it < my_items; ++it) {
      for (int t = 0; t < p.t_out; ++t) {
        pump(first + p.stages);
        if (kLoad != kLoadTma)
          while (made <= first + 2) make_ready();
#pragma unroll 1
        for (int k = 0; k < 3; ++k) {
          int sk = slot + k, rk = round;
          if (sk >= p.stages) {
            sk -= p.stages;
            ++rk;
          }
          mbar_wait(bar_of(sk), rk & 1);
#pragma unroll 1
          for (int sl = 0; sl < p.c_slices; ++sl)
            products(acc, stage_of(sk) + sl * kTileBytes,
                     l.weights + (k * p.c_slices + sl) * (BN * 128),
                     k == 0 && sl == 0);
        }
        wgmma_commit();
        epilogue(acc, clip, p0, t);
        // The next output's first stage: s on, or 3 on into the next item.
        const int delta = t + 1 < p.t_out ? p.stride : 3;
        first += delta;
        for (slot += delta; slot >= p.stages; slot -= p.stages) ++round;
      }
      item += workers;
      clip = item / p.p_tiles;
      p0 = (item - clip * p.p_tiles) * kRows;
    }
  } else {
    // A stage feeds two outputs, 2 t and 2 t + 1 (tile 1 is its frame s
    // on): they share the stage's weight block. Past T_out the second is
    // zeros and is not stored.
    float acc2[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc2[i] = 0.f;
    Cursor c = start();
    for (int s = 0; s < total; ++s) {
      // The products of stage s - 2 are done, for every thread: its slot
      // takes the copies of stage s + stages - 2.
      wgmma_wait<1>();
      __syncthreads();
      pump(s + p.stages - 1);
      if (kLoad != kLoadTma) make_ready();
      mbar_wait(bar_of(c.slot), c.round & 1);
      const uint32_t stage = stage_of(c.slot);
      const bool first = c.slice == 0 && c.tap == 0;
      products(acc, stage, stage + p.a_bytes, first);
      products(acc2, stage + kTileBytes, stage + p.a_bytes, first);
      wgmma_commit();
      if (c.slice == p.c_slices - 1 && c.tap == 2) {
        epilogue(acc, c.clip, c.p0, 2 * c.t);
        epilogue(acc2, c.clip, c.p0, 2 * c.t + 1);
      }
      advance(c);
    }
  }
  if (tid == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// Host side.

struct Plan {
  int bn, load, gran, flat, resident, stages, a_bytes, stage_bytes, pitch;
  int64_t smem;
};

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

// The kernel's parameters for C -> Co channels and x at address x: BN; the
// load path (TMA where rows and x are 16-byte aligned, else cp.async copies
// of 8 or 4 bytes where they are so aligned, else the staged path); whether
// the weights stay resident beside a ring of whole frames, else they stream
// beside (tap, slice) stages; and the ring's depth, as deep as fits (up to
// kMaxStages) without fewer blocks on an SM than the shallowest ring gives.
Plan plan_of(int c, int co, int hw, const void* x) {
  Plan pl;
  pl.bn = co <= 64 ? 64 : 128;
  pl.gran = 16;
  while (pl.gran > 2 && ((2 * c) % pl.gran != 0 || !aligned(x, pl.gran)))
    pl.gran /= 2;
  pl.load = pl.gran == 16 ? kLoadTma : pl.gran >= 4 ? kLoadDirect
                                                    : kLoadStaged;
  const int c_slices = static_cast<int>(ceil_div(c, 64));
  // A row's bytes of a slice start at any even offset of a 16-byte chunk.
  pl.pitch = pl.load != kLoadStaged ? 0 : static_cast<int>(
      16 * ceil_div(14 + 2 * (c < 64 ? c : 64), 16));
  auto smem = [&](int resident, int stages) {
    const int a_tiles = resident ? c_slices : 2;
    const int64_t stage = static_cast<int64_t>(a_tiles) * kTileBytes +
                          (resident ? 0 : pl.bn * 128);
    return 1024 + (resident ? weight_bytes(c_slices, pl.bn) : 0) +
           stages * stage + pl.bn * 128 +
           static_cast<int64_t>(stages) * a_tiles * kRows * pl.pitch +
           8 * (stages + 1);
  };
  auto per_sm = [](int64_t bytes) { return kSmemPerSm / (bytes + 1024); };
  pl.resident = smem(1, kFrameStages) <= kSmemLimit;
  pl.stages = pl.resident ? kFrameStages : kStreamStages;
  const int64_t blocks = per_sm(smem(pl.resident, pl.stages));
  while (pl.stages < kMaxStages &&
         smem(pl.resident, pl.stages + 1) <= kSmemLimit &&
         per_sm(smem(pl.resident, pl.stages + 1)) == blocks)
    ++pl.stages;
  // A resident tile's rows are one run of x: on the staged path one bulk
  // copy brings them where every run is 16-byte aligned and long.
  pl.flat = pl.load == kLoadStaged && pl.resident && aligned(x, 16) &&
            static_cast<int64_t>(hw) * c % 8 == 0;
  pl.a_bytes = (pl.resident ? c_slices : 2) * kTileBytes;
  pl.stage_bytes = pl.a_bytes + (pl.resident ? 0 : pl.bn * 128);
  pl.smem = smem(pl.resident, pl.stages);
  return pl;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A tensor map of a bf16 tensor of `rank` dims (innermost first, the
// innermost contiguous, `inner` elements), boxes of 64 x 64 (x 1 ...) in
// the 128-byte swizzle. cuTensorMapEncodeTiled is looked up through the
// runtime, so nothing more is linked.
cudaError_t tensor_map(CUtensorMap* map, const void* t, int rank,
                       const cuuint64_t* dims) {
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
  cuuint64_t strides[3];
  cuuint64_t stride = dims[0] * 2;
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = stride;
    stride *= dims[i];
  }
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(t), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What a launch of a kernel instance at `smem` bytes of dynamic shared
// memory needs to know of a device: its SMs and the blocks an SM holds.
struct Occupancy {
  int64_t smem;  // 0: not asked yet
  int sms, per_sm;
};

// The Occupancy of `kernel` on `device` at `smem` bytes, from `kept` (the
// instance's table on that device) or asked of the runtime and kept there.
// The first ask allows the instance kSmemLimit bytes. A (kernel instance,
// device, size) asks once, not at every launch; a full table asks again.
cudaError_t occupancy(const void* kernel, int device, int64_t smem,
                      Occupancy* kept, Occupancy* out) {
  int i = 0;
  for (; i < kSizesKept && kept[i].smem != 0; ++i) {
    if (kept[i].smem == smem) {
      *out = kept[i];
      return cudaSuccess;
    }
  }
  cudaError_t e = cudaSuccess;
  if (i == 0)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  Occupancy o{smem, 0, 0};
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o.per_sm, kernel, kThreads, static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  if (i < kSizesKept) kept[i] = o;
  *out = o;
  return cudaSuccess;
}

template <int BN, int kLoad, int kGran>
cudaError_t launch(const CUtensorMap& x_map, const CUtensorMap& w_map,
                   const CUtensorMap& y_map, const Params& p, int64_t smem,
                   cudaStream_t stream) {
  auto kernel = temporal_conv_kernel<BN, kLoad, kGran>;
  static std::mutex mu;
  static Occupancy kept[kMaxDevices][kSizesKept];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Occupancy o;
  {
    std::lock_guard<std::mutex> lock(mu);
    e = occupancy(reinterpret_cast<const void*>(kernel), device, smem,
                  kept[device], &o);
  }
  if (e != cudaSuccess) return e;
  if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many blocks as fit at once, a whole number on each channel tile, and
  // no more than there are items.
  const int64_t items = static_cast<int64_t>(p.batch) * p.p_tiles;
  int64_t per_co = static_cast<int64_t>(o.sms) * o.per_sm / p.co_blocks;
  if (per_co < 1) per_co = 1;
  if (per_co > items) per_co = items;
  kernel<<<static_cast<int>(per_co * p.co_blocks), kThreads, smem, stream>>>(
      x_map, w_map, y_map, p);
  return cudaGetLastError();
}

// The kernel instance of a plan: its BN, load path and copy size.
template <int BN>
cudaError_t launch_bn(const Plan& pl, const CUtensorMap& x_map,
                      const CUtensorMap& w_map, const CUtensorMap& y_map,
                      const Params& p, cudaStream_t stream) {
  if (pl.load == kLoadTma)
    return launch<BN, kLoadTma, 16>(x_map, w_map, y_map, p, pl.smem, stream);
  if (pl.load == kLoadDirect && pl.gran == 8)
    return launch<BN, kLoadDirect, 8>(x_map, w_map, y_map, p, pl.smem,
                                      stream);
  if (pl.load == kLoadDirect)
    return launch<BN, kLoadDirect, 4>(x_map, w_map, y_map, p, pl.smem,
                                      stream);
  return launch<BN, kLoadStaged, 2>(x_map, w_map, y_map, p, pl.smem, stream);
}

}  // namespace

extern "C" {

// The kernel's plan for C -> Co channels, planes of hw pixels and x at
// address x_address: writes {dynamic shared memory in bytes, resident, ring
// stages, BN, load path (0 TMA, 1 cp.async of `gran` bytes, 2 staged),
// gran, flat (staged by one bulk copy a tile)}.
void temporal_conv_plan(int c, int co, int hw, long long x_address,
                        long long* out) {
  const Plan pl = plan_of(
      c, co, hw,
      reinterpret_cast<const void*>(static_cast<uintptr_t>(x_address)));
  out[0] = pl.smem;
  out[1] = pl.resident;
  out[2] = pl.stages;
  out[3] = pl.bn;
  out[4] = pl.load;
  out[5] = pl.gran;
  out[6] = pl.flat;
}

// y [batch, t_out, hw, co] = the temporal conv of x [batch, t_in, hw, c]
// with w2 [3, c, co], all bf16, contiguous, t_out = (t_in - 1) / stride + 1.
// w2 and y 16-byte aligned, co % 8 == 0, stride 1 or 2. Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
int temporal_conv_fwd(const void* x, const void* w2, void* y, int batch,
                      int t_in, int hw, int c, int co, int stride,
                      void* stream) {
  if (batch <= 0 || t_in <= 0 || hw <= 0 || c <= 0 || co <= 0 ||
      co % 8 != 0 || (stride != 1 && stride != 2) || !aligned(w2, 16) ||
      !aligned(y, 16) || !aligned(x, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int t_out = (t_in - 1) / stride + 1;
  const int64_t rows = static_cast<int64_t>(batch) * t_in * hw;
  // Tensor-map coordinates and the block's item and stage counts are int.
  if (static_cast<int64_t>(batch) * t_out > INT32_MAX ||
      static_cast<int64_t>(batch) * ceil_div(hw, kRows) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(c, co, hw, x);
  if (pl.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.x = static_cast<const bf16*>(x);
  p.batch = batch;
  p.t_in = t_in;
  p.hw = hw;
  p.c = c;
  p.co = co;
  p.t_out = t_out;
  p.stride = stride;
  p.c_slices = static_cast<int>(ceil_div(c, 64));
  p.co_blocks = static_cast<int>(ceil_div(co, pl.bn));
  p.p_tiles = static_cast<int>(ceil_div(hw, kRows));
  p.resident = pl.resident;
  p.stages = pl.stages;
  p.a_bytes = pl.a_bytes;
  p.stage_bytes = pl.stage_bytes;
  p.pitch = pl.pitch;
  p.flat = pl.flat;
  p.x_end = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x)) + rows * c * 2;

  CUtensorMap x_map, w_map, y_map;
  cudaError_t e = cudaSuccess;
  if (pl.load == kLoadTma) {
    const cuuint64_t dims[4] = {
        static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(hw),
        static_cast<cuuint64_t>(t_in), static_cast<cuuint64_t>(batch)};
    e = tensor_map(&x_map, x, 4, dims);
  } else {
    x_map = CUtensorMap{};
  }
  if (e == cudaSuccess) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(co),
                                static_cast<cuuint64_t>(c), 3};
    e = tensor_map(&w_map, w2, 3, dims);
  }
  if (e == cudaSuccess) {
    const cuuint64_t dims[3] = {
        static_cast<cuuint64_t>(co), static_cast<cuuint64_t>(hw),
        static_cast<cuuint64_t>(batch) * t_out};
    e = tensor_map(&y_map, y, 3, dims);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = pl.bn == 64 ? launch_bn<64>(pl, x_map, w_map, y_map, p, s)
                  : launch_bn<128>(pl, x_map, w_map, y_map, p, s);
  return static_cast<int>(e);
}

}  // extern "C"

// Eval-mode BatchNorm, an optional residual add and an optional ReLU in one
// pass, for Hopper (sm_90a): bf16 or fp32 in and out, fp32 arithmetic.
//
//   y[i] = act(x[i] * s[c] + t[c] (+ r[i])),   c = (i / inner) mod C,
//   s = weight / sqrt(running_var + eps),   t = bias - running_mean * s,
//
// over a dense tensor in one of two layouts: channels its fastest dimension
// (channels_last_3d 5D, channels_last 4D or [N, C]; inner 1), or channels
// outside the spatial positions (contiguous NCHW or NCDHW; inner the
// positions a channel plane holds). r (optional) is in x's layout, act the
// identity or ReLU, the sum rounded once to x's type.
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into the conv's epilogue. It was added because in eval mode ATen
// runs BatchNorm on channels-last bf16 as a broadcast TensorIterator pass
// (elementwise_kernel<128, 4> with an offset calculator, ~42% of HBM
// bandwidth, after a launch that computes invstd), then a ReLU pass, then
// a residual add and another ReLU: three or four reads and writes of the
// activations where one does.
//
// Bound: bytes. x read once, r read once where there is one, y written once;
// the parameters (4 C floats) are noise. R(2+1)D-18's 37 BatchNorms read
// and write 118 M elements a 30 x 112 x 112 clip (layer1's four midplanes
// 13.5 M each); in bf16 at 3.35 TB/s that is 0.14 ms a clip.
//
// The design, channels fastest (bn_act_kernel):
// * A prologue: each block computes s and t for all C channels (fp32, as
//   the formulas above, no fused multiply-add) into shared memory. There
//   is no separate launch for them.
// * Persistent blocks (kBlocksPerSm on each SM) walk the tensor in 16-byte
//   vectors (8 bf16 or 4 fp32), kUnroll vectors a thread in flight, all
//   loaded before any arithmetic, with streaming cache hints: nothing here
//   is read again soon.
// * A vector's first channel is tracked per vector slot by a running
//   modulo: the grid's step over the tensor advances it by a constant, so
//   the loop has no division. With C a multiple of the vector's width a
//   vector holds channels c0 .. c0 + 7 of one position; otherwise (the
//   tower's 45, 230, 460 and 921) a channel past C wraps to 0 within it.
// * s and t are read from shared memory one float at a time from tables
//   with one unused slot after every 8 channels: lane j of a warp reads
//   channel c0 + 8 j + k, which lands in bank 9 j + const, 32 banks for 32
//   lanes (16 wavefronts a warp's vector against 32 for two unpadded
//   16-byte reads, whose lanes 32 bytes apart meet two to a bank).
// * The elements past the last whole vector, and a whole tensor whose
//   pointers are not 16-byte aligned or whose C is under a vector's width,
//   go one element a thread. Offsets are 64-bit: layer1's midplane at
//   batch 128 is 1.73e9 elements.
// * The arithmetic: one fused multiply-add per element, the residual added
//   in fp32, ReLU, one rounding (the plain version rounds after the
//   BatchNorm and again after the add).
//
// Channels outside (bn_act_planar_kernel; the audio tower's NCHW maps): a
// warp a channel plane at a time, s and t of the plane's channel computed
// by each lane as the prologue does, the plane's elements up to its first
// 16-byte boundary and past its last one a lane each, the vectors between
// kUnroll a lane in flight. Planes need not start on a vector: the audio
// stem's is 129 x 50 positions.
//
// Plain C interface, loaded with ctypes by selavi_tpu_torch/ops/bn_act.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;  // 16-byte vectors in flight a thread
constexpr int kMaxChannels = 4096;
constexpr int kMaxDevices = 64;

// The slot of channel c in a padded table: one slot skipped after every 8.
__host__ __device__ __forceinline__ int slot(int c) { return c + (c >> 3); }

// Floats in each padded table (a multiple of 4, so the second stays
// 16-byte aligned).
__host__ __device__ __forceinline__ int table_floats(int c) {
  return (slot(c - 1) + 1 + 3) & ~3;
}

template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static void store(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

struct Params {
  const void* x;
  const void* r;  // null: no residual
  void* y;
  const float *weight, *bias, *mean, *var;
  float eps;
  int c;
  int64_t numel;
  int64_t inner;    // elements of a channel plane; 1 with channels fastest
  int64_t nvec;     // whole 16-byte vectors taken by the vector loop
  bool vectors;     // x, r and y 16-byte aligned
};

// s = weight / sqrt(var + eps) and t = bias - mean * s of channel ch,
// rounded at each step, with no fused multiply-add.
__device__ __forceinline__ void scale_shift(const Params& p, int ch, float* s,
                                            float* t) {
  *s = __fdiv_rn(p.weight[ch], __fsqrt_rn(__fadd_rn(p.var[ch], p.eps)));
  *t = __fsub_rn(p.bias[ch], __fmul_rn(p.mean[ch], *s));
}

template <bool kRelu>
__device__ __forceinline__ float act(float v) {
  // NaN stays NaN, as torch's relu keeps it
  return kRelu && v < 0.f ? 0.f : v;
}

template <typename T, bool kWrap, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bn_act_kernel(Params p) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  extern __shared__ float4 smem4[];
  float* s_tab = reinterpret_cast<float*>(smem4);
  float* t_tab = s_tab + table_floats(p.c);
  const int c = p.c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads)
    scale_shift(p, ch, &s_tab[slot(ch)], &t_tab[slot(ch)]);
  __syncthreads();

  const T* x = static_cast<const T*>(p.x);
  const T* r = static_cast<const T*>(p.r);
  T* y = static_cast<T*>(p.y);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* yv = reinterpret_cast<uint4*>(y);

  // Vector loop: block b's step covers vectors [b * kThreads * kUnroll,
  // +kThreads * kUnroll); thread i of it takes i, i + kThreads, ...
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  const int c_step = static_cast<int>((step * kN) % c);
  int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll +
                 threadIdx.x;
  int c0[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    c0[k] = static_cast<int>(((base + k * kThreads) * kN) % c);
  for (; base < p.nvec; base += step) {
    uint4 xs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < p.nvec) {
        xs[k] = __ldcs(xv + i);
        if (kRes) rs[k] = __ldcs(rv + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < p.nvec) {
        float f[kN], g[kN];
        V::unpack(xs[k], f);
        if (kRes) V::unpack(rs[k], g);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          int ch = c0[k] + j;
          if (kWrap && ch >= c) ch -= c;
          const int sl = slot(ch);
          float v = fmaf(f[j], s_tab[sl], t_tab[sl]);
          if (kRes) v += g[j];
          f[j] = act<kRelu>(v);
        }
        __stcs(yv + i, V::pack(f));
      }
      c0[k] += c_step;
      if (c0[k] >= c) c0[k] -= c;
    }
  }

  // Elements past the vectors, one a thread.
  for (int64_t e = p.nvec * kN +
                   static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < p.numel; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int sl = slot(static_cast<int>(e % c));
    float v = fmaf(V::load(x + e), s_tab[sl], t_tab[sl]);
    if (kRes) v += V::load(r + e);
    V::store(y + e, act<kRelu>(v));
  }
}

// One warp a channel plane of inner elements, planes n * C + c in turn.
template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bn_act_planar_kernel(Params p) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  const T* x = static_cast<const T*>(p.x);
  const T* r = static_cast<const T*>(p.r);
  T* y = static_cast<T*>(p.y);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t planes = p.numel / p.inner;
  for (int64_t plane = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) / 32;
       plane < planes; plane += warps) {
    float s, t;
    scale_shift(p, static_cast<int>(plane % p.c), &s, &t);
    const int64_t e0 = plane * p.inner, e1 = e0 + p.inner;
    // whole vectors [v0, v1); the elements outside them one a lane
    int64_t v0 = 0, v1 = 0;
    if (p.vectors) {
      v0 = (e0 + kN - 1) / kN;
      v1 = e1 / kN;
    }
    const bool any = v1 > v0;  // else every element one a lane
    const int64_t head = any ? v0 * kN : e1;
    const int64_t tail = any ? v1 * kN : e1;
    for (int64_t e = e0 + lane; e < head; e += 32) {
      float v = fmaf(V::load(x + e), s, t);
      if (kRes) v += V::load(r + e);
      V::store(y + e, act<kRelu>(v));
    }
    for (int64_t base = v0 + lane; base < v1; base += 32 * kUnroll) {
      uint4 xs[kUnroll], rs[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = base + 32 * k;
        if (i < v1) {
          xs[k] = __ldcs(xv + i);
          if (kRes) rs[k] = __ldcs(rv + i);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = base + 32 * k;
        if (i < v1) {
          float f[kN], g[kN];
          V::unpack(xs[k], f);
          if (kRes) V::unpack(rs[k], g);
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            float v = fmaf(f[j], s, t);
            if (kRes) v += g[j];
            f[j] = act<kRelu>(v);
          }
          __stcs(yv + i, V::pack(f));
        }
      }
    }
    for (int64_t e = tail + lane; e < e1; e += 32) {
      float v = fmaf(V::load(x + e), s, t);
      if (kRes) v += V::load(r + e);
      V::store(y + e, act<kRelu>(v));
    }
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The device's SM count, asked of the runtime once a device.
cudaError_t sm_count(int* out) {
  static std::mutex mu;
  static int kept[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (kept[device] == 0) {
    e = cudaDeviceGetAttribute(&kept[device],
                               cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  *out = kept[device];
  return cudaSuccess;
}

template <typename T, bool kWrap, bool kRes, bool kRelu>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int64_t blocks = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (p.inner > 1) {
    // a warp a plane, as many as there are planes up to the persistent grid
    constexpr int64_t kWarps = kThreads / 32;
    int64_t grid = (p.numel / p.inner + kWarps - 1) / kWarps;
    if (blocks < grid) grid = blocks;
    bn_act_planar_kernel<T, kRes, kRelu>
        <<<static_cast<int>(grid), kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  constexpr int64_t kPerBlock = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t tail = p.numel - p.nvec * Vec<T>::kN;
  int64_t want = (p.nvec + kPerBlock - 1) / kPerBlock;
  const int64_t want_tail = (tail + kThreads - 1) / kThreads;
  if (want_tail > want) want = want_tail;
  int64_t grid = blocks;
  if (want < grid) grid = want;
  const size_t smem = 2 * sizeof(float) * table_floats(p.c);
  bn_act_kernel<T, kWrap, kRes, kRelu>
      <<<static_cast<int>(grid), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kWrap>
cudaError_t launch_act(const Params& p, bool relu, cudaStream_t stream) {
  if (p.r != nullptr)
    return relu ? launch<T, kWrap, true, true>(p, stream)
                : launch<T, kWrap, true, false>(p, stream);
  return relu ? launch<T, kWrap, false, true>(p, stream)
              : launch<T, kWrap, false, false>(p, stream);
}

template <typename T>
cudaError_t launch_type(Params p, bool relu, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  p.vectors = aligned16(p.x) && aligned16(p.y) &&
              (p.r == nullptr || aligned16(p.r));
  p.nvec = p.vectors && p.inner == 1 && p.c >= kN ? p.numel / kN : 0;
  return p.inner > 1 || p.c % kN == 0 ? launch_act<T, false>(p, relu, stream)
                       : launch_act<T, true>(p, relu, stream);
}

}  // namespace

extern "C" {

// y = act(x * s[c] + t[c] (+ r)) over numel elements of x (and r, y), the
// channel of element i (i / inner) mod C: inner 1 for channels fastest,
// else the elements of a channel plane; weight, bias, mean and var fp32
// [C]; dtype 0 bf16, 1 fp32; r null for no residual; relu 0 or 1. x, r and
// y of one type and element-aligned, numel a multiple of C * inner, 1 <= C
// <= 4096. Returns the cudaError_t of the launch (0 on success); nothing
// is synchronised.
int bn_act_fwd(const void* x, const void* r, void* y, const void* weight,
               const void* bias, const void* mean, const void* var,
               double eps, long long numel, int c, long long inner,
               int dtype, int relu, void* stream) {
  if (x == nullptr || y == nullptr || weight == nullptr || bias == nullptr ||
      mean == nullptr || var == nullptr || numel <= 0 || c < 1 ||
      c > kMaxChannels || inner < 1 || numel % (c * inner) != 0 ||
      (dtype != 0 && dtype != 1) || (relu != 0 && relu != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.r = r;
  p.y = y;
  p.weight = static_cast<const float*>(weight);
  p.bias = static_cast<const float*>(bias);
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.eps = static_cast<float>(eps);
  p.c = c;
  p.numel = numel;
  p.inner = inner;
  p.nvec = 0;
  p.vectors = false;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch_type<bf16>(p, relu != 0, s)
                                   : launch_type<float>(p, relu != 0, s);
  return static_cast<int>(e);
}

}  // extern "C"

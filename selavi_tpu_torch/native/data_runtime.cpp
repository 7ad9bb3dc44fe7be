// The host data runtime of the PyTorch/CUDA port: the C++ half of its
// input pipeline and of modality matching. A copy of the JAX package's
// selavi_tpu/native/data_runtime.cpp with the same arithmetic, so both
// packages compute the same bits; the tests hold one against the other.
//
//   * selavi_logfbank_batch: preemphasis + rectangular-window framing +
//     1024-point real FFT (iterative radix-2) + mel filterbank projection +
//     eps-floored log, threaded over the batch. Semantics match
//     selavi_tpu_torch.data.audio.logfbank (parity-tested).
//   * selavi_resize_bilinear_u8: THWC uint8 bilinear resize (the loader's
//     scale-jitter resize), threaded over frames. Semantics match the
//     reference's torch F.interpolate(mode="bilinear",
//     align_corners=false): 2-tap, half-pixel centers, no antialias.
//   * selavi_greedy_swap_match: the greedy random-swap permutation search
//     of selavi_tpu_torch.selflabel.matching over a K x K cost matrix.
//
// C ABI only; bound from Python with ctypes
// (selavi_tpu_torch/native/__init__.py), built with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------- FFT ----
// Precomputed radix-2 plan shared by every frame of every batch sample:
// bit-reversal permutation + per-stage twiddle tables (removes the serial
// sin/cos recurrence of the naive loop), and the SPARSE structure of the
// triangular mel filters (each filter touches a short contiguous bin run,
// so the dense [nfilt, nbins] projection is ~95% multiplications by zero).
struct FftPlan {
  int n;
  std::vector<int> bitrev;
  std::vector<float> tw_re, tw_im;  // concatenated per-stage tables
  std::vector<int> stage_off;       // offset of each stage's table
  // sparse mel: filter m covers bins [lo[m], hi[m]) with weights w
  std::vector<int> mel_lo, mel_hi, mel_off;
  std::vector<float> mel_w;

  FftPlan(int nfft, const double* fb, int nfilt) : n(nfft) {
    bitrev.resize(n);
    for (int i = 1, j = 0; i < n; ++i) {
      int bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      bitrev[i] = j;
    }
    stage_off.clear();
    for (int len = 2; len <= n; len <<= 1) {
      stage_off.push_back((int)tw_re.size());
      for (int j = 0; j < len / 2; ++j) {
        double ang = -2.0 * kPi * j / len;
        tw_re.push_back((float)std::cos(ang));
        tw_im.push_back((float)std::sin(ang));
      }
    }
    const int nbins = n / 2 + 1;
    mel_lo.resize(nfilt);
    mel_hi.resize(nfilt);
    mel_off.resize(nfilt);
    for (int m = 0; m < nfilt; ++m) {
      const double* row = fb + (size_t)m * nbins;
      int lo = 0, hi = nbins;
      while (lo < nbins && row[lo] == 0.0) ++lo;
      while (hi > lo && row[hi - 1] == 0.0) --hi;
      mel_lo[m] = lo;
      mel_hi[m] = hi;
      mel_off[m] = (int)mel_w.size();
      for (int b = lo; b < hi; ++b) mel_w.push_back((float)row[b]);
    }
  }

  void fft(float* re, float* im) const {
    int stage = 0;
    for (int len = 2; len <= n; len <<= 1, ++stage) {
      const float* wr = tw_re.data() + stage_off[stage];
      const float* wi = tw_im.data() + stage_off[stage];
      const int half = len / 2;
      for (int i = 0; i < n; i += len) {
        float* re0 = re + i;
        float* im0 = im + i;
        float* re1 = re0 + half;
        float* im1 = im0 + half;
        for (int j = 0; j < half; ++j) {
          float vr = re1[j] * wr[j] - im1[j] * wi[j];
          float vi = re1[j] * wi[j] + im1[j] * wr[j];
          float ur = re0[j], ui = im0[j];
          re0[j] = ur + vr;
          im0[j] = ui + vi;
          re1[j] = ur - vr;
          im1[j] = ui - vi;
        }
      }
    }
  }
};

void one_sample_logfbank(
    const float* pcm, int slen, int nfft, int frame_len, int frame_step,
    int nframes, const FftPlan& plan, int nfilt, double preemph,
    float* out /* [nfilt, nframes] */) {
  const int nbins = nfft / 2 + 1;
  std::vector<float> sig(slen);
  sig[0] = pcm[0];
  for (int i = 1; i < slen; ++i)
    sig[i] = pcm[i] - (float)preemph * pcm[i - 1];

  // two real frames per complex FFT: z = frame_f + i*frame_{f+1};
  // X[k] = (Z[k] + conj(Z[n-k]))/2, Y[k] = (Z[k] - conj(Z[n-k]))/(2i)
  std::vector<float> re(nfft), im(nfft);
  std::vector<float> pspec0(nbins), pspec1(nbins);
  const float inv_n = 1.0f / (float)nfft;
  for (int f = 0; f < nframes; f += 2) {
    const bool pair = f + 1 < nframes;
    std::fill(re.begin(), re.end(), 0.0f);
    std::fill(im.begin(), im.end(), 0.0f);
    {
      // write inputs bit-reverse-permuted so the FFT body skips the swap
      const int start = f * frame_step;
      const int avail = std::max(0, std::min(frame_len, slen - start));
      for (int i = 0; i < avail; ++i)
        re[plan.bitrev[i]] = sig[start + i];
    }
    if (pair) {
      const int start = (f + 1) * frame_step;
      const int avail = std::max(0, std::min(frame_len, slen - start));
      for (int i = 0; i < avail; ++i)
        im[plan.bitrev[i]] = sig[start + i];
    }
    plan.fft(re.data(), im.data());
    const int mask = nfft - 1;
    for (int b = 0; b < nbins; ++b) {
      const int nk = (nfft - b) & mask;
      const float xr = 0.5f * (re[b] + re[nk]);
      const float xi = 0.5f * (im[b] - im[nk]);
      pspec0[b] = (xr * xr + xi * xi) * inv_n;
      if (pair) {
        const float yr = 0.5f * (im[b] + im[nk]);
        const float yi = 0.5f * (re[nk] - re[b]);
        pspec1[b] = (yr * yr + yi * yi) * inv_n;
      }
    }
    for (int half = 0; half < (pair ? 2 : 1); ++half) {
      const float* ps = half ? pspec1.data() : pspec0.data();
      const int col = f + half;
      for (int m = 0; m < nfilt; ++m) {
        double acc = 0.0;
        const float* w = plan.mel_w.data() + plan.mel_off[m];
        for (int b = plan.mel_lo[m]; b < plan.mel_hi[m]; ++b)
          acc += (double)ps[b] * (double)w[b - plan.mel_lo[m]];
        if (acc <= 0.0) acc = 2.220446049250313e-16;  // float64 eps
        out[(size_t)m * nframes + col] = (float)std::log(acc);
      }
    }
  }
}

void parallel_for_impl(int n, int nthreads,
                       const std::function<void(int)>& fn) {
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  int per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] {
      for (int i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}
}  // namespace

extern "C" {

// pcm [B, S] float32 -> out [B, nfilt, nframes] float32.
// fb is the mel filterbank [nfilt, nfft/2+1] float64 (computed in Python so
// bin-edge semantics are bit-identical to the host numpy implementation).
void selavi_logfbank_batch(const float* pcm, int batch, int slen, int sr,
                           const double* fb, int nfilt, int nfft,
                           int frame_len, int frame_step, int nframes,
                           double preemph, float* out, int nthreads) {
  (void)sr;
  const FftPlan plan(nfft, fb, nfilt);  // shared, read-only across threads
  parallel_for_impl(batch, nthreads, [&](int b) {
    one_sample_logfbank(pcm + (size_t)b * slen, slen, nfft, frame_len,
                        frame_step, nframes, plan, nfilt, preemph,
                        out + (size_t)b * nfilt * nframes);
  });
}

// in [T, H, W, C] uint8 -> out [T, newH, newW, C] uint8, 2-tap bilinear
// (half-pixel centers, edge clamp, no antialias — torch F.interpolate
// semantics, like the reference), threaded over frames.
void selavi_resize_bilinear_u8(const uint8_t* in, int t, int h, int w, int c,
                               uint8_t* out, int new_h, int new_w,
                               int nthreads) {
  const double sy = (double)h / new_h;
  const double sx = (double)w / new_w;
  parallel_for_impl(t, nthreads, [&](int f) {
    const uint8_t* src = in + (size_t)f * h * w * c;
    uint8_t* dst = out + (size_t)f * new_h * new_w * c;
    for (int y = 0; y < new_h; ++y) {
      double fy = (y + 0.5) * sy - 0.5;
      int y0 = (int)std::floor(fy);
      double wy = fy - y0;
      int y1 = std::min(y0 + 1, h - 1);
      y0 = std::max(y0, 0);
      for (int x = 0; x < new_w; ++x) {
        double fx = (x + 0.5) * sx - 0.5;
        int x0 = (int)std::floor(fx);
        double wx = fx - x0;
        int x1 = std::min(x0 + 1, w - 1);
        x0 = std::max(x0, 0);
        for (int ch = 0; ch < c; ++ch) {
          double v00 = src[((size_t)y0 * w + x0) * c + ch];
          double v01 = src[((size_t)y0 * w + x1) * c + ch];
          double v10 = src[((size_t)y1 * w + x0) * c + ch];
          double v11 = src[((size_t)y1 * w + x1) * c + ch];
          double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                     v10 * wy * (1 - wx) + v11 * wy * wx;
          dst[((size_t)y * new_w + x) * c + ch] =
              (uint8_t)std::min(255.0, std::max(0.0, v + 0.5));
        }
      }
    }
  });
}

}  // extern "C"

// ------------------------------------------------------------------ match
// Greedy random-swap permutation search over a precomputed K x K column
// cost matrix (the host half of modality alignment,
// selavi_tpu_torch/selflabel/matching.py). Same algorithm as the Python
// implementation: propose random (i, j), accept if it lowers
// sum_k C[k, perm[k]], stop after `patience` non-improving proposals,
// keep the best of `restarts` restarts. xorshift RNG (seeded) — the
// proposal sequence differs from numpy's, but the search target and
// acceptance rule are identical.
extern "C" {

void selavi_greedy_swap_match(const double* cost, int k, int steps,
                              int restarts, int patience, uint64_t seed,
                              int32_t* out_perm) {
  std::vector<int32_t> best(k);
  for (int i = 0; i < k; ++i) best[i] = i;
  double best_cost = 0;
  for (int i = 0; i < k; ++i) best_cost += cost[(size_t)i * k + i];

  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
  auto next = [&s]() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
  };

  std::vector<int32_t> perm(k);
  std::vector<double> cur(k);
  for (int r = 0; r < restarts; ++r) {
    for (int i = 0; i < k; ++i) perm[i] = i;
    for (int i = 0; i < k; ++i) cur[i] = cost[(size_t)i * k + i];
    int last_improve = 0;
    for (int it = 0; it < steps; ++it) {
      int i = (int)(next() % (uint64_t)k);
      int j = (int)(next() % (uint64_t)k);
      if (i == j) continue;
      double current = cur[i] + cur[j];
      double future = cost[(size_t)i * k + perm[j]] +
                      cost[(size_t)j * k + perm[i]];
      if (current - future > 0) {
        std::swap(perm[i], perm[j]);
        cur[i] = cost[(size_t)i * k + perm[i]];
        cur[j] = cost[(size_t)j * k + perm[j]];
        last_improve = it;
      }
      if (it - last_improve > patience) break;
    }
    double total = 0;
    for (int i = 0; i < k; ++i) total += cur[i];
    if (total < best_cost) {
      best_cost = total;
      best = std::vector<int32_t>(perm.begin(), perm.end());
    }
  }
  std::copy(best.begin(), best.end(), out_perm);
}

}  // extern "C"

// Masked speech/noise spatial covariances, both in one pass over the spectra.
//
// Replaces: disco_tpu/ops/cov_ops.py::masked_cov_pallas -> _cov_kernel (a mask
// shared by the channels) and _cov_kernel_chan (one mask per channel).
//
// What it computes, per batch b and frequency bin f, over the T frames:
//   Rss[b, f, c, d] = sum_t w_s(t) Y[b, c, f, t] conj(Y[b, d, f, t])
//   Rnn[b, f, c, d] = sum_t w_n(t) Y[b, c, f, t] conj(Y[b, d, f, t])
// shared mask m:        w_s = m^2 / T,        w_n = (1 - m)^2 / T
// per-channel masks:    w_s = m_c m_d / T,    w_n = (1 - m_c)(1 - m_d) / T
// as the upper triangle c <= d plus its Hermitian mirror.  Y is read as
// interleaved complex64 (B, C, F, T) and the pair is written as complex64
// (B, F, C, C), the layouts of the caller: no planar split, no transpose.
//
// Bound on an H100: bytes.  The step-2 stack of the main path (8 nodes x
// 11 channels x 257 bins x 626 frames) is ~118 MB read once, ~35 us at
// 3.35 TB/s, against ~1.2 GFLOP.  The design: one block per (b, f); the
// block stages 64 frames of its C rows and mask(s) in shared memory with
// coalesced loads (each row of a bin is contiguous in T), and each thread
// owns one upper-triangle pair (10 at C = 4, 66 at C = 11) and runs its four
// float32 sums over t in a fixed order.  No atomics: the reduction order is
// fixed, so the result is bit-identical from run to run.
#include "common.cuh"

namespace {

constexpr int kMaxC = 16;
constexpr int kTT = 64;  // frames staged per step

template <bool CHAN>
__global__ void masked_cov_kernel(const float2* __restrict__ y, const float* __restrict__ mask,
                                  float2* __restrict__ rss, float2* __restrict__ rnn,
                                  const int C, const int F, const int T, const float inv_t) {
  // +1 pad: rows of one time step fall in distinct banks
  __shared__ float2 ys[kMaxC][kTT + 1];
  __shared__ float ms[CHAN ? kMaxC : 1][kTT + 1];

  const int bf = blockIdx.x;  // b * F + f
  const int b = bf / F, f = bf % F;
  const int tid = threadIdx.x;
  const int P = C * (C + 1) / 2;
  const bool active = tid < P;
  int c = 0, d = 0;
  if (active) {  // upper-triangle pair of this thread, row by row
    int r = tid;
    while (r >= C - c) {
      r -= C - c;
      ++c;
    }
    d = c + r;
  }
  const size_t row = (size_t)F * T;  // stride between channels
  const float2* yb = y + (size_t)b * C * row + (size_t)f * T;
  const float* mb = CHAN ? mask + (size_t)b * C * row + (size_t)f * T
                         : mask + ((size_t)b * F + f) * T;
  const int n_mask = CHAN ? C : 1;

  float ssr = 0.0f, ssi = 0.0f, nnr = 0.0f, nni = 0.0f;
  for (int t0 = 0; t0 < T; t0 += kTT) {
    const int nt = min(kTT, T - t0);
    for (int e = tid; e < C * kTT; e += blockDim.x) {
      const int cc = e / kTT, tt = e % kTT;
      if (tt < nt) ys[cc][tt] = yb[cc * row + t0 + tt];
    }
    for (int e = tid; e < n_mask * kTT; e += blockDim.x) {
      const int cc = e / kTT, tt = e % kTT;
      if (tt < nt) ms[cc][tt] = mb[cc * row + t0 + tt];
    }
    __syncthreads();
    if (active) {
      for (int tt = 0; tt < nt; ++tt) {
        const float2 yc = ys[c][tt], yd = ys[d][tt];
        float ws, wn;
        if constexpr (CHAN) {
          const float mc = ms[c][tt], md = ms[d][tt];
          ws = (mc * md) * inv_t;
          wn = ((1.0f - mc) * (1.0f - md)) * inv_t;
        } else {
          const float m = ms[0][tt], om = 1.0f - m;
          ws = (m * m) * inv_t;
          wn = (om * om) * inv_t;
        }
        // Y_c conj(Y_d): re = rc rd + ic id, im = ic rd - rc id
        const float prr = yc.x * yd.x + yc.y * yd.y;
        const float pii = yc.y * yd.x - yc.x * yd.y;
        ssr += ws * prr;
        ssi += ws * pii;
        nnr += wn * prr;
        nni += wn * pii;
      }
    }
    __syncthreads();
  }
  if (active) {
    if (c == d) {  // a Hermitian diagonal is real
      ssi = 0.0f;
      nni = 0.0f;
    }
    float2* Rs = rss + (size_t)bf * C * C;
    float2* Rn = rnn + (size_t)bf * C * C;
    Rs[c * C + d] = make_float2(ssr, ssi);
    Rn[c * C + d] = make_float2(nnr, nni);
    if (c != d) {
      Rs[d * C + c] = make_float2(ssr, -ssi);
      Rn[d * C + c] = make_float2(nnr, -nni);
    }
  }
}

}  // namespace

// y: (B, C, F, T) complex64; mask: (B, F, T) float32, or (B, C, F, T) when
// per_channel_mask != 0; rss, rnn: (B, F, C, C) complex64.
extern "C" int disco_masked_cov(const void* y, const void* mask, void* rss, void* rnn, int B,
                                int C, int F, int T, int per_channel_mask, void* stream) {
  if (B <= 0 || F <= 0) return (int)cudaSuccess;
  if (C < 1 || C > kMaxC || T < 1) return (int)cudaErrorInvalidValue;
  const int P = C * (C + 1) / 2;
  const int threads = (P + 31) / 32 * 32;
  const float inv_t = 1.0f / (float)T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* yy = static_cast<const float2*>(y);
  const float* mm = static_cast<const float*>(mask);
  float2* a = static_cast<float2*>(rss);
  float2* b = static_cast<float2*>(rnn);
  if (per_channel_mask)
    masked_cov_kernel<true><<<B * F, threads, 0, s>>>(yy, mm, a, b, C, F, T, inv_t);
  else
    masked_cov_kernel<false><<<B * F, threads, 0, s>>>(yy, mm, a, b, C, F, T, inv_t);
  return (int)cudaGetLastError();
}

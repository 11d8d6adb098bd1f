// Fused rank-1 GEVD-MWF solve, one thread per (C x C) Hermitian pencil.
//
// Replaces: disco_tpu/ops/mwf_ops.py::fused_mwf_pallas -> _mwf_kernel (helpers
// _elem_cholesky, _elem_whiten, and eigh_ops.py::_lane_rotation).
//
// What it computes, per pencil (Rss, Rnn) and its mu, step for step as the
// TPU kernel: scale both by 1/max(tr(Rnn)/C, FLT_MIN) -> diagonal load
// 1e-6 tr/C + FLT_MIN -> complex Cholesky L of Rnn -> A = L^-1 Rss L^-H,
// re-hermitized -> `sweeps` cyclic-by-rows Jacobi sweeps with V (the
// jacobi_rotation of common.cuh, eps = sqrt(FLT_MIN) guard) -> the dominant
// pair by a strict running max over the diagonal -> lambda clipped to
// [EIG_FLOOR, EIG_CEIL] -> q1 = L^-H u1 -> W = q1 lambda/(lambda+mu)
// conj(u1[0] L00), t1 = q1 conj(u1[0] L00).  NaNs propagate (the e1
// sanitize step is the caller's); the ragged edge is masked by the thread
// index, so no identity padding is needed.
//
// Bound on an H100: operations.  At the step-2 width (C = 11, 7 sweeps)
// a pencil costs ~2e5 float ops against ~2 KB of input, but the main path
// has only K*F = 2056 pencils per step: 2056 threads fill ~16 of 132 SMs'
// worth of warps, so the kernel is latency-bound far above its bound.  The
// design keeps each pencil in one thread's registers (templated on C = 4
// and 11 with every loop unrolled on constant indices, a generic C <= 16
// path of runtime loops in local memory); at C = 11 the ~700 live floats exceed the 255
// registers and spill to local memory (counts in PERF.md).  Blocks of 32
// threads spread the few warps over as many SMs (and L1 caches for the
// spills) as possible.
#include <cfloat>

#include "common.cuh"

namespace {

struct MwfParams {
  float eps;        // rotation guard, sqrt(FLT_MIN)
  float loading;    // relative diagonal loading, 1e-6
  float lam_floor;  // EIG_FLOOR
  float lam_ceil;   // EIG_CEIL
};

constexpr int kThreads = 32;

template <int CM, bool FIXED>
__global__ void __launch_bounds__(kThreads)
    fused_mwf_kernel(const float2* __restrict__ rss, const float2* __restrict__ rnn,
                     const float* __restrict__ mu, float2* __restrict__ w,
                     float2* __restrict__ t1, const int n, const int c_rt, const int sweeps,
                     const MwfParams prm) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int C = FIXED ? CM : c_rt;
  const float2* S = rss + (size_t)idx * C * C;
  const float2* N = rnn + (size_t)idx * C * C;

  float Ar[CM][CM], Ai[CM][CM];  // Rss, then B = L^-1 Rss, then A
  float Lr[CM][CM], Li[CM][CM];  // lower triangle of Rnn, then L in place
  float Mr[CM][CM], Mi[CM][CM];  // M = L^-1 B^H, then the eigenvectors V
  float inv[CM];                 // 1 / L[i][i]

  // Every loop runs to C: a constant in the FIXED instances, where the
  // loops unroll fully and the planes stay in registers; a runtime bound in
  // the generic one, whose loops stay loops (a quick compile).
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float2 s = S[i * C + j];
      Ar[i][j] = s.x;
      Ai[i][j] = s.y;
      if (j <= i) {
        const float2 v = N[i * C + j];
        Lr[i][j] = v.x;
        Li[i][j] = v.y;
      }
    }
  }

  // -- joint scale normalization (filter-invariant)
  float tr = Lr[0][0];
#pragma unroll
  for (int c = 1; c < C; ++c) tr = tr + Lr[c][c];
  tr = tr * (1.0f / C);
  const float scale = 1.0f / disco::max_keep_nan(tr, FLT_MIN);
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      Ar[i][j] = Ar[i][j] * scale;
      Ai[i][j] = Ai[i][j] * scale;
      if (j <= i) {
        Lr[i][j] = Lr[i][j] * scale;
        Li[i][j] = Li[i][j] * scale;
      }
    }
  }

  // -- relative diagonal loading
  float tr2 = Lr[0][0];
#pragma unroll
  for (int c = 1; c < C; ++c) tr2 = tr2 + Lr[c][c];
  const float load = prm.loading * (tr2 * (1.0f / C)) + FLT_MIN;

  // -- complex Cholesky in place (NaN for a non-PSD pencil via sqrtf)
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float d = Lr[j][j] + load;
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - (Lr[j][k] * Lr[j][k] + Li[j][k] * Li[j][k]);
    const float ljj = sqrtf(d);
    const float iv = 1.0f / ljj;
    Lr[j][j] = ljj;
    Li[j][j] = 0.0f;
    inv[j] = iv;
#pragma unroll
    for (int i = j + 1; i < C; ++i) {
      float ar = Lr[i][j], ai = Li[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        // A[i][j] - sum_k L[i][k] conj(L[j][k])
        ar = ar - (Lr[i][k] * Lr[j][k] + Li[i][k] * Li[j][k]);
        ai = ai - (Li[i][k] * Lr[j][k] - Lr[i][k] * Li[j][k]);
      }
      Lr[i][j] = ar * iv;
      Li[i][j] = ai * iv;
    }
  }

  // -- whitening: B = L^-1 Rss by rows (in place), M = L^-1 B^H
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float rr = Ar[i][j], ri = Ai[i][j];
#pragma unroll
      for (int k = 0; k < i; ++k) {
        const float lr = Lr[i][k], li = Li[i][k];
        rr = rr - (lr * Ar[k][j] - li * Ai[k][j]);
        ri = ri - (lr * Ai[k][j] + li * Ar[k][j]);
      }
      Ar[i][j] = rr * inv[i];
      Ai[i][j] = ri * inv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float rr = Ar[j][i], ri = -Ai[j][i];  // B^H[i][j] = conj(B[j][i])
#pragma unroll
      for (int k = 0; k < i; ++k) {
        rr = rr - (Lr[i][k] * Mr[k][j] - Li[i][k] * Mi[k][j]);
        ri = ri - (Lr[i][k] * Mi[k][j] + Li[i][k] * Mr[k][j]);
      }
      Mr[i][j] = rr * inv[i];
      Mi[i][j] = ri * inv[i];
    }
  }
  // A = M^H re-hermitized: A[i][j] = (conj(M[j][i]) + M[i][j]) / 2
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      Ar[i][j] = 0.5f * (Mr[j][i] + Mr[i][j]);
      Ai[i][j] = 0.5f * (Mi[i][j] - Mi[j][i]);
    }
  }

  // -- fixed-sweep cyclic Jacobi with eigenvector accumulation (V in M)
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      Mr[i][j] = i == j ? 1.0f : 0.0f;
      Mi[i][j] = 0.0f;
    }
  }
  disco::jacobi_sweeps<CM, FIXED>(Ar, Ai, Mr, Mi, C, sweeps, prm.eps);

  // -- dominant pair: strict running max over the converged diagonal
  float best = Ar[0][0];
  float ur[CM], ui[CM];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    ur[i] = Mr[i][0];
    ui[i] = Mi[i][0];
  }
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const bool better = Ar[c][c] > best;
    best = better ? Ar[c][c] : best;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      ur[i] = better ? Mr[i][c] : ur[i];
      ui[i] = better ? Mi[i][c] : ui[i];
    }
  }
  float lam1 = best < prm.lam_floor ? prm.lam_floor : best;  // NaN stays NaN
  lam1 = lam1 > prm.lam_ceil ? prm.lam_ceil : lam1;

  // -- back-substitution q1 = L^-H u1 (L^H upper triangular)
  float qr[CM], qi[CM];
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    float rr = ur[i], ri = ui[i];
#pragma unroll
    for (int k = i + 1; k < C; ++k) {
      const float lr = Lr[k][i], li = -Li[k][i];  // L^H[i][k] = conj(L[k][i])
      rr = rr - (lr * qr[k] - li * qi[k]);
      ri = ri - (lr * qi[k] + li * qr[k]);
    }
    qr[i] = rr * inv[i];
    qi[i] = ri * inv[i];
  }

  // -- filter formation: (Q^-1)[0][0] = conj(u1[0] L00)
  const float qinv_r = ur[0] * Lr[0][0];
  const float qinv_i = -ui[0] * Lr[0][0];
  const float g = lam1 / (lam1 + mu[idx]);
  const float cr = g * qinv_r, ci = g * qinv_i;
  float2* W = w + (size_t)idx * C;
  float2* T1 = t1 + (size_t)idx * C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    W[i] = make_float2(qr[i] * cr - qi[i] * ci, qr[i] * ci + qi[i] * cr);
    T1[i] = make_float2(qr[i] * qinv_r - qi[i] * qinv_i, qr[i] * qinv_i + qi[i] * qinv_r);
  }
}

}  // namespace

// rss, rnn: (n, C, C) complex64; mu: (n,) float32; w, t1: (n, C) complex64.
extern "C" int disco_fused_mwf(const void* rss, const void* rnn, const void* mu, void* w,
                               void* t1, int n, int C, int sweeps, float eps, float loading,
                               float lam_floor, float lam_ceil, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C < 1 || C > 16 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const MwfParams prm{eps, loading, lam_floor, lam_ceil};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* a = static_cast<const float2*>(rss);
  const float2* b = static_cast<const float2*>(rnn);
  const float* m = static_cast<const float*>(mu);
  float2* wo = static_cast<float2*>(w);
  float2* to = static_cast<float2*>(t1);
  switch (C) {
    case 4:
      fused_mwf_kernel<4, true><<<blocks, kThreads, 0, s>>>(a, b, m, wo, to, n, C, sweeps, prm);
      break;
    case 11:
      fused_mwf_kernel<11, true><<<blocks, kThreads, 0, s>>>(a, b, m, wo, to, n, C, sweeps, prm);
      break;
    default:
      fused_mwf_kernel<16, false><<<blocks, kThreads, 0, s>>>(a, b, m, wo, to, n, C, sweeps, prm);
      break;
  }
  return (int)cudaGetLastError();
}

// Fused rank-1 GEVD-MWF solve: a thread per (C x C) Hermitian pencil up to
// C = 4, a group of lanes per pencil with its planes in shared memory above.
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
// sanitize step is the caller's); the ragged edge is masked by the pencil
// index, so no identity padding is needed.  mu is a per-pencil array, or
// one value for every pencil (a null pointer or a stride of 0).
//
// Bound on an H100: operations.  At the step-2 width (C = 11, 7 sweeps) a
// pencil costs ~2e5 float operations against ~2 KB of input, but the main
// path hands a launch only K*F = 2056 pencils (32,896 at the 16-clip
// batch), each a serial chain of 385 rotations of ~650 cycles (three
// correctly rounded square roots and three divisions, PERF.md): latency
// first, instruction issue at large batches.  Two designs, chosen by C, as
// in eigh.cu:
// - C <= 4 (step 1): a thread per pencil, its planes in registers, every
//   loop unrolled on constant indices (one instance for each C from 1 to
//   4); the rotations are common.cuh's jacobi_sweeps.
// - C >= 5 (step 2): a group of G lanes per pencil (G = 8 for C <= 8, else
//   16: four or two pencils a warp), lane l owning row and column l.  A, L
//   and V sit in shared memory as interleaved complex C x C matrices with an
//   odd row stride (one 8-byte access an entry, columns on distinct banks).
//   The Cholesky goes column by column:
//   lane j takes the diagonal's square root and reciprocal, a shuffle
//   broadcasts it, lanes i > j form L[i][j].  The whitening's B = L^-1 Rss
//   and M = L^-1 B^H are C independent right-hand sides: lane j solves
//   column j.  The sweeps are common.cuh's group_rotation with runtime
//   (p, q) (the eigensolver's rotation; unrolled, a C = 11 sweep is more
//   code than the instruction caches hold).  Each lane runs the same running
//   max over the diagonal, lane 0 the back-substitution, lane i stores W[i]
//   and t1[i].
// Each element is computed by the expression of the plain version, in its
// order, and the source is built with -fmad=false (see _build.py), as
// eigh.cu is: the kernel then repeats fused_mwf_plain's rounding.
#include <cfloat>

#include "common.cuh"

namespace {

struct MwfParams {
  float eps;        // rotation guard, sqrt(FLT_MIN)
  float loading;    // relative diagonal loading, 1e-6
  float lam_floor;  // EIG_FLOOR
  float lam_ceil;   // EIG_CEIL
};

constexpr int kMaxC = 16;

// lambda clipped to [floor, ceil]; NaN stays NaN
__device__ __forceinline__ float clip_lambda(const float best, const MwfParams& prm) {
  const float lam = best < prm.lam_floor ? prm.lam_floor : best;
  return lam > prm.lam_ceil ? prm.lam_ceil : lam;
}

// A pencil entry as the chain starts from it: the bf16 lane (BF16 instances,
// the TPU kernel's precision='bf16' branch) rounds its real and imaginary
// part to bf16 at load (ops/resolve.py's rounding points, _bf16_round of the
// reference); the rest of the chain is the f32 lane's.
__device__ __forceinline__ float2 load_plane(const float2 v, const bool bf16) {
  return bf16 ? make_float2(disco::bf16_round(v.x), disco::bf16_round(v.y)) : v;
}

// ---------------------------------------------------------------- C <= 4
constexpr int kThreads = 32;

template <int C, bool BF16>
__global__ void __launch_bounds__(kThreads)
    fused_mwf_thread_kernel(const float2* __restrict__ rss, const float2* __restrict__ rnn,
                            const float* __restrict__ mu, const int mu_stride,
                            const float mu_value, float2* __restrict__ w,
                            float2* __restrict__ t1, const int n, const int sweeps,
                            const MwfParams prm) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float2* S = rss + (size_t)idx * C * C;
  const float2* N = rnn + (size_t)idx * C * C;

  float Ar[C][C], Ai[C][C];  // Rss, then B = L^-1 Rss, then A
  float Lr[C][C], Li[C][C];  // lower triangle of Rnn, then L in place
  float Mr[C][C], Mi[C][C];  // M = L^-1 B^H, then the eigenvectors V
  float inv[C];              // 1 / L[i][i]

#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float2 s = load_plane(S[i * C + j], BF16);
      Ar[i][j] = s.x;
      Ai[i][j] = s.y;
      if (j <= i) {
        const float2 v = load_plane(N[i * C + j], BF16);
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

  // -- complex Cholesky in place (NaN for a non-PSD pencil)
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float d = Lr[j][j] + load;
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - (Lr[j][k] * Lr[j][k] + Li[j][k] * Li[j][k]);
    const float ljj = disco::sqrt_rn(d);
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
  disco::jacobi_sweeps<C>(Ar, Ai, Mr, Mi, sweeps, prm.eps);

  // -- dominant pair: strict running max over the converged diagonal
  float best = Ar[0][0];
  float ur[C], ui[C];
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
  const float lam1 = clip_lambda(best, prm);

  // -- back-substitution q1 = L^-H u1 (L^H upper triangular)
  float qr[C], qi[C];
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
  const float m = mu ? mu[(size_t)idx * mu_stride] : mu_value;
  const float g = lam1 / (lam1 + m);
  const float cr = g * qinv_r, ci = g * qinv_i;
  float2* W = w + (size_t)idx * C;
  float2* T1 = t1 + (size_t)idx * C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    W[i] = make_float2(qr[i] * cr - qi[i] * ci, qr[i] * ci + qi[i] * cr);
    T1[i] = make_float2(qr[i] * qinv_r - qi[i] * qinv_i, qr[i] * qinv_i + qi[i] * qinv_r);
  }
}

template <int C>
void launch_thread(const float2* a, const float2* b, const float* mu, int mu_stride,
                   float mu_value, float2* w, float2* t1, int n, int sweeps,
                   const MwfParams& prm, bool bf16, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (bf16)
    fused_mwf_thread_kernel<C, true><<<blocks, kThreads, 0, s>>>(a, b, mu, mu_stride, mu_value,
                                                                  w, t1, n, sweeps, prm);
  else
    fused_mwf_thread_kernel<C, false><<<blocks, kThreads, 0, s>>>(a, b, mu, mu_stride, mu_value,
                                                                   w, t1, n, sweeps, prm);
}

// ---------------------------------------------------------------- C >= 5
// Pencils a block of the lane-group design holds: 64 threads.
template <int G>
constexpr int kGroupPencils = 64 / G;

// Floats of shared memory a pencil takes: three C x (C | 1) complex
// matrices (A, L, V, interleaved re/im), then 1 / L[i][i] and q1 (re, im),
// kMaxC each.
__host__ __device__ constexpr int group_floats(const int C) { return 6 * C * (C | 1) + 3 * kMaxC; }

// A group of G lanes per pencil (C <= G), lane l owning row and column l of
// A, V and L.
template <int G, bool BF16>
__global__ void __launch_bounds__(G * kGroupPencils<G>)
    fused_mwf_group_kernel(const float2* __restrict__ rss, const float2* __restrict__ rnn,
                           const float* __restrict__ mu, const int mu_stride,
                           const float mu_value, float2* __restrict__ w,
                           float2* __restrict__ t1, const int n, const int C, const int sweeps,
                           const MwfParams prm) {
  constexpr int kPencils = kGroupPencils<G>;
  constexpr int kThreadsG = G * kPencils;
  extern __shared__ float2 sm2[];
  const int S = C | 1;  // row stride (odd: columns hit distinct banks)
  const int cs = C * S, cc = C * C, per = group_floats(C) / 2;  // in float2
  const int first = blockIdx.x * kPencils;
  const int count = min(kPencils, n - first);

  // coalesced loads: Rss into A, Rnn into L; pencils past the end are zeros
  // (their chain runs on finite values and stores nothing)
  const float2* a2 = rss + (size_t)first * cc;
  const float2* b2 = rnn + (size_t)first * cc;
  for (int e = threadIdx.x; e < kPencils * cc; e += kThreadsG) {
    const int m = e / cc, r = (e - m * cc) / C, k = e - m * cc - r * C;
    float2 x = make_float2(0.0f, 0.0f), v = make_float2(0.0f, 0.0f);
    if (m < count) {
      x = load_plane(a2[e], BF16);
      v = load_plane(b2[e], BF16);
    }
    sm2[m * per + r * S + k] = x;
    sm2[m * per + cs + r * S + k] = v;
  }
  __syncthreads();

  const int l = threadIdx.x % G;
  const int pencil = threadIdx.x / G;
  float2* A = sm2 + pencil * per;
  float2* L = A + cs;
  float2* V = L + cs;
  float* inv = reinterpret_cast<float*>(V + cs);
  float* qr = inv + kMaxC;
  float* qi = qr + kMaxC;

  // -- joint scale normalization; every lane reads the same trace
  float tr = L[0].x;
  for (int c = 1; c < C; ++c) tr = tr + L[c * S + c].x;
  tr = tr * (1.0f / C);
  const float scale = 1.0f / disco::max_keep_nan(tr, FLT_MIN);
  __syncwarp();
  if (l < C) {
    for (int i = 0; i < C; ++i) {
      const float2 a = A[i * S + l], b = L[i * S + l];
      A[i * S + l] = make_float2(a.x * scale, a.y * scale);
      L[i * S + l] = make_float2(b.x * scale, b.y * scale);
    }
  }
  __syncwarp();

  // -- relative diagonal loading
  float tr2 = L[0].x;
  for (int c = 1; c < C; ++c) tr2 = tr2 + L[c * S + c].x;
  const float load = prm.loading * (tr2 * (1.0f / C)) + FLT_MIN;

  // -- complex Cholesky, column by column: lane i >= j forms L[i][j] less
  // the sum over k < j (at i == j, with the load, the diagonal's radicand);
  // lane j takes the root and its reciprocal, and a shuffle broadcasts the
  // reciprocal.
  for (int j = 0; j < C; ++j) {
    const int i = l >= j && l < C ? l : j;
    float2 x = L[i * S + j];
    if (i == j) x.x = x.x + load;
    for (int k = 0; k < j; ++k) {
      // A[i][j] - sum_k L[i][k] conj(L[j][k])
      const float2 u = L[i * S + k], v = L[j * S + k];
      x.x = x.x - (u.x * v.x + u.y * v.y);
      x.y = x.y - (u.y * v.x - u.x * v.y);
    }
    const float ljj = disco::sqrt_rn(x.x);  // used by lane j only
    const float ivj = 1.0f / ljj;
    const float iv = __shfl_sync(0xffffffffu, ivj, j, G);
    __syncwarp();  // row j is read by every lane before lane j writes it
    if (l == j) {
      L[j * S + j] = make_float2(ljj, 0.0f);
      inv[j] = ivj;
    } else if (l > j && l < C) {
      L[l * S + j] = make_float2(x.x * iv, x.y * iv);
    }
    __syncwarp();
  }

  // -- whitening: B = L^-1 Rss, lane j solving column j in place
  const int j0 = l < C ? l : 0;  // idle lanes read a valid column and write nothing
  for (int i = 0; i < C; ++i) {
    float2 x = A[i * S + j0];
    for (int k = 0; k < i; ++k) {
      const float2 u = L[i * S + k], b = A[k * S + j0];
      x.x = x.x - (u.x * b.x - u.y * b.y);
      x.y = x.y - (u.x * b.y + u.y * b.x);
    }
    if (l < C) A[i * S + l] = make_float2(x.x * inv[i], x.y * inv[i]);
  }
  __syncwarp();
  // M = L^-1 B^H into V, lane j solving column j: B^H[i][j] = conj(B[j][i])
  for (int i = 0; i < C; ++i) {
    const float2 b = A[j0 * S + i];
    float2 x = make_float2(b.x, -b.y);
    for (int k = 0; k < i; ++k) {
      const float2 u = L[i * S + k], m = V[k * S + j0];
      x.x = x.x - (u.x * m.x - u.y * m.y);
      x.y = x.y - (u.x * m.y + u.y * m.x);
    }
    if (l < C) V[i * S + l] = make_float2(x.x * inv[i], x.y * inv[i]);
  }
  __syncwarp();
  // A = M^H re-hermitized: A[i][j] = (conj(M[j][i]) + M[i][j]) / 2
  if (l < C) {
    for (int i = 0; i < C; ++i) {
      const float2 mt = V[l * S + i], m = V[i * S + l];
      A[i * S + l] = make_float2(0.5f * (mt.x + m.x), 0.5f * (m.y - mt.y));
    }
  }
  __syncwarp();
  if (l < C) {
    for (int i = 0; i < C; ++i) V[i * S + l] = make_float2(i == l ? 1.0f : 0.0f, 0.0f);
  }
  __syncwarp();

  // -- fixed-sweep cyclic Jacobi with eigenvector accumulation
  const disco::InterleavedMatrix Am{A, S}, Vm{V, S};
#pragma unroll 1
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll 1
    for (int p = 0; p < C - 1; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < C; ++q) disco::group_rotation<G>(Am, Vm, C, p, q, l, prm.eps);
    }
  }

  // -- dominant pair: strict running max over the converged diagonal, the
  // same in every lane
  float best = A[0].x;
  int top = 0;
  for (int c = 1; c < C; ++c) {
    const float v = A[c * S + c].x;
    if (v > best) {
      best = v;
      top = c;
    }
  }
  const float lam1 = clip_lambda(best, prm);

  // -- back-substitution q1 = L^-H u1 (L^H upper triangular), by lane 0
  if (l == 0) {
    for (int i = C - 1; i >= 0; --i) {
      const float2 u = V[i * S + top];
      float rr = u.x, ri = u.y;
      for (int k = i + 1; k < C; ++k) {
        const float2 lk = L[k * S + i];
        const float lr = lk.x, li = -lk.y;  // L^H[i][k] = conj(L[k][i])
        rr = rr - (lr * qr[k] - li * qi[k]);
        ri = ri - (lr * qi[k] + li * qr[k]);
      }
      qr[i] = rr * inv[i];
      qi[i] = ri * inv[i];
    }
  }
  __syncwarp();

  // -- filter formation: (Q^-1)[0][0] = conj(u1[0] L00); lane i stores
  // row i
  if (pencil < count && l < C) {
    const float2 u0 = V[top];
    const float qinv_r = u0.x * L[0].x;
    const float qinv_i = -u0.y * L[0].x;
    const int idx = first + pencil;
    const float m = mu ? mu[(size_t)idx * mu_stride] : mu_value;
    const float g = lam1 / (lam1 + m);
    const float cr = g * qinv_r, ci = g * qinv_i;
    const float xr = qr[l], xi = qi[l];
    w[(size_t)idx * C + l] = make_float2(xr * cr - xi * ci, xr * ci + xi * cr);
    t1[(size_t)idx * C + l] = make_float2(xr * qinv_r - xi * qinv_i, xr * qinv_i + xi * qinv_r);
  }
}

template <int G>
void launch_group(const float2* a, const float2* b, const float* mu, int mu_stride,
                  float mu_value, float2* w, float2* t1, int n, int C, int sweeps,
                  const MwfParams& prm, bool bf16, cudaStream_t s) {
  constexpr int kPencils = kGroupPencils<G>;
  const int blocks = (n + kPencils - 1) / kPencils;
  const size_t smem = sizeof(float) * kPencils * group_floats(C);
  if (bf16)
    fused_mwf_group_kernel<G, true><<<blocks, G * kPencils, smem, s>>>(
        a, b, mu, mu_stride, mu_value, w, t1, n, C, sweeps, prm);
  else
    fused_mwf_group_kernel<G, false><<<blocks, G * kPencils, smem, s>>>(
        a, b, mu, mu_stride, mu_value, w, t1, n, C, sweeps, prm);
}

}  // namespace

// rss, rnn: (n, C, C) complex64; mu: (n,) float32 read at mu[i * mu_stride]
// (mu_stride 0: one value for all), or null for mu_value; w, t1: (n, C)
// complex64; bf16 != 0 runs the bf16 lane.
extern "C" int disco_fused_mwf(const void* rss, const void* rnn, const void* mu, int mu_stride,
                               float mu_value, void* w, void* t1, int n, int C, int sweeps,
                               float eps, float loading, float lam_floor, float lam_ceil,
                               int bf16, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C < 1 || C > kMaxC || sweeps < 0) return (int)cudaErrorInvalidValue;
  const MwfParams prm{eps, loading, lam_floor, lam_ceil};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* a = static_cast<const float2*>(rss);
  const float2* b = static_cast<const float2*>(rnn);
  const float* m = static_cast<const float*>(mu);
  float2* wo = static_cast<float2*>(w);
  float2* to = static_cast<float2*>(t1);
  const bool bf = bf16 != 0;
  switch (C) {
    case 1: launch_thread<1>(a, b, m, mu_stride, mu_value, wo, to, n, sweeps, prm, bf, s); break;
    case 2: launch_thread<2>(a, b, m, mu_stride, mu_value, wo, to, n, sweeps, prm, bf, s); break;
    case 3: launch_thread<3>(a, b, m, mu_stride, mu_value, wo, to, n, sweeps, prm, bf, s); break;
    case 4: launch_thread<4>(a, b, m, mu_stride, mu_value, wo, to, n, sweeps, prm, bf, s); break;
    default:
      if (C <= 8) {
        launch_group<8>(a, b, m, mu_stride, mu_value, wo, to, n, C, sweeps, prm, bf, s);
      } else {
        launch_group<16>(a, b, m, mu_stride, mu_value, wo, to, n, C, sweeps, prm, bf, s);
      }
      break;
  }
  return (int)cudaGetLastError();
}

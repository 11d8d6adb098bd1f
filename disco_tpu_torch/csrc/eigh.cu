// Batched Hermitian eigendecomposition by fixed-sweep cyclic Jacobi: a
// thread per (C x C) matrix up to C = 4, a group of lanes per matrix with
// its planes in shared memory from C = 5.
//
// Replaces: disco_tpu/ops/eigh_ops.py::eigh_jacobi_pallas -> _eigh_kernel
// (helpers _lane_rotation and _rotation).
//
// What it computes, per matrix A, step for step as the TPU kernel: V = I,
// then `sweeps` cyclic-by-rows sweeps (every p < q, row by row) of the
// rotation A <- G^H A G, V <- V G that zeroes A[p][q] (the jacobi_rotation
// of common.cuh, identity where |A[p][q]| < eps = sqrt(FLT_MIN)); out come
// the UNSORTED converged diagonal and V.  The ascending sort runs outside,
// in the wrapper, as it runs outside the Pallas kernel.  A NaN matrix gives
// NaN pairs (the streaming ffill guard needs them).  Complex64 input is read
// interleaved, float32 input as is (imaginary planes zero); V is written in
// the input's type.  The ragged edge is masked by the matrix index, so the
// TPU kernel's identity padding is gone.
//
// Bound on an H100: operations.  A rotation costs ~(48 C + 20) float
// operations, 7 sweeps x 55 rotations at the streaming step-2 width C = 11:
// ~2e5 operations against ~1 KB read and ~1 KB written per matrix.  Each
// matrix is a serial chain of rotations, each rotation a chain of three
// correctly rounded square roots and three divisions (~650 cycles on an
// H100, exp/rotation_latency.py).  At the streaming window's batch (2056
// matrices) that chain's latency sets the time; at a whole clip's (322,792)
// the instructions run per matrix do.  Two designs, chosen by C:
// - C <= 4 (the streaming step-1 width): a thread per matrix, its four
//   C x C planes (A and V, re and im) in registers, every rotation unrolled
//   with constant indices (common.cuh's jacobi_sweeps).  Its 4 C updates a
//   rotation are few, so it runs the fewest instructions: 3.2-3.4x faster
//   than lane groups of 4 at a clip's batch, the same within the wrapper's
//   own time at a window's (exp/eigh_group_variants.py).
// - C >= 5: a group of G lanes owns a matrix (G = 8 for C <= 8, else 16:
//   four or two matrices a warp), its four planes in shared memory with odd
//   row strides.  A rotation (common.cuh's group_rotation) costs the
//   rotation's scalar math, one element update per lane for each of rows p
//   and q, columns p and q and V's columns p and q, four shuffles and two
//   warp barriers, instead of the 4 C complex updates of a thread per
//   matrix, whose four 11 x 11 planes also spill from the registers.  C and
//   (p, q) are runtime values: with every rotation of a C = 11 sweep
//   unrolled the kernel is ~15,000 instructions (~240 KB), more than the
//   instruction caches hold.  Blocks of 128 threads load their matrices
//   into shared memory with coalesced reads and write V and the diagonal
//   back the same way.  Lanes l >= C and the matrices past the end of the
//   batch (zeros: identity rotations) go through every barrier and write
//   nothing.
// The rotation's square roots go through sqrt_rn, sqrtf's fast path
// without its branch (the same bits).
//
// Built with -fmad=false (see _build.py): every product and sum is rounded
// on its own, in the order of the plain PyTorch version, whose element-wise
// ops are never contracted into FMAs.  The kernel then repeats the plain
// version's arithmetic, so both give the same eigenvectors even inside a
// degenerate eigenspace, where a last-bit difference would turn them by an
// arbitrary angle (the warm-up refreshes of the streaming path sit there).
#include "common.cuh"

namespace {

// A thread per C x C matrix, the planes in registers.
constexpr int kThreadBlock = 32;

template <int C>
__global__ void __launch_bounds__(kThreadBlock)
    eigh_thread_kernel(const float* __restrict__ a, float* __restrict__ lam,
                       float* __restrict__ v, const int n, const bool complex_in,
                       const int sweeps, const float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const size_t base = (size_t)idx * C * C;
  float Ar[C][C], Ai[C][C];  // the matrix, rotated towards its diagonal
  float Vr[C][C], Vi[C][C];  // the accumulated rotations
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (complex_in) {
        const float2 x = reinterpret_cast<const float2*>(a)[base + i * C + j];
        Ar[i][j] = x.x;
        Ai[i][j] = x.y;
      } else {
        Ar[i][j] = a[base + i * C + j];
        Ai[i][j] = 0.0f;
      }
      Vr[i][j] = i == j ? 1.0f : 0.0f;
      Vi[i][j] = 0.0f;
    }
  }
  disco::jacobi_sweeps<C>(Ar, Ai, Vr, Vi, sweeps, eps);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    lam[(size_t)idx * C + i] = Ar[i][i];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (complex_in) {
        reinterpret_cast<float2*>(v)[base + i * C + j] = make_float2(Vr[i][j], Vi[i][j]);
      } else {
        v[base + i * C + j] = Vr[i][j];
      }
    }
  }
}

template <int C>
void launch_thread(const float* a, float* lam, float* v, int n, bool cplx, int sweeps,
                   float eps, cudaStream_t s) {
  const int blocks = (n + kThreadBlock - 1) / kThreadBlock;
  eigh_thread_kernel<C><<<blocks, kThreadBlock, 0, s>>>(a, lam, v, n, cplx, sweeps, eps);
}

// A group of G lanes per matrix, the planes in shared memory.
constexpr int kThreads = 128;

template <int G>
__global__ void __launch_bounds__(kThreads)
    eigh_group_kernel(const float* __restrict__ a, float* __restrict__ lam,
                      float* __restrict__ v, const int n, const int C, const bool complex_in,
                      const int sweeps, const float eps) {
  constexpr int kMats = kThreads / G;      // matrices per block
  constexpr int kPlane = G * (G | 1);      // the largest plane a group takes
  __shared__ float sm[kMats][4][kPlane];   // Ar, Ai, Vr, Vi
  const int S = C | 1;                     // row stride (odd: columns hit distinct banks)
  const int cc = C * C;
  const int first = blockIdx.x * kMats;
  const int count = min(kMats, n - first);
  const float2* a2 = reinterpret_cast<const float2*>(a) + (size_t)first * cc;
  const float* a1 = a + (size_t)first * cc;
  for (int e = threadIdx.x; e < kMats * cc; e += kThreads) {
    const int m = e / cc, r = (e - m * cc) / C, k = e - m * cc - r * C;
    float re = 0.0f, im = 0.0f;
    if (m < count) {
      if (complex_in) {
        const float2 x = a2[e];
        re = x.x;
        im = x.y;
      } else {
        re = a1[e];
      }
    }
    sm[m][0][r * S + k] = re;
    sm[m][1][r * S + k] = im;
    sm[m][2][r * S + k] = r == k ? 1.0f : 0.0f;
    sm[m][3][r * S + k] = 0.0f;
  }
  __syncthreads();

  const int l = threadIdx.x % G;
  float* Ar = sm[threadIdx.x / G][0];
  float* Ai = sm[threadIdx.x / G][1];
  float* Vr = sm[threadIdx.x / G][2];
  float* Vi = sm[threadIdx.x / G][3];
#pragma unroll 1
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll 1
    for (int p = 0; p < C - 1; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < C; ++q) disco::group_rotation<G>(Ar, Ai, Vr, Vi, C, S, p, q, l, eps);
    }
  }
  __syncthreads();

  float2* v2 = reinterpret_cast<float2*>(v) + (size_t)first * cc;
  float* v1 = v + (size_t)first * cc;
  for (int e = threadIdx.x; e < count * cc; e += kThreads) {
    const int m = e / cc, r = (e - m * cc) / C, k = e - m * cc - r * C;
    if (complex_in) {
      v2[e] = make_float2(sm[m][2][r * S + k], sm[m][3][r * S + k]);
    } else {
      v1[e] = sm[m][2][r * S + k];
    }
  }
  float* lo = lam + (size_t)first * C;
  for (int e = threadIdx.x; e < count * C; e += kThreads) {
    const int m = e / C, i = e - m * C;
    lo[e] = sm[m][0][i * S + i];
  }
}

template <int G>
void launch(const float* a, float* lam, float* v, int n, int C, bool cplx, int sweeps,
            float eps, cudaStream_t s) {
  constexpr int kMats = kThreads / G;
  const int blocks = (n + kMats - 1) / kMats;
  eigh_group_kernel<G><<<blocks, kThreads, 0, s>>>(a, lam, v, n, C, cplx, sweeps, eps);
}

}  // namespace

// a: (n, C, C) complex64 (complex_in) or float32; lam: (n, C) float32, the
// unsorted diagonal; v: (n, C, C) in the type of a.
extern "C" int disco_eigh_jacobi(const void* a, void* lam, void* v, int n, int C,
                                 int complex_in, int sweeps, float eps, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C < 1 || C > 16 || sweeps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ain = static_cast<const float*>(a);
  float* lo = static_cast<float*>(lam);
  float* vo = static_cast<float*>(v);
  const bool cplx = complex_in != 0;
  if (C == 1) {
    launch_thread<1>(ain, lo, vo, n, cplx, sweeps, eps, s);
  } else if (C == 2) {
    launch_thread<2>(ain, lo, vo, n, cplx, sweeps, eps, s);
  } else if (C == 3) {
    launch_thread<3>(ain, lo, vo, n, cplx, sweeps, eps, s);
  } else if (C == 4) {
    launch_thread<4>(ain, lo, vo, n, cplx, sweeps, eps, s);
  } else if (C <= 8) {
    launch<8>(ain, lo, vo, n, C, cplx, sweeps, eps, s);
  } else {
    launch<16>(ain, lo, vo, n, C, cplx, sweeps, eps, s);
  }
  return (int)cudaGetLastError();
}

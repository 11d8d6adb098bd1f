// Batched Hermitian eigendecomposition by fixed-sweep cyclic Jacobi, one
// thread per (C x C) matrix.
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
// the input's type.  The ragged edge is masked by the thread index, so the
// TPU kernel's identity padding is gone.
//
// Bound on an H100: operations.  A rotation costs ~(48 C + 20) float
// operations, 7 sweeps x 55 rotations at the streaming step-2 width C = 11:
// ~2e5 operations against ~1 KB read and ~1 KB written per matrix.  The
// design keeps each matrix in one thread's registers (templated on C = 4
// and 11, where every rotation unrolls on constant indices within a sweep
// while the sweep loop stays rolled; a generic C <= 16 path of runtime
// loops), as the fused solve (mwf.cu) does.  At C = 11 the four 11 x 11
// planes exceed the 255 registers and spill to local memory.  Blocks of 32
// threads, as in mwf.cu; on an H100 they time the same as blocks of 128 at
// both of the streaming path's batch sizes (2056 matrices a refresh block,
// 322,792 a whole clip): one thread's serial chain of rotations, not the
// spread over SMs, sets the time (PERF.md).
//
// Built with -fmad=false (see _build.py): every product and sum is rounded
// on its own, in the order of the plain PyTorch version, whose element-wise
// ops are never contracted into FMAs.  The kernel then repeats the plain
// version's arithmetic, so both give the same eigenvectors even inside a
// degenerate eigenspace, where a last-bit difference would turn them by an
// arbitrary angle (the warm-up refreshes of the streaming path sit there).
#include "common.cuh"

namespace {

constexpr int kThreads = 32;

template <int CM, bool FIXED>
__global__ void __launch_bounds__(kThreads)
    eigh_jacobi_kernel(const float* __restrict__ a, float* __restrict__ lam,
                       float* __restrict__ v, const int n, const int c_rt,
                       const bool complex_in, const int sweeps, const float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int C = FIXED ? CM : c_rt;
  const size_t base = (size_t)idx * C * C;

  float Ar[CM][CM], Ai[CM][CM];  // the matrix, rotated towards its diagonal
  float Vr[CM][CM], Vi[CM][CM];  // the accumulated rotations
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

  disco::jacobi_sweeps<CM, FIXED>(Ar, Ai, Vr, Vi, C, sweeps, eps);

  float* L = lam + (size_t)idx * C;
#pragma unroll
  for (int i = 0; i < C; ++i) L[i] = Ar[i][i];
#pragma unroll
  for (int i = 0; i < C; ++i) {
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

}  // namespace

// a: (n, C, C) complex64 (complex_in) or float32; lam: (n, C) float32, the
// unsorted diagonal; v: (n, C, C) in the type of a.
extern "C" int disco_eigh_jacobi(const void* a, void* lam, void* v, int n, int C,
                                 int complex_in, int sweeps, float eps, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C < 1 || C > 16 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ain = static_cast<const float*>(a);
  float* lo = static_cast<float*>(lam);
  float* vo = static_cast<float*>(v);
  const bool cplx = complex_in != 0;
  switch (C) {
    case 4:
      eigh_jacobi_kernel<4, true><<<blocks, kThreads, 0, s>>>(ain, lo, vo, n, C, cplx, sweeps, eps);
      break;
    case 11:
      eigh_jacobi_kernel<11, true><<<blocks, kThreads, 0, s>>>(ain, lo, vo, n, C, cplx, sweeps, eps);
      break;
    default:
      eigh_jacobi_kernel<16, false><<<blocks, kThreads, 0, s>>>(ain, lo, vo, n, C, cplx, sweeps, eps);
      break;
  }
  return (int)cudaGetLastError();
}

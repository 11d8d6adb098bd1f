// Centered STFT (+ magnitude): framing, periodic Hann window and the real DFT
// as float32 products against precomputed cos/sin tables, in one launch.
//
// Replaces: disco_tpu/ops/stft_ops.py::stft_pallas -> _stft_kernel.
//
// What it computes: for each row b of the reflect-padded signal xp (the
// wrapper pads) and frame t (samples t*hop .. t*hop + n_fft - 1),
//   re[b, f, t] = sum_n xp[b, t*hop + n] win[n] Dre[n, f]
//   im[b, f, t] = sum_n xp[b, t*hop + n] win[n] Dim[n, f]
//   mag[b, f, t] = sqrt(re^2 + im^2)            (when mag != nullptr)
// with Dre/Dim the (n_fft, n_fft/2+1) tables built once on the host in
// float64 and cast to float32 (dft_matrices), written straight into the
// (B, F, T) complex64 spec and float32 magnitude planes the caller uses.
// Sums run over n in order with float32 FMAs: no TF32, no tensor cores.
//
// Bound on an H100: bytes.  A 10 s, 96-row clip stack needs ~0.8 GFLOP by
// FFT against ~247 MB moved (signal in, spectrum and magnitude out), ~0.074 ms
// at 3.35 TB/s.  The DFT product this kernel runs instead is ~31.7 GFLOP,
// ~0.47 ms at 67 TFLOP/s of non-tensor-core FP32: the algorithm, not the
// memory, limits it, 6x above the function's bound however well it is tuned.
// The design is a plain register-tiled product: a block computes 64 frames
// x 32 bins, staging 32 windowed samples of its 64 frames and 32 rows of
// both tables in shared memory per step; each of 128 threads keeps 4 frames
// x 4 bins of (re, im) sums in registers, 32 FMAs per 12 shared loads.
// The framed (B, T, n_fft) signal never exists in device memory.
#include "common.cuh"

namespace {

constexpr int kBM = 64;   // frames per block
constexpr int kBF = 32;   // frequency bins per block
constexpr int kBK = 32;   // samples per step
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    stft_kernel(const float* __restrict__ xp, const float* __restrict__ win,
                const float* __restrict__ dre, const float* __restrict__ dim,
                float2* __restrict__ spec, float* __restrict__ mag, const int Lp,
                const int n_fft, const int hop, const int n_freq, const int T,
                const int t_tiles) {
  __shared__ float As[kBK][kBM + 1];  // windowed samples, [n][frame]
  __shared__ float Cs[kBK][kBF];      // cos table rows
  __shared__ float Ss[kBK][kBF];      // sin table rows

  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * kBM;
  const int f0 = blockIdx.y * kBF;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // frames t0 + tx + 16 i
  const int ty = tid / 16;  // bins f0 + ty + 8 j
  const float* x = xp + (size_t)b * Lp;

  float acc_re[4][4], acc_im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_re[i][j] = 0.0f;
      acc_im[i][j] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < n_fft; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int e = tid + kThreads * r;
      const int kk = e % kBK, i = e / kBK;
      const int t = t0 + i, n = k0 + kk;
      As[kk][i] = (t < T && n < n_fft) ? x[(size_t)t * hop + n] * win[n] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBF / kThreads; ++r) {
      const int e = tid + kThreads * r;
      const int jj = e % kBF, kk = e / kBF;
      const int f = f0 + jj, n = k0 + kk;
      const bool ok = f < n_freq && n < n_fft;
      Cs[kk][jj] = ok ? dre[(size_t)n * n_freq + f] : 0.0f;
      Ss[kk][jj] = ok ? dim[(size_t)n * n_freq + f] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], c[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Cs[kk][ty + 8 * j];
        s[j] = Ss[kk][ty + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(a[i], c[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(a[i], s[j], acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * i, f = f0 + ty + 8 * j;
      if (t < T && f < n_freq) {
        const size_t o = ((size_t)b * n_freq + f) * T + t;
        const float re = acc_re[i][j], im = acc_im[i][j];
        spec[o] = make_float2(re, im);
        if (mag != nullptr) mag[o] = sqrtf(re * re + im * im);
      }
    }
  }
}

}  // namespace

// xp: (B, Lp) float32 reflect-padded rows; win: (n_fft,); dre, dim:
// (n_fft, n_freq); spec: (B, n_freq, T) complex64; mag: (B, n_freq, T)
// float32 or null.
extern "C" int disco_stft(const void* xp, const void* win, const void* dre, const void* dim,
                          void* spec, void* mag, int B, int Lp, int n_fft, int hop,
                          int n_freq, int T, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (n_fft < 1 || hop < 1 || n_freq < 1 || (size_t)(T - 1) * hop + n_fft > (size_t)Lp)
    return (int)cudaErrorInvalidValue;
  const int t_tiles = (T + kBM - 1) / kBM;
  const dim3 grid(B * t_tiles, (n_freq + kBF - 1) / kBF);
  stft_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(win),
      static_cast<const float*>(dre), static_cast<const float*>(dim),
      static_cast<float2*>(spec), static_cast<float*>(mag), Lp, n_fft, hop, n_freq, T,
      t_tiles);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code returned by any entry point.
extern "C" const char* disco_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

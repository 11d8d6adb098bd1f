// Centered STFT (+ magnitude) as a shared-memory real FFT: reflect padding,
// framing, periodic Hann window, one 512-point real FFT per frame and the
// magnitude, in one launch.
//
// Replaces: disco_tpu/ops/stft_ops.py::stft_pallas -> _stft_kernel.
//
// What it computes: for each row b of x (B, L) and frame t of the centered
// STFT (padded samples t*256 .. t*256 + 511 of the row reflect-padded by 256
// at both ends, T = 1 + L / 256 frames),
//   spec[b, k, t] = sum_n x_pad[b, t*256 + n] win[n] e^{-2 pi i k n / 512},  k = 0 .. 256
//   mag[b, k, t]  = sqrt(re^2 + im^2)            (when mag != nullptr)
// written straight into the (B, 257, T) complex64 spec and float32 magnitude
// planes the caller uses: the same function as the TPU kernel's DFT product
// and as the plain version (stft_ops.stft_matmul), by another algorithm.
//
// Bound on an H100: bytes.  A 10 s, 96-row clip stack needs ~0.8 GFLOP by
// FFT against ~247 MB moved (signal in, spectrum and magnitude out), ~0.074
// ms at 3.35 TB/s.  The design (one block of 256 threads per row and tile of
// 32 frames, ~107 KB of dynamic shared memory, two blocks per SM):
//   1. the tile's strip of the row, (32 + 1) * 256 samples, is read once
//      with coalesced loads; the reflect padding happens here, by reflecting
//      the index at both ends of the row, so no padded copy of the signal is
//      ever written;
//   2. each frame's 512 windowed samples are packed as a 256-point complex
//      sequence z[m] = x[2m] + i x[2m+1] and transformed by a four-step
//      16 x 16 FFT: 16 lanes a frame, each lane a 16-point FFT in registers
//      (radix 4 x 4) over the stride-16 samples, the twiddle w256^(n2 k1),
//      a transpose through shared memory (rows padded to 17, frames 272
//      apart: no bank conflicts), and the second 16-point FFT;
//   3. the split post-pass X[k] = E[k] + w512^k O[k] from Z[k] and
//      conj Z[256 - k] gives the 257 bins, one warp per bin and one lane per
//      frame, so that each warp's stores run along T, the fastest axis of
//      (B, F, T), and coalesce; the magnitude comes from the same registers.
// Twiddles come from host tables (stft_ops.rfft_tables: float64 from exact
// integer-mod angles, cast to float32); no sin/cos runs on the device.  Float32
// throughout, a fixed order of operations, no atomics, no tensor cores.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kN = 512;                  // n_fft
constexpr int kHop = 256;                // hop
constexpr int kM = kN / 2;               // points of the packed complex FFT
constexpr int kFreq = kN / 2 + 1;        // bins
constexpr int kTile = 32;                // frames per block
constexpr int kThreads = 256;            // 16 lanes a frame, 16 frames at a time
constexpr int kStrip = (kTile - 1) * kHop + kN;  // samples a tile reads
constexpr int kBStride = 16 * 17;        // a frame's transpose rows (17 = 16 + pad)
constexpr int kZStride = kM + 1;         // a frame's spectrum (odd: lanes = frames)
constexpr int kPlane = kTile * kBStride; // floats of one re/im plane
// dynamic shared memory, in floats: strip, two planes, window, tw, post
constexpr int kSmemFloats = kStrip + 2 * kPlane + kN + 2 * kM + 2 * (kM + 1) + 2;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ void cmul(float& r, float& i, const float2 w) {
  const float t = r * w.x - i * w.y;
  i = r * w.y + i * w.x;
  r = t;
}

// y_k = sum_n a_n (-i)^{n k}, n, k = 0 .. 3, in place on (r[o + s j], i[o + s j]).
template <int O, int S>
__device__ __forceinline__ void fft4(float (&r)[16], float (&i)[16]) {
  const float t0r = r[O] + r[O + 2 * S], t0i = i[O] + i[O + 2 * S];
  const float t1r = r[O] - r[O + 2 * S], t1i = i[O] - i[O + 2 * S];
  const float t2r = r[O + S] + r[O + 3 * S], t2i = i[O + S] + i[O + 3 * S];
  const float t3r = r[O + S] - r[O + 3 * S], t3i = i[O + S] - i[O + 3 * S];
  r[O] = t0r + t2r;
  i[O] = t0i + t2i;
  r[O + S] = t1r + t3i;
  i[O + S] = t1i - t3r;
  r[O + 2 * S] = t0r - t2r;
  i[O + 2 * S] = t0i - t2i;
  r[O + 3 * S] = t1r - t3i;
  i[O + 3 * S] = t1i + t3r;
}

// X[k] = sum_n x[n] w16^{n k} on 16 values in registers, natural order in and
// out: x[4 n1 + n2] -> 4-point FFTs over n1 (position 4 k1 + n2 then holds
// (n2, k1)) -> twiddle w16^{n2 k1} = tw[16 n2 k1] -> 4-point FFTs over n2
// (position 4 k1 + k2 then holds X[k1 + 4 k2]) -> a 4 x 4 transpose, which
// only renames registers.
__device__ __forceinline__ void fft16(float (&r)[16], float (&i)[16], const float2* tw) {
  fft4<0, 4>(r, i);
  fft4<1, 4>(r, i);
  fft4<2, 4>(r, i);
  fft4<3, 4>(r, i);
#pragma unroll
  for (int n2 = 1; n2 < 4; ++n2) {
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1) cmul(r[4 * k1 + n2], i[4 * k1 + n2], tw[16 * n2 * k1]);
  }
  fft4<0, 1>(r, i);
  fft4<4, 1>(r, i);
  fft4<8, 1>(r, i);
  fft4<12, 1>(r, i);
  // position 4 k1 + k2 holds X[k1 + 4 k2]: transpose the 4 x 4 in registers
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      float t = r[4 * a + b];
      r[4 * a + b] = r[4 * b + a];
      r[4 * b + a] = t;
      t = i[4 * a + b];
      i[4 * a + b] = i[4 * b + a];
      i[4 * b + a] = t;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    stft_rfft_kernel(const float* __restrict__ x, const float* __restrict__ win_g,
                     const float2* __restrict__ tw_g, const float2* __restrict__ post_g,
                     float2* __restrict__ spec, float* __restrict__ mag, const int L,
                     const int T, const int t_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;                               // kStrip samples
  float* bre = strip + kStrip;                       // transpose, then spectrum
  float* bim = bre + kPlane;
  float* win = bim + kPlane;                         // kN
  float2* tw = reinterpret_cast<float2*>(win + kN);  // kM
  float2* post = tw + kM;                            // kM + 1

  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * kTile;
  const int tid = threadIdx.x;
  const float* row = x + (size_t)b * L;

  for (int j = tid; j < kN; j += kThreads) win[j] = win_g[j];
  for (int j = tid; j < kM; j += kThreads) tw[j] = tw_g[j];
  for (int j = tid; j <= kM; j += kThreads) post[j] = post_g[j];
  // the strip: padded samples t0*hop .. t0*hop + kStrip - 1, reflected into the row
  const int p0 = t0 * kHop - kN / 2;
  for (int j = tid; j < kStrip; j += kThreads) {
    int s = p0 + j;
    s = s < 0 ? -s : s;
    s = s >= L ? 2 * (L - 1) - s : s;
    strip[j] = (s >= 0 && s < L) ? row[s] : 0.0f;  // out of range only past the last frame
  }
  __syncthreads();

  const int lane = tid & 15;  // n2 in the first pass, k1 in the second
  const int fr = tid >> 4;    // frames fr and fr + 16 of the tile
  const float2* strip2 = reinterpret_cast<const float2*>(strip);
  const float2* win2 = reinterpret_cast<const float2*>(win);

  // first pass: lane n2 of frame f transforms z[16 n1 + n2] over n1, twiddles
  // by w256^{n2 k1} and writes B[f][n2][k1] (rows of 17)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = fr + 16 * h;
    float r[16], im[16];
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) {
      const int m = 16 * n1 + lane;
      const float2 s = strip2[f * (kHop / 2) + m];
      const float2 w = win2[m];
      r[n1] = s.x * w.x;
      im[n1] = s.y * w.y;
    }
    fft16(r, im, tw);
#pragma unroll
    for (int k1 = 1; k1 < 16; ++k1) cmul(r[k1], im[k1], tw[(lane * k1) & (kM - 1)]);
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {
      bre[f * kBStride + lane * 17 + k1] = r[k1];
      bim[f * kBStride + lane * 17 + k1] = im[k1];
    }
  }
  __syncthreads();

  // second pass: lane k1 of frame f transforms B[f][n2][k1] over n2 into
  // Z[k1 + 16 k2]; both frames are read before the planes are overwritten
  float zr[2][16], zi[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = fr + 16 * h;
#pragma unroll
    for (int n2 = 0; n2 < 16; ++n2) {
      zr[h][n2] = bre[f * kBStride + n2 * 17 + lane];
      zi[h][n2] = bim[f * kBStride + n2 * 17 + lane];
    }
    fft16(zr[h], zi[h], tw);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = fr + 16 * h;
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {
      bre[f * kZStride + lane + 16 * k2] = zr[h][k2];
      bim[f * kZStride + lane + 16 * k2] = zi[h][k2];
    }
  }
  __syncthreads();

  // post-pass: warp w takes bins w, w + 8, ..; lane = frame of the tile
  const int f = tid & 31;
  const int t = t0 + f;
  if (t >= T) return;
  for (int k = tid >> 5; k < kFreq; k += kThreads / 32) {
    const int ka = k & (kM - 1), kb = (kM - k) & (kM - 1);
    const float ar = bre[f * kZStride + ka], ai = bim[f * kZStride + ka];
    const float br = bre[f * kZStride + kb], bi = bim[f * kZStride + kb];
    // E = (Z[k] + conj Z[256-k]) / 2, O = (Z[k] - conj Z[256-k]) / 2i
    const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
    const float orr = 0.5f * (ai + bi), oi = 0.5f * (br - ar);
    const float2 w = post[k];
    const float xr = er + (w.x * orr - w.y * oi);
    const float xi = ei + (w.x * oi + w.y * orr);
    const size_t o = ((size_t)b * kFreq + k) * T + t;
    spec[o] = make_float2(xr, xi);
    if (mag != nullptr) mag[o] = sqrtf(xr * xr + xi * xi);
  }
}

}  // namespace

// x: (B, L) float32 rows, L > n_fft / 2; win: (n_fft,) float32; tw: (n_fft/2,)
// and post: (n_fft/2 + 1,) complex64 (stft_ops.rfft_tables); spec: (B, n_fft/2
// + 1, T) complex64; mag: (B, n_fft/2 + 1, T) float32 or null; T = 1 + L / hop.
// Takes n_fft = 512, hop = 256 only.
extern "C" int disco_stft(const void* x, const void* win, const void* tw, const void* post,
                          void* spec, void* mag, int B, int L, int n_fft, int hop, int T,
                          void* stream) {
  if (n_fft != kN || hop != kHop || L <= kN / 2 || T != 1 + L / kHop)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  // The shared-memory limit is an attribute of the kernel on each device and
  // never changes: set it on a device's first launch only (bit d of `set`).
  static std::atomic<unsigned long long> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(stft_rfft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int t_tiles = (T + kTile - 1) / kTile;
  stft_rfft_kernel<<<B * t_tiles, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float2*>(post),
      static_cast<float2*>(spec), static_cast<float*>(mag), L, T, t_tiles);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code returned by any entry point.
extern "C" const char* disco_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

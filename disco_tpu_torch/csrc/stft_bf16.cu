// Centered STFT (+ magnitude) of the bf16 lane: a DFT product on the tensor
// cores, bf16 operands and float32 accumulators.
//
// Replaces: disco_tpu/ops/stft_ops.py::stft_pallas -> _stft_kernel, its
// precision='bf16' branch (bf16 chunk views and DFT tables, float32
// accumulation in jnp.dot).  The f32 lane is stft.cu, a real FFT: the FFT
// has no bf16 form, so this lane computes the DFT product the TPU kernel
// runs.
//
// What it computes: for each row b of x (B, L), frame t of the centered STFT
// (padded samples t*256 .. t*256 + 511 of the row reflect-padded by 256 at
// both ends, T = 1 + L / 256 frames) and bin k = 0 .. 256,
//   a[t][n]     = bf16(win[n] * x_pad[b, t*256 + n])   (the product in float32)
//   spec[b,k,t] = sum_n a[t][n] * (bf16(cos_kn) + i bf16(sin_kn))
//   mag[b,k,t]  = sqrt(re^2 + im^2)                    (when mag != nullptr)
// with the tables of stft_ops.dft_matrices (exact integer-mod angles) rounded
// to bf16: the rounding points of ops/resolve.py.  A bf16 product is exact in
// float32, so the kernel and its plain version (stft_ops.stft_matmul with
// precision='bf16') differ only in the order of their float32 sums.
//
// Bound on an H100: bytes.  The work is a GEMM, (frames x 512) x (512 x 514):
// ~3.2e10 operations for a 10 s, 96-row clip stack, 0.03 ms at the 989
// TFLOP/s dense-bf16 peak, against ~247 MB moved (the signal in, the complex
// spectrum and the magnitude out), 0.074 ms at 3.35 TB/s.  The design (one
// block of 8 warps per row and tile of 64 frames):
//   1. the block windows its 64 frames straight from the row (the reflect
//      padding by index, as in stft.cu; each sample is read by two frames,
//      the second time from the caches), rounds each product to bf16 and
//      keeps the frames in shared memory, rows 520 bf16 apart (the eight
//      rows an ldmatrix phase reads fall on distinct banks);
//   2. the tables go to the card pre-arranged in mma.sync's B-fragment order
//      (stft_ops.dft_fragments): for each 8-column tile and 16-sample step,
//      lane l's four bf16 values sit at 8 l bytes, so a warp reads one
//      fragment as 256 contiguous bytes, from L2 (540 KB in all, shared by
//      every block);
//   3. warp w takes the bin groups p = w, w + 8, ... (8 bins each, 33 groups
//      for 257 bins padded to 264) and, for its 64 frames, runs the
//      m16n8k16 bf16 mma.sync over the 32 sample steps: per step 4 ldmatrix
//      loads of the frames and 8 products into 64 float32 accumulators (re
//      and im of 8 bins at 64 frames), the next step's table fragments in
//      flight;
//   4. each lane stores its re/im pairs straight into the (B, 257, T)
//      complex64 spectrum (eight lanes cover eight consecutive frames of a
//      bin) and the magnitude from the same registers.
// No atomics; a fixed order of operations.  mma.sync, not wgmma/TMA.
#include <cuda_bf16.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kN = 512;               // n_fft
constexpr int kHop = 256;             // hop
constexpr int kFreq = kN / 2 + 1;     // bins
constexpr int kFrames = 64;           // frames per block: 4 m-tiles of 16
constexpr int kMTiles = kFrames / 16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = (kFreq + 7) / 8;  // bin groups of 8: 33, bins padded to 264
constexpr int kSteps = kN / 16;           // 16-sample k-steps
constexpr int kRow = kN + 8;              // bf16 per frame row in shared memory
constexpr size_t kSmemBytes = sizeof(__nv_bfloat16) * kFrames * kRow;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b over one m16n8k16 tile, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__global__ void __launch_bounds__(kThreads)
    stft_bf16_kernel(const float* __restrict__ x, const float* __restrict__ win,
                     const uint2* __restrict__ frag, float2* __restrict__ spec,
                     float* __restrict__ mag, const int L, const int T, const int t_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* frames = reinterpret_cast<__nv_bfloat16*>(smem);  // [kFrames][kRow]
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * kFrames;
  const float* row = x + (size_t)b * L;

  // 1. the windowed frames, rounded to bf16, two samples a thread and step
  const int p0 = t0 * kHop - kN / 2;  // padded sample t0*hop, in row coordinates
  for (int e = threadIdx.x; e < kFrames * (kN / 2); e += kThreads) {
    const int f = e / (kN / 2), n = 2 * (e - f * (kN / 2));
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int s = p0 + f * kHop + n + h;
      s = s < 0 ? -s : s;
      s = s >= L ? 2 * (L - 1) - s : s;
      // out of range only past the last frame, whose outputs are not stored
      v[h] = (s >= 0 && s < L) ? row[s] * win[n + h] : 0.0f;
    }
    *reinterpret_cast<__nv_bfloat162*>(frames + f * kRow + n) =
        __floats2bfloat162_rn(v[0], v[1]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;  // the mma fragments' row group and pair
  // this lane's ldmatrix row of an m-tile and its column within a k-step
  const __nv_bfloat16* a_lane =
      frames + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 8;

  for (int p = warp; p < kGroups; p += kWarps) {
    // the re (cos) tile 2p and im (sin) tile 2p + 1 of bins 8p .. 8p + 7
    const uint2* fre = frag + (size_t)(2 * p) * kSteps * 32 + lane;
    const uint2* fim = fre + kSteps * 32;
    float acc[kMTiles][2][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][0][j] = 0.0f;
        acc[i][1][j] = 0.0f;
      }
    }
    uint2 bre = __ldg(fre), bim = __ldg(fim);
#pragma unroll 4
    for (int s = 0; s < kSteps; ++s) {
      const uint2 cre = bre, cim = bim;
      if (s + 1 < kSteps) {  // the next step's fragments in flight
        bre = __ldg(fre + (s + 1) * 32);
        bim = __ldg(fim + (s + 1) * 32);
      }
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        unsigned a[4];
        ldmatrix_x4(a, a_lane + i * 16 * kRow + s * 16);
        mma_bf16(acc[i][0], a, cre);
        mma_bf16(acc[i][1], a, cim);
      }
    }
    // acc[i][c][h]: frame 16 i + g + 8 (h >> 1), bin 8 p + 2 q + (h & 1)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = 8 * p + 2 * q + (h & 1);
      if (k >= kFreq) continue;
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const int t = t0 + 16 * i + g + 8 * (h >> 1);
        if (t >= T) continue;
        const float re = acc[i][0][h], im = acc[i][1][h];
        const size_t o = ((size_t)b * kFreq + k) * T + t;
        spec[o] = make_float2(re, im);
        if (mag != nullptr) mag[o] = sqrtf(re * re + im * im);
      }
    }
  }
}

}  // namespace

// x: (B, L) float32 rows, L > n_fft / 2; win: (n_fft,) float32; frag: the bf16
// DFT tables in B-fragment order (stft_ops.dft_fragments: 66 tiles x 32 steps
// x 32 lanes x 4 bf16); spec: (B, n_fft/2 + 1, T) complex64; mag: (B, n_fft/2 +
// 1, T) float32 or null; T = 1 + L / hop.  Takes n_fft = 512, hop = 256 only.
extern "C" int disco_stft_bf16(const void* x, const void* win, const void* frag, void* spec,
                               void* mag, int B, int L, int n_fft, int hop, int T,
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
    err = cudaFuncSetAttribute(stft_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int t_tiles = (T + kFrames - 1) / kFrames;
  stft_bf16_kernel<<<B * t_tiles, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const uint2*>(frag), static_cast<float2*>(spec), static_cast<float*>(mag), L,
      T, t_tiles);
  return (int)cudaGetLastError();
}

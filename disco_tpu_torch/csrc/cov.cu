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
// The bf16 lane (the BF16 instances; the TPU kernel's precision='bf16'
// branch, which feeds it bf16 y planes) reads the same complex64 input once,
// with no cast pass before the launch (ops/resolve.py's rounding points;
// PERF.md says why not bf16 planes), and keeps everything else, the
// frame-slice order included, so that its plain version
// (cov_ops._masked_cov_sliced, the same order) gives the same bits: a
// covariance that moved by one float32 rounding could round to another bf16
// value in the fused solve's bf16 lane.  Two things make it cheap:
// - Each element is rounded once, where it lands: when a tile's copies are
//   in, one pass of the bin's group rounds the tile's C x nt complex values
//   to bf16 in place in shared memory, so the pair loop reads values already
//   rounded (before, every pair rounded both of its operands again, ~12
//   times an element and frame at C = 11).
// - Only the exact is fused: a product of two bf16 values is exact in
//   float32, so prr = fmaf(rc, rd, ic id) rounds only the sum, as the plain
//   version's rc rd + ic id does (and pii alike): the same bits.  The
//   weighted accumulations ss + w prr are not exact and keep one rounding a
//   product and one a sum (__fmul_rn, __fadd_rn).
//
// Bound on an H100: bytes.  The step-2 stack of the main path (8 nodes x
// 11 channels x 257 bins x 626 frames) is ~118 MB read once, ~35 us at
// 3.35 TB/s, against ~1.2 GFLOP.  The design:
// - A group of kSlices x P threads per (b, f) bin, P = C(C+1)/2 the
//   upper-triangle pairs: thread (s, p) owns pair p and the frames
//   t = s, s + kSlices, ... of each frame tile, so the frame range is split
//   across the group's warps and neighbouring slices read neighbouring
//   banks.  At small C a block holds several bins' groups, so that its
//   lanes are not idle.
// - Tiles of kTile frames of the bin's C rows (and its mask rows) go to
//   shared memory by cp.async, double-buffered: the next tile's copies are
//   in flight while the current one is summed.  Each element is copied on
//   its own (8 or 4 bytes), so rows need no alignment and any T >= 1 works.
// - With a shared mask, each frame's weights m^2/T and (1-m)^2/T are
//   computed once into shared memory, not once per pair.
// - Each thread runs its four float32 sums per pair over its frames in
//   order; the slices' partial sums are then added in shared memory in
//   slice order.  No atomics: the reduction order is fixed, so the result
//   is bit-identical from run to run.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxC = 16;
constexpr int kTile = 128;   // frames per tile
constexpr int kRow = kTile + 1;  // shared row stride (float2): rows of one frame in distinct banks
constexpr int kSlices = 4;   // frame slices per bin
constexpr int kMaxThreads = 256;  // a block's threads, when it holds several bins
constexpr int kMaxSmem = 48 * 1024;  // a block's shared memory, when it holds several bins

__device__ __forceinline__ void cp_async(void* dst, const void* src, const int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of shared memory one bin's group takes: two buffers of the C rows
// (float2) and of the mask rows (float), then with a shared mask two
// buffers of the frame weights (float2: w_s, w_n); or, if more, the
// slices' partial sums (4 floats a pair).
__host__ __device__ constexpr int bin_bytes(const int C, const bool chan) {
  const int loads = 2 * C * kRow * 8 + 2 * (chan ? C : 1) * kTile * 4 + (chan ? 0 : 2 * kTile * 8);
  const int parts = kSlices * C * (C + 1) / 2 * 16;
  return loads > parts ? loads : parts;
}

template <bool CHAN, bool BF16>
__global__ void masked_cov_kernel(const float2* __restrict__ y, const float* __restrict__ mask,
                                  float2* __restrict__ rss, float2* __restrict__ rnn,
                                  const int n_bins, const int C, const int F, const int T,
                                  const int bins_per_block, const float inv_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = C * (C + 1) / 2;
  const int group = kSlices * P;  // threads per bin
  const int n_mask = CHAN ? C : 1;
  const int grp = threadIdx.x / group, r = threadIdx.x - grp * group;
  const int s = r / P, p = r - s * P;
  const int bf = blockIdx.x * bins_per_block + grp;  // b * F + f
  const bool live = grp < bins_per_block && bf < n_bins;
  const int b = live ? bf / F : 0, f = live ? bf - b * F : 0;

  unsigned char* base = smem + (size_t)(live ? grp : 0) * bin_bytes(C, CHAN);
  float2* ys = reinterpret_cast<float2*>(base);                    // [2][C][kRow]
  float* ms = reinterpret_cast<float*>(base + 2 * C * kRow * 8);     // [2][n_mask][kTile]
  float2* ws = reinterpret_cast<float2*>(ms + 2 * n_mask * kTile);  // [2][kTile], shared mask

  int c = 0, d = 0;  // upper-triangle pair p, row by row
  {
    int rem = p;
    while (rem >= C - c) {
      rem -= C - c;
      ++c;
    }
    d = c + rem;
  }
  const size_t row = (size_t)F * T;  // stride between channels
  const float2* yb = y + (size_t)b * C * row + (size_t)f * T;
  const float* mb = CHAN ? mask + (size_t)b * C * row + (size_t)f * T : mask + (size_t)bf * T;

  // the copies of tile k into buffer k & 1, issued by the bin's group
  auto issue = [&](const int k) {
    if (!live) return;
    const int t0 = k * kTile, nt = min(kTile, T - t0);
    float2* yd = ys + (k & 1) * C * kRow;
    float* md = ms + (k & 1) * n_mask * kTile;
    for (int e = r; e < C * kTile; e += group) {
      const int cc = e / kTile, tt = e - cc * kTile;
      if (tt < nt) cp_async(yd + cc * kRow + tt, yb + cc * row + t0 + tt, 8);
    }
    for (int e = r; e < n_mask * kTile; e += group) {
      const int cc = e / kTile, tt = e - cc * kTile;
      if (tt < nt) cp_async(md + e, mb + cc * row + t0 + tt, 4);
    }
    cp_async_commit();
  };
  // once per tile k, when its copies are in: the shared mask's weights, once
  // per frame, and in the bf16 lane every element rounded to bf16 in place
  auto prepare = [&](const int k) {
    if (!live) return;
    const int nt = min(kTile, T - k * kTile);
    if constexpr (!CHAN) {
      const float* md = ms + (k & 1) * kTile;
      for (int tt = r; tt < nt; tt += group) {
        const float m = md[tt], om = 1.0f - m;
        ws[(k & 1) * kTile + tt] = make_float2((m * m) * inv_t, (om * om) * inv_t);
      }
    }
    if constexpr (BF16) {
      float2* yd = ys + (k & 1) * C * kRow;
      for (int e = r; e < C * kTile; e += group) {
        const int cc = e / kTile, tt = e - cc * kTile;
        if (tt < nt) yd[cc * kRow + tt] = disco::bf16_round2(yd[cc * kRow + tt]);
      }
    }
  };
  // whether prepare writes what other threads read: a barrier after it
  constexpr bool kPrepared = !CHAN || BF16;

  const int n_tiles = (T + kTile - 1) / kTile;
  issue(0);
  cp_async_wait_all();
  __syncthreads();
  prepare(0);
  __syncthreads();

  float ssr = 0.0f, ssi = 0.0f, nnr = 0.0f, nni = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) issue(k + 1);  // in flight while tile k is summed
    if (live) {
      const int nt = min(kTile, T - k * kTile);
      const float2* yc_row = ys + (k & 1) * C * kRow + c * kRow;
      const float2* yd_row = ys + (k & 1) * C * kRow + d * kRow;
      const float* mc_row = ms + (k & 1) * n_mask * kTile + (CHAN ? c : 0) * kTile;
      const float* md_row = ms + (k & 1) * n_mask * kTile + (CHAN ? d : 0) * kTile;
      const float2* w_row = ws + (k & 1) * kTile;
      for (int tt = s; tt < nt; tt += kSlices) {
        const float2 yc = yc_row[tt], yd = yd_row[tt];
        float wsv, wnv;
        if constexpr (CHAN) {
          const float mc = mc_row[tt], md = md_row[tt];
          wsv = (mc * md) * inv_t;
          wnv = ((1.0f - mc) * (1.0f - md)) * inv_t;
        } else {
          const float2 wv = w_row[tt];
          wsv = wv.x;
          wnv = wv.y;
        }
        // Y_c conj(Y_d): re = rc rd + ic id, im = ic rd - rc id
        if constexpr (BF16) {
          // the products of bf16 values are exact: one rounding a pair sum,
          // as the plain version's; then a rounded product and a rounded sum
          const float prr = fmaf(yc.x, yd.x, __fmul_rn(yc.y, yd.y));
          const float pii = fmaf(yc.y, yd.x, -__fmul_rn(yc.x, yd.y));
          ssr = __fadd_rn(ssr, __fmul_rn(wsv, prr));
          ssi = __fadd_rn(ssi, __fmul_rn(wsv, pii));
          nnr = __fadd_rn(nnr, __fmul_rn(wnv, prr));
          nni = __fadd_rn(nni, __fmul_rn(wnv, pii));
        } else {
          const float prr = yc.x * yd.x + yc.y * yd.y;
          const float pii = yc.y * yd.x - yc.x * yd.y;
          ssr += wsv * prr;
          ssi += wsv * pii;
          nnr += wnv * prr;
          nni += wnv * pii;
        }
      }
    }
    if (k + 1 < n_tiles) {
      cp_async_wait_all();
      __syncthreads();  // tile k summed by all, tile k + 1 landed
      prepare(k + 1);
      if (kPrepared) __syncthreads();
    }
  }

  // the slices' partial sums, added in slice order (the bin's buffers hold
  // them: every read of them is done)
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(base);
  if (live) part[s * P + p] = make_float4(ssr, ssi, nnr, nni);
  __syncthreads();
  if (live && s == 0) {
    float4 acc = part[p];
    for (int j = 1; j < kSlices; ++j) {
      const float4 x = part[j * P + p];
      acc.x = acc.x + x.x;
      acc.y = acc.y + x.y;
      acc.z = acc.z + x.z;
      acc.w = acc.w + x.w;
    }
    if (c == d) {  // a Hermitian diagonal is real
      acc.y = 0.0f;
      acc.w = 0.0f;
    }
    float2* Rs = rss + (size_t)bf * C * C;
    float2* Rn = rnn + (size_t)bf * C * C;
    Rs[c * C + d] = make_float2(acc.x, acc.y);
    Rn[c * C + d] = make_float2(acc.z, acc.w);
    if (c != d) {
      Rs[d * C + c] = make_float2(acc.x, -acc.y);
      Rn[d * C + c] = make_float2(acc.z, -acc.w);
    }
  }
}

template <bool CHAN, bool BF16>
void launch(const float2* y, const float* mask, float2* rss, float2* rnn, const int blocks,
            const int threads, const size_t smem, cudaStream_t s, const int n_bins, const int C,
            const int F, const int T, const int bins, const float inv_t) {
  masked_cov_kernel<CHAN, BF16><<<blocks, threads, smem, s>>>(y, mask, rss, rnn, n_bins, C, F, T,
                                                              bins, inv_t);
}

template <bool CHAN, bool BF16>
cudaError_t raise_smem_limit(const int bytes) {
  return cudaFuncSetAttribute(masked_cov_kernel<CHAN, BF16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// y: (B, C, F, T) complex64; mask: (B, F, T) float32, or (B, C, F, T) when
// per_channel_mask != 0; rss, rnn: (B, F, C, C) complex64; bf16 != 0 runs the
// bf16 lane.
extern "C" int disco_masked_cov(const void* y, const void* mask, void* rss, void* rnn, int B,
                                int C, int F, int T, int per_channel_mask, int bf16,
                                void* stream) {
  if (B <= 0 || F <= 0) return (int)cudaSuccess;
  if (C < 1 || C > kMaxC || T < 1) return (int)cudaErrorInvalidValue;
  const bool chan = per_channel_mask != 0;
  const int group = kSlices * C * (C + 1) / 2;
  const int per_bin = bin_bytes(C, chan);
  int bins = kMaxThreads / group;
  bins = bins < kMaxSmem / per_bin ? bins : kMaxSmem / per_bin;
  bins = bins < 1 ? 1 : bins;
  const int threads = (bins * group + 31) / 32 * 32;
  const int n_bins = B * F;
  const int blocks = (n_bins + bins - 1) / bins;
  const size_t smem = (size_t)bins * per_bin;
  const float inv_t = 1.0f / (float)T;
  // One bin may take more than 48 KB (C = 16 with per-channel masks): the
  // limit is an attribute of each kernel on each device and never changes,
  // so it is raised on a device's first launch only (bit d of `set`).
  static std::atomic<unsigned long long> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(set.load(std::memory_order_relaxed) & bit)) {
    // the most any launch takes: a block of several bins, or one bin at C = 16
    const int most = bin_bytes(kMaxC, true) > kMaxSmem ? bin_bytes(kMaxC, true) : kMaxSmem;
    err = raise_smem_limit<true, false>(most);
    if (err == cudaSuccess) err = raise_smem_limit<false, false>(most);
    if (err == cudaSuccess) err = raise_smem_limit<true, true>(most);
    if (err == cudaSuccess) err = raise_smem_limit<false, true>(most);
    if (err != cudaSuccess) return (int)err;
    set.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* yy = static_cast<const float2*>(y);
  const float* mm = static_cast<const float*>(mask);
  float2* a = static_cast<float2*>(rss);
  float2* b = static_cast<float2*>(rnn);
  if (chan && bf16)
    launch<true, true>(yy, mm, a, b, blocks, threads, smem, s, n_bins, C, F, T, bins, inv_t);
  else if (chan)
    launch<true, false>(yy, mm, a, b, blocks, threads, smem, s, n_bins, C, F, T, bins, inv_t);
  else if (bf16)
    launch<false, true>(yy, mm, a, b, blocks, threads, smem, s, n_bins, C, F, T, bins, inv_t);
  else
    launch<false, false>(yy, mm, a, b, blocks, threads, smem, s, n_bins, C, F, T, bins, inv_t);
  return (int)cudaGetLastError();
}

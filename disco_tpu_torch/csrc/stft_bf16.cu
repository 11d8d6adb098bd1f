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
// spectrum and the magnitude out), 0.074 ms at 3.35 TB/s.
//
// The design.  The frames of all rows are numbered f = b T + t; a block
// takes a tile of 256 consecutive frames (a tile may span rows) and one slab
// of 64 bins: 128 GEMM columns, the re and im columns of each group of 8
// bins.  Four slabs cover bins 0 .. 255 and are neighbouring blocks, so the
// signal a tile reads comes from device memory once and from L2 for the
// other three.  Bin 256 is summed on the CUDA cores: its table has period 2
// in the sample, so it is the even and odd sums of each frame weighted by
// the table's first two rows; each slab takes a quarter of the frames.  The
// block is 4 warpgroups; warpgroup w owns frames 64 w .. 64 w + 63 and
// computes their 64 x 128 product with wgmma.mma_async m64n128k16 (bf16
// operands in shared memory, float32 accumulators, 64 a thread).
//   (a) Table reuse: each table chunk goes through shared memory once per
//       block and serves all 256 frames of the tile (4x the 64 frames of a
//       block before): every warpgroup reads every chunk.
//   (b) Operands in flight: the table arrives in 16 chunks of 32 samples
//       (8 KB each, stft_ops.dft_fragments' order, already in wgmma's
//       core-matrix layout) through a ring of kStages = 4 stages, each filled
//       by one bulk async copy (cp.async.bulk) that completes the stage's
//       mbarrier; the warp that releases a stage last (a shared counter)
//       refills it.  The frames: 256 frames x 512 samples of bf16 do not fit
//       in shared memory with the ring, so the K loop runs in 8 phases of
//       2 x 32 samples: phase p holds frame samples 32 p .. 32 p + 31 (chunk
//       t - 1 of the row: the LO tile) and 256 + 32 p .. (chunk t: HI) of
//       every frame.  Each warpgroup walks the phases on its own (warpgroup
//       barriers only): phase p + 2's raw float32 rows come by cp.async, and
//       phase p's products run asynchronously, while it rounds phase p + 1's
//       raw rows into the other pair of operand tiles.  Frame t's HI and
//       frame t + 1's LO are the same samples under the two window halves,
//       so each sample is read once a phase (reflect padding by index, the
//       window product in float32, one bf16 rounding; no framed intermediate
//       in device memory).  The raw rows' float4 are XOR-swizzled by row,
//       and the tiles are written a core matrix (128 bytes) per 8 lanes, so
//       neither pass has a bank conflict.
//   (c) Staged stores: the accumulators go through shared memory (over the
//       operand tiles, the raw rows and the ring, as a (64 bins x 256 frames)
//       float2 tile, rows 260 apart: a warp's float2 writes take the two
//       wavefronts they must); warp w then writes frames 32 (w % 8) .. + 31
//       of every other bin, each lane one frame, so a warp's store is 256
//       contiguous bytes of the complex spectrum and 128 of the magnitude
//       along T.
// What holds it (exp/stft_bf16_variants.py cuts each part out in turn and
// stamps the phases with clock64; an H100 at 700 W): one block a SM (168 KB
// of shared memory, 128 registers a thread), whose rounding of each phase's
// raw rows (~1,700 cycles a phase of ~3,500) and whose epilogue, when every
// SM writes its tile at once (~15,000 cycles of ~50,000 a block), leave the
// tensor cores idle; and the signal is read once a slab (4x).  No atomics on
// data; a fixed order of operations.
#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kN = 512;                     // n_fft
constexpr int kHop = 256;                   // hop
constexpr int kFreq = kN / 2 + 1;           // bins
constexpr int kFrames = 256;                // frames a block
constexpr int kGroupsW = 4;                 // warpgroups, 64 frames each
constexpr int kWgFrames = kFrames / kGroupsW;
constexpr int kThreads = 128 * kGroupsW;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabGroups = 8;              // bin groups of 8 a slab
constexpr int kSlabs = (kFreq - 1) / (8 * kSlabGroups);  // 4: bins 0 .. 255; bin 256 apart
constexpr int kCols = 16 * kSlabGroups;     // GEMM columns a slab: re and im of 64 bins
constexpr int kQuarter = 32;                // samples of LO (and of HI) a phase
constexpr int kPhases = kHop / kQuarter;    // 8
constexpr int kChunks = 2 * kPhases;        // table chunks of 32 samples: LO and HI a phase
constexpr int kStages = 4;                  // table ring stages: two phases' chunks
constexpr unsigned kChunkBytes = 2 * kCols * kQuarter;        // 8 KB
constexpr unsigned kCore = 128;             // bytes of an 8 x 8 bf16 core matrix
constexpr unsigned kLbo = kCore;            // core matrices adjacent along K
constexpr unsigned kSbo = kQuarter / 8 * kCore;  // adjacent along M (N): 512
constexpr unsigned kOperand = kWgFrames / 8 * kSbo;  // a warpgroup's LO or HI tile: 4 KB
constexpr int kRows = kWgFrames + 1;        // chunk rows of a warpgroup: 65
constexpr int kRawBufs = 2;                 // raw-row buffers: phase p + 2 in flight
constexpr unsigned kRawBytes = sizeof(float) * kRows * kQuarter;  // a warpgroup's raw rows
constexpr int kStageRow = kFrames + 4;      // float2 a bin of the epilogue tile
constexpr int kNyqFrames = kWgFrames / kSlabs;  // bin-256 frames of a warpgroup a slab takes: 16
constexpr size_t kBufBytes = (size_t)2 * kGroupsW * 2 * kOperand;  // 2 phases x 4 groups x LO, HI
constexpr size_t kRawAll = (size_t)kRawBufs * kGroupsW * kRawBytes;  // 2 phases x 4 groups
constexpr size_t kRingBytes = (size_t)kChunkBytes * kStages;
constexpr size_t kInfoBytes = sizeof(int2) * kGroupsW * kRows;
constexpr size_t kNyqBytes = sizeof(float4) * kGroupsW * kNyqFrames;  // bin-256 partials
constexpr size_t kInfoOff = kBufBytes + kRawAll + kRingBytes;
constexpr size_t kBarOff = kInfoOff + kInfoBytes;                   // full barriers, then counts
constexpr size_t kNyqOff = (kBarOff + kStages * 12 + 15) / 16 * 16;
constexpr size_t kSmemBytes = kNyqOff + kNyqBytes;
static_assert(kInfoOff % 16 == 0 && kBarOff % 8 == 0, "alignment");
static_assert(sizeof(float2) * 8 * kSlabGroups * kStageRow <= kBufBytes + kRawAll + kRingBytes,
              "the epilogue tile lies over the frame buffers, the raw rows and the ring");
static_assert(kWarps % (kFrames / 32) == 0, "the epilogue's warps cover the tile's frames");
static_assert(kNyqFrames * kSlabs == kWgFrames, "bin 256: the slabs split the frames");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the descriptor of a K-major bf16 operand in shared memory, no swizzle: core
// matrix (i, j) (8 rows x 8 columns of K, 128 contiguous bytes) at i SBO + j LBO
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d (64 x 128, float32) (+)= a (64 x 16) b (128 x 16)^T, bf16 operands in
// shared memory; accumulate = 0 starts the sum
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint64_t da,
                                                 const uint64_t db, const int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup w (barrier ids 1 .. 4; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(const int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(128) : "memory");
}

// the table ring's full barriers: one arrival with the bytes to expect, then
// the bulk copy's completion
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, const unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// table chunk `src` into a ring stage, by one bulk copy that completes `bar`
__device__ __forceinline__ void fill_stage(void* dst, const void* src, uint64_t* bar) {
  fence_async_smem();
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(kChunkBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(kChunkBytes), "r"(smem_u32(bar))
      : "memory");
}

// four samples s .. s + 3 of a row, reflected at both ends (L > 256, so every
// reflected index lies in the row): the rows' ends, which no copy can take
__device__ __forceinline__ float4 row4(const float* __restrict__ row, const int s, const int L) {
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int u = s + e;
    u = u < 0 ? -u : u;
    u = u >= L ? 2 * (L - 1) - u : u;
    v[e] = __ldg(row + u);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// bf16(w x) of four samples, as four packed bf16
__device__ __forceinline__ uint2 window4(const float4 x, const float4 w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * w.x, x.y * w.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * w.z, x.w * w.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

// byte offset of element (m, k) of a core-matrix tile (kQuarter samples a row)
__device__ __forceinline__ unsigned core_off(const int m, const int k) {
  return (m >> 3) * kSbo + (k >> 3) * kLbo + (m & 7) * 16 + (k & 7) * 2;
}

__global__ void __launch_bounds__(kThreads, 1)
    stft_bf16_kernel(const float* __restrict__ x, const float* __restrict__ win,
                     const uint4* __restrict__ frag, const float* __restrict__ nyq_tab,
                     float2* __restrict__ spec, float* __restrict__ mag, const int B, const int L,
                     const int T) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int slab = blockIdx.x % kSlabs;
  const int f0 = (blockIdx.x / kSlabs) * kFrames;  // the tile's first frame, f = b T + t
  const int n_frames = B * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp / 4, ww = warp % 4;  // its warpgroup (64 frames) and warp in it
  const bool aligned = (L & 3) == 0;
  // [phase % 2][warpgroup][LO, HI]: 4 KB core-matrix tiles of 64 frames x 32 samples
  unsigned char* bufs = smem;
  // [phase % 2][warpgroup]: 65 raw float32 rows of 32 samples (float4 v of row
  // l at column v ^ (l % 8), so that eight rows' same float4 fall on distinct banks)
  float* raws = reinterpret_cast<float*>(smem + kBufBytes);
  unsigned char* ring = smem + kBufBytes + kRawAll;                        // [kStages][8 KB]
  int2* info = reinterpret_cast<int2*>(smem + kInfoOff) + wg * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  int* done = reinterpret_cast<int*>(full + kStages);
  // [warpgroup][bin-256 frame]: (even, odd) sums of the LO halves, then of the HI halves
  float4* nyq_part = reinterpret_cast<float4*>(smem + kNyqOff) + wg * kNyqFrames;
  float2* stage = reinterpret_cast<float2*>(smem);                         // [64][kStageRow]
  const unsigned char* slab_frag =
      reinterpret_cast<const unsigned char*>(frag) + (size_t)slab * kChunks * kChunkBytes;
  auto operand = [&](const int p, const int h) {  // phase p's LO (h = 0) or HI tile
    return bufs + ((p & 1) * kGroupsW * 2 + wg * 2 + h) * kOperand;
  };

  // info[l] = (b, t) of the warpgroup's frame l - 1 (b >= B: past the last frame)
  {
    const int l = threadIdx.x % 128;
    if (l < kRows) {
      const int f = f0 + kWgFrames * wg + l - 1;
      info[l] = f < 0 ? make_int2(B, 0) : make_int2(f / T, f - (f / T) * T);
    }
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < kStages; ++c)
      fill_stage(ring + c * kChunkBytes, slab_frag + (size_t)c * kChunkBytes, full + c);
  }

  // Warp ww of a warpgroup takes the chunk rows l = 8 o + lane % 8 with
  // o % 4 == ww, lane kg = lane / 8 their samples 8 kg .. 8 kg + 7 of the
  // phase's 32.
  const int kg = lane / 8, r8 = lane % 8;
  auto raw_row = [&](const int p, const int l) {  // phase p's raw row l of the warpgroup
    return raws + ((p % kRawBufs) * kGroupsW + wg) * (kRawBytes / 4) + l * kQuarter;
  };
  // phase p's raw rows: row l is chunk t of frame l - 1's row (for l = 0,
  // chunk t - 1 of frame 0's), samples 32 p .. 32 p + 31, its float4 f at
  // f ^ (l % 8); by cp.async, except at the reflected ends of a row
  auto issue_raw = [&](const int p) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int l = 8 * (ww + 4 * i) + r8;
      if (l >= kRows) continue;
      const int2 bs = info[l == 0 ? 1 : l];
      const int j = l == 0 ? bs.y - 1 : bs.y;
      float* row_s = raw_row(p, l);
      const int fa = 4 * ((2 * kg) ^ (l & 7));
      float* d0 = row_s + fa;
      float* d1 = row_s + (fa ^ 4);
      const int s = kHop * j + kQuarter * p + 8 * kg;
      const float* row = x + (size_t)bs.x * L;
      if (bs.x >= B) {
        *reinterpret_cast<float4*>(d0) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(d1) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (s >= 0 && s + 7 < L) {
        if (aligned) {
          cp_async16(d0, row + s);
          cp_async16(d1, row + s + 4);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cp_async4(d0 + e, row + s + e);
            cp_async4(d1 + e, row + s + 4 + e);
          }
        }
      } else {
        *reinterpret_cast<float4*>(d0) = row4(row, s, L);
        *reinterpret_cast<float4*>(d1) = row4(row, s + 4, L);
      }
    }
  };
  // bin 256 on the CUDA cores: its table's angle is -pi n, so the table has
  // period 2 in n and the bin is (E, O) . (table rows 0 and 1), E and O the
  // sums of a frame's even and odd samples.  Slab s takes frames 16 s .. +
  // 15 of each warpgroup; convert adds the rounded samples a thread makes of
  // those frames to its sums (a thread's rows hold at most one LO and one HI
  // piece of them): (even, odd) of the LO piece, then of the HI piece.
  const int nyq0 = kNyqFrames * slab;
  float4 nyq = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add_pairs = [](const uint2 a, const uint2 b, float& even, float& odd) {
    const unsigned w[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[u]));
      even += v2.x;
      odd += v2.y;
    }
  };
  // what each of this thread's rows l = 8 (ww + 4 i) + lane % 8 (i < 3) is,
  // 5 bits a row: LO of frame l live, HI of frame l - 1 live, frame l starts
  // a row, frame l and frame l - 1 among this slab's bin-256 frames
  int rflags = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int l = 8 * (ww + 4 * i) + r8;
    if (l >= kRows) continue;
    int fl = 0;
    if (l < kWgFrames) {
      const int2 bt = info[l + 1];
      fl |= bt.x < B ? 1 : 0;
      fl |= (bt.x < B && l > 0 && bt.y == 0) ? 4 : 0;
      fl |= (l >= nyq0 && l < nyq0 + kNyqFrames) ? 8 : 0;
    }
    if (l > 0) {
      fl |= info[l].x < B ? 2 : 0;
      fl |= (l - 1 >= nyq0 && l - 1 < nyq0 + kNyqFrames) ? 16 : 0;
    }
    rflags |= fl << (5 * i);
  }
  // phase p's LO and HI tiles from its raw rows: HI of frame l - 1 is raw row
  // l; LO of frame l is raw row l too, unless frame l starts a row (its
  // chunk t - 1, the reflected head of the row, is read here)
  auto convert = [&](const int p) {
    const int n = kQuarter * p + 8 * kg;
    const float4 wl0 = *reinterpret_cast<const float4*>(win + n);
    const float4 wl1 = *reinterpret_cast<const float4*>(win + n + 4);
    const float4 wh0 = *reinterpret_cast<const float4*>(win + kHop + n);
    const float4 wh1 = *reinterpret_cast<const float4*>(win + kHop + n + 4);
    unsigned char* lo = operand(p, 0);
    unsigned char* hi = operand(p, 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int l = 8 * (ww + 4 * i) + r8;
      if (l >= kRows) continue;
      const int fl = rflags >> (5 * i);
      const float* row_s = raw_row(p, l);
      const int fa = 4 * ((2 * kg) ^ (l & 7));
      const float4 s0 = *reinterpret_cast<const float4*>(row_s + fa);
      const float4 s1 = *reinterpret_cast<const float4*>(row_s + (fa ^ 4));
      if (l > 0) {
        uint2 a = window4(s0, wh0), b = window4(s1, wh1);
        if (!(fl & 2)) a = b = make_uint2(0u, 0u);
        *reinterpret_cast<uint4*>(hi + core_off(l - 1, 8 * kg)) = make_uint4(a.x, a.y, b.x, b.y);
        if (fl & 16) add_pairs(a, b, nyq.z, nyq.w);
      }
      if (l < kWgFrames) {
        float4 a0 = s0, a1 = s1;
        if (fl & 4) {
          const int2 bt = info[l + 1];
          a0 = row4(x + (size_t)bt.x * L, n - kHop, L);
          a1 = row4(x + (size_t)bt.x * L, n + 4 - kHop, L);
        }
        uint2 a = window4(a0, wl0), b = window4(a1, wl1);
        if (!(fl & 1)) a = b = make_uint2(0u, 0u);
        *reinterpret_cast<uint4*>(lo + core_off(l, 8 * kg)) = make_uint4(a.x, a.y, b.x, b.y);
        if (fl & 8) add_pairs(a, b, nyq.x, nyq.y);
      }
    }
    fence_async_smem();  // for the products' reads
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // Each warpgroup walks the phases on its own (warpgroup barriers only):
  // phase p + 2's raw rows come by cp.async and phase p's products run on
  // the tensor cores (wgmma, asynchronous) while it rounds phase p + 1's raw
  // rows into the other pair of tiles and sums bin 256; then it waits for
  // its products.  The table chunks are shared: chunk c waits on its
  // stage's full barrier, and the warp that releases a stage last refills it
  // with chunk c + kStages.
  for (int p = 0; p < kRawBufs; ++p) {
    issue_raw(p);
    cp_async_commit();
  }
  cp_async_wait<kRawBufs - 1>();  // phase 0's raw rows (this thread's copies)
  group_sync(wg);
  convert(0);
  group_sync(wg);
  for (int p = 0; p < kPhases; ++p) {
    if (p + kRawBufs < kPhases) issue_raw(p + kRawBufs);  // into phase p's raw rows, converted
    cp_async_commit();
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // chunk 2 p + h: LO (h = 0) or HI of every frame
      const int c = 2 * p + h, st = c % kStages;
      mbar_wait(full + st, (c / kStages) & 1);
      const unsigned char* a = operand(p, h);
      const unsigned char* b = ring + st * kChunkBytes;
#pragma unroll
      for (int ks = 0; ks < kQuarter / 16; ++ks)
        wgmma_m64n128k16(acc, smem_desc(a + 2 * ks * kLbo), smem_desc(b + 2 * ks * kLbo), 1);
    }
    wgmma_commit();
    if (p + 1 < kPhases) {
      cp_async_wait<kRawBufs - 1>();  // phase p + 1's raw rows
      group_sync(wg);
      convert(p + 1);
    }
    wgmma_wait_all();
    // release the phase's two stages; the last of the kWarps warps refills each
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * p + h, st = c % kStages;
        __threadfence_block();
        if (atomicAdd(done + st, 1) == kWarps - 1) {
          done[st] = 0;
          if (c + kStages < kChunks)
            fill_stage(ring + st * kChunkBytes, slab_frag + (size_t)(c + kStages) * kChunkBytes,
                       full + st);
        }
      }
    }
    group_sync(wg);  // phase p + 1's tiles built; phase p's raw rows free
  }

  // bin 256: each piece's four sample groups (lanes r8 + 8 kg), then the LO
  // and HI pieces of each frame (from two threads, through shared memory)
#pragma unroll
  for (int m = 8; m <= 16; m *= 2) {
    nyq.x += __shfl_xor_sync(0xffffffffu, nyq.x, m);
    nyq.y += __shfl_xor_sync(0xffffffffu, nyq.y, m);
    nyq.z += __shfl_xor_sync(0xffffffffu, nyq.z, m);
    nyq.w += __shfl_xor_sync(0xffffffffu, nyq.w, m);
  }
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int l = 8 * (ww + 4 * i) + r8;
      if (l < kWgFrames && l >= nyq0 && l < nyq0 + kNyqFrames) {
        nyq_part[l - nyq0].x = nyq.x;
        nyq_part[l - nyq0].y = nyq.y;
      }
      if (l > 0 && l < kRows && l - 1 >= nyq0 && l - 1 < nyq0 + kNyqFrames) {
        nyq_part[l - 1 - nyq0].z = nyq.z;
        nyq_part[l - 1 - nyq0].w = nyq.w;
      }
    }
  }
  __syncthreads();  // every warp is done with the frame buffers and the ring
  if (threadIdx.x % 128 < kNyqFrames) {
    const int fr = threadIdx.x % 128;
    const int f = f0 + kWgFrames * wg + nyq0 + fr;
    if (f < n_frames) {
      const float4 part = nyq_part[fr];
      const float even = part.x + part.z, odd = part.y + part.w;
      const float re = fmaf(even, __ldg(nyq_tab), odd * __ldg(nyq_tab + 1));
      const float im = fmaf(even, __ldg(nyq_tab + kN), odd * __ldg(nyq_tab + kN + 1));
      const int b = f / T, t = f - b * T;
      const size_t o = ((size_t)b * kFreq + (kFreq - 1)) * T + t;
      spec[o] = make_float2(re, im);
      if (mag != nullptr) mag[o] = sqrtf(re * re + im * im);
    }
  }

  // the epilogue tile: acc[4 j + h] is column 8 j + 2 q + (h & 1) (n-tile j:
  // the re (j even) or im of bin group j / 2) at frame 64 wg + 16 ww + g +
  // 8 (h >> 1)
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int gg = 0; gg < kSlabGroups; ++gg)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = 8 * gg + 2 * q + (h & 1);
      const int t = kWgFrames * wg + 16 * ww + g + 8 * (h >> 1);
      stage[k * kStageRow + t] = make_float2(acc[8 * gg + h], acc[8 * gg + 4 + h]);
    }
  __syncthreads();

  // warp w stores frames 32 (w % 8) .. + 31 of the tile for the bins k of the
  // slab with k % 2 == w / 8
  const int fc = warp % (kFrames / 32);
  const int f = f0 + 32 * fc + lane;
  if (f >= n_frames) return;
  const int b = f / T, t = f - b * T;
  const size_t o0 = (size_t)b * kFreq * T + t;
  const int k0 = 8 * kSlabGroups * slab;
  for (int k = warp / (kFrames / 32); k < 8 * kSlabGroups; k += kWarps / (kFrames / 32)) {
    const float2 val = stage[k * kStageRow + 32 * fc + lane];
    const size_t o = o0 + (size_t)(k0 + k) * T;
    spec[o] = val;
    if (mag != nullptr) mag[o] = sqrtf(val.x * val.x + val.y * val.y);
  }
}

}  // namespace

// x: (B, L) float32 rows, L > n_fft / 2; win: (n_fft,) float32; frag: the bf16
// DFT tables of bins 0 .. 255 in the kernel's chunk order and wgmma operand
// layout (stft_ops.dft_fragments: 4 slabs x 16 chunks x 16 column groups x 4
// sample groups x 8 x 8); nyq: (2, n_fft) float32, the bf16 cos and sin
// tables of bin 256 (stft_ops.nyquist_table); spec: (B, n_fft/2 + 1, T)
// complex64; mag: (B, n_fft/2 + 1, T) float32 or null; T = 1 + L / hop.
// Takes n_fft = 512, hop = 256 only.
extern "C" int disco_stft_bf16(const void* x, const void* win, const void* frag, const void* nyq,
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
    err = cudaFuncSetAttribute(stft_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    set.fetch_or(bit, std::memory_order_relaxed);
  }
  const long long tiles = ((long long)B * T + kFrames - 1) / kFrames;
  if (tiles * kSlabs > 0x7fffffffLL || (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  stft_bf16_kernel<<<(unsigned)(tiles * kSlabs), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const uint4*>(frag), static_cast<const float*>(nyq), static_cast<float2*>(spec),
      static_cast<float*>(mag), B, L, T);
  return (int)cudaGetLastError();
}

// A layout probe of wgmma.mma_async m64n128k16 bf16/f32 with operands in
// shared memory in the no-swizzle core-matrix layout: element (r, k) of an
// (R x K) K-major operand at (r / 8) SBO + (k / 8) LBO + (r % 8) 16 + (k % 8) 2
// bytes, LBO = 128 (core matrices adjacent along K), SBO = K / 8 x 128.  One
// warpgroup computes D (64 x 128) = A (64 x K) B (128 x K)^T over K / 16
// instructions.  exp/wgmma_probe.py builds it and holds D to torch.matmul.
#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ uint64_t smem_desc(const void* p, const unsigned lbo,
                                              const unsigned sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

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

// A: (64, K), B: (128, K), both row-major bf16; D: (64, 128) float32; K = 64
extern "C" __global__ void __launch_bounds__(128) wgmma_probe(const __nv_bfloat16* A,
                                                              const __nv_bfloat16* B, float* D) {
  constexpr int K = 64;
  constexpr unsigned LBO = 128, SBO = K / 8 * 128;
  __shared__ __align__(128) __nv_bfloat16 sa[64 * K];
  __shared__ __align__(128) __nv_bfloat16 sb[128 * K];
  for (int e = threadIdx.x; e < 64 * K; e += 128) {
    const int r = e / K, k = e % K;
    *reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(sa) + (r / 8) * SBO +
                                      (k / 8) * LBO + (r % 8) * 16 + (k % 8) * 2) = A[e];
  }
  for (int e = threadIdx.x; e < 128 * K; e += 128) {
    const int r = e / K, k = e % K;
    *reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(sb) + (r / 8) * SBO +
                                      (k / 8) * LBO + (r % 8) * 16 + (k % 8) * 2) = B[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    wgmma_m64n128k16(d, smem_desc(reinterpret_cast<char*>(sa) + 2 * s * LBO, LBO, SBO),
                     smem_desc(reinterpret_cast<char*>(sb) + 2 * s * LBO, LBO, SBO), s > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = 16 * warp + g + 8 * (h >> 1), c = 8 * j + 2 * q + (h & 1);
      D[r * 128 + c] = d[4 * j + h];
    }
}

extern "C" int wgmma_probe_launch(const void* A, const void* B, void* D) {
  wgmma_probe<<<1, 128>>>(static_cast<const __nv_bfloat16*>(A),
                          static_cast<const __nv_bfloat16*>(B), static_cast<float*>(D));
  return (int)cudaDeviceSynchronize();
}

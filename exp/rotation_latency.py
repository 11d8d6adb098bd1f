#!/usr/bin/env python3
"""Latency on the card of the Jacobi rotation that ``csrc/eigh.cu`` runs
once per (p, q), and of its correctly rounded float32 divisions and square
roots, measured with ``clock64`` in one warp.

The eigensolver kernel is a serial chain of rotations per matrix
(7 sweeps x 55 rotations at C = 11), so at the streaming window's batch
(2056 matrices, fewer than two warps per scheduler) its time is that
chain's latency.  This script splits it: one rotation's scalar math
(``common.cuh::jacobi_rotation``: three square roots and three divisions
in series), and each of its operations alone, built as ``eigh.cu`` is
(``-fmad=false``) and with nvcc's defaults.  The square root comes three
ways: ``sqrtf``; ``common.cuh::sqrt_rn`` (``sqrtf``'s fast path without
its branch); and, like the division, in float64 rounded to float32 (the same
bits: a float64 result of an operation on float32 operands, rounded once
more to float32, is the correctly rounded float32 result, since
53 >= 2 * 24 + 2).  It counts the results where the ways differ: the
float64 ones over 2^24 random operand pairs, ``sqrt_rn`` over all 2^32
float32 bit patterns (NaN equals NaN); expected: none.  It also times the
eigensolver kernel on random Hermitian matrices at the streaming
window's batch (2056) and at a whole clip's (322,792).

Run on the card, from the root of the checkout (about a minute)::

    python3 exp/rotation_latency.py

It prints one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROBE = r"""
#include "common.cuh"


__device__ __forceinline__ float div_d(float a, float b) { return (float)((double)a / (double)b); }
__device__ __forceinline__ float sqrt_d(float a) { return (float)sqrt((double)a); }

// jacobi_rotation with the divisions and square roots through float64
__device__ __forceinline__ void rotation_d(float app, float aqq, float apq_re, float apq_im,
                                           float eps, float& c, float& sr, float& si) {
  const float mag = sqrt_d(apq_re * apq_re + apq_im * apq_im);
  const bool small = mag < eps;
  const float mag_safe = small ? 1.0f : mag;
  const float tau = div_d(aqq - app, 2.0f * mag_safe);
  const float rt = sqrt_d(1.0f + tau * tau);
  const float t = tau >= 0.0f ? div_d(1.0f, tau + rt) : div_d(1.0f, tau - rt);
  const float cc = div_d(1.0f, sqrt_d(1.0f + t * t));
  const float s = t * cc;
  c = small ? 1.0f : cc;
  sr = small ? 0.0f : s * div_d(apq_re, mag_safe);
  si = small ? 0.0f : s * div_d(apq_im, mag_safe);
}

// which: 0 div, 1 sqrt, 2 div via f64, 3 sqrt via f64, 4 rotation, 5 rotation via f64,
// 6 sqrt_rn
extern "C" __global__ void chain(int which, int n, float seed, float* out, long long* cyc) {
  float x = seed + 0.001f * threadIdx.x, y = 1.7f, z = 0.3f;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (which == 0) x = y / (x + 1.0f);
    else if (which == 1) x = sqrtf(x + 1.0f);
    else if (which == 2) x = div_d(y, x + 1.0f);
    else if (which == 3) x = sqrt_d(x + 1.0f);
    else if (which == 6) x = disco::sqrt_rn(x + 1.0f);
    else {
      float c, sr, si;
      if (which == 4) disco::jacobi_rotation(x, y, z, 0.25f, 1e-19f, c, sr, si);
      else rotation_d(x, y, z, 0.25f, 1e-19f, c, sr, si);
      x = 1.0f + sr;
      z = 0.5f * c + si;
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x + z;
  cyc[threadIdx.x] = t1 - t0;
}

__device__ unsigned bits(float v) { return __float_as_uint(v); }

// mismatches between the direct and the float64 ways, over random operands
extern "C" __global__ void compare(unsigned long long seed, unsigned long long* bad) {
  unsigned long long s = seed + 0x9E3779B97F4A7C15ull * (blockIdx.x * blockDim.x + threadIdx.x + 1);
  unsigned long long nb = 0;
  for (int i = 0; i < 64; ++i) {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    // operands of every sign and of exponents -60 .. 60
    const float a = __uint_as_float((unsigned)(s & 0x807fffffu) | ((unsigned)(67 + (s >> 32) % 120) << 23));
    const float b = __uint_as_float((unsigned)((s >> 23) & 0x807fffffu) | ((unsigned)(67 + (s >> 40) % 120) << 23));
    nb += bits(a / b) != bits(div_d(a, b));
    nb += bits(sqrtf(fabsf(a))) != bits(sqrt_d(fabsf(a)));
    float c0, r0, i0, c1, r1, i1;
    disco::jacobi_rotation(a, b, a * 1e-3f, b * 1e-4f, 1e-19f, c0, r0, i0);
    rotation_d(a, b, a * 1e-3f, b * 1e-4f, 1e-19f, c1, r1, i1);
    nb += (bits(c0) != bits(c1)) + (bits(r0) != bits(r1)) + (bits(i0) != bits(i1));
  }
  atomicAdd(bad, nb);
}

// sqrt_rn against sqrtf on every float32 bit pattern
extern "C" __global__ void sweep_sqrt(unsigned long long* bad) {
  unsigned long long nb = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)i);
    const float a = sqrtf(x), b = disco::sqrt_rn(x);
    nb += !(bits(a) == bits(b) || (a != a && b != b));
  }
  atomicAdd(bad, nb);
}

extern "C" int run_sweep_sqrt(unsigned long long* bad) {
  sweep_sqrt<<<4096, 256>>>(bad);
  return (int)cudaDeviceSynchronize();
}

extern "C" int run_chain(int which, int n, float* out, long long* cyc) {
  chain<<<1, 32>>>(which, n, 0.5f, out, cyc);
  return (int)cudaDeviceSynchronize();
}

extern "C" int run_compare(unsigned long long* bad) {
  compare<<<1024, 256>>>(12345ull, bad);
  return (int)cudaDeviceSynchronize();
}
"""


def build(flags: list[str], name: str) -> ctypes.CDLL:
    """The probe built with ``flags`` into ``build/probe/<name>.so``."""
    from disco_tpu_torch.ops import _build

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE)
    lib = out / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", *flags, "-I", str(_build.CSRC), str(out / "probe.cu"), "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.run_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    dll.run_compare.argtypes = [ctypes.c_void_p]
    dll.run_sweep_sqrt.argtypes = [ctypes.c_void_p]
    return dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rotation_latency: needs a GPU", file=sys.stderr)
        return 1
    from disco_tpu_torch.ops import eigh_ops

    res = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    names = ["div", "sqrt", "div via f64", "sqrt via f64", "rotation (by sqrt_rn)",
             "rotation via f64", "sqrt_rn"]
    n = 4096
    for flavour, flags in (("-fmad=false", ["-fmad=false"]), ("default", [])):
        dll = build(flags, "probe" + flavour.replace("=", "_"))
        out = torch.zeros(32, device="cuda")
        cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        lat = {}
        for w, name in enumerate(names):
            assert dll.run_chain(w, 16, out.data_ptr(), cyc.data_ptr()) == 0  # warm-up
            assert dll.run_chain(w, n, out.data_ptr(), cyc.data_ptr()) == 0
            lat[name] = cyc.max().item() / n
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        assert dll.run_compare(bad.data_ptr()) == 0
        bad_rn = torch.zeros(1, dtype=torch.int64, device="cuda")
        assert dll.run_sweep_sqrt(bad_rn.data_ptr()) == 0
        res[flavour] = {"cycles per link of the chain": lat,
                        "mismatches of the f64 way over 2^24 operand pairs": bad.item(),
                        "mismatches of sqrt_rn over all 2^32 inputs": bad_rn.item()}
    # the eigensolver kernel on random Hermitian matrices: the window's batch
    # and a whole clip's
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, reps in ((2056, 20), (322792, 3)):
        for C in (4, 11):
            X = torch.randn((n, C, C), dtype=torch.complex64, device="cuda", generator=gen)
            A = X @ X.mH
            eigh_ops.eigh_jacobi_kernel(A)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(reps):
                eigh_ops.eigh_jacobi_kernel(A)
            ev[1].record()
            torch.cuda.synchronize()
            res[f"eigh_jacobi_kernel on {n} random {C}x{C}, ms"] = ev[0].elapsed_time(ev[1]) / reps
    res["sm clock MHz"] = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                          "--format=csv,noheader,nounits"], capture_output=True,
                                         text=True).stdout.strip()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

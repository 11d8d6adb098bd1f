#!/usr/bin/env python3
"""The eigensolver kernel's two designs at C = 4, timed on the card and held
to each other bit for bit, and the kernel as built at C = 11.

``csrc/eigh.cu`` runs a thread per matrix up to C = 4 and a group of lanes
per matrix, its planes in shared memory, from C = 5.  At C = 4 this script
also runs the lane-group design (``eigh.cu``'s own ``launch<4>``, the kernel
as it is built for C >= 5, with groups of four lanes), so the choice by C
can be checked: at a whole clip's batch (322,792 matrices) the thread per
matrix runs fewer instructions; at the streaming window's (2056) both
are a chain of 30 rotations and the difference sits inside the wrapper's
own time (``kernel as built, 0 sweeps``).  Both designs are also called
straight through the library, without the wrapper, for a like-for-like
time.

Each runs on random Hermitian matrices (and, at C = 11, on
near-degenerate ones, 2 I plus 1e-6 of a random Hermitian matrix) at the
window's batch and at a whole clip's, and on the matrices the streaming
path really hands the kernel: the first refresh block of the second
window of ``chip_smoke.py``'s scene (C = 4 at step 1, C = 11 at step 2),
built with ``-fmad=false`` as ``eigh.cu`` is.  Run on the card from the
root of the checkout::

    python3 exp/eigh_group_variants.py

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

SOURCE = r"""
#include "eigh.cu"

// eigh.cu's lane-group design at C <= 4: groups of four lanes, eight matrices a warp
extern "C" int run_group4(const void* a, void* lam, void* v, int n, int C, int sweeps,
                          float eps) {
  launch<4>(static_cast<const float*>(a), static_cast<float*>(lam), static_cast<float*>(v), n,
            C, true, sweeps, eps, 0);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("eigh_group_variants: needs a GPU", file=sys.stderr)
        return 1
    from disco_tpu_torch.ops import _build, eigh_ops

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "variants.cu").write_text(SOURCE)
    lib = out / "variants.so"
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-fmad=false", "-Xptxas", "-v", "-I", str(_build.CSRC),
                    str(out / "variants.cu"), "-o", str(lib)], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.disco_eigh_jacobi.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p]
    dll.run_group4.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float]
    res = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    import chip_smoke as cs
    from types import SimpleNamespace

    y, s, n_ = (torch.from_numpy(a).to("cuda")
                for a in cs.scene(cs.K, cs.C, 2 * cs.LW, noise_scale=cs.NOISE_SCALE))
    with cs.recorded_eigh_inputs() as seen:
        cs.stream_windows(SimpleNamespace(y=y, s=s, n=n_), 0, 2, None)
    per_window = len(seen) // 2
    streamed = {4: seen[per_window], 11: seen[per_window + 1]}
    for C in (4, 11):
        for n, reps in ((2056, 50), (322792, 3)):
            X = torch.randn((n, C, C), dtype=torch.complex64, device="cuda", generator=gen)
            sets = {"random": X @ X.mH}
            if n == 2056:
                sets["streaming window 2, block 1"] = streamed[C].reshape(-1, C, C)
            if C == 11 and n == 2056:
                sets["near-degenerate"] = (2 * torch.eye(C, device="cuda") + 1e-6 * (X @ X.mH)
                                           ).to(torch.complex64)
            for label, A in sets.items():
                A = A.contiguous()
                sweeps = eigh_ops.default_sweeps(C)
                lam0, V0 = eigh_ops.eigh_jacobi_kernel(A)
                row = {"kernel as built, ms": timed(lambda: eigh_ops.eigh_jacobi_kernel(A), reps),
                       "kernel as built, 0 sweeps, ms":
                           timed(lambda: eigh_ops.eigh_jacobi_kernel(A, sweeps=0), reps)}
                lam = torch.empty_like(lam0)
                V = torch.empty_like(V0)
                args = (A.data_ptr(), lam.data_ptr(), V.data_ptr(), n, C)

                def direct():
                    assert dll.disco_eigh_jacobi(*args, 1, sweeps, eigh_ops.ROTATION_EPS,
                                                 None) == 0

                def group4():
                    assert dll.run_group4(*args, sweeps, eigh_ops.ROTATION_EPS) == 0

                row["kernel as built, called directly, ms"] = timed(direct, reps)
                if C == 4:
                    row["lane groups of 4, called directly"] = {
                        "ms": timed(group4, reps),
                        "bit-identical to the kernel as built":
                            bool(torch.equal(lam, lam0) and torch.equal(V, V0))}
                res[f"C={C}, n={n}, {label}"] = row
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

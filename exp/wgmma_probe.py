#!/usr/bin/env python3
"""Checks the shared-memory operand layout that ``exp/wgmma_probe.cu``
hands ``wgmma.mma_async`` (m64n128k16, bf16 in, float32 out) against
``torch.matmul`` in float64 on the card.  Run from the root of the
checkout on an H100::

    python3 exp/wgmma_probe.py

It prints the largest error and exits nonzero on a mismatch.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from disco_tpu_torch.ops import _build

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libwgmma_probe.so"
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", str(ROOT / "exp" / "wgmma_probe.cu"), "-o", str(lib_path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.wgmma_probe_launch.argtypes = [ctypes.c_void_p] * 3
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((64, 64), device="cuda", generator=g).to(torch.bfloat16)
    B = torch.randn((128, 64), device="cuda", generator=g).to(torch.bfloat16)
    D = torch.full((64, 128), float("nan"), device="cuda")
    rc = lib.wgmma_probe_launch(A.data_ptr(), B.data_ptr(), D.data_ptr())
    want = A.double() @ B.double().T
    err = float((D.double() - want).abs().max() / want.abs().max())
    print(f"wgmma probe: rc {rc}, max error {err:.3e} of the output scale", flush=True)
    return 0 if rc == 0 and err < 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())

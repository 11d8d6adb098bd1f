"""Build and load the hand-written CUDA kernels of ``disco_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, bound with ``ctypes``:

* one ``nvcc -c`` per ``.cu`` source, all started together, then one
  ``nvcc -shared`` link;
* the library lives in ``build/kernels/<sha256 of flags and sources>/`` at the
  root of the checkout, built at first use, so a fresh checkout builds it
  on its first kernel launch and a changed source gets a new directory;
* ``-Xptxas -v`` output (registers, spills) is kept beside the library in
  ``ptxas.log``;
* ``eigh.cu`` and ``mwf.cu`` are compiled with ``-fmad=false``, so that
  the Jacobi eigensolver and the fused solve round every product and sum
  as their plain PyTorch versions do (see the notes at the top of those
  sources).

Every C entry point takes ``c_void_p`` pointers and stream and ``c_int``
sizes, launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("stft.cu", "stft_bf16.cu", "cov.cu", "mwf.cu", "eigh.cu")
HEADERS = ("common.cuh",)
LIB_NAME = "libdisco_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: flags of one source on top of NVCC_FLAGS
SOURCE_FLAGS = {"eigh.cu": ["-fmad=false"], "mwf.cu": ["-fmad=false"]}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures of the entry points (argument types; every one returns int)
SIGNATURES = {
    # x, win, tw, post, spec, mag, B, L, n_fft, hop, T, stream
    "disco_stft": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, win, frag, nyq, spec, mag, B, L, n_fft, hop, T, stream
    "disco_stft_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # y, mask, rss, rnn, B, C, F, T, per_channel_mask, bf16, stream
    "disco_masked_cov": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # rss, rnn, mu, mu_stride, mu_value, w, t1, n, C, sweeps, eps, loading,
    # lam_floor, lam_ceil, bf16, stream
    "disco_fused_mwf": [_P, _P, _P, _I, _F, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    # a, lam, v, n, C, complex_in, sweeps, eps, stream
    "disco_eigh_jacobi": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lib = None


def source_digest() -> str:
    """sha256 over the compiler flags and the names and contents of every
    kernel source."""
    h = hashlib.sha256(repr((NVCC_FLAGS, SOURCE_FLAGS)).encode())
    for name in sorted(SOURCES + HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build_dir() -> Path:
    return BUILD_ROOT / source_digest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Build the kernel library unless this source digest is built; return
    its path."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    tmp = BUILD_ROOT / f"{out.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in SOURCES:
        obj = tmp / (src + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, []), "-c", str(CSRC / src), "-o", str(obj)]
        with open(tmp / (src + ".log"), "w") as out_log:
            procs[src] = subprocess.Popen(cmd, stdout=out_log, stderr=subprocess.STDOUT)
    seconds = {}
    while len(seconds) < len(procs):  # each compile's own wall time
        for src, proc in procs.items():
            if src not in seconds and proc.poll() is not None:
                seconds[src] = time.perf_counter() - t0
        time.sleep(0.05)
    logs = []
    for src, proc in procs.items():
        text = (tmp / (src + ".log")).read_text()
        logs.append(f"== {src} (finished within {seconds[src]:.1f} s of the start)\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME)]
    link += [str(tmp / (src + ".o")) for src in SOURCES]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    (tmp / "ptxas.log").write_text("\n".join(logs))
    try:
        tmp.rename(out)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load():
    """The loaded kernel library (built at first use).  Raises when the
    current CUDA device is not a Hopper card: the library holds ``sm_90a``
    code only."""
    global _lib
    if _lib is None:
        import torch

        from disco_tpu_torch.device import is_hopper

        if not is_hopper():
            raise RuntimeError(
                "disco_tpu_torch kernels are built for sm_90a (Hopper); the current "
                f"CUDA device has compute capability {torch.cuda.get_device_capability()}"
            )
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.disco_error_string.argtypes = [ctypes.c_int]
        lib.disco_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point returned a nonzero CUDA error."""
    if rc != 0:
        msg = load().disco_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc} ({msg})")


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the current build ('' before a build)."""
    path = build_dir() / "ptxas.log"
    return path.read_text() if path.exists() else ""


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

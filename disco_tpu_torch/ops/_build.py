"""Build and load the hand-written CUDA kernels of ``disco_tpu_torch/csrc``
(no counterpart in ``disco_tpu``, whose Pallas kernels XLA compiles).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, bound with ``ctypes``:

* one ``nvcc -c`` per ``.cu`` source, all started together, then one
  ``nvcc -shared`` link;
* the library lives in ``<root>/<sha256 of flags and sources>/``, built at
  first use, so a fresh root builds it on its first kernel launch and a
  changed source gets a new directory; ``<root>`` is the kernel build cache
  that :mod:`disco_tpu_torch.utils.compile_cache` hands to :func:`build`
  at the first :func:`load` (resolved then, unless a caller resolved the
  cache earlier through ``ensure_enabled``): an argument to
  ``ensure_enabled``, ``DISCO_TORCH_COMPILE_CACHE``, or
  ``build/kernels/`` at the root of the checkout; with the cache off, a
  per-process temporary directory removed at exit;
* ``-Xptxas -v`` output (registers, spills) is kept beside the library in
  ``ptxas.log``;
* ``eigh.cu`` and ``mwf.cu`` are compiled with ``-fmad=false``, so that
  the Jacobi eigensolver and the fused solve round every product and sum
  as their plain PyTorch versions do (see the notes at the top of those
  sources).

Every C entry point takes ``c_void_p`` pointers and stream and ``c_int``
sizes, launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.

Each kernel is one torch op, ``torch.ops.disco_torch.<name>``
(:func:`kernel_op`): its CUDA implementation launches the kernel, its CPU
implementation runs the kernel's plain version, and its fake
implementation gives the shapes and dtypes of its outputs, so a program
traced for the card or recorded on it shows each launch as one op.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
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
#: the loaded library's build directory (:func:`build_dir`)
_lib_dir = None

#: the launch-thread recorder (:func:`record_launch_threads`): None, or the
#: list :func:`check` appends each launch's entry name and thread to
_launch_threads = None

#: the namespace of the kernels' torch ops (``torch.ops.disco_torch``)
OP_NAMESPACE = "disco_torch"
_op_library = None


def source_digest() -> str:
    """sha256 over the compiler flags and the names and contents of every
    kernel source."""
    h = hashlib.sha256(repr((NVCC_FLAGS, SOURCE_FLAGS)).encode())
    for name in sorted(SOURCES + HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build_dir() -> Path | None:
    """The build directory of the loaded library, ``<root>/<source
    digest>`` under the kernel build cache's root; None before
    :func:`load`."""
    return None if _lib_dir is None else _lib_dir


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Build the kernel library under the kernel build cache's root
    (``compile_cache.kernel_root``, resolved here when no caller resolved
    the cache before) unless this source digest is built there; return
    its path."""
    from disco_tpu_torch.utils import compile_cache

    out = compile_cache.kernel_root() / source_digest()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    tmp = out.parent / f"{out.name}.tmp{os.getpid()}"
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
    global _lib, _lib_dir
    if _lib is None:
        import torch

        from disco_tpu_torch.device import is_hopper

        if not is_hopper():
            raise RuntimeError(
                "disco_tpu_torch kernels are built for sm_90a (Hopper); the current "
                f"CUDA device has compute capability {torch.cuda.get_device_capability()}"
            )
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.disco_error_string.argtypes = [ctypes.c_int]
        lib.disco_error_string.restype = ctypes.c_char_p
        _lib, _lib_dir = lib, path.parent
    return _lib


def record_launch_threads(recorder) -> None:
    """Arm (a list) or disarm (None) the launch-thread recorder: while a
    list is armed, :func:`check` appends ``(entry point name,
    threading.current_thread())`` after every kernel launch, so a caller
    can see which threads launched the kernels (``chip_smoke.py`` phase 3o
    holds them to the thread roles of ``analysis/race/roles.py``).
    Disarmed, nothing is recorded."""
    global _launch_threads
    _launch_threads = recorder


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point returned a nonzero CUDA error.
    Every wrapper calls it right after its launch, so it is where an armed
    launch-thread recorder (:func:`record_launch_threads`) notes the
    launching thread."""
    if _launch_threads is not None:
        _launch_threads.append((name, threading.current_thread()))
    if rc != 0:
        msg = load().disco_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc} ({msg})")


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the loaded library's build ('' before
    :func:`load`)."""
    if _lib_dir is None:
        return ""
    path = _lib_dir / "ptxas.log"
    return path.read_text() if path.exists() else ""


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def kernel_op(schema: str, cuda, cpu, fake):
    """Define the op ``torch.ops.disco_torch.<name>`` of ``schema``
    (``"name(Tensor x, int n) -> Tensor"``): ``cuda`` is its CUDA
    implementation (the launch), ``cpu`` its CPU implementation (the plain
    version), ``fake`` its fake implementation (output shapes and dtypes
    for tracing).  Returns the op.  The ops are defined with the low-level
    ``torch.library`` API: ``torch.library.custom_op``'s Python layers cost
    ~25 µs more a call on an H100's host (``exp/custom_op_host_cost.py``),
    which a host-bound streaming window pays per launch."""
    import torch

    global _op_library
    if _op_library is None:
        _op_library = torch.library.Library(OP_NAMESPACE, "FRAGMENT")
    name = schema.split("(", 1)[0]
    _op_library.define(schema)
    _op_library.impl(name, cuda, "CUDA")
    _op_library.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{OP_NAMESPACE}::{name}", fake, lib=_op_library)
    return getattr(getattr(torch.ops, OP_NAMESPACE), name)

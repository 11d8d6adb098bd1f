#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``disco_tpu_torch``) on one NVIDIA
Hopper GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and turned into a
pass):

1. The card's name and power limit (``nvidia-smi``); the four hand-written
   kernels are built from ``disco_tpu_torch/csrc`` into ``build/kernels/``
   (one ``nvcc`` per source, all started together) and their build
   seconds, ``-Xptxas -v`` register, spill and shared-memory counts and
   SASS instruction counts (``cuobjdump -sass``) printed.
2. Every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (K=8 nodes, C=4 mics, 10 s at 16 kHz):
   the STFT on the clip (626 frames, not a multiple of the kernel's
   32-frame tile), on one streaming window (64 frames) and on 300 samples
   (2 frames, both reaching into the reflected edges), the covariances
   and the fused solve at one clip's launches and at those of a 16-clip
   batch of distinct clips (recorded as the path hands them over, so
   that indexing across clips is checked too; the covariances also bit
   for bit from run to run, the solve's bit-identity to its plain version
   reported), the eigensolver on
   the whitened step-1 (C=4) and step-2 (C=11) matrices of the full-clip
   streaming run, on its generic path (C = 1, 2, 7, 16), a ragged batch
   and a NaN matrix, each bit-identical to its plain version.
3. The offline path — ``tango_clip_fused(y, s, n, solver='fused')`` —
   with every launch counter set to 0 before and read after (1 STFT, 2
   covariance, 2 fused-solve launches); the output is finite, within 1e-4
   of the output scale of the same clip run with the plain versions on
   the card, and improves SI-SDR at node 0 by more than 3 dB over the
   noisy reference mic.
4. The streaming path, ``solver='jacobi-pallas'``: nine 1.008-s windows
   through ``streaming_clip_fused`` with the state carried (1 STFT and
   2 x 16 eigensolver launches a window), and ``streaming_tango`` on the
   full 626-frame clip (2 eigensolver launches), each with the counters
   set to 0 before and read after; ``streaming_tango_scan`` bit-identical
   to ``per_block_reference``; the eigensolver bit-identical to its
   plain version on the matrices of one window; windows 2-9 through the
   plain versions from the state after window 1 within 1e-4 rel-l2 and
   0.1 dB SI-SDR of the kernels' windows; the windows' SI-SDR gain at
   node 0 over the noisy reference mic within 0.2 dB of the JAX package's
   on the same windows (``JAX_WINDOWS_GAIN_DB``) after 1, 2 and 3 s; the
   full-clip stream's more than 3 dB after the recursion's first three
   seconds.
5. CUDA-event times: the offline path on a 16-clip batch, the streaming
   window's latency, and per kernel the kernel, its plain version and
   (where one exists) one PyTorch library call computing the same
   function, beside the bound from this run's shapes and the H100 SXM
   data-sheet peaks; the eigensolver both at the full-clip stream's
   batch and at the streaming window's (2056 matrices, C=4 and C=11), the
   covariances and the fused solve both at one clip's launches and at the
   16-clip batch's; beside each kernel's events (which include the
   wrapper's host time) its device time under the profiler.
6. Where one 16-clip offline call and one streaming window spend their
   device time, by kernel (``torch.profiler``), and the device's busy
   share of their wall time.

The last two lines of standard output are one ``{"kernels": [...]}``
object and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np

FS = 16000
K, C = 8, 4              # nodes, mics per node (the north-star scene)
DUR_S = 10.0
NOISE_SCALE = 0.5
BATCH = 16               # clips per timed batch
PEAK_FP32 = 67e12        # H100 SXM, FP32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth (data sheet)
TOL = {"stft": 1e-5, "masked_cov": 1e-5, "fused_mwf": 1e-5, "clip": 1e-4,
       "stream": 1e-4, "stream_sdr_db": 0.1, "sdr_gain_db": 3.0, "witness_db": 0.2}
LW = 16128               # streaming window: 1 + LW // 256 = 64 frames = 16 refresh blocks
N_WINDOWS = 9
BLOCKS_PER_DISPATCH = 16
STREAM_SDR_FROM_S = 3.0  # the full-clip stream's SI-SDR is read after this many seconds
#: SI-SDR gain at node 0 after t s of the JAX package's ``streaming_clip_fused``
#: on the same nine windows (``exp/stream_windows_witness.py``, JAX on the CPU,
#: ``solver='jacobi'``); the port's windows are held to it within TOL["witness_db"]
JAX_WINDOWS_GAIN_DB = {1.0: -0.6723192136432736, 2.0: 0.2787509996364008,
                       3.0: 0.6841468098197936}


def scene(n_nodes, n_mics, length, seed=0, noise_scale=0.8):
    """A broadband speech-like source convolved with random short filters
    per mic, plus white noise: (y, s, n), each (K, C, L) float32."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(length)
    s = np.stack([
        np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same") for _ in range(n_mics)])
        for _ in range(n_nodes)
    ]).astype(np.float32)
    n = noise_scale * rng.standard_normal((n_nodes, n_mics, length)).astype(np.float32)
    return s + n, s, n


def si_sdr(reference, estimation) -> float:
    """Scale-invariant SDR in dB, float64."""
    reference = np.asarray(reference, np.float64)
    estimation = np.asarray(estimation, np.float64)
    alpha = np.dot(reference, estimation) / np.dot(reference, reference)
    proj = alpha * reference
    return float(10 * np.log10(np.sum(proj ** 2) / np.sum((estimation - proj) ** 2)))


def rel_l2(a, b) -> float:
    return float((a - b).abs().pow(2).sum().sqrt() / b.abs().pow(2).sum().sqrt())


def max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call over ``reps`` calls, by CUDA events
    around each call.  Before each call a write of a buffer twice the
    size of the 50 MB L2 cache evicts it, so every call starts cold, as
    in the path, where each stage reads what the one before wrote."""
    import torch

    flush = torch.empty(25 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) at the data-sheet peaks."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stft_cost(rows: int, length: int, n_fft: int = 512, hop: int = 256):
    """(operations, bytes) of a centered real STFT with magnitudes: per
    frame the window, one real FFT (2.5 n log2 n operations, half those of
    a complex radix-2 FFT) and the magnitude; the signal read once, the
    complex spectrum and the magnitude written once."""
    n_freq = n_fft // 2 + 1
    frames = rows * (1 + length // hop)
    flops = frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 4 * n_freq)
    nbytes = rows * length * 4 + frames * n_freq * 12
    return flops, nbytes


def cov_cost(batch: int, D: int, F: int, T: int, chan: bool):
    pairs = D * (D + 1) // 2
    per_t = pairs * (14 + (6 if chan else 0)) + (0 if chan else 5)
    flops = batch * F * T * per_t
    nbytes = batch * F * T * (D * 8 + (D if chan else 1) * 4) + 2 * batch * F * D * D * 8
    return flops, nbytes


def mwf_cost(n: int, C: int, sweeps: int):
    """Float operations of the fused solve's chain per pencil, times n."""
    f = 3 * C * C + 2 * C + 6                                  # traces, scale
    for j in range(C):                                           # Cholesky
        f += 4 * j + 3 + (C - 1 - j) * (8 * j + 2)
    f += sum(C * (8 * i + 2) for i in range(C))                  # B = L^-1 Rss
    f += sum(C * (8 * i + 3) for i in range(C)) + 4 * C * C      # M, re-hermitize
    f += sweeps * (C * (C - 1) // 2) * (48 * C + 20)             # Jacobi
    f += C + 2 + sum(8 * (C - 1 - i) + 2 for i in range(C))      # max, clip, back-sub
    f += 6 + 12 * C                                              # filter formation
    nbytes = n * (2 * C * C * 8 + 4 + 2 * C * 8)
    return n * f, nbytes


def eigh_cost(n: int, C: int, sweeps: int, complex_in: bool = True):
    """(operations, bytes) of ``n`` fixed-sweep Jacobi eigensolves: 48 C + 20
    float operations per rotation (the rotation's own ~20, then 16 per
    element of two rows, two columns and two V columns); each matrix read
    once, its diagonal and V written once."""
    flops = n * sweeps * (C * (C - 1) // 2) * (48 * C + 20)
    width = 8 if complex_in else 4
    return flops, n * (C * C * width + C * 4 + C * C * width)


def short_kernel_name(mangled: str) -> str:
    """The kernel's name and template arguments out of its mangled name."""
    short = re.search(r"(stft_rfft_kernel|masked_cov_kernelILb[01]E"
                      r"|(?:fused_mwf|eigh)_(?:thread|group)_kernelILi\d+E)", mangled)
    return short.group(1) if short else mangled


def sass_counts(lib_path) -> dict:
    """SASS instructions per kernel of the built library (``cuobjdump
    -sass``, from the toolkit of the ``nvcc`` that built it)."""
    from pathlib import Path

    from disco_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_kernel_name(m.group(1))
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def ptxas_summary(log: str) -> list[dict]:
    """Registers, spill bytes and static shared memory per compiled kernel
    from ``-Xptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = short_kernel_name(m.group(1))
            out.append({"kernel": name})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and out:
            out[-1]["smem_bytes"] = int(m.group(1))
    return out


@contextmanager
def plain_kernels():
    """Swap each kernel wrapper for its plain version, so the same path
    runs the plain PyTorch versions on the card (the reference runs of
    phases 3 and 4)."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    saved = (stft_ops.stft_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel,
             eigh_ops.eigh_jacobi_kernel)
    stft_ops.stft_kernel = stft_ops.stft_matmul
    cov_ops.masked_cov_kernel = cov_ops.masked_covariances_folded
    mwf_ops.fused_mwf_kernel = mwf_ops.fused_mwf_plain
    eigh_ops.eigh_jacobi_kernel = eigh_ops.eigh_jacobi_unsorted
    try:
        yield
    finally:
        (stft_ops.stft_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel,
         eigh_ops.eigh_jacobi_kernel) = saved


@contextmanager
def recorded_eigh_inputs():
    """The matrices the ``'jacobi-pallas'`` eigensolve is given, in call
    order (one call per eigensolver launch)."""
    from disco_tpu_torch.ops import eigh_ops

    seam, seen = eigh_ops.eigh_jacobi_pallas, []

    def record(A, sweeps=None):
        seen.append(A)
        return seam(A, sweeps)

    eigh_ops.eigh_jacobi_pallas = record
    try:
        yield seen
    finally:
        eigh_ops.eigh_jacobi_pallas = seam


@contextmanager
def recorded_kernel_inputs():
    """The arguments the covariance and fused-solve wrappers are given, in
    call order."""
    from disco_tpu_torch.ops import cov_ops, mwf_ops

    cov, mwf = cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel
    seen = {"masked_cov": [], "fused_mwf": []}

    def record_cov(y, mask):
        seen["masked_cov"].append((y, mask))
        return cov(y, mask)

    def record_mwf(Rss, Rnn, mu=1.0, sweeps=None):
        seen["fused_mwf"].append((Rss, Rnn, mu))
        return mwf(Rss, Rnn, mu, sweeps)

    # a wrapper adds to the counter of the function its module name holds:
    # while recording, the recorder's, so recorded launches count nowhere
    record_cov.launches = record_mwf.launches = 0
    cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = record_cov, record_mwf
    try:
        yield seen
    finally:
        cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = cov, mwf


def kernel_wrappers() -> dict:
    """name -> the wrapper whose ``launches`` counts the kernel."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    return {"stft": stft_ops.stft_kernel, "masked_cov": cov_ops.masked_cov_kernel,
            "fused_mwf": mwf_ops.fused_mwf_kernel, "eigh_jacobi": eigh_ops.eigh_jacobi_kernel}


@contextmanager
def counted(label: str, expected: dict, out: dict):
    """Set every launch counter to 0, run the body, read the counters into
    ``out[label]`` and require ``expected``."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    yield
    import torch

    torch.cuda.synchronize()
    out[label] = {name: fn.launches for name, fn in wrappers.items()}
    print(f"launches, {label}: {out[label]}", flush=True)
    require(out[label] == expected, (label, out[label], expected))


def require(ok: bool, what) -> None:
    """Fail the run (a raised error, never a pass) unless ``ok``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase1_build() -> str:
    """The card's name and power limit; build and load the kernels."""
    from disco_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})", flush=True)
    log = _build.ptxas_log()
    print("build seconds: " + json.dumps({m.group(1): float(m.group(2)) for m in re.finditer(
        r"== (\S+) \(finished within ([0-9.]+) s of the start\)", log)}), flush=True)
    print("ptxas: " + json.dumps(ptxas_summary(log)), flush=True)
    print("SASS instructions: " + json.dumps(sass_counts(_build.build_dir() / _build.LIB_NAME)),
          flush=True)
    return smi


def phase2_kernels() -> SimpleNamespace:
    """Each kernel against its plain version at the main path's shapes;
    returns the scene, the inputs of each launch and the largest errors."""
    import torch

    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.enhance.tango import others_index
    from disco_tpu_torch.ops import stft_ops

    d = SimpleNamespace(dev=torch.device("cuda"), L=int(DUR_S * FS))
    d.y_np, d.s_np, d.n_np = scene(K, C, d.L, noise_scale=NOISE_SCALE)
    d.y, d.s, d.n = (torch.from_numpy(a).to(d.dev) for a in (d.y_np, d.s_np, d.n_np))
    d.x = torch.stack([d.y, d.s, d.n])                           # (3, K, C, L)
    d.err = {}

    # the streaming window's shape (two 32-frame tiles); 300 samples, 44 more
    # than the reflect padding needs (2 frames, both reaching into the
    # reflected edges); the offline clip's (626 frames: a ragged last tile)
    d.err["stft"] = 0.0
    for label, x in (("window", d.x[..., :LW]), ("short", d.x[..., :300]), ("clip", d.x)):
        spec_k, mag_k = stft_ops.stft_kernel(x, with_mag=True)
        spec_p, mag_p = stft_ops.stft_matmul(x, with_mag=True)
        torch.cuda.synchronize()
        r = max(rel_l2(spec_k, spec_p), rel_l2(mag_k, mag_p))
        e = max(max_abs(spec_k, spec_p), max_abs(mag_k, mag_p))
        d.err["stft"] = max(d.err["stft"], e)
        print(f"phase 2: stft {label} {tuple(x.shape)} rel-l2 {r:.3e} max-abs {e:.3e}",
              flush=True)
        require(r <= TOL["stft"], ("stft", label, r))

    d.Y = spec_p[0]                                              # (K, C, F, T)
    d.m = tf_mask_mag(mag_p[1][:, 0], mag_p[2][:, 0], "irm1")    # (K, F, T)
    oth = torch.as_tensor(others_index(K), device=d.dev)
    d.in_y = torch.cat([d.Y, d.Y[:, 0][oth]], dim=1)             # (K, C+K-1, F, T)
    chan_m = torch.cat([d.m[:, None].expand(K, C, *d.m.shape[1:]), d.m[oth]], dim=1)
    d.pencils = {}
    d.err["masked_cov"] = 0.0
    for label, yy, mm in (("step1", d.Y, d.m), ("step2", d.in_y, d.m),
                          ("step2-chan", d.in_y, chan_m)):
        d.pencils[label] = check_cov(d, label, yy, mm)
    # the generic C <= 16 path of the solve, off the main path
    d.pencils["generic-C7"] = tuple(p[..., :7, :7].contiguous() for p in d.pencils["step2"])
    d.err["fused_mwf"] = 0.0
    for label in ("step1", "step2", "generic-C7"):
        check_mwf(d, label, *d.pencils[label])

    # the launches of a 16-clip batch, as the path hands them to the kernels;
    # its clips differ, so a kernel that read another clip's bin or pencil
    # would disagree with its plain version
    with recorded_kernel_inputs() as seen:
        tango_clip_fused(*distinct_clips(d), solver="fused")
    require(len(seen["masked_cov"]) == 2 and len(seen["fused_mwf"]) == 2,
            ("kernel launches of one batched offline call", {k: len(v) for k, v in seen.items()}))
    d.batch = seen
    for label, (yy, mm) in zip(("batch step1", "batch step2"), seen["masked_cov"]):
        check_cov(d, label, yy, mm)
    for label, (Rss, Rnn, mu) in zip(("batch step1", "batch step2"), seen["fused_mwf"]):
        check_mwf(d, label, Rss, Rnn, mu)
    phase2_eigh(d)
    return d


def check_cov(d: SimpleNamespace, label: str, yy, mm):
    """The covariance kernel against its plain version, and against its own
    second run bit for bit; returns the plain version's pair."""
    import torch

    from disco_tpu_torch.ops import cov_ops

    ks = cov_ops.masked_cov_kernel(yy, mm)
    again = cov_ops.masked_cov_kernel(yy, mm)
    ps = cov_ops.masked_covariances_folded(yy, mm)
    torch.cuda.synchronize()
    r = max(max_rel(ks[0], ps[0]), max_rel(ks[1], ps[1]))
    e = max(max_abs(ks[0], ps[0]), max_abs(ks[1], ps[1]))
    stable = all(torch.equal(a, b) for a, b in zip(ks, again))
    d.err["masked_cov"] = max(d.err["masked_cov"], e)
    print(f"phase 2: masked_cov {label} {tuple(yy.shape)} mask {tuple(mm.shape)} max-rel {r:.3e} "
          f"max-abs {e:.3e} bit-stable run to run {stable}", flush=True)
    require(r <= TOL["masked_cov"] and stable, ("masked_cov", label, r, stable))
    return ps


def check_mwf(d: SimpleNamespace, label: str, Rss, Rnn, mu=1.0) -> None:
    """The fused-solve kernel against its plain version; whether the two
    agree bit for bit is reported."""
    import torch

    from disco_tpu_torch.ops import mwf_ops

    wk, tk = mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu)
    wp, tp = mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(wk).all() and torch.isfinite(wp).all())
    r = max(rel_l2(wk, wp), rel_l2(tk, tp))
    e = max(max_abs(wk, wp), max_abs(tk, tp))
    bitwise = bool(torch.equal(wk, wp) and torch.equal(tk, tp))
    d.err["fused_mwf"] = max(d.err["fused_mwf"], e)
    print(f"phase 2: fused_mwf {label} {tuple(Rss.shape)} rel-l2 {r:.3e} max-abs {e:.3e} "
          f"finite {finite} bit-identical {bitwise}", flush=True)
    require(finite and r <= TOL["fused_mwf"], ("fused_mwf", label, r))


def batch_clips(d: SimpleNamespace):
    """(y, s, n) of the timed batch: the clip repeated BATCH times."""
    return tuple(a[None].expand(BATCH, *a.shape).contiguous() for a in (d.y, d.s, d.n))


def distinct_clips(d: SimpleNamespace):
    """(y, s, n) of BATCH distinct clips: clip b is the scene circularly
    shifted by b * 1237 samples (1237 b mod 256 differs for every b < 256,
    so no two clips' frames line up)."""
    import torch

    return tuple(torch.stack([torch.roll(a, b * 1237, dims=-1) for b in range(BATCH)])
                 for a in (d.y, d.s, d.n))


def phase2_eigh(d: SimpleNamespace) -> None:
    """The eigensolver kernel against its plain version: on the whitened
    matrices of the full-clip streaming run (recorded as the path hands
    them to the kernel), on the generic path, a ragged batch and a NaN
    matrix.  Eigenvalues and eigenvectors are compared as they come."""
    import torch

    from disco_tpu_torch.enhance.streaming import streaming_tango
    from disco_tpu_torch.ops import eigh_ops

    with recorded_eigh_inputs() as seen:
        streaming_tango(d.Y, d.m, d.m, solver="jacobi-pallas")
    require(len(seen) == 2, ("eigensolver launches of one streaming_tango call", len(seen)))
    d.whitened = {"step1": seen[0], "step2": seen[1]}
    D = seen[1].shape[-1]
    flat2 = seen[1].reshape(-1, D, D)
    gen = torch.Generator(device=d.dev).manual_seed(0)
    X = torch.randn((20000, 16, 16), dtype=torch.complex64, device=d.dev, generator=gen)
    C1 = seen[0].shape[-1]
    ragged = seen[0].reshape(-1, C1, C1)[:130].clone()
    ragged[7] = float("nan")
    ragged2 = flat2[:131].clone()
    ragged2[130] = float("nan")
    cases = [("step1", seen[0]), ("step2", seen[1])]
    cases += [(f"generic-C{c}", flat2[:20000, :c, :c].contiguous()) for c in (1, 2, 7)]
    cases += [("generic-C16", X @ X.mH), ("ragged-130-with-NaN", ragged),
              ("ragged-131-with-NaN", ragged2)]
    d.err["eigh_jacobi"] = 0.0
    for label, A in cases:
        c = A.shape[-1]
        lk, Vk = eigh_ops.eigh_jacobi_kernel(A)
        lp, Vp = eigh_ops.eigh_jacobi_unsorted(A)
        torch.cuda.synchronize()
        lk, lp = lk.reshape(-1, c), lp.reshape(-1, c)
        Vk, Vp = Vk.reshape(-1, c, c), Vp.reshape(-1, c, c)
        ok = torch.isfinite(A.reshape(-1, c * c)).all(-1)
        r_lam, r_V = rel_l2(lk[ok], lp[ok]), rel_l2(Vk[ok], Vp[ok])
        e = max(max_abs(lk[ok], lp[ok]), max_abs(Vk[ok], Vp[ok]))
        d.err["eigh_jacobi"] = max(d.err["eigh_jacobi"], e)
        bitwise = bool(torch.equal(lk.nan_to_num(), lp.nan_to_num())
                       and torch.equal(Vk.nan_to_num(), Vp.nan_to_num()))
        nan_pairs = bool(torch.isnan(lk[~ok]).all() and (c == 1 or torch.isnan(Vk[~ok]).all()))
        print(f"phase 2: eigh_jacobi {label} {tuple(A.shape)} eigenvalues rel-l2 {r_lam:.3e}, "
              f"eigenvectors rel-l2 {r_V:.3e}, max-abs {e:.3e}, bit-identical {bitwise}, "
              f"{int((~ok).sum())} non-finite matrices -> NaN pairs {nan_pairs}", flush=True)
        require(bitwise and nan_pairs, ("eigh", label, "bit-identical", bitwise, "NaN", nan_pairs))


def phase3_offline_path(d: SimpleNamespace) -> None:
    """The offline path through its entry point, with the launch counters."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused

    with counted("offline clip", {"stft": 1, "masked_cov": 2, "fused_mwf": 2, "eigh_jacobi": 0},
                 d.launches):
        out = tango_clip_fused(d.y, d.s, d.n, solver="fused")
    require(out.shape == (K, d.L) and bool(torch.isfinite(out).all()),
            "non-finite or misshapen output")
    with plain_kernels():
        ref = tango_clip_fused(d.y, d.s, d.n, solver="fused")
    torch.cuda.synchronize()
    clip_err = max_rel(out, ref)
    sdr_in = si_sdr(d.s_np[0, 0], d.y_np[0, 0])
    sdr_out = si_sdr(d.s_np[0, 0], out[0].cpu().numpy())
    print(f"phase 3: clip vs plain-version clip {clip_err:.3e} of output scale; SI-SDR node 0 "
          f"{sdr_in:.2f} -> {sdr_out:.2f} dB (gain {sdr_out - sdr_in:.2f})", flush=True)
    require(clip_err <= TOL["clip"], ("clip", clip_err))
    require(sdr_out - sdr_in > TOL["sdr_gain_db"], ("sdr gain", sdr_out - sdr_in))


def stream_windows(d: SimpleNamespace, first: int, last: int, state):
    """Windows ``first`` .. ``last - 1`` of the clip through
    ``streaming_clip_fused`` from ``state``; returns (the (K, n * LW)
    output, the state after each window)."""
    import torch

    from disco_tpu_torch.enhance.fused import streaming_clip_fused

    outs, states = [], []
    for w in range(first, last):
        sl = slice(w * LW, (w + 1) * LW)
        o = streaming_clip_fused(d.y[..., sl], d.s[..., sl], d.n[..., sl], state=state,
                                 solver="jacobi-pallas", blocks_per_dispatch=BLOCKS_PER_DISPATCH)
        state = o["state"]
        outs.append(o["yf"])
        states.append(state)
    return torch.cat(outs, dim=-1), states


def phase4_streaming_path(d: SimpleNamespace) -> None:
    """The streaming path with the eigensolver kernel: the windows through
    ``streaming_clip_fused`` and the full clip through ``streaming_tango``,
    each with the launch counters; scan against the per-block oracle, bit
    for bit; the windows after the first against the plain versions from
    a shared state; SI-SDR."""
    import torch

    from disco_tpu_torch.core.dsp import istft
    from disco_tpu_torch.enhance.stream_check import per_block_reference
    from disco_tpu_torch.enhance.streaming import (
        initial_stream_state,
        state_leaves,
        streaming_tango,
        streaming_tango_scan,
    )
    from disco_tpu_torch.ops.eigh_ops import eigh_jacobi_kernel, eigh_jacobi_unsorted

    per_window = 2 * (1 + LW // 256) // 4
    with counted("streaming windows", {"stft": N_WINDOWS, "masked_cov": 0, "fused_mwf": 0,
                                       "eigh_jacobi": N_WINDOWS * per_window}, d.launches):
        yw, states = stream_windows(d, 0, N_WINDOWS, None)
    Lc = N_WINDOWS * LW
    require(yw.shape == (K, Lc) and bool(torch.isfinite(yw).all()),
            "non-finite or misshapen streaming output")
    d.stream_state_1 = states[0]
    # the matrices one window hands the eigensolver (window 2, from the state
    # after window 1): its step-1 (C=4) and step-2 (C=11) launches of one block
    with recorded_eigh_inputs() as seen:
        stream_windows(d, 1, 2, d.stream_state_1)
    d.window_eigh = {"step1": seen[0], "step2": seen[1]}
    for label, A in d.window_eigh.items():
        lk, Vk = eigh_jacobi_kernel(A)
        lp, Vp = eigh_jacobi_unsorted(A)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(lk, lp) and torch.equal(Vk, Vp))
        print(f"phase 4: eigh_jacobi on one window's {label} launch {tuple(A.shape)}: "
              f"bit-identical {bitwise}", flush=True)
        require(bitwise, ("eigh on a window's matrices", label))
    with counted("streaming_tango full clip", {"stft": 0, "masked_cov": 0, "fused_mwf": 0,
                                               "eigh_jacobi": 2}, d.launches):
        full = streaming_tango(d.Y, d.m, d.m, solver="jacobi-pallas")
    yfull = istft(full["yf"], length=d.L)
    require(bool(torch.isfinite(yfull).all()), "non-finite full-clip stream")

    # scanned super ticks == the per-block loop, bit for bit, on the card
    Ys, ms = d.Y[..., :64], d.m[..., :64]
    F = d.Y.shape[-2]
    ref, ref_state = per_block_reference(Ys, ms, block=8, update_every=4,
                                         state=initial_stream_state(K, C, F),
                                         solver="jacobi-pallas")
    st, parts = initial_stream_state(K, C, F), []
    for w in range(2):
        sl = slice(32 * w, 32 * (w + 1))
        o = streaming_tango_scan(Ys[..., sl], ms[..., sl], ms[..., sl], state=st,
                                 z_avail=torch.ones((K, 8)), blocks_per_dispatch=4,
                                 solver="jacobi-pallas")
        st = o["state"]
        parts.append(o["yf"])
    same_out = bool(torch.equal(torch.cat(parts, dim=-1), ref))
    same_state = all(torch.equal(a, b) for a, b in zip(state_leaves(st), state_leaves(ref_state)))
    print(f"phase 4: streaming_tango_scan vs per_block_reference, 64 frames in super ticks of "
          f"4 blocks: output bit-identical {same_out}, state bit-identical {same_state}",
          flush=True)
    require(same_out and same_state, "scan vs per-block bit-exactness")

    # the plain versions from the state after the first window
    with plain_kernels():
        yp, _ = stream_windows(d, 1, N_WINDOWS, states[0])
        yc, _ = stream_windows(d, 0, N_WINDOWS, None)
    torch.cuda.synchronize()
    yk = yw[:, LW:]
    err = rel_l2(yk, yp)
    sdr = {}
    for label, out in (("kernels", yk), ("plain", yp)):
        sdr[label] = si_sdr(d.s_np[0, 0, LW:Lc], out[0].cpu().numpy())
    cold = [rel_l2(yw[:, w * LW:(w + 1) * LW], yc[:, w * LW:(w + 1) * LW])
            for w in range(N_WINDOWS)]
    print(f"phase 4: windows 2-{N_WINDOWS} from the state after window 1, kernels vs plain "
          f"versions: rel-l2 {err:.3e}, SI-SDR node 0 {sdr['kernels']:.4f} vs "
          f"{sdr['plain']:.4f} dB", flush=True)
    print("phase 4: every window from the warm start, kernels vs plain versions, rel-l2 per "
          "window: " + json.dumps(cold), flush=True)
    require(err <= TOL["stream"], ("stream vs plain", err))
    require(abs(sdr["kernels"] - sdr["plain"]) <= TOL["stream_sdr_db"], ("stream sdr", sdr))

    clean, noisy = d.s_np[0, 0], d.y_np[0, 0]
    yw0, yf0 = yw[0].cpu().numpy(), yfull[0].cpu().numpy()
    gains = {"windows": sdr_gains(clean, noisy, yw0),
             "windows, window edges left out": sdr_gains(clean, noisy, yw0, window_interior(Lc)),
             "full clip": sdr_gains(clean, noisy, yf0)}
    print("phase 4: SI-SDR gain at node 0 over the noisy reference mic, after t seconds: "
          + json.dumps(gains) + "; the JAX package's windows: " + json.dumps(JAX_WINDOWS_GAIN_DB),
          flush=True)
    require(all(abs(gains["windows"][t] - g) <= TOL["witness_db"]
                for t, g in JAX_WINDOWS_GAIN_DB.items()), ("windows vs JAX witness", gains))
    require(gains["full clip"][STREAM_SDR_FROM_S] > TOL["sdr_gain_db"], ("stream sdr gain", gains))


def sdr_gains(clean, noisy, out, keep=None) -> dict:
    """SI-SDR gain in dB of ``out`` over ``noisy`` against ``clean`` after
    t = 1, 2, 3 s, over the samples ``keep`` (a boolean mask; all when
    None)."""
    res = {}
    for t in (1.0, 2.0, 3.0):
        idx = np.arange(int(t * FS), len(out))
        if keep is not None:
            idx = idx[keep[idx]]
        res[t] = si_sdr(clean[idx], out[idx]) - si_sdr(clean[idx], noisy[idx])
    return res


def window_interior(length: int, hop: int = 256):
    """The samples of consecutive ``LW`` windows more than one hop from a
    window boundary: what each window's own centred, reflect-padded STFT
    frames alone do not reach."""
    pos = np.arange(length) % LW
    return (pos >= hop) & (pos < LW - hop)


def phase5_times(d: SimpleNamespace) -> list[dict]:
    """CUDA-event times of the paths and of each kernel, its plain version
    and its library call, with the bound of this run's shapes."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops
    from disco_tpu_torch.ops.eigh_ops import default_sweeps

    yb, sb, nb = batch_clips(d)
    tango_clip_fused(yb, sb, nb, solver="fused")  # warm-up
    runs = sorted(time_ms(lambda: tango_clip_fused(yb, sb, nb, solver="fused"), reps=1,
                          warmup=0) for _ in range(5))
    path_ms = runs[2]
    audio_s = BATCH * K * DUR_S
    print(f"phase 5: offline path {BATCH} clips {path_ms} ms (median of {runs}) = "
          f"{audio_s / (path_ms / 1e3)} enhanced audio-s per s", flush=True)
    del yb, sb, nb

    # streaming: windows 2..9 again from the state after window 1, each
    # timed on the host clock to its synchronize (the latency a caller sees)
    state, lat = d.stream_state_1, []
    for w in range(1, N_WINDOWS):
        t0 = time.perf_counter()
        _, (state,) = stream_windows(d, w, w + 1, state)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    med = sorted(lat)[len(lat) // 2]
    print(f"phase 5: streaming window ({LW} samples = {LW / FS} s, {BLOCKS_PER_DISPATCH} refresh "
          f"blocks) latency {med} ms (median of {lat}); per refresh block "
          f"{med / BLOCKS_PER_DISPATCH} ms; {LW / FS / (med / 1e3)} stream-seconds per s "
          f"({K * LW / FS / (med / 1e3)} node-audio-seconds per s)", flush=True)

    win = stft_ops.hann_periodic(512, device=d.dev)
    rows = d.x.reshape(-1, d.L)

    entries = []
    fl, nbytes = stft_cost(rows.shape[0], d.L)
    b_ms, b_by = bound(fl, nbytes)
    entries.append({
        "name": "stft", "route": "cuda", "source": "disco_tpu_torch/csrc/stft.cu",
        "replaces": "disco_tpu/ops/stft_ops.py:183", **_launches(d, "stft"),
        "max_abs_err": d.err["stft"],
        "ms": time_ms(lambda: stft_ops.stft_kernel(d.x, with_mag=True), reps=20),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(d.x, with_mag=True), reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.stft(rows, 512, 256, window=win, center=True,
                                                 pad_mode="reflect", return_complex=True), reps=20),
    })

    def cov_times(label, yy, mm, plain_reps):
        lead, (D, F, T) = yy.shape[:-3], yy.shape[-3:]
        chan = mm.ndim == yy.ndim
        fl, nbytes = cov_cost(math.prod(lead), D, F, T, chan)
        return {
            "shape": f"{label} {tuple(yy.shape)}",
            "ms": time_ms(lambda: cov_ops.masked_cov_kernel(yy, mm), reps=50),
            "device_ms": device_ms(lambda: cov_ops.masked_cov_kernel(yy, mm), "masked_cov_kernel"),
            "plain_ms": time_ms(lambda: cov_ops.masked_covariances_folded(yy, mm),
                                reps=plain_reps),
            "library_ms": time_ms(library_cov(yy, mm), reps=plain_reps),
            "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    def mwf_times(label, Rss, Rnn, mu, plain_reps):
        D = Rss.shape[-1]
        fl, nbytes = mwf_cost(Rss[..., 0, 0].numel(), D, default_sweeps(D))
        return {
            "shape": f"{label} {tuple(Rss.shape)}",
            "ms": time_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu), reps=20),
            "device_ms": device_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu), "fused_mwf"),
            "plain_ms": time_ms(lambda: mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu), reps=plain_reps,
                                warmup=1),
            "library_ms": None, "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    # covariances and fused solve: the step-1 (C=4) and step-2 (D=11)
    # launches of one clip; beside them, those of the 16-clip batch
    per = [cov_times(label, yy, d.m, 20) for label, yy in (("step1", d.Y), ("step2", d.in_y))]
    entries.append(_summed(d, "masked_cov", "disco_tpu_torch/csrc/cov.cu",
                           "disco_tpu/ops/cov_ops.py:233", per))
    entries[-1]["batch_launches"] = [cov_times(f"batch {label}", yy, mm, 5) for label, (yy, mm)
                                     in zip(("step1", "step2"), d.batch["masked_cov"])]
    per = [mwf_times(label, *d.pencils[label], 1.0, 2) for label in ("step1", "step2")]
    entries.append(_summed(d, "fused_mwf", "disco_tpu_torch/csrc/mwf.cu",
                           "disco_tpu/ops/mwf_ops.py:434", per))
    entries[-1]["batch_launches"] = [mwf_times(f"batch {label}", Rss, Rnn, mu, 1) for label,
                                     (Rss, Rnn, mu) in zip(("step1", "step2"), d.batch["fused_mwf"])]
    for e in entries[1:]:
        for row in e["per_launch"] + e["batch_launches"]:
            print(f"phase 5: {e['name']}: " + json.dumps(row), flush=True)

    def eigh_times(label, A, reps, plain_reps):
        D = A.shape[-1]
        fl, nbytes = eigh_cost(A[..., 0, 0].numel(), D, default_sweeps(D))
        lib_ms, lib_chunk = library_eigh_ms(A)
        return {
            "shape": f"{label} {tuple(A.shape)}",
            "ms": time_ms(lambda: eigh_ops.eigh_jacobi_kernel(A), reps=reps),
            "device_ms": device_ms(lambda: eigh_ops.eigh_jacobi_kernel(A), "eigh_"),
            "plain_ms": time_ms(lambda: eigh_ops.eigh_jacobi_unsorted(A), reps=plain_reps,
                                warmup=1),
            "library_ms": lib_ms, "library_matrices_per_call": lib_chunk,
            "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    # eigensolver: step 1 (C=4) and step 2 (D=11) launches of one full-clip
    # stream; beside them, those of one refresh block of a streaming window
    per = [eigh_times(label, d.whitened[label], 10, 1) for label in ("step1", "step2")]
    entries.append(_summed(d, "eigh_jacobi", "disco_tpu_torch/csrc/eigh.cu",
                           "disco_tpu/ops/eigh_ops.py:341", per))
    entries[-1]["window_launches"] = [eigh_times(f"window {label}", A, 50, 3)
                                      for label, A in d.window_eigh.items()]
    for w in entries[-1]["window_launches"]:
        print("phase 5: eigh_jacobi at the streaming window's batch: " + json.dumps(w),
              flush=True)
    for e in entries:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            require(math.isfinite(e[key]), (e["name"], key))
    return entries


def library_cov(yy, mm):
    """One ``torch.einsum`` call per covariance computing the kernel's pair
    (the shared mask's weights made before, as the kernel's wrapper is
    handed the mask)."""
    import torch

    T = yy.shape[-1]
    if mm.ndim == yy.ndim:
        return lambda: [torch.einsum("...cft,...dft->...fcd", a, a.conj()) / T
                        for a in (mm * yy, (1 - mm) * yy)]
    w_st = torch.stack([mm * mm, (1 - mm) ** 2]).to(torch.complex64) / T
    return lambda: torch.einsum("w...ft,...cft,...dft->w...fcd", w_st, yy, yy.conj())


def device_ms(fn, kernel: str, reps: int = 10) -> float | None:
    """Device time of one call of ``fn`` in the kernels whose name holds
    ``kernel`` (``torch.profiler``), mean of ``reps`` calls each after an L2
    flush, as ``time_ms``; None when the profiler saw no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(25 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            us += t
    return us / 1e3 / reps if us > 0 else None


def library_eigh_ms(A) -> tuple[float, int]:
    """CUDA-event time of ``torch.linalg.eigh`` (cuSOLVER) over the same
    batch, and the matrices per call.  cuSOLVER's batched eigensolver may
    refuse a batch this large; the batch is then halved until it takes it,
    and the time is that of the calls over the whole batch.  Non-finite
    matrices, if any, are replaced by the identity: it takes no NaN."""
    import torch

    D = A.shape[-1]
    flat = A.reshape(-1, D, D)
    finite = torch.isfinite(flat).flatten(-2).all(-1)[:, None, None]
    flat = torch.where(finite, flat, torch.eye(D, dtype=A.dtype, device=A.device))
    chunk = flat.shape[0]
    while True:
        try:
            torch.linalg.eigh(flat[:chunk])
            torch.cuda.synchronize()
            break
        except torch.linalg.LinAlgError as err:
            require(chunk > 1, ("torch.linalg.eigh", str(err)[:200]))
            chunk = (chunk + 1) // 2
    parts = flat.split(chunk)
    return time_ms(lambda: [torch.linalg.eigh(x) for x in parts], reps=3, warmup=1), chunk


def profiled(label: str, fn) -> None:
    """Device time by kernel name (``torch.profiler``) of one call of
    ``fn``, and the device's busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append({"kernel": ev.key[:90], "calls": ev.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    if not rows:
        print(f"phase 6: {label}: the profiler recorded no device time: breakdown not measured",
              flush=True)
        return
    print(f"phase 6: {label} under the profiler: wall {wall_ms} ms, device busy {busy} ms "
          f"({busy / wall_ms} of the wall time)", flush=True)
    for r in rows[:14]:
        print(f"phase 6: {label}: " + json.dumps(r), flush=True)


def phase6_breakdown(d: SimpleNamespace) -> None:
    """Where the time of one 16-clip offline call and of one streaming
    window goes."""
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    yb, sb, nb = batch_clips(d)
    profiled(f"one {BATCH}-clip offline call",
             lambda: tango_clip_fused(yb, sb, nb, solver="fused"))
    del yb, sb, nb
    profiled("one streaming window (window 2)", lambda: stream_windows(d, 1, 2, d.stream_state_1))


def _launches(d: SimpleNamespace, name: str) -> dict:
    """A kernel's launches over the main paths' runs, and by path."""
    by_path = {path: counts[name] for path, counts in d.launches.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def _summed(d: SimpleNamespace, name, source, replaces, per) -> dict:
    """One kernel's entry over the launches of one clip (``per``)."""
    lib = [p["library_ms"] for p in per]
    flops, nbytes = sum(p["flops"] for p in per), sum(p["bytes"] for p in per)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        **_launches(d, name), "max_abs_err": d.err[name],
        "ms": sum(p["ms"] for p in per), "plain_ms": sum(p["plain_ms"] for p in per),
        "bound_ms": sum(p["bound_ms"] for p in per), "bound_by": bound(flops, nbytes)[1],
        "library_ms": None if None in lib else sum(lib), "per_launch": per,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase1_build()
    d = phase2_kernels()
    d.launches = {}
    phase3_offline_path(d)
    phase4_streaming_path(d)
    entries = phase5_times(d)
    phase6_breakdown(d)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``disco_tpu_torch``) on one NVIDIA
Hopper GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and turned into a
pass):

1. The card's name and power limit (``nvidia-smi``); the hand-written
   kernels are built from ``disco_tpu_torch/csrc`` into ``build/kernels/``
   (one ``nvcc`` per source, all started together) and their build
   seconds, ``-Xptxas -v`` register, spill and shared-memory counts and
   SASS instruction counts (``cuobjdump -sass``) printed.  Five sources:
   the f32 STFT (a real FFT), the bf16 STFT (a tensor-core DFT product in
   tiles of 256 frames and slabs of 64 bins, the table through an mbarrier
   ring, the signal in phases by cp.async), the covariances, the fused
   solve (each with f32 and bf16 instances; the covariances' bf16 instances
   round each element once a tile) and the eigensolver.
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
   and a NaN matrix, each bit-identical to its plain version.  The bf16
   lane: the STFT kernel within 1e-4 of the output scale (max-abs) of its
   plain version at the same shapes and at the 16-clip batch, the
   covariances' bf16 instances (shared and per-channel masks, C = 4 and
   11, and the batch) within 1e-5 max-rel and bit-stable, the solve's bit
   for bit at step 1, step 2 and the batch of distinct clips.  Then the
   port's ``core.dsp`` STFT/ISTFT at 1024/512 and 512/128 (the rFFT route,
   no STFT kernel launched) and 512/256 (one ``csrc/stft.cu`` launch), on
   the card against the host within 1e-5.
3. The offline path — ``tango_clip_fused(y, s, n, solver='fused')`` —
   with every launch counter set to 0 before and read after (1 STFT, 2
   covariance, 2 fused-solve launches); the output is finite, within 1e-4
   of the output scale of the same clip run with the plain versions on
   the card, and improves SI-SDR at node 0 by more than 3 dB over the
   noisy reference mic.  The same in the bf16 lane for one clip and the
   16-clip batch (1 bf16 STFT, 2 + 2 bf16 covariance and solve launches),
   its SI-SDR also within 0.1 dB of the f32 lane's; ``tango`` on the
   clip's spectra under the 'compressed', 'use_oracle_refs' and
   'use_oracle_zs' policies and with a (K, K) ``z_mask`` and a NaN node,
   each finite and within 1e-4 of its plain-version run.
3d. The CRNN-masked offline path on the same clip: two canonical CRNNs
   (conv 32/64/64, GRU 256, FF 257) of seeded random weights, made as the
   JAX package's variable tree and loaded through ``nn.convert``, step 1
   on the reference mic (``n_ch = 1``) and step 2 on it and the other
   nodes' z_y (``n_ch = K``): ``stft_with_mag`` → ``estimate_masks`` →
   ``tango(solver='fused')`` with the counters set to 0 before and read
   after (1 STFT, 3 covariance, 2 fused-solve launches); the masks finite
   and in [0, 1]; the clip within 1e-4 of the output scale of the plain
   versions fed the same masks and the STFT kernel's spectra, with the
   covariances summed in the kernel's order and arithmetic (the untrained
   CRNNs' masks leave the pencils near-degenerate, and two plain
   formulations of the STFT or of the covariances already differ by more
   than 1e-4 there: ``exp/crnn_clip_witness.py``); the distance to the
   plain versions from the signal reported; the card's CRNN masks within
   1e-4 (max-abs) of the same modules' on the host on the same inputs; the
   stream route within 1e-5 of the per-window route; a second run of the
   masks within 1e-6 (bit-identity reported); ``_batched_masks`` on the
   16 distinct clips within 1e-5 of each clip's ``estimate_masks``.
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
   seconds.  The bf16 lane's nine windows (the bf16 STFT kernel): scan
   bit-identical to the per-block loop, windows 2-9 within 1e-4 rel-l2
   of the plain versions, the windows' SI-SDR gains within 0.1 dB of the
   f32 lane's.
5. CUDA-event times: the offline path on a 16-clip batch in both lanes, the streaming
   window's latency, and per kernel the kernel, its plain version and
   (where one exists) one PyTorch library call computing the same
   function, beside the bound from this run's shapes and the H100 SXM
   data-sheet peaks; the eigensolver both at the full-clip stream's
   batch and at the streaming window's (2056 matrices, C=4 and C=11), the
   covariances and the fused solve both at one clip's launches and at the
   16-clip batch's, in both lanes; beside each kernel's events (which
   include the wrapper's host time) its device time under the profiler.
   The bf16 STFT's bound counts its DFT product at the dense-bf16 peak;
   its library call is one cuBLAS bf16 GEMM (``torch.matmul``, bf16 out).
   Both STFT kernels are also timed at the 16-clip batch's rows (events and
   device time; the bf16 one beside its plain version and the GEMM).  The
   CRNN-masked path on the 16 distinct clips, by part (step-1 masks,
   step-1 z, step-2 masks, ``tango``), each the median of 5, the CRNNs'
   rates by the operations of their shapes.
6. Where one 16-clip offline call (in both lanes), the 16-clip CRNN mask
   stage and one streaming window spend their device time, by kernel
   (``torch.profiler``), and the device's busy share of their wall time.

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
PEAK_BF16 = 989e12       # H100 SXM, dense bf16 on the tensor cores (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth (data sheet)
TOL = {"stft": 1e-5, "stft_bf16": 1e-4, "masked_cov": 1e-5, "fused_mwf": 1e-5, "clip": 1e-4,
       "stream": 1e-4, "stream_sdr_db": 0.1, "sdr_gain_db": 3.0, "witness_db": 0.2,
       "bf16_lane": 1e-2, "crnn_host": 1e-4, "crnn_route": 1e-5, "crnn_batch": 1e-5,
       "crnn_rerun": 1e-6}
#: the seeds of the two canonical CRNNs' random weights (phase 3d)
CRNN_SEEDS = {"step1": 1, "step2": 2}
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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """(least time in ms, what bounds it) at the data-sheet peaks: the
    operations' (float32 outside the tensor cores unless ``peak`` says
    otherwise) and the memory's."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def stft_bf16_cost(rows: int, length: int, n_fft: int = 512, hop: int = 256):
    """(operations, bytes) of the bf16 lane's STFT as the DFT product it
    is: per frame the window, the (n_fft x 2 n_freq) product (2 operations
    a multiply-add) and the magnitude; the bytes of :func:`stft_cost`."""
    n_freq = n_fft // 2 + 1
    frames = rows * (1 + length // hop)
    flops = frames * (n_fft + 2 * n_fft * 2 * n_freq + 4 * n_freq)
    return flops, stft_cost(rows, length, n_fft, hop)[1]


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
    short = re.search(r"(stft_rfft_kernel|stft_bf16_kernel|masked_cov_kernelILb[01]ELb[01]E"
                      r"|(?:fused_mwf|eigh)_(?:thread|group)_kernelILi\d+E(?:Lb[01]E)?)", mangled)
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


def stft_bf16_plain(x, n_fft=512, hop=256, with_mag=False):
    """The bf16 STFT kernel's plain version, with its wrapper's arguments."""
    from disco_tpu_torch.ops import stft_ops

    return stft_ops.stft_matmul(x, n_fft, hop, with_mag, precision="bf16")


@contextmanager
def plain_kernels(stft: bool = True, cov_order: bool = False):
    """Swap each kernel wrapper for its plain version, so the same path
    runs the plain PyTorch versions on the card (the reference runs of
    phases 3 and 4), in either precision lane; ``stft=False`` keeps the STFT
    kernels, so that the plain versions downstream see the kernels'
    spectra; ``cov_order=True`` sums the covariances in the kernel's order
    and arithmetic in either lane (``cov_ops._masked_cov_sliced``)."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    def cov_sliced(y, mask, precision="f32"):
        return cov_ops._masked_cov_sliced(y, mask, precision)

    saved = (stft_ops.stft_kernel, stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel,
             mwf_ops.fused_mwf_kernel, eigh_ops.eigh_jacobi_kernel)
    if stft:
        stft_ops.stft_kernel = stft_ops.stft_matmul
        stft_ops.stft_bf16_kernel = stft_bf16_plain
    cov_ops.masked_cov_kernel = cov_sliced if cov_order else cov_ops.masked_covariances_plain
    mwf_ops.fused_mwf_kernel = mwf_ops.fused_mwf_plain
    eigh_ops.eigh_jacobi_kernel = eigh_ops.eigh_jacobi_unsorted
    try:
        yield
    finally:
        (stft_ops.stft_kernel, stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel,
         mwf_ops.fused_mwf_kernel, eigh_ops.eigh_jacobi_kernel) = saved


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

    def record_cov(y, mask, precision="f32"):
        seen["masked_cov"].append((y, mask))
        return cov(y, mask, precision)

    def record_mwf(Rss, Rnn, mu=1.0, sweeps=None, precision="f32"):
        seen["fused_mwf"].append((Rss, Rnn, mu))
        return mwf(Rss, Rnn, mu, sweeps, precision)

    # a wrapper adds to the counter of the function its module name holds:
    # while recording, the recorder's, so recorded launches count nowhere
    record_cov.launches = record_mwf.launches = 0
    record_cov.launches_bf16 = record_mwf.launches_bf16 = 0
    cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = record_cov, record_mwf
    try:
        yield seen
    finally:
        cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = cov, mwf


def kernel_counters() -> dict:
    """kernel name -> (the wrapper, the attribute that counts its launches):
    the bf16 instances of the covariance and solve kernels count apart."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    return {"stft": (stft_ops.stft_kernel, "launches"),
            "stft_bf16": (stft_ops.stft_bf16_kernel, "launches"),
            "masked_cov": (cov_ops.masked_cov_kernel, "launches"),
            "masked_cov_bf16": (cov_ops.masked_cov_kernel, "launches_bf16"),
            "fused_mwf": (mwf_ops.fused_mwf_kernel, "launches"),
            "fused_mwf_bf16": (mwf_ops.fused_mwf_kernel, "launches_bf16"),
            "eigh_jacobi": (eigh_ops.eigh_jacobi_kernel, "launches")}


@contextmanager
def counted(label: str, expected: dict, out: dict):
    """Set every launch counter to 0, run the body, read the counters into
    ``out[label]`` and require ``expected`` (a kernel it does not name: 0)."""
    counters = kernel_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    yield
    import torch

    torch.cuda.synchronize()
    out[label] = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    print(f"launches, {label}: {out[label]}", flush=True)
    want = {name: expected.get(name, 0) for name in counters}
    require(out[label] == want, (label, out[label], want))


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
    d.Y, d.S, d.N = spec_p[0], spec_p[1], spec_p[2]              # (K, C, F, T)
    d.m = tf_mask_mag(mag_p[1][:, 0], mag_p[2][:, 0], "irm1")    # (K, F, T)
    del spec_k, mag_k, spec_p, mag_p

    # the bf16 lane's STFT: the same shapes and the 16-clip batch's rows
    d.err["stft_bf16"] = 0.0
    for label, x in (("window", d.x[..., :LW]), ("short", d.x[..., :300]), ("clip", d.x),
                     ("batch", torch.stack(distinct_clips(d)))):
        spec_k, mag_k = stft_ops.stft_bf16_kernel(x, with_mag=True)
        spec_p, mag_p = stft_ops.stft_matmul(x, with_mag=True, precision="bf16")
        torch.cuda.synchronize()
        e = max(max_abs(spec_k, spec_p) / float(spec_p.abs().max()),
                max_abs(mag_k, mag_p) / float(mag_p.abs().max()))
        d.err["stft_bf16"] = max(d.err["stft_bf16"], max(max_abs(spec_k, spec_p),
                                                         max_abs(mag_k, mag_p)))
        print(f"phase 2: stft_bf16 {label} {tuple(x.shape)} max-abs {e:.3e} of the output "
              f"scale", flush=True)
        require(e <= TOL["stft_bf16"], ("stft_bf16", label, e))
        del spec_k, mag_k, spec_p, mag_p

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

    # the bf16 instances: shared and per-channel masks at C = 4 and 11 (the
    # per-mic step-1 masks stand in for a per-channel C = 4 stack)
    mic_m = tf_mask_mag(d.S.abs(), d.N.abs(), "irm1")            # (K, C, F, T)
    d.pencils_bf16 = {}
    d.err["masked_cov_bf16"] = d.err["fused_mwf_bf16"] = 0.0
    for label, yy, mm in (("step1", d.Y, d.m), ("step1-chan", d.Y, mic_m),
                          ("step2", d.in_y, d.m), ("step2-chan", d.in_y, chan_m)):
        d.pencils_bf16[label] = check_cov(d, label, yy, mm, "bf16")
    for label in ("step1", "step2"):
        check_mwf(d, label, *d.pencils_bf16[label], precision="bf16")

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
    with recorded_kernel_inputs() as seen:
        tango_clip_fused(*distinct_clips(d), solver="fused", precision="bf16")
    require(len(seen["masked_cov"]) == 2 and len(seen["fused_mwf"]) == 2,
            ("bf16 kernel launches of one batched offline call",
             {k: len(v) for k, v in seen.items()}))
    d.batch_bf16 = seen
    for label, (yy, mm) in zip(("batch step1", "batch step2"), seen["masked_cov"]):
        check_cov(d, label, yy, mm, "bf16")
    for label, (Rss, Rnn, mu) in zip(("batch step1", "batch step2"), seen["fused_mwf"]):
        check_mwf(d, label, Rss, Rnn, mu, "bf16")
    phase2_eigh(d)
    return d


def _lane(name: str, precision: str) -> str:
    """The kernel's name in the precision lane (the bf16 instances' rows)."""
    return name + ("_bf16" if precision == "bf16" else "")


def check_cov(d: SimpleNamespace, label: str, yy, mm, precision: str = "f32"):
    """The covariance kernel of a precision lane against its plain version
    (bit for bit in the bf16 lane, whose plain version sums in the
    kernel's order), and against its own second run bit for bit; returns
    the plain version's pair."""
    import torch

    from disco_tpu_torch.ops import cov_ops

    name = _lane("masked_cov", precision)
    ks = cov_ops.masked_cov_kernel(yy, mm, precision)
    again = cov_ops.masked_cov_kernel(yy, mm, precision)
    ps = cov_ops.masked_covariances_plain(yy, mm, precision)
    torch.cuda.synchronize()
    r = max(max_rel(ks[0], ps[0]), max_rel(ks[1], ps[1]))
    e = max(max_abs(ks[0], ps[0]), max_abs(ks[1], ps[1]))
    stable = all(torch.equal(a, b) for a, b in zip(ks, again))
    bitwise = all(torch.equal(a, b) for a, b in zip(ks, ps))
    d.err[name] = max(d.err[name], e)
    print(f"phase 2: {name} {label} {tuple(yy.shape)} mask {tuple(mm.shape)} max-rel {r:.3e} "
          f"max-abs {e:.3e} bit-stable run to run {stable} bit-identical {bitwise}", flush=True)
    require(r <= TOL["masked_cov"] and stable, (name, label, r, stable))
    require(bitwise or precision == "f32", (name, label, "bit-identical", bitwise))
    return ps


def check_mwf(d: SimpleNamespace, label: str, Rss, Rnn, mu=1.0, precision: str = "f32") -> None:
    """The fused-solve kernel of a precision lane against its plain version;
    whether the two agree bit for bit is reported, and required in the
    bf16 lane."""
    import torch

    from disco_tpu_torch.ops import mwf_ops

    name = _lane("fused_mwf", precision)
    wk, tk = mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu, precision=precision)
    wp, tp = mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu, precision=precision)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(wk).all() and torch.isfinite(wp).all())
    r = max(rel_l2(wk, wp), rel_l2(tk, tp))
    e = max(max_abs(wk, wp), max_abs(tk, tp))
    bitwise = bool(torch.equal(wk, wp) and torch.equal(tk, tp))
    d.err[name] = max(d.err[name], e)
    print(f"phase 2: {name} {label} {tuple(Rss.shape)} rel-l2 {r:.3e} max-abs {e:.3e} "
          f"finite {finite} bit-identical {bitwise}", flush=True)
    require(finite and r <= TOL["fused_mwf"], (name, label, r))
    require(bitwise or precision == "f32", (name, label, "bit-identical", bitwise))


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


def phase2_sizes(d: SimpleNamespace) -> None:
    """The port's STFT and ISTFT (``core.dsp``) at sizes the kernels do not
    compute, on the card against the same on the host: 1024/512 and 512/128
    take the rFFT route and launch no STFT kernel; 512/256 launches
    ``csrc/stft.cu`` once.  Rows of the clip stack, 1e-5 rel-l2 (the STFT)
    and 1e-5 of the output scale (the ISTFT, and its reconstruction of the
    signal)."""
    import torch

    from disco_tpu_torch.core import dsp
    from disco_tpu_torch.ops import stft_ops

    x = d.x.reshape(-1, d.L)[:8, :48000].contiguous()
    for n_fft, hop, launches in ((1024, 512, 0), (512, 128, 0), (512, 256, 1)):
        before = stft_ops.stft_kernel.launches, stft_ops.stft_bf16_kernel.launches
        spec = dsp.stft(x, n_fft, hop)
        y = dsp.istft(spec, x.shape[-1], n_fft, hop)
        torch.cuda.synchronize()
        got = (stft_ops.stft_kernel.launches - before[0],
               stft_ops.stft_bf16_kernel.launches - before[1])
        host = dsp.stft(x.cpu(), n_fft, hop)
        y_host = dsp.istft(host, x.shape[-1], n_fft, hop)
        e_spec = rel_l2(spec.cpu(), host)
        e_y, e_rec = max_rel(y.cpu(), y_host), max_rel(y.cpu(), x.cpu())
        print(f"phase 2: core.dsp stft/istft {n_fft}/{hop} on {tuple(x.shape)}: STFT kernel "
              f"launches {got}, card vs host STFT rel-l2 {e_spec:.3e}, ISTFT {e_y:.3e} of the "
              f"output scale, reconstruction {e_rec:.3e}", flush=True)
        require(got == (launches, 0), ("stft route", n_fft, hop, got))
        require(max(e_spec, e_y, e_rec) <= TOL["stft"], ("stft sizes", n_fft, hop, e_spec, e_y,
                                                         e_rec))


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
    d.sdr_f32 = sdr_out
    phase3_bf16_clip(d)
    phase3_policies_and_faults(d)


def phase3_bf16_clip(d: SimpleNamespace) -> None:
    """The offline path in the bf16 lane: one clip and the 16-clip batch,
    with the launch counters, against the bf16 plain-version clip; SI-SDR
    at node 0 within 0.1 dB of the f32 lane's and +3 dB over the input.

    The lane rounds to bf16 after the STFT (the covariances' spectra) and
    after the covariances (the solve's pencils).  Where the kernels and the
    plain versions sum in other orders before such a point, a value near a
    rounding boundary lands one bf16 step (2^-8) apart, and an
    ill-conditioned bin's filter moves with it.  The covariance and solve
    kernels are bit for bit their plain versions in this lane, and the STFT
    kernel is held to its plain version in phase 2; so the clip is held
    within 1e-4 of the plain versions fed the STFT kernel's spectra, and
    against the plain versions from the signal (the STFT's order too)
    within the lane's 1e-2 rel-l2 and 0.1 dB of SI-SDR.

    Against the f32 lane: the lane of the STFT and the covariances (the
    bf16 kernels, ``solver='eigh'``, whose solve stays float32) within the
    JAX package's 0.1 dB gate (``tests/test_tango.py``); the whole lane's
    SI-SDR cost with the fused solve, whose pencils are rounded to bf16
    too, is printed: at the north-star scene's 11-channel step 2 it
    exceeds 0.1 dB in the plain versions as in the kernels, and in the
    JAX package's lane too (``exp/bf16_sdr_cost.py``, PERF.md)."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused

    with counted("offline clip bf16", {"stft_bf16": 1, "masked_cov_bf16": 2,
                                       "fused_mwf_bf16": 2}, d.launches):
        out = tango_clip_fused(d.y, d.s, d.n, solver="fused", precision="bf16")
    require(out.shape == (K, d.L) and bool(torch.isfinite(out).all()),
            "non-finite or misshapen bf16 output")
    yb, sb, nb = batch_clips(d)
    with counted("offline batch bf16", {"stft_bf16": 1, "masked_cov_bf16": 2,
                                        "fused_mwf_bf16": 2}, d.launches):
        batch = tango_clip_fused(yb, sb, nb, solver="fused", precision="bf16")
    del yb, sb, nb
    with plain_kernels(stft=False):
        fed = tango_clip_fused(d.y, d.s, d.n, solver="fused", precision="bf16")
    with plain_kernels():
        ref = tango_clip_fused(d.y, d.s, d.n, solver="fused", precision="bf16")
    torch.cuda.synchronize()
    clip_err = max_rel(out, fed)
    batch_err = max(max_rel(batch[b], fed) for b in range(BATCH))
    full_err, full_l2 = max_rel(out, ref), rel_l2(out, ref)
    sdr_in = si_sdr(d.s_np[0, 0], d.y_np[0, 0])
    sdr_out = si_sdr(d.s_np[0, 0], out[0].cpu().numpy())
    sdr_ref = si_sdr(d.s_np[0, 0], ref[0].cpu().numpy())
    print(f"phase 3: bf16 clip vs the bf16 plain versions fed the STFT kernel's spectra "
          f"{clip_err:.3e} (bit-identical {bool(torch.equal(out, fed))}), every clip of the "
          f"{BATCH}-clip batch {batch_err:.3e} of output scale; vs the bf16 plain versions from "
          f"the signal {full_err:.3e} of output scale, rel-l2 {full_l2:.3e}, SI-SDR node 0 "
          f"{sdr_ref:.4f}; SI-SDR node 0 {sdr_in:.4f} -> {sdr_out:.4f} dB (f32 lane "
          f"{d.sdr_f32:.4f}, difference {sdr_out - d.sdr_f32:+.4f})", flush=True)
    require(clip_err <= TOL["clip"] and batch_err <= TOL["clip"], ("bf16 clip", clip_err,
                                                                    batch_err))
    require(full_l2 <= TOL["bf16_lane"] and abs(sdr_out - sdr_ref) <= TOL["stream_sdr_db"],
            ("bf16 clip vs the plain versions from the signal", full_l2, sdr_out, sdr_ref))
    require(sdr_out - sdr_in > TOL["sdr_gain_db"], ("bf16 sdr gain", sdr_out - sdr_in))
    with counted("offline clip bf16, solver='eigh'", {"stft_bf16": 1, "masked_cov_bf16": 2},
                 d.launches):
        cov_lane = tango_clip_fused(d.y, d.s, d.n, solver="eigh", precision="bf16")
    f32_eigh = tango_clip_fused(d.y, d.s, d.n, solver="eigh")
    sdr_cov = si_sdr(d.s_np[0, 0], cov_lane[0].cpu().numpy())
    sdr_f32_eigh = si_sdr(d.s_np[0, 0], f32_eigh[0].cpu().numpy())
    print(f"phase 3: SI-SDR node 0 against the f32 lane: the STFT and covariance lane "
          f"(solver='eigh') {sdr_cov:.4f} vs {sdr_f32_eigh:.4f} dB (difference "
          f"{sdr_cov - sdr_f32_eigh:+.4f}); the whole lane with the fused solve {sdr_out:.4f} vs "
          f"{d.sdr_f32:.4f} dB (difference {sdr_out - d.sdr_f32:+.4f})", flush=True)
    require(abs(sdr_cov - sdr_f32_eigh) <= TOL["stream_sdr_db"],
            ("bf16 covariance lane vs f32 SI-SDR", sdr_cov, sdr_f32_eigh))


def phase3_policies_and_faults(d: SimpleNamespace) -> None:
    """``tango`` on the clip's spectra under the three policies that
    substitute other signals for z, and with a (K, K) link mask and a NaN
    node, each against its plain-version run."""
    import torch

    from disco_tpu_torch.enhance.tango import tango

    zm = np.ones((K, K), np.float32)
    zm[0, 1] = zm[3, 5] = zm[7, 0] = 0.0        # three dead links
    z_nan = np.zeros(K)
    z_nan[6] = 1                                 # node 6's streams corrupted
    cases = [(p, dict(policy=p), {"masked_cov": 1, "fused_mwf": 2})
             for p in ("compressed", "use_oracle_refs", "use_oracle_zs")]
    cases.append(("local, (K, K) z_mask and a NaN node", dict(z_mask=zm, z_nan=z_nan),
                  {"masked_cov": 2, "fused_mwf": 2}))
    for label, kw, launches in cases:
        with counted(f"tango {label}", launches, d.launches):
            res = tango(d.Y, d.S, d.N, d.m, d.m, solver="fused", **kw)
        with plain_kernels():
            ref = tango(d.Y, d.S, d.N, d.m, d.m, solver="fused", **kw)
        torch.cuda.synchronize()
        err = max(max_rel(getattr(res, f), getattr(ref, f)) for f in ("yf", "sf", "nf"))
        finite = bool(torch.isfinite(res.yf).all())
        print(f"phase 3: tango {label}: vs its plain-version run {err:.3e} of output scale, "
              f"finite {finite}", flush=True)
        require(finite and err <= TOL["clip"], ("tango", label, err, finite))


def seeded_crnn_variables(n_ch: int, seed: int) -> dict:
    """The variable tree of the JAX package's canonical CRNN
    (``CRNN(input_shape=(n_ch, 21, 257))``: ``params``/``batch_stats`` of
    ``CNN2d_0`` (three Conv/BatchNorm pairs), ``RNN_0/GRUCell_0`` and
    ``FF_0/Dense_0``) drawn from a seeded numpy generator: kernels at the
    scale of flax's default initializer (variance 1/fan_in), biases and
    BatchNorm shifts and means N(0, 0.1), scales 1 + N(0, 0.1), variances in
    [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def kernel(*shape):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def small(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    cnn, stats = {}, {}
    chans = (n_ch, 32, 64, 64)
    for i in range(3):
        c = chans[i + 1]
        cnn[f"Conv_{i}"] = {"kernel": kernel(3, 3, chans[i], c), "bias": small(c)}
        cnn[f"BatchNorm_{i}"] = {"scale": small(c, 1.0), "bias": small(c)}
        stats[f"BatchNorm_{i}"] = {"mean": small(c),
                                   "var": (0.5 + rng.random(c)).astype(np.float32)}
    gru = {g: {"kernel": kernel(256, 256), "bias": small(256)} for g in ("ir", "iz", "in", "hn")}
    gru.update({g: {"kernel": kernel(256, 256)} for g in ("hr", "hz")})
    return {"params": {"CNN2d_0": cnn, "RNN_0": {"GRUCell_0": gru},
                       "FF_0": {"Dense_0": {"kernel": kernel(256, 257), "bias": small(257)}}},
            "batch_stats": {"CNN2d_0": stats}}


def canonical_crnn(n_ch: int, seed: int, device):
    """The port's canonical CRNN holding :func:`seeded_crnn_variables`,
    loaded through ``nn.convert``, on ``device``."""
    from disco_tpu_torch.nn.convert import state_dict_from_flax
    from disco_tpu_torch.nn.crnn import build_crnn

    model = build_crnn(n_ch=n_ch)
    model.load_state_dict(state_dict_from_flax(seeded_crnn_variables(n_ch, seed), model))
    return model.to(device).eval()


def phase3d_crnn_masked_clip(d: SimpleNamespace) -> None:
    """The CRNN-masked offline path on the north-star clip, with two
    canonical CRNNs of seeded random weights (step 1 on the reference mic,
    ``n_ch = 1``; step 2 on it and the other nodes' z_y, ``n_ch = K``):
    ``stft_with_mag`` of the [y, s, n] stack → ``estimate_masks`` →
    ``tango(solver='fused')`` → ISTFT."""
    import torch

    from unittest import mock

    from disco_tpu_torch.core.dsp import istft, stft
    from disco_tpu_torch.enhance import inference
    from disco_tpu_torch.enhance.driver import _batched_masks, _z_for_mask_device, estimate_masks
    from disco_tpu_torch.enhance.tango import tango
    from disco_tpu_torch.enhance.zexport import compute_z_signals
    from disco_tpu_torch.ops.stft_ops import stft_with_mag

    t0 = time.perf_counter()
    d.crnn = [canonical_crnn(1, CRNN_SEEDS["step1"], d.dev),
              canonical_crnn(K, CRNN_SEEDS["step2"], d.dev)]
    with counted("crnn-masked clip", {"stft": 1, "masked_cov": 3, "fused_mwf": 2}, d.launches):
        spec, mag = stft_with_mag(d.x)
        Y = spec[0]
        masks_z, mask_w = estimate_masks(Y, spec[1], spec[2], d.crnn, "irm1", K, z_sigs="zs_hat",
                                         mags=(mag[1], mag[2]))
        out = istft(tango(Y, spec[1], spec[2], masks_z, mask_w, solver="fused").yf, d.L)
    masks = torch.stack([masks_z, mask_w])
    in_range = bool(torch.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1)
    print(f"phase 3d: masks finite and in [0, 1]: {in_range}; step-1 mean {float(masks_z.mean())} "
          f"std {float(masks_z.std())}, step-2 mean {float(mask_w.mean())} std "
          f"{float(mask_w.std())}", flush=True)
    require(in_range and out.shape == (K, d.L) and bool(torch.isfinite(out).all()),
            "crnn-masked clip: masks out of [0, 1] or a non-finite clip")

    # The same clip through the plain versions, fed the same masks and the
    # STFT kernel's spectra (the STFT kernel is held to its plain version in
    # phase 2), the covariances summed in the kernel's order and arithmetic
    # (``_masked_cov_sliced``): the untrained CRNNs' masks (~0.5 +- 0.17)
    # leave the GEVD pencils near-degenerate, and two plain formulations of
    # the STFT or of the covariances move this clip by more than 1e-4 of its
    # scale (exp/crnn_clip_witness.py).  The distance to the plain versions
    # from the signal is reported.
    with plain_kernels(stft=False, cov_order=True):
        ref = istft(tango(Y, spec[1], spec[2], masks_z, mask_w, solver="fused").yf, d.L)
    with plain_kernels():
        spec_p, _ = stft_with_mag(d.x)
        ref_p = istft(tango(spec_p[0], spec_p[1], spec_p[2], masks_z, mask_w, solver="fused").yf,
                      d.L)
    clip_err, full_err = max_rel(out, ref), max_rel(out, ref_p)
    print(f"phase 3d: CRNN-masked clip vs the plain versions fed the same masks and the STFT "
          f"kernel's spectra, the covariances in the kernel's order: {clip_err:.3e} of output "
          f"scale (bit-identical {bool(torch.equal(out, ref))}); vs the plain versions from the "
          f"signal {full_err:.3e}; SI-SDR node 0 {si_sdr(d.s_np[0, 0], d.y_np[0, 0]):.2f} -> "
          f"{si_sdr(d.s_np[0, 0], out[0].cpu().numpy()):.2f} dB", flush=True)
    require(clip_err <= TOL["clip"], ("crnn-masked clip", clip_err))
    del ref, ref_p, spec_p

    # the card's CRNNs against the same modules on the host, on the same inputs
    zs = _z_for_mask_device(*(compute_z_signals(None, None, None, Y=Y, masks_z=masks_z)[k]
                              for k in ("z_y", "zn")), K, "zs_hat")
    host = [canonical_crnn(1, CRNN_SEEDS["step1"], "cpu"),
            canonical_crnn(K, CRNN_SEEDS["step2"], "cpu")]
    card_w = inference.crnn_masks_batched(Y[:, 0], d.crnn[1], zs=zs)
    host_z = inference.crnn_masks_batched(Y[:, 0].cpu(), host[0], device="cpu")
    host_w = inference.crnn_masks_batched(Y[:, 0].cpu(), host[1], zs=zs.cpu(), device="cpu")
    host_err = max(max_abs(masks_z.cpu(), host_z), max_abs(card_w.cpu(), host_w))
    print(f"phase 3d: card CRNN masks vs the host's on the same spectra and weights: max-abs "
          f"{host_err:.3e} (step 2 recomputed from the same z: {max_abs(card_w, mask_w):.3e} from "
          f"the path's)", flush=True)
    require(host_err <= TOL["crnn_host"], ("crnn card vs host", host_err))

    # the stream route (convs hoisted) against the per-window route, on the card
    with mock.patch.object(inference, "_conv_stream_safe", lambda model: False):
        window_w = inference.crnn_masks_batched(Y[:, 0], d.crnn[1], zs=zs)
    route_err = max_abs(card_w, window_w)
    print(f"phase 3d: stream route vs per-window route (step 2, {K} streams): max-abs "
          f"{route_err:.3e}", flush=True)
    require(route_err <= TOL["crnn_route"], ("crnn routes", route_err))
    del window_w

    # a second card run of the mask stage
    again = estimate_masks(Y, None, None, d.crnn, "irm1", K, z_sigs="zs_hat")
    identical = all(torch.equal(a, b) for a, b in zip(again, (masks_z, mask_w)))
    rerun_err = max(max_abs(a, b) for a, b in zip(again, (masks_z, mask_w)))
    print(f"phase 3d: second card run of the masks: bit-identical {identical}, max-abs "
          f"{rerun_err:.3e}", flush=True)
    require(rerun_err <= TOL["crnn_rerun"], ("crnn rerun", rerun_err))

    # the 16 distinct clips as one batch against each clip alone
    d.crnn_batch = tuple(stft(a) for a in distinct_clips(d))           # (B, K, C, F, T) each
    Mz, Mw = _batched_masks(*d.crnn_batch, d.crnn, "irm1", 1.0, K, "zs_hat")
    batch_err = 0.0
    for b in range(BATCH):
        mz, mw = estimate_masks(d.crnn_batch[0][b], None, None, d.crnn, "irm1", K)
        batch_err = max(batch_err, max_abs(Mz[b], mz), max_abs(Mw[b], mw))
    print(f"phase 3d: _batched_masks on {BATCH} distinct clips vs each clip's estimate_masks: "
          f"max-abs {batch_err:.3e}; phase 3d took {time.perf_counter() - t0:.1f} s", flush=True)
    require(batch_err <= TOL["crnn_batch"], ("crnn batch vs clips", batch_err))


def stream_windows(d: SimpleNamespace, first: int, last: int, state, precision: str = "f32"):
    """Windows ``first`` .. ``last - 1`` of the clip through
    ``streaming_clip_fused`` from ``state``; returns (the (K, n * LW)
    output, the state after each window)."""
    import torch

    from disco_tpu_torch.enhance.fused import streaming_clip_fused

    outs, states = [], []
    for w in range(first, last):
        sl = slice(w * LW, (w + 1) * LW)
        o = streaming_clip_fused(d.y[..., sl], d.s[..., sl], d.n[..., sl], state=state,
                                 solver="jacobi-pallas", blocks_per_dispatch=BLOCKS_PER_DISPATCH,
                                 precision=precision)
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
    from disco_tpu_torch.enhance.streaming import streaming_tango
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

    check_scan_vs_per_block(d, "f32")

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
    phase4_bf16_windows(d, gains["windows"])


def check_scan_vs_per_block(d: SimpleNamespace, precision: str) -> None:
    """Scanned super ticks == the per-block loop, bit for bit, on the card,
    in a precision lane."""
    import torch

    from disco_tpu_torch.enhance.stream_check import per_block_reference
    from disco_tpu_torch.enhance.streaming import (
        initial_stream_state,
        state_leaves,
        streaming_tango_scan,
    )

    Ys, ms = d.Y[..., :64], d.m[..., :64]
    F = d.Y.shape[-2]
    ref, ref_state = per_block_reference(Ys, ms, block=8, update_every=4,
                                         state=initial_stream_state(K, C, F),
                                         solver="jacobi-pallas", precision=precision)
    st, parts = initial_stream_state(K, C, F), []
    for w in range(2):
        sl = slice(32 * w, 32 * (w + 1))
        o = streaming_tango_scan(Ys[..., sl], ms[..., sl], ms[..., sl], state=st,
                                 z_avail=torch.ones((K, 8)), blocks_per_dispatch=4,
                                 solver="jacobi-pallas", precision=precision)
        st = o["state"]
        parts.append(o["yf"])
    same_out = bool(torch.equal(torch.cat(parts, dim=-1), ref))
    same_state = all(torch.equal(a, b) for a, b in zip(state_leaves(st), state_leaves(ref_state)))
    print(f"phase 4: {precision} streaming_tango_scan vs per_block_reference, 64 frames in super "
          f"ticks of 4 blocks: output bit-identical {same_out}, state bit-identical {same_state}",
          flush=True)
    require(same_out and same_state, (precision, "scan vs per-block bit-exactness"))


def phase4_bf16_windows(d: SimpleNamespace, f32_gains: dict) -> None:
    """The streaming windows in the bf16 lane (the bf16 STFT kernel, the
    bf16 tail accumulation, the eigensolver): scan against the per-block
    loop bit for bit, windows 2-9 against the plain versions from the state
    after window 1 (within 1e-4 fed the STFT kernel's spectra, within the
    lane's 1e-2 from the signal: see :func:`phase3_bf16_clip`), and the
    windows' SI-SDR gains within 0.1 dB of the f32 lane's."""
    import torch

    per_window = 2 * (1 + LW // 256) // 4
    with counted("streaming windows bf16", {"stft_bf16": N_WINDOWS,
                                            "eigh_jacobi": N_WINDOWS * per_window}, d.launches):
        yw, states = stream_windows(d, 0, N_WINDOWS, None, "bf16")
    Lc = N_WINDOWS * LW
    require(yw.shape == (K, Lc) and bool(torch.isfinite(yw).all()),
            "non-finite or misshapen bf16 streaming output")
    check_scan_vs_per_block(d, "bf16")
    with plain_kernels(stft=False):
        yp, _ = stream_windows(d, 1, N_WINDOWS, states[0], "bf16")
    with plain_kernels():
        yq, _ = stream_windows(d, 1, N_WINDOWS, states[0], "bf16")
    torch.cuda.synchronize()
    err, err_full = rel_l2(yw[:, LW:], yp), rel_l2(yw[:, LW:], yq)
    gains = sdr_gains(d.s_np[0, 0], d.y_np[0, 0], yw[0].cpu().numpy())
    print(f"phase 4: bf16 windows 2-{N_WINDOWS} from the state after window 1, kernels vs plain "
          f"versions: fed the STFT kernel's spectra rel-l2 {err:.3e}, from the signal "
          f"{err_full:.3e}; SI-SDR gain at node 0 after t seconds "
          + json.dumps(gains) + " (f32 lane " + json.dumps(f32_gains) + ")", flush=True)
    require(err <= TOL["stream"], ("bf16 stream vs plain", err))
    require(err_full <= TOL["bf16_lane"], ("bf16 stream vs plain from the signal", err_full))
    require(all(abs(gains[t] - g) <= TOL["stream_sdr_db"] for t, g in f32_gains.items()),
            ("bf16 windows vs f32 windows", gains, f32_gains))


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
    audio_s = BATCH * K * DUR_S
    for precision in ("f32", "bf16"):
        def path():
            return tango_clip_fused(yb, sb, nb, solver="fused", precision=precision)

        path()  # warm-up
        runs = sorted(time_ms(path, reps=1, warmup=0) for _ in range(5))
        path_ms = runs[2]
        print(f"phase 5: offline path, {precision} lane, {BATCH} clips {path_ms} ms (median of "
              f"{runs}) = {audio_s / (path_ms / 1e3)} enhanced audio-s per s", flush=True)
    del yb, sb, nb
    phase5_crnn_mask_stage(d)

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
        "device_ms": device_ms(lambda: stft_ops.stft_kernel(d.x, with_mag=True),
                               "stft_rfft_kernel"),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(d.x, with_mag=True), reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.stft(rows, 512, 256, window=win, center=True,
                                                 pad_mode="reflect", return_complex=True), reps=20),
    })
    # the bf16 lane's tensor-core DFT; its library call is one cuBLAS GEMM,
    # torch.matmul of the bf16 windowed frames and the bf16 [cos | sin]
    # table, whose output is bf16
    fl, nbytes = stft_bf16_cost(rows.shape[0], d.L)
    b_ms, b_by = bound(fl, nbytes, PEAK_BF16)
    frames = torch.nn.functional.pad(rows, (256, 256), mode="reflect").unfold(-1, 512, 256)
    frames16 = (frames * win).to(torch.bfloat16)
    table16 = torch.cat([torch.from_numpy(t) for t in stft_ops.dft_matrices(512)],
                        dim=1).to(device=d.dev, dtype=torch.bfloat16)
    entries.append({
        "name": "stft_bf16", "route": "cuda", "source": "disco_tpu_torch/csrc/stft_bf16.cu",
        "replaces": "disco_tpu/ops/stft_ops.py:183", **_launches(d, "stft_bf16"),
        "max_abs_err": d.err["stft_bf16"],
        "ms": time_ms(lambda: stft_ops.stft_bf16_kernel(d.x, with_mag=True), reps=20),
        "device_ms": device_ms(lambda: stft_ops.stft_bf16_kernel(d.x, with_mag=True),
                               "stft_bf16_kernel"),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(d.x, with_mag=True, precision="bf16"),
                            reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.matmul(frames16, table16), reps=20),
        "library_call": "torch.matmul(bf16 (96, 626, 512), bf16 (512, 514)) -> bf16 (cuBLAS)",
    })
    del frames, frames16, table16
    # both STFT kernels at the 16-clip batch's rows (the clip stack BATCH
    # times): events and device time, the bound of those rows, and for the
    # bf16 lane its plain version and the cuBLAS bf16 GEMM on the same rows
    xb = d.x[None].expand(BATCH, *d.x.shape).contiguous()
    rows_b = xb.reshape(-1, d.L)
    fl, nbytes = stft_cost(rows_b.shape[0], d.L)
    entries[0]["batch_launches"] = [{
        "shape": f"batch {tuple(xb.shape)}",
        "ms": time_ms(lambda: stft_ops.stft_kernel(xb, with_mag=True), reps=10),
        "device_ms": device_ms(lambda: stft_ops.stft_kernel(xb, with_mag=True),
                               "stft_rfft_kernel", reps=5),
        "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
    }]
    fl, nbytes = stft_bf16_cost(rows_b.shape[0], d.L)
    frames16 = (torch.nn.functional.pad(rows_b, (256, 256), mode="reflect").unfold(-1, 512, 256)
                * win).to(torch.bfloat16)
    table16 = torch.cat([torch.from_numpy(t) for t in stft_ops.dft_matrices(512)],
                        dim=1).to(device=d.dev, dtype=torch.bfloat16)
    entries[1]["batch_launches"] = [{
        "shape": f"batch {tuple(xb.shape)}",
        "ms": time_ms(lambda: stft_ops.stft_bf16_kernel(xb, with_mag=True), reps=10),
        "device_ms": device_ms(lambda: stft_ops.stft_bf16_kernel(xb, with_mag=True),
                               "stft_bf16_kernel", reps=5),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(xb, with_mag=True, precision="bf16"),
                            reps=3, warmup=1),
        "library_ms": time_ms(lambda: torch.matmul(frames16, table16), reps=10),
        "library_call": f"torch.matmul(bf16 {tuple(frames16.shape)}, bf16 (512, 514)) -> bf16 "
                        "(cuBLAS)",
        "bound_ms": bound(fl, nbytes, PEAK_BF16)[0], "flops": fl, "bytes": nbytes,
    }]
    for e in entries[:2]:
        print(f"phase 5: {e['name']}: " + json.dumps(e["batch_launches"][0]), flush=True)
    del xb, rows_b, frames16, table16

    def cov_times(label, yy, mm, plain_reps, precision):
        lead, (D, F, T) = yy.shape[:-3], yy.shape[-3:]
        chan = mm.ndim == yy.ndim
        fl, nbytes = cov_cost(math.prod(lead), D, F, T, chan)
        lib = (library_cov(yy, mm) if precision == "f32" else
               lambda: cov_ops.masked_covariances_folded(yy, mm, precision="bf16"))
        return {
            "shape": f"{label} {tuple(yy.shape)}",
            "ms": time_ms(lambda: cov_ops.masked_cov_kernel(yy, mm, precision), reps=50),
            "device_ms": device_ms(lambda: cov_ops.masked_cov_kernel(yy, mm, precision),
                                   "masked_cov_kernel"),
            "plain_ms": time_ms(lambda: cov_ops.masked_covariances_plain(yy, mm, precision),
                                reps=plain_reps),
            "library_ms": time_ms(lib, reps=plain_reps),
            "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    def mwf_times(label, Rss, Rnn, mu, plain_reps, precision):
        D = Rss.shape[-1]
        fl, nbytes = mwf_cost(Rss[..., 0, 0].numel(), D, default_sweeps(D))
        return {
            "shape": f"{label} {tuple(Rss.shape)}",
            "ms": time_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu, precision=precision),
                          reps=20),
            "device_ms": device_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu,
                                                                    precision=precision),
                                   "fused_mwf"),
            "plain_ms": time_ms(lambda: mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu,
                                                                precision=precision),
                                reps=plain_reps, warmup=1),
            "library_ms": None, "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    # covariances and fused solve, each lane: the step-1 (C=4) and step-2
    # (D=11) launches of one clip; beside them, those of the 16-clip batch
    for precision, pencils, batch in (("f32", d.pencils, d.batch),
                                      ("bf16", d.pencils_bf16, d.batch_bf16)):
        per = [cov_times(label, yy, d.m, 20, precision)
               for label, yy in (("step1", d.Y), ("step2", d.in_y))]
        entries.append(_summed(d, _lane("masked_cov", precision), "disco_tpu_torch/csrc/cov.cu",
                               "disco_tpu/ops/cov_ops.py:233", per))
        entries[-1]["batch_launches"] = [cov_times(f"batch {label}", yy, mm, 5, precision)
                                         for label, (yy, mm)
                                         in zip(("step1", "step2"), batch["masked_cov"])]
        per = [mwf_times(label, *pencils[label], 1.0, 2, precision)
               for label in ("step1", "step2")]
        entries.append(_summed(d, _lane("fused_mwf", precision), "disco_tpu_torch/csrc/mwf.cu",
                               "disco_tpu/ops/mwf_ops.py:434", per))
        entries[-1]["batch_launches"] = [mwf_times(f"batch {label}", Rss, Rnn, mu, 1, precision)
                                         for label, (Rss, Rnn, mu)
                                         in zip(("step1", "step2"), batch["fused_mwf"])]
    for e in entries[2:]:
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


def crnn_cost(n_streams: int, n_ch: int, T: int, win: int = 21, win_out: int = 15) -> float:
    """Operations of one canonical CRNN over ``n_streams`` streams of ``T``
    frames by the stream route: the three 3x3 convs over the padded
    streams (T + win - 1 frames), and per window the GRU's 15 steps
    (input and hidden products, 3 gates of 256) and the 257-wide FF on
    each of its 15 frames."""
    flops, t, f, c_in = 0.0, T + win - 1, 257, n_ch
    for c_out in (32, 64, 64):
        t -= 2
        flops += 2 * n_streams * c_out * t * f * c_in * 9
        f, c_in = f // 4, c_out
    steps = n_streams * T * win_out
    return flops + steps * (2 * 3 * 256 * (256 + 256) + 2 * 256 * 257)


def phase5_crnn_mask_stage(d: SimpleNamespace) -> None:
    """CUDA-event times (median of 5) of the CRNN-masked path on the 16
    distinct clips, by part: step-1 masks, step-1 z, step-2 masks, and
    ``tango(solver='fused')`` with those masks."""
    from disco_tpu_torch.enhance.driver import _z_for_mask_device
    from disco_tpu_torch.enhance.inference import crnn_masks_batched
    from disco_tpu_torch.enhance.tango import tango, tango_step1

    Yb, Sb, Nb = d.crnn_batch
    B, _, _, F, T = Yb.shape
    refs = Yb[:, :, 0].reshape(B * K, F, T)
    Mz = crnn_masks_batched(refs, d.crnn[0]).reshape(B, K, F, T)
    z = tango_step1(Yb, Sb, Nb, Mz)
    zs = _z_for_mask_device(z["z_y"], z["zn"], K, "zs_hat").reshape(B * K, K - 1, F, T)
    Mw = crnn_masks_batched(refs, d.crnn[1], zs=zs).reshape(B, K, F, T)
    del z
    parts = {"step-1 masks": (lambda: crnn_masks_batched(refs, d.crnn[0]), crnn_cost(B * K, 1, T)),
             "step-1 z": (lambda: tango_step1(Yb, Sb, Nb, Mz), None),
             "step-2 masks": (lambda: crnn_masks_batched(refs, d.crnn[1], zs=zs),
                              crnn_cost(B * K, K, T)),
             "tango": (lambda: tango(Yb, Sb, Nb, Mz, Mw, solver="fused"), None)}
    total = 0.0
    for label, (fn, flops) in parts.items():
        fn()  # warm-up
        runs = sorted(time_ms(fn, reps=1, warmup=0) for _ in range(5))
        total += runs[2]
        rate = "" if flops is None else (f"; {flops / 1e12:.3f} TFLOP by the CRNN's shapes = "
                                         f"{flops / (runs[2] / 1e3) / 1e12:.2f} TFLOP/s")
        print(f"phase 5: CRNN-masked path, {BATCH} clips, {label} {runs[2]} ms (median of "
              f"{runs}){rate}", flush=True)
    print(f"phase 5: CRNN-masked path, {BATCH} clips, the four parts {total} ms = "
          f"{BATCH * K * DUR_S / (total / 1e3)} enhanced audio-s per s (the STFT and ISTFT "
          f"not included)", flush=True)


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
    """Where the time of one 16-clip offline call, of the 16-clip CRNN mask
    stage and of one streaming window goes."""
    from disco_tpu_torch.enhance.driver import _batched_masks
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    yb, sb, nb = batch_clips(d)
    profiled(f"one {BATCH}-clip offline call",
             lambda: tango_clip_fused(yb, sb, nb, solver="fused"))
    profiled(f"one {BATCH}-clip offline call, bf16 lane",
             lambda: tango_clip_fused(yb, sb, nb, solver="fused", precision="bf16"))
    del yb, sb, nb
    profiled(f"the {BATCH}-clip CRNN mask stage (_batched_masks)",
             lambda: _batched_masks(*d.crnn_batch, d.crnn, "irm1", 1.0, K, "zs_hat"))
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
    phase2_sizes(d)
    d.launches = {}
    phase3_offline_path(d)
    phase3d_crnn_masked_clip(d)
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

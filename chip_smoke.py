#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``disco_tpu_torch``) on one NVIDIA
Hopper GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and turned into a
pass):

1. The card's name and power limit (``nvidia-smi``); the hand-written
   kernels are built from ``disco_tpu_torch/csrc`` into ``build/kernels/``
   and their ``-Xptxas -v`` register/spill counts printed.
2. Every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (K=8 nodes, C=4 mics, 10 s at 16 kHz).
3. The main path — ``tango_clip_fused(y, s, n, solver='fused')`` on the
   K=8 x C=4 x 10 s scene — with every launch counter set to 0 before and
   read after (1 STFT, 2 covariance and 2 fused-solve launches); the output
   is finite, within 1e-4 of the output scale of the same clip run with
   the plain versions on the card, and improves SI-SDR at node 0 by more
   than 3 dB over the noisy reference mic.
4. CUDA-event times: the path on a 16-clip batch, and per kernel the
   kernel, its plain version and (where one exists) one PyTorch library
   call computing the same function, beside the bound from this run's
   shapes and the H100 SXM data-sheet peaks.
5. Where one 16-clip path call spends its device time, by kernel
   (``torch.profiler``), and the device's busy share of its wall time.

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
TOL = {"stft": 1e-5, "masked_cov": 1e-5, "fused_mwf": 1e-5, "clip": 1e-4, "sdr_gain_db": 3.0}


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
    """(operations, bytes, DFT-product operations) of a centered real STFT
    with magnitudes.  The first two are what the function needs: per frame
    the window, one real FFT (2.5 n log2 n operations, half those of a
    complex radix-2 FFT) and the magnitude; the signal read once, the
    complex spectrum and the magnitude written once.  The third is the
    512 x 257 cos/sin product that the ported kernel runs instead of an
    FFT: the bound of that algorithm, not of the function."""
    n_freq = n_fft // 2 + 1
    frames = rows * (1 + length // hop)
    flops = frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 4 * n_freq)
    dft_flops = frames * (n_fft + 4 * n_fft * n_freq + 4 * n_freq)
    nbytes = rows * length * 4 + frames * n_freq * 12
    return flops, nbytes, dft_flops


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


def ptxas_summary(log: str) -> list[dict]:
    """Registers and spill bytes per compiled kernel from ``-Xptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            short = re.search(r"(stft_kernel|masked_cov_kernelILb[01]E|fused_mwf_kernelILi\d+ELb[01]E)",
                              m.group(1))
            name = short.group(1) if short else m.group(1)
            out.append({"kernel": name})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


@contextmanager
def plain_kernels():
    """Swap each kernel wrapper for its plain version, so the same path
    runs the plain PyTorch versions on the card (the reference run of
    phase 3)."""
    from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops

    saved = (stft_ops.stft_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel)
    stft_ops.stft_kernel = stft_ops.stft_matmul
    cov_ops.masked_cov_kernel = cov_ops.masked_covariances_folded
    mwf_ops.fused_mwf_kernel = mwf_ops.fused_mwf_plain
    try:
        yield
    finally:
        stft_ops.stft_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = saved


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
    print("ptxas: " + json.dumps(ptxas_summary(_build.ptxas_log())), flush=True)
    return smi


def phase2_kernels() -> SimpleNamespace:
    """Each kernel against its plain version at the main path's shapes;
    returns the scene, the inputs of each launch and the largest errors."""
    import torch

    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.enhance.tango import others_index
    from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops

    d = SimpleNamespace(dev=torch.device("cuda"), L=int(DUR_S * FS))
    d.y_np, d.s_np, d.n_np = scene(K, C, d.L, noise_scale=NOISE_SCALE)
    d.y, d.s, d.n = (torch.from_numpy(a).to(d.dev) for a in (d.y_np, d.s_np, d.n_np))
    d.x = torch.stack([d.y, d.s, d.n])                           # (3, K, C, L)
    d.err = {}

    spec_k, mag_k = stft_ops.stft_kernel(d.x, with_mag=True)
    spec_p, mag_p = stft_ops.stft_matmul(d.x, with_mag=True)
    torch.cuda.synchronize()
    r = max(rel_l2(spec_k, spec_p), rel_l2(mag_k, mag_p))
    d.err["stft"] = max(max_abs(spec_k, spec_p), max_abs(mag_k, mag_p))
    print(f"phase 2: stft {tuple(d.x.shape)} rel-l2 {r:.3e} max-abs {d.err['stft']:.3e}",
          flush=True)
    require(r <= TOL["stft"], ("stft", r))

    d.Y = spec_p[0]                                              # (K, C, F, T)
    d.m = tf_mask_mag(mag_p[1][:, 0], mag_p[2][:, 0], "irm1")    # (K, F, T)
    oth = torch.as_tensor(others_index(K), device=d.dev)
    d.in_y = torch.cat([d.Y, d.Y[:, 0][oth]], dim=1)             # (K, C+K-1, F, T)
    chan_m = torch.cat([d.m[:, None].expand(K, C, *d.m.shape[1:]), d.m[oth]], dim=1)
    d.pencils = {}
    d.err["masked_cov"] = 0.0
    for label, yy, mm in (("step1", d.Y, d.m), ("step2", d.in_y, d.m),
                          ("step2-chan", d.in_y, chan_m)):
        ks = cov_ops.masked_cov_kernel(yy, mm)
        ps = cov_ops.masked_covariances_folded(yy, mm)
        torch.cuda.synchronize()
        r = max(max_rel(ks[0], ps[0]), max_rel(ks[1], ps[1]))
        e = max(max_abs(ks[0], ps[0]), max_abs(ks[1], ps[1]))
        d.err["masked_cov"] = max(d.err["masked_cov"], e)
        print(f"phase 2: masked_cov {label} {tuple(yy.shape)} max-rel {r:.3e} max-abs {e:.3e}",
              flush=True)
        require(r <= TOL["masked_cov"], ("masked_cov", label, r))
        d.pencils[label] = ps
    # the generic C <= 16 path of the solve, off the main path
    d.pencils["generic-C7"] = tuple(p[..., :7, :7].contiguous() for p in d.pencils["step2"])
    d.err["fused_mwf"] = 0.0
    for label in ("step1", "step2", "generic-C7"):
        Rss, Rnn = d.pencils[label]
        wk, tk = mwf_ops.fused_mwf_kernel(Rss, Rnn)
        wp, tp = mwf_ops.fused_mwf_plain(Rss, Rnn)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(wk).all() and torch.isfinite(wp).all())
        r = max(rel_l2(wk, wp), rel_l2(tk, tp))
        e = max(max_abs(wk, wp), max_abs(tk, tp))
        d.err["fused_mwf"] = max(d.err["fused_mwf"], e)
        print(f"phase 2: fused_mwf {label} {tuple(Rss.shape)} rel-l2 {r:.3e} max-abs {e:.3e} "
              f"finite {finite}", flush=True)
        require(finite and r <= TOL["fused_mwf"], ("fused_mwf", label, r))
    return d


def phase3_main_path(d: SimpleNamespace) -> dict:
    """The main path through the entry point, with the launch counters;
    returns the launches per clip."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops

    wrappers = {"stft": stft_ops.stft_kernel, "masked_cov": cov_ops.masked_cov_kernel,
                "fused_mwf": mwf_ops.fused_mwf_kernel}
    for fn in wrappers.values():
        fn.launches = 0
    out = tango_clip_fused(d.y, d.s, d.n, solver="fused")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"phase 3: launches per clip {launches}", flush=True)
    require(launches == {"stft": 1, "masked_cov": 2, "fused_mwf": 2}, launches)
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
    return launches


def phase4_times(d: SimpleNamespace, launches: dict) -> list[dict]:
    """CUDA-event times of the path and of each kernel, its plain version
    and its library call, with the bound of this run's shapes."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops
    from disco_tpu_torch.ops.eigh_ops import default_sweeps

    yb, sb, nb = (a[None].expand(BATCH, *a.shape).contiguous() for a in (d.y, d.s, d.n))
    tango_clip_fused(yb, sb, nb, solver="fused")  # warm-up
    runs = sorted(time_ms(lambda: tango_clip_fused(yb, sb, nb, solver="fused"), reps=1,
                          warmup=0) for _ in range(5))
    path_ms = runs[2]
    audio_s = BATCH * K * DUR_S
    print(f"phase 4: path {BATCH} clips {path_ms} ms (median of {runs}) = "
          f"{audio_s / (path_ms / 1e3)} enhanced audio-s per s", flush=True)
    del yb, sb, nb

    F, T = d.Y.shape[-2], d.Y.shape[-1]
    win = stft_ops.hann_periodic(512, device=d.dev)
    rows = d.x.reshape(-1, d.L)
    w_st = torch.stack([d.m * d.m, (1 - d.m) ** 2]).to(torch.complex64) / T

    def lib_cov(yy):
        return lambda: torch.einsum("wkft,kcft,kdft->wkfcd", w_st, yy, yy.conj())

    entries = []
    fl, nbytes, dft_fl = stft_cost(rows.shape[0], d.L)
    b_ms, b_by = bound(fl, nbytes)
    entries.append({
        "name": "stft", "route": "cuda", "source": "disco_tpu_torch/csrc/stft.cu",
        "replaces": "disco_tpu/ops/stft_ops.py:183", "launches": launches["stft"],
        "max_abs_err": d.err["stft"],
        "ms": time_ms(lambda: stft_ops.stft_kernel(d.x, with_mag=True), reps=20),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(d.x, with_mag=True), reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.stft(rows, 512, 256, window=win, center=True,
                                                 pad_mode="reflect", return_complex=True), reps=20),
        "dft_product_bound_ms": bound(dft_fl, nbytes)[0],
    })
    per = []  # covariances: step 1 (C=4) and step 2 (D=11) launches of one clip
    for label, yy in (("step1", d.Y), ("step2", d.in_y)):
        fl, nbytes = cov_cost(K, yy.shape[1], F, T, chan=False)
        per.append({
            "shape": f"{label} {tuple(yy.shape)}",
            "ms": time_ms(lambda: cov_ops.masked_cov_kernel(yy, d.m), reps=50),
            "plain_ms": time_ms(lambda: cov_ops.masked_covariances_folded(yy, d.m), reps=20),
            "library_ms": time_ms(lib_cov(yy), reps=20),
            "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        })
    entries.append(_summed("masked_cov", "disco_tpu_torch/csrc/cov.cu",
                           "disco_tpu/ops/cov_ops.py:233", launches, d.err, per))
    per = []  # fused solve: step 1 (C=4) and step 2 (D=11) launches of one clip
    for label in ("step1", "step2"):
        Rss, Rnn = d.pencils[label]
        D = Rss.shape[-1]
        fl, nbytes = mwf_cost(Rss[..., 0, 0].numel(), D, default_sweeps(D))
        per.append({
            "shape": f"{label} {tuple(Rss.shape)}",
            "ms": time_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn), reps=20),
            "plain_ms": time_ms(lambda: mwf_ops.fused_mwf_plain(Rss, Rnn), reps=2, warmup=1),
            "library_ms": None, "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        })
    entries.append(_summed("fused_mwf", "disco_tpu_torch/csrc/mwf.cu",
                           "disco_tpu/ops/mwf_ops.py:434", launches, d.err, per))
    for e in entries:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            require(math.isfinite(e[key]), (e["name"], key))
    return entries


def phase5_breakdown(d: SimpleNamespace) -> None:
    """Where the time of one 16-clip path call goes: device time by kernel
    name (``torch.profiler``) and the device's busy share of the call's
    wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from disco_tpu_torch.enhance.fused import tango_clip_fused

    yb, sb, nb = (a[None].expand(BATCH, *a.shape).contiguous() for a in (d.y, d.s, d.n))
    tango_clip_fused(yb, sb, nb, solver="fused")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tango_clip_fused(yb, sb, nb, solver="fused")
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
        print("phase 5: the profiler recorded no device time: breakdown not measured", flush=True)
        return
    print(f"phase 5: one {BATCH}-clip path call under the profiler: wall {wall_ms} ms, device "
          f"busy {busy} ms ({busy / wall_ms} of the wall time)", flush=True)
    for r in rows[:14]:
        print("phase 5: " + json.dumps(r), flush=True)


def _summed(name, source, replaces, launches, err, per) -> dict:
    """One kernel's entry over the launches of one clip (``per``)."""
    lib = [p["library_ms"] for p in per]
    flops, nbytes = sum(p["flops"] for p in per), sum(p["bytes"] for p in per)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": err[name],
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
    launches = phase3_main_path(d)
    entries = phase4_times(d, launches)
    phase5_breakdown(d)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

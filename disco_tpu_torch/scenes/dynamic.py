"""Dynamic scenes: piecewise-stationary trajectories with crossfaded RIRs
(counterpart of ``disco_tpu/scenes/dynamic.py``).

The image-source model is only defined for a frozen geometry, so a moving
scene is approximated the way perceptual RIR interpolation does it: the
trajectory is sampled at K segment waypoints, each segment gets its own
static RIR, and the per-segment wet signals are blended with raised-cosine
crossfades at the segment boundaries — piecewise-stationary acoustics with
no hard switching clicks.

On the device of the call: the K segment RIRs are K × M rows of one
:func:`disco_tpu_torch.sim.ism.shoebox_rirs_batched`, the K convolutions one
batched rFFT, and the blend accumulates segment by segment in order, as the
JAX package's ``lax.scan`` (``unroll=1``) does: the accumulation order is the
segment order.  The device part's call signatures are counted under the
JAX package's ``dynamic_scene`` label (``obs.accounting.counted_jit``).

No reference counterpart: the reference corpus is static rooms only
(``gen_disco/convolve_signals.py``).
"""
from __future__ import annotations

from functools import partial

import numpy as np

from disco_tpu_torch.obs.accounting import counted_jit


def piecewise_trajectory(start, end, n_segments: int) -> np.ndarray:
    """(K, 3) segment waypoints linearly interpolating start → end (the
    midpoint of each segment — a constant-velocity walk sampled at segment
    centers).

    No reference counterpart (module docstring)."""
    start = np.asarray(start, np.float32)
    end = np.asarray(end, np.float32)
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    frac = (np.arange(n_segments, dtype=np.float32) + 0.5) / n_segments
    return start[None, :] + frac[:, None] * (end - start)[None, :]


def segment_weights(n_samples: int, n_segments: int, crossfade: int):
    """(K, n_samples) float32 blend weights: segment k owns samples
    ``[k*seg, (k+1)*seg)`` with a raised-cosine handover of ``crossfade``
    samples centered on each interior boundary.  Rows sum to 1 everywhere
    (the overlap-add complement convention).  Host numpy: the weights depend
    only on the shapes.

    No reference counterpart (module docstring)."""
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    seg = n_samples / float(n_segments)
    t = np.arange(n_samples, dtype=np.float64)
    w = np.zeros((n_segments, n_samples), np.float64)
    half = max(int(crossfade), 0) / 2.0
    for k in range(n_segments):
        lo, hi = k * seg, (k + 1) * seg
        if half == 0:
            w[k] = (t >= lo) & (t < hi) if k < n_segments - 1 else (t >= lo)
            continue
        # Ramp up across [lo-half, lo+half) (skipped at the first segment),
        # down across [hi-half, hi+half) (skipped at the last).
        up = np.clip((t - (lo - half)) / (2 * half), 0.0, 1.0) if k > 0 else np.ones_like(t)
        dn = np.clip(((hi + half) - t) / (2 * half), 0.0, 1.0) if k < n_segments - 1 else np.ones_like(t)
        ramp_up = 0.5 - 0.5 * np.cos(np.pi * up)
        ramp_dn = 0.5 - 0.5 * np.cos(np.pi * dn)
        w[k] = ramp_up * ramp_dn
    w /= np.maximum(w.sum(0, keepdims=True), 1e-12)
    return w.astype(np.float32)


def dynamic_scene_mixture(room_dim, src_path, mics, alpha, dry, *,
                          crossfade: int = 512, max_order: int = 20,
                          rir_len: int = 4096, fs: int = 16000,
                          mic_path=None, device=None) -> dict:
    """Nonstationary mixture of one moving scene.

    Args:
      room_dim: (3,) room dimensions.
      src_path: (K, 3) per-segment source waypoints
        (:func:`piecewise_trajectory`); K = number of stationary segments.
      mics: (M, 3) static mic positions — or pass ``mic_path`` (K, M, 3)
        for time-varying node positions.
      alpha: wall energy absorption.
      dry: (L,) dry source signal.
      crossfade: boundary handover width in samples (0 = hard switch).
      device: ``"cuda"`` when None (RuntimeError without a CUDA device), or
        ``"cpu"``.

    Returns numpy ``{"mixture": (M, L), "rirs": (K, M, rir_len)}`` read back
    in one copy.
    """
    from disco_tpu_torch.device import as_device_tensors, to_host

    src_path = np.asarray(src_path, np.float32)
    K = int(src_path.shape[0])
    if mic_path is None:
        mic_path = np.broadcast_to(np.asarray(mics, np.float32)[None], (K,) + np.shape(mics))
    mic_path = np.ascontiguousarray(mic_path, np.float32)
    out = _dynamic_scene_program(
        *as_device_tensors((np.asarray(room_dim, np.float32), src_path, mic_path,
                            np.float32(alpha), dry), device),
        n_segments=K, crossfade=int(crossfade), max_order=int(max_order),
        rir_len=int(rir_len), fs=int(fs))
    mixture, rirs = to_host([out["mixture"], out["rirs"]])
    return {"mixture": mixture, "rirs": rirs}


@partial(counted_jit, label="dynamic_scene",
         static_argnames=("n_segments", "crossfade", "max_order", "rir_len", "fs"))
def _dynamic_scene_program(room_dim, src_path, mic_path, alpha, dry, n_segments: int,
                           crossfade: int, max_order: int, rir_len: int, fs: int) -> dict:
    """The moving scene's work on the device — see
    :func:`dynamic_scene_mixture` (the JAX package's one jitted program,
    whose call signatures the ``dynamic_scene`` label counts)."""
    import torch

    from disco_tpu_torch.sim.ism import fft_convolve, shoebox_rirs_batched

    K, L = n_segments, int(dry.shape[-1])
    room, path, alphas, weights = (
        room_dim[None].expand(K, 3).contiguous(), src_path[:, None, :],
        alpha.reshape(1).expand(K).contiguous(),
        torch.as_tensor(segment_weights(L, K, crossfade), device=dry.device))
    # K segment RIRs as K rooms of one source: (K, M, rir_len)
    rirs = shoebox_rirs_batched(room, path, mic_path, alphas, max_order=max_order,
                                rir_len=rir_len, fs=fs)[:, 0]
    # Each segment hears the WHOLE dry signal through its frozen room —
    # (K, M, L) — and the blend picks each segment's window.  Convolving
    # full-length (vs per-segment slices) is what makes the crossfade
    # click-free: both sides of a boundary carry the same source material.
    wet = fft_convolve(dry[None, None, :], rirs, out_len=L)
    out = torch.zeros_like(wet[0])
    for wet_k, w_k in zip(wet, weights):
        out = out + wet_k * w_k[None, :]
    return {"mixture": out, "rirs": rirs}


def boundary_jumps(mixture: np.ndarray, n_segments: int) -> np.ndarray:
    """Max |x[t] - x[t-1]| across any channel AT each interior segment
    boundary — the discontinuity statistic of the continuity check (a
    hard-switched blend clicks exactly there).

    No reference counterpart (module docstring)."""
    x = np.asarray(mixture)
    L = x.shape[-1]
    seg = L / float(n_segments)
    jumps = []
    for k in range(1, int(n_segments)):
        t = int(round(k * seg))
        if 1 <= t < L:
            jumps.append(float(np.max(np.abs(x[..., t] - x[..., t - 1]))))
    return np.asarray(jumps)

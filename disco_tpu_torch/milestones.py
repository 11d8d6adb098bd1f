"""The BASELINE milestone configurations as executable programs on the card
(counterpart of ``disco_tpu/milestones.py``).

Each function builds its scenario, runs the pipeline on the device, and
returns a metrics dict (real-time factor + SI-SDR deltas) with the JAX
package's keys.  The scales default to the BASELINE spec; every function
takes size overrides so the test suite exercises all of them end-to-end on
the CPU in seconds.

1. ``mvdr_single_clip``      — 1 node, 4 mics, rank-1 GEVD-MWF, one clip.
2. ``disco_mwf_4node``       — 4-node DISCO array, local MWF only (step 1).
3. ``tango_4node``           — 4-node two-step DANSE MWF (TASLP 2021 setup),
                               oracle or CRNN masks.
4. ``meetit_separation``     — 8-node array, 2 competing speakers, per-source
                               extraction (ICASSP 2021 setup).
5. ``batched_meetit_end_to_end`` — 64 rooms x 8 nodes: ISM RIR simulation +
                               convolution + enhancement over the whole room
                               batch in batched calls (no loop over rooms).
6. ``streaming_latency``     — per-frame latency of the online two-step
                               pipeline per mask-for-z policy.

(The self-generated-corpus pipeline milestone lives in
``disco_tpu_torch.milestones_corpus``.)

Every function takes ``device``: ``"cuda"`` when None (RuntimeError without
a CUDA device), ``"cpu"`` for the plain versions on the host.  A scenario's
arrays are drawn on the host in numpy, exactly as the JAX package draws
them, and put on the device once before the timing; the timed call is the
pipeline from those device tensors to the enhanced time signal.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from disco_tpu_torch.core.dsp import istft, stft
from disco_tpu_torch.core.metrics import si_sdr
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.tango import oracle_masks, tango
from disco_tpu_torch.enhance.zexport import compute_z_signals
from disco_tpu_torch.sim.ism import fft_convolve, shoebox_rirs_batched

FS = 16000


def _fence(x) -> float:
    """Host readback of one element of ``x`` — the execution fence: on the
    card a one-element copy to the host waits for every launch queued on
    the stream before it (a directly attached H100 has no tunnel, so the
    fence costs one synchronization and a few microseconds of copy).

    Every attempt ticks the obs fence counter (``obs.accounting``), and the
    readback runs under bounded retry (``utils.resilience``) with the JAX
    package's budgets: a transport error is retried in-process instead of
    killing the run."""
    from disco_tpu_torch.utils.resilience import TRANSPORT_ERRORS, call_with_retries

    return call_with_retries(_fence_readback, x, retries=2, base_delay_s=0.25,
                             max_delay_s=1.0, label="fence",
                             retry_on=TRANSPORT_ERRORS)


def _fence_readback(x) -> float:
    """One un-retried fence attempt: the real part of ``x``'s first element
    (a complex leaf reads back as its real part).

    ``pre_fence`` is a chaos seam (``disco_tpu_torch.runs.chaos``): the
    injected crash lands immediately before the readback — work queued on
    the device, nothing fenced back."""
    from disco_tpu_torch.obs import accounting
    from disco_tpu_torch.runs import chaos

    chaos.tick("pre_fence")
    accounting.fence_tick()
    return float(x.reshape(-1)[0].real.item())


def _scene(K, C, L, seed=0, noise_scale=0.8):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(L)
    s = np.stack(
        [np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same") for _ in range(C)]) for _ in range(K)]
    ).astype(np.float32)
    n = noise_scale * rng.standard_normal((K, C, L)).astype(np.float32)
    return s + n, s, n


def _leaf(out):
    """The first tensor of ``out`` (a tensor, or a tuple, list or dict of
    them; dict keys in sorted order, as ``jax.tree_util.tree_leaves``)."""
    if isinstance(out, dict):
        return _leaf(out[sorted(out)[0]])
    if isinstance(out, (tuple, list)):
        return _leaf(out[0])
    return out


def _time_queued(fn, *args, k: int = 1, iters: int = 5):
    """Median wall time of k queued executions under ONE fence."""
    _fence(_leaf(fn(*args)))  # warm-up
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(k)]
        _fence(_leaf(outs[-1]))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _slope_time(fn, *args, k: int = 6, iters: int = 5):
    """(per-execution seconds, single-dispatch seconds) via the k-queued
    slope: queue k executions, fence once, slope = (t_k - t_1)/(k-1).  A
    fenced single execution pays the host's launch and synchronization
    cost once; the slope removes that fixed part.  When jitter swamps the
    signal (tk <= t1, a non-positive slope), fall back to tk/k — a
    conservative upper bound that still amortizes the fixed cost k-fold."""
    t1 = _time_queued(fn, *args, k=1, iters=iters)
    tk = _time_queued(fn, *args, k=k, iters=iters)
    slope = (tk - t1) / (k - 1)
    if slope <= 0:
        slope = tk / k
    return slope, t1


def _timed(fn, *args, iters=3):
    """(out, per-execution seconds, single-dispatch seconds): one run for
    the output, then the slope decomposition."""
    out = fn(*args)
    _fence(_leaf(out))
    dt, dt1 = _slope_time(fn, *args, iters=iters)
    return out, dt, dt1


def _rtf_fields(audio_s, dt, dt1):
    """The decomposed milestone RTF triple: ``rtf`` = audio seconds per
    per-execution second (the slope), ``rtf_single_dispatch`` = the same
    for one fenced execution, ``dispatch_ms`` = their difference: on the
    card the host's launch and synchronization cost of a run."""
    return {
        "rtf": audio_s / dt,
        "rtf_single_dispatch": audio_s / dt1,
        "dispatch_ms": round(max(dt1 - dt, 0.0) * 1e3, 2),
    }


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def mvdr_single_clip(dur_s=5.0, seed=0, iters=3, device=None):
    """Config 1: single 4-mic node, rank-1 GEVD-MWF on one clip (one STFT
    launch for the mixture, speech and noise; the covariances by the plain
    ``beam.masked_covariances``, the eigensolver by ``torch.linalg.eigh``,
    as the JAX package's ``jnp.linalg.eigh``)."""
    from disco_tpu_torch.beam.covariance import masked_covariances
    from disco_tpu_torch.beam.filters import gevd_mwf
    from disco_tpu_torch.core.masks import tf_mask

    dev = resolve_device(device)
    L = int(dur_s * FS)
    y, s, n = _scene(1, 4, L, seed)
    (ysn,) = _on(dev, np.stack([y[0], s[0], n[0]]))

    def run(ysn):
        Y, S, N = stft(ysn)
        mask = tf_mask(S[0], N[0], "irm1")
        Rss, Rnn = masked_covariances(Y, mask)
        w, _ = gevd_mwf(Rss, Rnn, mu=1.0, rank=1)
        yf = torch.einsum("fc,cft->ft", w.conj(), Y)
        return istft(yf, length=L)

    enh, dt, dt1 = _timed(run, ysn, iters=iters)
    enh = _host(enh)
    return {
        "config": "mvdr_single_clip",
        **_rtf_fields(dur_s, dt, dt1),
        "si_sdr_in": float(si_sdr(s[0, 0], y[0, 0])),
        "si_sdr_out": float(si_sdr(s[0, 0], enh)),
    }


def _deltas(s, y, enh, K):
    return [float(si_sdr(s[k, 0], enh[k]) - si_sdr(s[k, 0], y[k, 0])) for k in range(K)]


def disco_mwf_4node(dur_s=5.0, K=4, C=4, seed=0, iters=3, device=None):
    """Config 2: 4-node DISCO array, local MWF only (TANGO step 1 — each
    node beamforms its own mics, no z exchange, oracle masks)."""
    dev = resolve_device(device)
    L = int(dur_s * FS)
    y, s, n = _scene(K, C, L, seed)

    def run(y, s, n):
        out = compute_z_signals(y, s, n, mask_type="irm1", device=dev)
        return istft(out["z_y"], length=L)

    enh, dt, dt1 = _timed(run, *_on(dev, y, s, n), iters=iters)
    return {"config": "disco_mwf_4node", **_rtf_fields(K * dur_s, dt, dt1),
            "delta_si_sdr": _deltas(s, y, _host(enh), K)}


def tango_4node(dur_s=5.0, K=4, C=4, seed=0, iters=3, models=(None, None), device=None):
    """Config 3: the full two-step DANSE-style distributed MWF (TASLP 2021).
    ``models``: (step1, step2) CRNN modules (on ``device``) or None for
    oracle masks.  The STFTs (one launch) and the masks are made before the
    timing, as in the JAX package."""
    from disco_tpu_torch.enhance.driver import estimate_masks

    dev = resolve_device(device)
    L = int(dur_s * FS)
    y, s, n = _scene(K, C, L, seed)
    Y, S, N = stft(*_on(dev, np.stack([y, s, n])))
    masks_z, mask_w = estimate_masks(Y, S, N, list(models), "irm1", K, device=dev)

    def run(Y, S, N, masks_z, mask_w):
        res = tango(Y, S, N, masks_z, mask_w, policy="local", device=dev)
        return istft(res.yf, length=L)

    enh, dt, dt1 = _timed(run, Y, S, N, masks_z, mask_w, iters=iters)
    return {"config": "tango_4node", **_rtf_fields(K * dur_s, dt, dt1),
            "delta_si_sdr": _deltas(s, y, _host(enh), K)}


def meetit_separation(dur_s=5.0, K=8, C=4, n_src=2, seed=0, iters=3, device=None):
    """Config 4: 8-node array, 2 competing speakers (ICASSP 2021): per-source
    oracle IRMs drive one TANGO pass per source (the source a leading axis
    of one batched call); each speaker is evaluated at the node facing it
    (node k attends source k % n_src)."""
    from disco_tpu_torch.enhance.separation import separate_sources

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    L = int(dur_s * FS)
    srcs = [rng.standard_normal(L) for _ in range(n_src)]
    imgs = np.stack(
        [
            np.stack(
                [np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same") for _ in range(C)]) for _ in range(K)]
            )
            for src in srcs
        ]
    ).astype(np.float32)  # (n_src, K, C, L)
    y = imgs.sum(0)

    def run(y_imgs):
        spec = stft(y_imgs)  # the mixture and every image, one launch
        est = separate_sources(spec[0], spec[1:], device=dev)  # (n_src, K, F, T)
        return istft(est, length=L)

    est, dt, dt1 = _timed(run, *_on(dev, np.concatenate([y[None], imgs])), iters=iters)
    est = _host(est)
    deltas = []
    for k in range(K):
        si = k % n_src
        ref = imgs[si, k, 0]
        deltas.append(float(si_sdr(ref, est[si, k]) - si_sdr(ref, y[k, 0])))
    return {"config": "meetit_separation", **_rtf_fields(K * dur_s, dt, dt1), "delta_si_sdr": deltas}


def batched_meetit_end_to_end(
    n_rooms=64, K=8, C=2, dur_s=2.0, max_order=10, rir_len=2048, seed=0, iters=1, device=None
):
    """Config 5: ISM room simulation + convolution + two-step enhancement for
    ``n_rooms`` rooms — simulation and enhancement share the device (the
    north-star end-to-end config).  Each stage is one batched call over the
    whole room batch: ``shoebox_rirs_batched``, ``fft_convolve``, one STFT
    launch for the mixtures, images and noises, ``oracle_masks`` and
    ``tango`` over the leading room axis.

    Geometry is sampled host-side in numpy in the JAX package's draw order
    (rejection sampling stays on the host, SURVEY.md §7 hard-part 5);
    everything after the draw runs on the device.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    L = int(dur_s * FS)
    M = K * C

    dims = rng.uniform([4, 4, 2.5], [8, 6, 3], size=(n_rooms, 3)).astype(np.float32)
    mics = (dims[:, None, :] * rng.uniform(0.2, 0.8, size=(n_rooms, M, 3))).astype(np.float32)
    srcs = (dims[:, None, :] * rng.uniform(0.2, 0.8, size=(n_rooms, 2, 3))).astype(np.float32)
    alphas = rng.uniform(0.3, 0.6, size=(n_rooms,)).astype(np.float32)
    dry = rng.standard_normal((n_rooms, 2, L)).astype(np.float32)

    def run(dims, srcs, mics, alphas, dry):
        rirs = shoebox_rirs_batched(dims, srcs, mics, alphas, max_order=max_order,
                                    rir_len=rir_len)                    # (B, 2, M, R)
        imgs = fft_convolve(dry[:, :, None, :], rirs, out_len=L)        # (B, 2, M, L)
        s = imgs[:, 0].reshape(n_rooms, K, C, L)
        n = imgs[:, 1].reshape(n_rooms, K, C, L)
        Y, S, N = stft(torch.stack([s + n, s, n]))
        m = oracle_masks(S, N, "irm1")
        res = tango(Y, S, N, m, m, policy="local", device=dev)
        return istft(res.yf, length=L), s

    (enh, s_ref), dt, dt1 = _timed(run, *_on(dev, dims, srcs, mics, alphas, dry), iters=iters)
    enh, s_ref = _host(enh), _host(s_ref)
    # SI-SDR of the enhanced output vs the clean image at each node's ref mic
    sdrs = [
        float(si_sdr(s_ref[r, k, 0], enh[r, k]))
        for r in range(min(n_rooms, 4))
        for k in range(K)
    ]
    return {
        "config": "batched_meetit_end_to_end",
        **_rtf_fields(n_rooms * K * dur_s, dt, dt1),
        "rooms": n_rooms,
        "mean_si_sdr_out": float(np.mean(sdrs)),
    }


def streaming_latency(dur_s=5.0, K=4, C=4, update_every=4, seed=0, iters=3,
                      policies=("local", "distant", "none"), device=None):
    """Per-frame processing latency of the online (streaming) TANGO.

    Reports, per mask-for-z policy: wall-clock per STFT frame for the
    full K-node two-step online pipeline (``streaming_tango`` over the
    whole clip), the real-time budget (one frame = hop/fs = 16 ms), and the
    resulting real-time factor.  Algorithmic latency is one block
    (``update_every`` frames) of filter staleness; the pipeline itself is
    causal (each frame is filtered with the most recent refresh, never
    future data).
    """
    from disco_tpu_torch.enhance.streaming import streaming_tango

    dev = resolve_device(device)
    L = int(dur_s * FS)
    y, s, n = _scene(K, C, L, seed)
    Y, S, N = stft(*_on(dev, np.stack([y, s, n])))
    masks = oracle_masks(S, N, "irm1")
    T = Y.shape[-1]
    frame_budget_ms = 1e3 * 256 / FS  # hop / fs

    out = {"config": "streaming_latency", "frames": T, "update_every": update_every,
           "frame_budget_ms": round(frame_budget_ms, 3), "policies": {}}
    for policy in policies:
        def run(Y, mz, mw):
            return streaming_tango(Y, mz, mw, update_every=update_every, policy=policy,
                                   device=dev)["yf"]

        _, dt, dt1 = _timed(run, Y, masks, masks, iters=iters)
        per_frame_ms = 1e3 * dt / T
        out["policies"][policy] = {
            "per_frame_ms": round(per_frame_ms, 4),
            "rtf": round(frame_budget_ms / per_frame_ms, 1),
            "dispatch_ms": round(max(dt1 - dt, 0.0) * 1e3, 2),
        }
    return out


#: the ``tiny=True`` scales (the JAX package's): CPU-testable in seconds
TINY = {
    1: dict(dur_s=1.0, iters=1),
    2: dict(dur_s=1.0, iters=1),
    3: dict(dur_s=1.0, iters=1),
    4: dict(dur_s=1.0, K=4, C=2, iters=1),
    5: dict(n_rooms=2, K=2, C=2, dur_s=0.5, max_order=4, rir_len=1024, iters=1),
    6: dict(dur_s=1.0, K=2, C=2, iters=1),
}

#: config number -> function
CONFIGS = {
    1: mvdr_single_clip,
    2: disco_mwf_4node,
    3: tango_4node,
    4: meetit_separation,
    5: batched_meetit_end_to_end,
    6: streaming_latency,
}


def run_all(tiny: bool = False, device=None):
    """All milestone configs (1-5 + streaming latency); ``tiny=True``
    shrinks every scale for CPU test runs."""
    resolve_device(device)
    return [fn(**(TINY[i] if tiny else {}), device=device) for i, fn in CONFIGS.items()]


if __name__ == "__main__":
    import json

    for res in run_all():
        print(json.dumps(res))

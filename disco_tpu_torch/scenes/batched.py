"""Batched scenario factory: B rooms simulated together (counterpart of
``disco_tpu/scenes/batched.py``).

The reference simulates scenes one at a time — one ``pra.ShoeBox`` per room,
per-channel ``np.convolve`` loops (``gen_disco/convolve_signals.py:84-99,
161``).  This module batches the SCENE axis:

* :func:`scene_batch_bucket` picks ONE ``(max_order, rir_len)`` bucket for
  a whole batch (the coarse-quantum application of the canonical
  :func:`disco_tpu_torch.sim.ism.rir_bucket` policy);
* :func:`simulate_scene_batch` runs the whole factory on the device — B × S
  × M image-source RIRs, dry→wet FFT convolution, SNR-scaled mixing, the
  reference mic's STFT magnitudes (ONE launch of the STFT kernel,
  ``csrc/stft.cu``, on the (3, B, L) stack of the noisy, clean and noise
  streams) and the IRM training mask — and hands the results to the host
  in one copy (``device.to_host``).

The JAX package compiles the factory as one ``counted_jit`` program and
counts its retraces; eager torch compiles nothing, so the port has no such
counter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco_tpu_torch.sim.ism import rir_bucket

#: Coarse rir_len rounding for batch buckets: nearby scene batches share a
#: bucket (the per-scene path uses 256)
BATCH_QUANTUM = 2048


@dataclasses.dataclass
class SceneBatch:
    """Host-side parameters of one scene batch (everything the factory
    consumes, as numpy).

    Shapes: B scenes × S sources (index 0 = target, 1 = noise, the
    two-source DISCO convention of convolve_signals.py:216-282) × M mics.

    No reference counterpart: the reference has no batched scene axis
    (module docstring).
    """

    room_dims: np.ndarray  # (B, 3) float32
    sources: np.ndarray    # (B, S, 3) float32
    mics: np.ndarray       # (B, M, 3) float32
    alphas: np.ndarray     # (B,) float32 wall energy absorption
    betas: np.ndarray      # (B,) float32 RT60 seconds (bucket sizing)
    dry: np.ndarray        # (B, S, L) float32 dry source signals
    noise_gains: np.ndarray  # (B,) float32 linear gain applied to the wet noise
    snr_db: np.ndarray     # (B,) float32 the sampled per-scene SNR (metadata)

    @property
    def n_scenes(self) -> int:
        return int(self.room_dims.shape[0])


def scene_batch_bucket(batch: SceneBatch, max_order: int = 20,
                       fs: int = 16000, quantum: int = BATCH_QUANTUM) -> tuple[int, int]:
    """The shared ``(max_order, rir_len)`` bucket of one batch: the canonical
    :func:`disco_tpu_torch.sim.ism.rir_bucket` policy per scene, the max
    ``rir_len`` over the batch (every scene's tail fits).

    No reference counterpart (module docstring).
    """
    rir_len = 0
    for b in range(batch.n_scenes):
        _, n = rir_bucket(float(batch.betas[b]), batch.room_dims[b],
                          max_order=max_order, fs=fs, quantum=quantum)
        rir_len = max(rir_len, n)
    return max_order, rir_len


def noise_gain_for_snr(target: np.ndarray, noise: np.ndarray, snr_db: float) -> float:
    """Linear gain scaling ``noise`` so that ``rms(target)/rms(gain*noise)``
    hits ``snr_db`` (the dry-domain analogue of
    ``core.sigproc.increase_to_snr``'s energy balance, reference
    sigproc_utils.py:28-55; the factory applies it to the WET noise)."""
    pt = float(np.mean(np.square(target))) + 1e-12
    pn = float(np.mean(np.square(noise))) + 1e-12
    return float(np.sqrt(pt / pn) * 10.0 ** (-float(snr_db) / 20.0))


def simulate_scene_batch(batch: SceneBatch, max_order: int = 20,
                         fs: int = 16000, quantum: int = BATCH_QUANTUM,
                         rir_len: int | None = None, device=None) -> dict:
    """Simulate one scene batch on the device and read it back in ONE copy.

    B sequential reference scene simulations
    (``gen_disco/convolve_signals.py:216-282`` per scene) as one pass:
    batched ISM RIRs, batched FFT convolution, SNR mixing, one STFT kernel
    launch for the reference mic's magnitudes, the IRM mask target.
    ``device``: ``"cuda"`` when None (RuntimeError without a CUDA device),
    or ``"cpu"`` for the plain versions.

    Returns a dict of numpy arrays: ``rirs (B,S,M,rir_len)``,
    ``noisy/clean (B,M,L)``, ``mag_noisy (B,F,T)``, ``mask (B,F,T)``.
    """
    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.device import as_device_tensors, to_host
    from disco_tpu_torch.ops.stft_ops import stft_with_mag
    from disco_tpu_torch.sim.ism import fft_convolve, shoebox_rirs_batched

    if rir_len is None:
        max_order, rir_len = scene_batch_bucket(batch, max_order=max_order,
                                                fs=fs, quantum=quantum)
    room_dims, sources, mics, alphas, dry, noise_gains = as_device_tensors(
        (batch.room_dims, batch.sources, batch.mics, batch.alphas, batch.dry,
         batch.noise_gains), device)
    rirs = shoebox_rirs_batched(room_dims, sources, mics, alphas, max_order=int(max_order),
                                rir_len=int(rir_len), fs=int(fs))
    # (B, S, M, L): every dry source convolved with its RIRs to every mic
    wet = fft_convolve(dry[:, :, None, :], rirs, out_len=dry.shape[-1])
    clean = wet[:, 0]                                    # (B, M, L)
    noise = wet[:, 1] * noise_gains[:, None, None]       # (B, M, L)
    noisy = clean + noise
    # reference-mic analysis (mic 0): one STFT over the three stacked
    # streams, then the IRM1 training target
    stack = torch.stack([noisy[:, 0], clean[:, 0], noise[:, 0]])  # (3, B, L)
    _spec, mag = stft_with_mag(stack)                     # (3, B, F, T)
    mask = tf_mask_mag(mag[1], mag[2], mask_type="irm1")  # (B, F, T)
    out = {"rirs": rirs, "noisy": noisy, "clean": clean, "mag_noisy": mag[0], "mask": mask}
    return dict(zip(out, to_host(out.values())))


def synthetic_dry_pair(rng: np.random.Generator, n_samples: int,
                       fs: int = 16000) -> tuple[np.ndarray, np.ndarray]:
    """A hermetic (target, noise) dry pair: speech-shaped amplitude-modulated
    noise vs stationary noise — the corpus-free stand-in of SceneStream's
    synthetic mode (real runs plug ``sim.signals.SpeechAndNoiseSetup``
    corpora in instead).

    No reference counterpart: the reference always reads LibriSpeech
    (convolve_signals.py:32-81).
    """
    t = np.arange(n_samples, dtype=np.float64) / fs
    carrier = rng.standard_normal(n_samples)
    # ~4 Hz syllabic envelope with a random phase, floored so silence is
    # quiet-but-nonzero (fw-SNR needs energy in every band).
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 2 * np.pi))
    target = (carrier * env).astype(np.float32)
    noise = rng.standard_normal(n_samples).astype(np.float32)
    target /= max(float(np.std(target)), 1e-9)
    noise /= max(float(np.std(noise)), 1e-9)
    return target, noise


def draw_scene_batch(rng: np.random.Generator, n_scenes: int, *,
                     scenario: str = "random", duration_s: float = 1.0,
                     snr_range: tuple = (-5.0, 10.0), fs: int = 16000,
                     setup_overrides: dict | None = None,
                     dry_fn=None) -> SceneBatch:
    """Draw one :class:`SceneBatch`: geometry by the rejection samplers
    (``sim.make_setup``, the constraints of reference room_setups.py), dry
    signals from ``dry_fn`` (default :func:`synthetic_dry_pair`), per-scene
    SNR uniform in ``snr_range`` (the ``snr_cnv_range`` convention,
    convolve_signals.py:404-409).  Host numpy, draw for draw as the JAX
    package.

    All scenes in a batch share the scenario's fixed sensor layout, so the
    (B, S, M) stacking is rectangular by construction.
    """
    from disco_tpu_torch.sim import make_setup

    sampler = make_setup(scenario, rng=rng, **(setup_overrides or {}))
    L = int(round(duration_s * fs))
    dry_fn = dry_fn or (lambda r, n: synthetic_dry_pair(r, n, fs=fs))

    dims, srcs, mics, alphas, betas, drys, gains, snrs = [], [], [], [], [], [], [], []
    for _ in range(int(n_scenes)):
        cfg = sampler.create_room_setup()
        target, noise = dry_fn(rng, L)
        snr_db = float(rng.uniform(*snr_range))
        dims.append(np.asarray(cfg.room_dim, np.float32))
        srcs.append(np.asarray(cfg.source_positions[:2], np.float32))
        mics.append(np.asarray(cfg.mic_positions.T, np.float32))
        alphas.append(np.float32(cfg.alpha))
        betas.append(np.float32(cfg.beta))
        drys.append(np.stack([target, noise]).astype(np.float32))
        gains.append(np.float32(noise_gain_for_snr(target, noise, snr_db)))
        snrs.append(np.float32(snr_db))
    return SceneBatch(
        room_dims=np.stack(dims), sources=np.stack(srcs), mics=np.stack(mics),
        alphas=np.asarray(alphas, np.float32), betas=np.asarray(betas, np.float32),
        dry=np.stack(drys), noise_gains=np.asarray(gains, np.float32),
        snr_db=np.asarray(snrs, np.float32),
    )

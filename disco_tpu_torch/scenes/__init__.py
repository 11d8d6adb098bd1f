"""The batched scene factory (counterpart of ``disco_tpu/scenes``).

* :mod:`disco_tpu_torch.scenes.batched` — B rooms × S sources × M mics
  simulated in one pass on the device (RIRs, convolution, SNR mixing, one
  STFT kernel launch, mask) and read back in one copy.
* :mod:`disco_tpu_torch.scenes.dynamic` — piecewise-stationary moving-source
  / moving-node scenes with crossfaded segment RIRs.
* :mod:`disco_tpu_torch.scenes.stream` — the SceneStream training feed
  (``batch_fn`` drives ``nn.training.fit``).

No reference counterpart: the reference simulates scenes one at a time on
the host (gen_disco/convolve_signals.py).
"""
from disco_tpu_torch.scenes.batched import (
    BATCH_QUANTUM,
    SceneBatch,
    draw_scene_batch,
    noise_gain_for_snr,
    scene_batch_bucket,
    simulate_scene_batch,
    synthetic_dry_pair,
)
from disco_tpu_torch.scenes.dynamic import (
    boundary_jumps,
    dynamic_scene_mixture,
    piecewise_trajectory,
    segment_weights,
)
from disco_tpu_torch.scenes.stream import SceneStream, unit_scene_batch

__all__ = [
    "BATCH_QUANTUM",
    "SceneBatch",
    "SceneStream",
    "boundary_jumps",
    "draw_scene_batch",
    "dynamic_scene_mixture",
    "noise_gain_for_snr",
    "piecewise_trajectory",
    "scene_batch_bucket",
    "segment_weights",
    "simulate_scene_batch",
    "synthetic_dry_pair",
    "unit_scene_batch",
]

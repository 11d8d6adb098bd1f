"""Seeded synthetic scenes, made on the device: the traffic's one generator.

A scene is the port's milestone scene (``disco_tpu_torch/milestones.py::
_scene``) written in torch: one white source, filtered at every mic by a
random FIR of ``fir_taps`` taps (a fixed, mic-specific spatial response),
plus spatially white noise scaled to the clip's SNR, drawn uniformly from the
mix's ``snr_db`` range (0-6 dB upstream, nfurnon/disco
``speech_enhancement/tango.py:37``), at the speech level ``speech_rms``.
The source talks in blocks of ``activity_block_s``, each one on with
probability ``activity_on`` (the first always), as speech pauses: speech and noise then differ
in time as well as in level, so that masks, even those of a CRNN with
random weights, weigh them apart and the filters' pencils are not
degenerate.

A pool of ``pool_batches`` distinct batches is made once in set-up and cycled
through in the window, so every seed gives the same sizes and the same work,
and only the values differ.
"""
from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    return gen


def batch_shape(cfg: dict, mix: dict) -> tuple[int, int, int, int]:
    """(B, K, C, L) of one batch."""
    return (mix["batch_clips"], cfg["nodes"], cfg["mics_per_node"],
            int(round(mix["clip_s"] * cfg["fs"])))


def make_batch(cfg: dict, mix: dict, gen: torch.Generator, device) -> torch.Tensor:
    """One batch: the (3, B, K, C, L) float32 stack of mixture, speech and
    noise."""
    B, K, C, L = batch_shape(cfg, mix)
    taps = mix["fir_taps"]
    src = torch.randn((B, 1, L + taps - 1), generator=gen, device=device)
    block = int(round(mix["activity_block_s"] * cfg["fs"]))
    n_blocks = -(-(L + taps - 1) // block)
    on = (torch.rand((B, 1, n_blocks), generator=gen, device=device) < mix["activity_on"])
    on[..., 0] = True                                      # every clip has a talker
    src = src * on.to(src.dtype).repeat_interleave(block, dim=-1)[..., :L + taps - 1]
    h = torch.randn((B, K * C, taps), generator=gen, device=device) * 0.5
    s = torch.zeros((B, K * C, L), device=device)
    for k in range(taps):                                  # a causal FIR, tap by tap
        s += h[:, :, k:k + 1] * src[:, :, taps - 1 - k: taps - 1 - k + L]
    noise = torch.randn((B, K * C, L), generator=gen, device=device)
    lo, hi = mix["snr_db"]
    snr = lo + (hi - lo) * torch.rand((B,), generator=gen, device=device)
    p_s = s.pow(2).mean((1, 2))
    p_n = noise.pow(2).mean((1, 2))
    gain_n = torch.sqrt(p_s / p_n * 10.0 ** (-snr / 10.0))
    level = mix["speech_rms"] / torch.sqrt(p_s)
    s = s * level[:, None, None]
    n = noise * (gain_n * level)[:, None, None]
    return torch.stack([s + n, s, n]).reshape(3, B, K, C, L).contiguous()


def make_pool(cfg: dict, mix: dict, gen: torch.Generator, device) -> list[torch.Tensor]:
    """``pool_batches`` distinct batches from ``gen``."""
    return [make_batch(cfg, mix, gen, device) for _ in range(mix["pool_batches"])]

"""Canonical scenario constants of the DISCO / MEETIT corpora (the port's
copy of ``disco_tpu/sim/defaults.py``).

These reproduce the hard-coded room/signal parameters of reference
``gen_disco/convolve_signals.py:361-369,377-401,404-409`` and
``gen_meetit/convolve_signals.py`` as one typed place (SURVEY.md §5.6: one
config tree replacing argparse + module constants + yaml)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoomDefaults:
    l_range: tuple = (3, 8)
    w_range: tuple = (3, 5)
    h_range: tuple = (2.5, 3)
    beta_range: tuple = (0.3, 0.6)  # RT60 seconds
    n_sensors_per_node: tuple = (4, 4, 4, 4)
    d_mw: float = 0.5
    d_mn: float = 0.05  # circular sub-array radius: 5 cm
    d_nn: float = 0.5
    d_rnd_mics: float = 1.0
    n_sources: int = 2
    d_ss: float = 0.5
    d_sn: float = 0.5
    d_sw: float = 0.5
    z_range_m: tuple = (0.7, 2)
    z_range_s: tuple = (1.20, 2)
    # Meeting/meetit extras (convolve_signals.py:370)
    r_range: tuple = (0.5, 1)
    d_nt_range: tuple = (0.05, 0.20)
    d_st_range: tuple = (0, 0.50)
    phi_ss_range: tuple = (np.pi / 8, 15 * np.pi / 8)
    max_order: int = 20  # ISM reflection order (convolve_signals.py:245)
    fs: int = 16000


@dataclasses.dataclass(frozen=True)
class SignalDefaults:
    """(convolve_signals.py:404-409)"""

    duration_range: tuple = (5, 10)
    var_tar_db: float = -23.0
    snr_dry_range: tuple = ((0, 0),)
    snr_cnv_range: tuple = (-10, 15)
    min_delta_snr: float = 0.0
    lead_silence_s: float = 1.0  # prepended second of silence (signal_setups.py:70)
    train_pad_s: float = 11.0  # train clips padded to 11 s (convolve_signals.py:275-279)


def make_setup(scenario: str, rng=None, **overrides):
    """Build the scenario's room sampler with the reference's per-scenario
    z-ranges (convolve_signals.py:377-401)."""
    from disco_tpu_torch.sim.geometry import (
        LivingRoomSetup,
        MeetingRoomSetup,
        MeetitSetup,
        RandomRoomSetup,
    )

    d = dataclasses.asdict(RoomDefaults())
    for k in ("max_order", "fs"):
        d.pop(k)
    d.update(overrides)
    common = dict(
        l_range=d["l_range"], w_range=d["w_range"], h_range=d["h_range"],
        beta_range=d["beta_range"], n_sensors_per_node=d["n_sensors_per_node"],
        d_mw=d["d_mw"], d_mn=d["d_mn"], d_nn=d["d_nn"], d_rnd_mics=d["d_rnd_mics"],
        n_sources=d["n_sources"], d_ss=d["d_ss"], d_sn=d["d_sn"], d_sw=d["d_sw"],
        rng=rng,
    )
    table = dict(
        r_range=d["r_range"], d_nt_range=d["d_nt_range"],
        d_st_range=d["d_st_range"], phi_ss_range=d["phi_ss_range"],
    )
    if scenario == "meeting":
        return MeetingRoomSetup(z_range_m=(0.7, 0.8), z_range_s=(1.15, 1.30), **table, **common)
    if scenario == "meetit":
        return MeetitSetup(z_range_m=(0.7, 0.8), z_range_s=(1.15, 1.30), **table, **common)
    if scenario == "living":
        return LivingRoomSetup(z_range_m=(0.7, 0.95), z_range_s=(1.20, 2), **common)
    if scenario == "random":
        return RandomRoomSetup(z_range_m=d["z_range_m"], z_range_s=d["z_range_s"], **common)
    raise ValueError(f"unknown scenario {scenario!r}")

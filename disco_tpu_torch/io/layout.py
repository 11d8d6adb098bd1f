"""The dataset file layout — the inter-layer contract of the reference (the
port's copy of ``disco_tpu/io/layout.py``: every path equal to the JAX
package's).

The reference's layers communicate through a conventional directory/naming
scheme rather than Python objects (SURVEY.md §1; reference
post_generator.py:133-166, dnn/utils.py:110-138, tango.py:75-110,
get_z_signals.py:324-359).  This module is the single source of truth for
those paths, so generated corpora are drop-in compatible both ways:

    {root}/{scenario}/{train|val|test}/
        wav_original/{dry,cnv}/{target,noise}/{rir}_S-{s}[_{noise}]_Ch-{c}.wav
        wav_processed/{snrdir}/{target,noise,mixture}/...
        stft_processed/{raw,normed/abs}/{snrdir}/{...}/...npy
        mask_processed/{snrdir}/{rir}_{noise}_Ch-{c}.npy
        stft_z/{zfile}/{raw,normed/abs}/{snrdir}/{zs_hat,zn_hat}/{rir}_{noise}_Node-{k}.npy
        log/snrs/dry/{snrdir}/{rir}_{noise}.npy
        log/infos/{rir}.npy
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path


def snr_dirname(snr_range) -> str:
    """'0-6'-style directory name from an SNR range (post_generator.py:66-68)."""
    return f"{snr_range[0]}-{snr_range[1]}"


@dataclasses.dataclass(frozen=True)
class DatasetLayout:
    """Path factory for one (root, scenario, case) corpus slice."""

    root: str
    scenario: str  # 'random' | 'living' | 'meeting' | 'meetit'
    case: str  # 'train' | 'val' | 'test'

    @property
    def base(self) -> Path:
        return Path(self.root) / self.scenario / self.case

    # -- wav_original (dataset generation output) --------------------------
    def wav_original(self, kind: str, source: str, rir: int, s: int, ch: int, noise: str | None = None) -> Path:
        """kind: 'dry'|'cnv'; source: 'target'|'noise'; 1-based source id ``s``
        and channel ``ch``; noise-type tag for noise files."""
        tag = f"{rir}_S-{s}" + (f"_{noise}" if noise else "") + f"_Ch-{ch}.wav"
        return self.base / "wav_original" / kind / source / tag

    def dry_source(self, source: str, rir: int, s: int, noise: str | None = None) -> Path:
        """Dry source wav — no channel suffix: {rir}_S-{s}[_{noise}].wav
        (convolve_signals.py:305-310)."""
        tag = f"{rir}_S-{s}" + (f"_{noise}" if noise else "") + ".wav"
        return self.base / "wav_original" / "dry" / source / tag

    def cnv_image(self, source: str, rir: int, s: int, ch: int, noise: str | None = None) -> Path:
        """Convolved image wav: {rir}_S-{s}[_{noise}]_Ch-{ch}.wav
        (convolve_signals.py:312-325)."""
        return self.wav_original("cnv", source, rir, s, ch, noise=noise)

    # -- wav_processed / stft_processed / mask_processed (mixing output) ---
    def wav_processed(self, snr_range, source: str, rir: int, ch: int, noise: str | None = None) -> Path:
        tag = f"{rir}" + (f"_{noise}" if noise else "") + f"_Ch-{ch}.wav"
        return self.base / "wav_processed" / snr_dirname(snr_range) / source / tag

    def stft_processed(self, snr_range, source: str, rir: int, ch: int, noise: str | None = None, normed: bool = False) -> Path:
        tag = f"{rir}" + (f"_{noise}" if noise else "") + f"_Ch-{ch}.npy"
        sub = ("normed", "abs") if normed else ("raw",)
        return self.base.joinpath("stft_processed", *sub, snr_dirname(snr_range), source, tag)

    def mask_processed(self, snr_range, rir: int, ch: int, noise: str) -> Path:
        return self.base / "mask_processed" / snr_dirname(snr_range) / f"{rir}_{noise}_Ch-{ch}.npy"

    # -- stft_z (compressed-signal exports for CRNN training) --------------
    def stft_z(self, zfile: str, snr_range, zsig: str, rir: int, node: int, noise: str, normed: bool = False) -> Path:
        """zsig: 'zs_hat' | 'zn_hat'; 1-based node index."""
        sub = ("normed", "abs") if normed else ("raw",)
        return self.base.joinpath(
            "stft_z", zfile, *sub, snr_dirname(snr_range), zsig, f"{rir}_{noise}_Node-{node}.npy"
        )

    # -- logs --------------------------------------------------------------
    def snr_log(self, snr_range, rir: int, noise: str) -> Path:
        return self.base / "log" / "snrs" / "dry" / snr_dirname(snr_range) / f"{rir}_{noise}.npy"

    def infos(self, rir: int) -> Path:
        return self.base / "log" / "infos" / f"{rir}.npy"

    def ensure_dir(self, path: Path) -> Path:
        os.makedirs(path.parent, exist_ok=True)
        return path


def case_of_rir(rir: int, n_samples=(10000, 1000, 1000)) -> str:
    """train/val/test split from a 1-based RIR id against cumulative sample
    counts (post_generator.py:49-64)."""
    cum = [sum(n_samples[: i + 1]) for i in range(len(n_samples))]
    assert 0 < rir <= cum[-1], f"rir should be between 1 and {cum[-1]}"
    return "train" if rir <= cum[0] else "val" if rir <= cum[1] else "test"

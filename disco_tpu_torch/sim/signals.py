"""Signal setups: pick, scale and VAD the source material for a scene (the
port's copy of ``disco_tpu/sim/signals.py``).

Capability parity with reference ``dataset_utils/signal_setups.py``
(``SpeechAndNoiseSetup:6``, ``InterferentSpeakersSetup:157``), host-side.
The list-based design survives: WAV files come from pre-shuffled lists so
parallel corpus shards never collide (signal_setups.py:9-12).

Differences by design: explicit ``numpy.random.Generator``; audio I/O
through ``disco_tpu_torch.io``; the VAD is ``core.masks.vad_oracle_batch``
run on a CPU tensor and handed back as numpy, as the JAX package evaluates
its VAD on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from disco_tpu_torch.core.masks import vad_oracle_batch
from disco_tpu_torch.core.sigproc import noise_from_signal, stack_talkers
from disco_tpu_torch.io import read_wav


def _vad(x):
    """The oracle VAD of a host waveform, as float32 numpy."""
    return vad_oracle_batch(torch.from_numpy(np.asarray(x, np.float32)), thr=0.001).numpy()


def normalize_to_var(signal, var_tar):
    """Scale so the VAD-active samples have variance ``var_tar``, then
    recompute the VAD (signal_setups.py:62-67).  Returns (signal, vad)."""
    vad = _vad(signal)
    active = signal[vad == 1]
    if active.size == 0:
        return signal, vad
    signal = signal * np.sqrt(var_tar / np.var(active))
    return signal, _vad(signal)


class SpeechAndNoiseSetup:
    """Target-speech + noise material picker (signal_setups.py:6-154)."""

    def __init__(
        self,
        target_list,
        talkers_list,
        noises_dict,
        duration_range,
        var_tar,
        snr_dry_range,
        snr_cnv_range,
        min_delta_snr,
        rng=None,
        read_fn=read_wav,
    ):
        self.target_list = list(target_list)
        self.ssn_list = list(talkers_list)
        self.noises_dict = {k: list(v) for k, v in noises_dict.items()}
        self.duration_range = duration_range
        self.target_duration = None
        self.var_tar = var_tar
        self.snr_dry_range = np.atleast_2d(np.asarray(snr_dry_range))
        self.snr_cnv_range = snr_cnv_range
        self.min_delta_snr = min_delta_snr
        self.source_snr = np.zeros(self.snr_dry_range.shape[0])
        self.rng = np.random.default_rng() if rng is None else rng
        self.read_fn = read_fn

    def get_target_segment(self, target_file):
        """Load, trim to max duration, variance-normalize over VAD-active
        samples, prepend 1 s of silence (signal_setups.py:42-73).

        Returns (signal, vad, fs); (None, None, fs) if shorter than the
        minimum duration — callers redraw (convolve_signals.py:229-233)."""
        min_dur, max_dur = self.duration_range
        signal, fs = self.read_fn(target_file)
        signal = np.asarray(signal, np.float64)[: int(max_dur * fs)]
        signal = signal - np.mean(signal)
        sig_duration = len(signal) / fs
        if sig_duration < min_dur:
            self.target_duration = sig_duration + 1
            return None, None, fs
        signal, vad = normalize_to_var(signal, self.var_tar)
        self.target_duration = sig_duration + 1
        return (
            np.concatenate((np.zeros(fs), signal)),
            np.concatenate((np.zeros(fs), vad)),
            fs,
        )

    def get_noise_segment(self, n_type, duration):
        """Noise material: a category from noises_dict, an interferent
        talker, or synthesized SSN (signal_setups.py:75-105).

        Returns (noise, file, start, vad, fs)."""
        fs = 16000
        if n_type.lower() in self.noises_dict:
            n, fs, n_file, n_start = self._read_random_signal(n_type.lower(), duration)
            vad = _vad(n) if n_type.lower() == "interferent_talker" else None
            return n, n_file, n_start, vad, fs
        if n_type == "SSN":
            tlk, fs, _ = stack_talkers(self.ssn_list, duration, None, nb_tlk=5, rng=self.rng, read_fn=self.read_fn)
            ssn = noise_from_signal(tlk, rng=self.rng)
            return ssn[: int(duration * fs)], None, None, None, fs
        raise ValueError(f"Unknown noise type {n_type!r}")

    def _read_random_signal(self, n_type, duration):
        """Random file + random circular start offset (signal_setups.py:107-138)."""
        assert duration > 0, "Duration should be strictly positive"
        noise_list = self.noises_dict[n_type]
        max_trials = max(100, 2 * len(noise_list))
        for _ in range(max_trials):
            pick = int(self.rng.integers(0, len(noise_list)))
            sig, fs = self.read_fn(noise_list[pick])
            if len(sig) / fs >= duration:
                start = int(len(sig) * self.rng.random())
                rolled = np.roll(sig, len(sig) - start)
                y = np.asarray(rolled[: int(duration * fs)], np.float64)
                return y - np.mean(y), fs, noise_list[pick], start
        raise ValueError(
            f"Failed to find a file lasting more than {duration} s. Please choose a shorter duration"
        )

    def get_random_dry_snr(self):
        """Per-source uniform SNR draw (signal_setups.py:140-154)."""
        lo = self.snr_dry_range[:, 0]
        hi = self.snr_dry_range[:, 1]
        self.source_snr = lo + (hi - lo) * self.rng.random(len(lo))
        return self.source_snr


class InterferentSpeakersSetup:
    """All sources are distinct interfering speakers
    (signal_setups.py:157-213).  Speaker identity is the third-from-last
    path component (the LibriSpeech `{speaker}/{chapter}/{utt}.wav` layout)."""

    def __init__(
        self,
        speakers_list,
        duration_range,
        var_tar,
        snr_dry_range,
        snr_cnv_range,
        min_delta_snr,
        rng=None,
        read_fn=read_wav,
    ):
        self.speakers_list = list(speakers_list)
        self.duration_range = duration_range
        self.speakers_ids, self.speakers_files = [], []
        self.var_tar = var_tar
        self.snr_dry_range = np.atleast_2d(np.asarray(snr_dry_range))
        self.snr_cnv_range = snr_cnv_range
        self.min_delta_snr = min_delta_snr
        self.source_snr = np.zeros(self.snr_dry_range.shape[0])
        self.fs = None
        self.rng = np.random.default_rng() if rng is None else rng
        self.read_fn = read_fn

    def reset(self):
        """Forget used speakers (new room)."""
        self.speakers_ids, self.speakers_files = [], []

    def get_signal(self, duration):
        """A normalized segment from a speaker not yet used in this room
        (signal_setups.py:175-213).  Returns (signal, vad)."""
        assert duration > 0, "Duration should be strictly positive"
        max_trials = 100
        for _ in range(max_trials):
            pick = str(self.rng.choice(self.speakers_list))
            speaker_id = pick.split("/")[-3]
            if speaker_id in self.speakers_ids:
                continue
            sig, fs = self.read_fn(pick)
            if len(sig) / fs < duration:
                continue
            y = np.asarray(sig[: int(duration * fs)], np.float64)
            y -= np.mean(y)
            y, vad = normalize_to_var(y, self.var_tar)
            self.speakers_ids.append(speaker_id)
            self.speakers_files.append(pick)
            self.fs = fs
            return y, vad
        raise ValueError(
            f"Failed to find an unused speaker with >= {duration} s of audio"
        )

"""The mixing pass: target + noise at a random SNR -> STFTs, ideal masks,
saved representations (counterpart of ``disco_tpu/datagen/postgen.py``;
reference ``dataset_utils/post_generator.py``, ``PostGenerator:9``).

Per RIR the 16 channels of the target, the noise and the mixture are each
one (16, L) stack through the STFT — three launches of the STFT kernel
(``csrc/stft.cu``) on the card — the ideal masks are computed on the
device, and the spectra and masks cross to the host in one copy
(``device.to_host``).  Every file is written atomically, in the JAX
package's layout and order; an RIR whose SNR log exists is skipped.
"""
from __future__ import annotations

import glob

import numpy as np
import torch

from disco_tpu_torch.core.dsp import stft
from disco_tpu_torch.core.masks import tf_mask
from disco_tpu_torch.device import resolve_device, to_host
from disco_tpu_torch.io.atomic import save_npy_atomic, write_wav_atomic
from disco_tpu_torch.io.audio import read_wav
from disco_tpu_torch.io.layout import DatasetLayout, case_of_rir, snr_dirname


class PostGenerator:
    """Mix, transform and save one RIR range (post_generator.py:9-166).
    ``device``: ``"cuda"`` when None (RuntimeError without a CUDA device),
    or ``"cpu"`` for the plain versions."""

    def __init__(
        self,
        rir_start,
        nb_rir,
        scene,
        noise,
        snr_range,
        path_to_dataset,
        n_fft=512,
        n_hop=256,
        mask_type="irm1",
        save_target=True,
        n_samples=None,
        rng=None,
        device=None,
    ):
        self.rir_start = rir_start
        self.nb_rir = nb_rir
        self.save_target = save_target
        self.scene = scene
        self.noise = noise
        self.snr_range = np.asarray(snr_range)
        self.path_dataset = path_to_dataset
        self.n_fft = n_fft
        self.n_hop = n_hop
        self.mask_type = mask_type
        self.snr_out = np.zeros((nb_rir, 1))
        self.n_samples = n_samples if n_samples is not None else (10000, 1000, 1000)
        self.case = self._get_dset()
        self.rng = np.random.default_rng() if rng is None else rng
        self.device = resolve_device(device)
        # Hard-coded corpus constants (post_generator.py:52-56)
        self.fs = 16000
        self.ch_per_node = [4, 4, 4, 4]
        self.n_ch = sum(self.ch_per_node)
        self.n_nodes = len(self.ch_per_node)
        self.layout = DatasetLayout(path_to_dataset, scene, self.case)

    def _get_dset(self):
        """train/val/test from the RIR range; both ends must fall in the same
        split (post_generator.py:58-64)."""
        first = case_of_rir(self.rir_start, self.n_samples)
        last = case_of_rir(self.rir_start + self.nb_rir - 1, self.n_samples)
        assert first == last, "First and last RIRs do not belong to the same set."
        return first

    @property
    def snr_dir(self):
        return snr_dirname(self.snr_range)

    def post_process(self):
        """Idempotent per-RIR mixing pass (post_generator.py:70-84); returns
        the RIRs processed."""
        done = []
        for rir in range(self.rir_start, self.rir_start + self.nb_rir):
            if self.layout.snr_log(self.snr_range, rir, self.noise).exists():
                continue
            tar_list, noi_list = self.get_sig_lists(rir)
            tars, nois, mixs, snr = self.mix_sigs(tar_list, noi_list)
            self.snr_out[rir - self.rir_start, 0] = snr
            specs = [stft(torch.as_tensor(a, device=self.device), self.n_fft, self.n_hop)
                     for a in (tars, nois, mixs)]
            masks = tf_mask(specs[0], specs[1], self.mask_type)
            tars_stft, nois_stft, mixs_stft, masks = to_host(specs + [masks])
            self.save_data(tars, nois, mixs, tars_stft, nois_stft, mixs_stft, masks, rir)
            done.append(rir)
        return done

    def get_sig_lists(self, rir):
        """Channel-sorted convolved-wav lists for one RIR
        (post_generator.py:86-97)."""
        base = self.layout.base / "wav_original" / "cnv"
        tar = sorted(
            glob.glob(str(base / "target" / f"{rir}_S-1_Ch-*.wav")),
            key=lambda p: int(p.split("_Ch-")[-1].split(".wav")[0]),
        )
        noi = sorted(
            glob.glob(str(base / "noise" / f"{rir}_S-2_{self.noise}_Ch-*.wav")),
            key=lambda p: int(p.split("_Ch-")[-1].split(".wav")[0]),
        )
        return tar, [noi]

    def mix_sigs(self, tar_list, noi_list):
        """One random SNR for all channels and noises (post_generator.py:99-115)."""
        snr = self.snr_range[0] + (self.snr_range[1] - self.snr_range[0]) * self.rng.random()
        tars, nois, mixs = [], [], []
        for ch in range(self.n_ch):
            tar, _ = read_wav(tar_list[ch])
            noi_sum = np.zeros(len(tar))
            for group in noi_list:
                noi, _ = read_wav(group[ch])
                noi_sum[: len(noi)] += noi * 10 ** (-snr / 20)
            tars.append(tar)
            nois.append(noi_sum)
            mixs.append(tar + noi_sum)
        return (np.array(tars, np.float32), np.array(nois, np.float32),
                np.array(mixs, np.float32), snr)

    def save_data(self, s, n, m, ss, ns, ms, masks, rir):
        """Write wav_processed / stft_processed{raw, normed/abs} /
        mask_processed / snr log (post_generator.py:133-166)."""
        lay = self.layout
        for ch in range(s.shape[0]):
            c = ch + 1
            if self.save_target:
                p = lay.wav_processed(self.snr_range, "target", rir, c)
                write_wav_atomic(lay.ensure_dir(p), s[ch], self.fs)
            for kind, sig in (("noise", n[ch]), ("mixture", m[ch])):
                p = lay.wav_processed(self.snr_range, kind, rir, c, noise=self.noise)
                write_wav_atomic(lay.ensure_dir(p), sig, self.fs)
            if self.save_target:
                p = lay.stft_processed(self.snr_range, "target", rir, c)
                save_npy_atomic(lay.ensure_dir(p), ss[ch])
            for kind, spec in (("noise", ns[ch]), ("mixture", ms[ch])):
                p = lay.stft_processed(self.snr_range, kind, rir, c, noise=self.noise)
                save_npy_atomic(lay.ensure_dir(p), spec)
            p = lay.stft_processed(self.snr_range, "mixture", rir, c, noise=self.noise, normed=True)
            save_npy_atomic(lay.ensure_dir(p), np.abs(ms[ch]))
            p = lay.mask_processed(self.snr_range, rir, c, self.noise)
            save_npy_atomic(lay.ensure_dir(p), masks[ch])
        p = lay.snr_log(self.snr_range, rir, self.noise)
        save_npy_atomic(lay.ensure_dir(p), self.snr_out[rir - self.rir_start])

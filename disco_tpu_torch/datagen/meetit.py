"""MEETIT dataset generation: N interfering speakers facing N nodes
(source separation, ICASSP 2021 setup; counterpart of
``disco_tpu/datagen/meetit.py``).

Capability parity with reference ``dataset_generation/gen_meetit/
convolve_signals.py`` (get_value_range:43, sir_at_node:81,
check_sir_validity:94, simulate_room:114, get_masks:166, save_data:191,
__main__:210): the RIRs from the batched image-source model and all
source×mic convolutions on the device, read back in one copy; per-node
per-source IRMs from ONE launch of the STFT kernel (``csrc/stft.cu``) over
all (source, mic) images, computed on the device and read back in one copy
(the reference's ``get_masks`` uses the broken ``my_stft`` — implemented
working here).

SIR accounting: the reference measures SIR with mir_eval's bss_eval on
(mixture, mixture) estimates, which reduces to the energy ratio of the
projections; here the SIR at a node is the scale-invariant SIR of the
mixture against the local target (``si_bss``), averaged over the node's
mics — same quantity, owned implementation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from disco_tpu_torch.core.dsp import stft
from disco_tpu_torch.core.masks import tf_mask
from disco_tpu_torch.core.metrics import si_bss
from disco_tpu_torch.device import resolve_device, to_host
from disco_tpu_torch.io import DatasetLayout, write_wav
from disco_tpu_torch.io.atomic import save_npy_atomic
from disco_tpu_torch.sim import RoomSetup, fft_convolve, rir_length_for, shoebox_rirs


def get_value_range(i_rir, n_rirs, vmin=0, vmax=20, n_bins=5):
    """Linear bin of the value range for this RIR index (gen_meetit:43-57)."""
    i_bin = i_rir // (n_rirs / n_bins)
    d = vmax - vmin
    return np.array([vmin + i_bin * d / n_bins, vmin + (i_bin + 1) * d / n_bins])


def sir_at_node(s, n):
    """Mean over the node's mics of the mixture's SIR against the local
    target (gen_meetit:81-92)."""
    sirs = np.zeros(s.shape[0])
    for i in range(s.shape[0]):
        m = s[i] + n[i]
        _, sir, _ = si_bss(m, np.stack([s[i], n[i]], axis=1), 0)
        sirs[i] = sir
    return np.mean(sirs)


def sir_histogram(past_sirs_first, n_classes=4, vmin=2, vmax=14):
    """Counts per SIR class over the first-node SIRs of past rooms (the
    plt.hist trick of gen_meetit:107, without matplotlib)."""
    edges = np.linspace(vmin, vmax, n_classes + 1)
    return np.histogram(np.asarray(past_sirs_first), bins=edges)[0], edges


def check_sir_validity(current_sirs, past_sirs, bin_level, delta_sir=2, n_classes=4, vmin=2, vmax=14):
    """Balance the SIR histogram across classes and reject inter-node SIR
    spreads above ``delta_sir`` (gen_meetit:94-111)."""
    current_sirs = np.asarray(current_sirs)
    for shift in range(1, len(current_sirs)):
        if np.any((current_sirs - np.roll(current_sirs, shift)) > delta_sir):
            return False
    if current_sirs[0] < vmin or current_sirs[0] > vmax:
        return False
    counts, edges = sir_histogram([p[0] for p in past_sirs] if past_sirs else [], n_classes, vmin, vmax)
    bin_index = min(int(np.searchsorted(edges, current_sirs[0], side="right")) - 1, n_classes - 1)
    return counts[bin_index] < bin_level


@dataclasses.dataclass
class MeetitScene:
    setup: RoomSetup
    rirs: np.ndarray  # (n_sources, n_mics, R)
    sources: np.ndarray  # (n_sources, L) dry
    images: np.ndarray  # (n_sources, n_mics, L)
    sirs: np.ndarray  # (n_nodes,)


def simulate_meetit_room(
    room_cfg: RoomSetup,
    signal_setup,
    dset: str,
    mics_per_node,
    past_sirs,
    n_rirs_per_proc: int,
    max_order: int = 20,
    fs: int = 16000,
    rng=None,
    sir_vmin: float = 2.0,
    sir_vmax: float = 14.0,
    n_sir_classes: int = 4,
    device=None,
):
    """One meeting room with n_sources == n_nodes interfering speakers
    (gen_meetit:114-163): the RIRs and images on ``device`` (``"cuda"`` when
    None, RuntimeError without a CUDA device; ``"cpu"`` for the host), read
    back in one copy, then the host's SIR gate.  Returns a MeetitScene or
    "redraw_room_setup".

    The default SIR gate reproduces the reference's four 3-dB classes
    2-5 / 5-8 / 8-11 / 11-14 (gen_meetit:150-152)."""
    rng = np.random.default_rng() if rng is None else rng
    n_sources = len(room_cfg.source_positions)
    rnd_dur = signal_setup.duration_range[0] + (
        signal_setup.duration_range[1] - signal_setup.duration_range[0]
    ) * rng.random()

    signal_setup.reset()
    sigs = []
    for _ in range(n_sources):
        sig, _vad = signal_setup.get_signal(duration=rnd_dur)
        sigs.append(sig)
    L = min(len(s) for s in sigs)
    sources = np.stack([np.asarray(s[:L], np.float32) for s in sigs])

    rir_len = rir_length_for(room_cfg.beta, fs=fs)
    rirs_d = shoebox_rirs(
        np.asarray(room_cfg.room_dim, np.float32),
        np.asarray(room_cfg.source_positions, np.float32),
        np.asarray(room_cfg.mic_positions.T, np.float32),
        float(room_cfg.alpha), max_order=max_order, rir_len=rir_len, fs=fs, device=device,
    )
    images_d = fft_convolve(sources[:, None, :], rirs_d, out_len=L)  # (S, M, L)
    rirs, images = to_host([rirs_d, images_d])

    bounds = node_channel_bounds(mics_per_node)
    sirs = np.zeros(len(mics_per_node))
    for src in range(n_sources):
        local_target = images[src, bounds[src] : bounds[src + 1]]
        others = [j for j in range(n_sources) if j != src]
        local_noise = images[others, bounds[src] : bounds[src + 1]].sum(0)
        sirs[src] = sir_at_node(local_target, local_noise)

    bin_level = int(np.ceil(n_rirs_per_proc / n_sir_classes))
    if not check_sir_validity(
        sirs, past_sirs, bin_level, n_classes=n_sir_classes, vmin=sir_vmin, vmax=sir_vmax
    ):
        return "redraw_room_setup"

    if dset in ("train", "val"):
        len_max = int(signal_setup.duration_range[-1] * fs)
        pad = max(len_max - images.shape[-1], 0)
        images = np.pad(images, ((0, 0), (0, 0), (0, pad)))[:, :, :len_max]

    return MeetitScene(setup=room_cfg, rirs=rirs, sources=sources, images=images, sirs=sirs)


def get_masks(images, mics_per_node, device=None):
    """Per-node mixtures and per-source IRMs at every channel
    (gen_meetit:166-189), batched: one STFT kernel launch over all
    (sources, mics) images on ``device`` (``"cuda"`` when None,
    RuntimeError without a CUDA device; ``"cpu"`` for the plain STFT), the
    mixture and the masks there, one copy back.

    Returns numpy (mix_stfts (M, F, T), masks (n_sources, M, F, T))."""
    S = stft(torch.as_tensor(np.asarray(images, np.float32), device=resolve_device(device)))
    mix = S.sum(0)  # (M, F, T)
    masks = torch.stack([tf_mask(S_s, mix - S_s, "irm1") for S_s in S])
    mix, masks = to_host([mix, masks])
    return mix, masks


def save_meetit_scene(scene: MeetitScene, infos, rir_id, layout: DatasetLayout, fs=16000):
    """wav/clean/{dry,cnv} layout of the MEETIT corpus (gen_meetit:191-207)."""
    base = layout.base
    for i_s in range(len(scene.sources)):
        p = base / "wav" / "clean" / "dry" / f"{rir_id}_S-{i_s + 1}.wav"
        layout.ensure_dir(p)
        write_wav(p, scene.sources[i_s], fs)
        for ch in range(scene.images.shape[1]):
            p = base / "wav" / "clean" / "cnv" / f"{rir_id}_S-{i_s + 1}_Ch-{ch + 1}.wav"
            layout.ensure_dir(p)
            write_wav(p, scene.images[i_s, ch], fs)
    # infos is written LAST: it doubles as the idempotency marker, so a
    # crash mid-save leaves a restartable (not silently-skipped) RIR.
    info_path = layout.infos(rir_id)
    layout.ensure_dir(info_path)
    # atomic: a crash mid-save must leave the marker absent, not truncated
    save_npy_atomic(info_path, infos, allow_pickle=True)


def generate_meetit_rirs(
    n_sources: int,
    dset: str,
    rir_start: int,
    n_rirs: int,
    signal_setup,
    layout: DatasetLayout,
    rng=None,
    max_order: int = 20,
    fs: int = 16000,
    max_redraws: int = 200,
    device=None,
):
    """The per-RIR-range MEETIT generation driver (gen_meetit:210-302):
    idempotent per RIR, SIR-histogram-balanced redraw loop, node count ==
    source count.  ``device``: where the RIRs, convolutions and masks run,
    ``"cuda"`` when None (RuntimeError without a CUDA device), or ``"cpu"``.
    Returns the list of RIR ids actually generated."""
    from disco_tpu_torch.sim import make_setup

    device = resolve_device(device)
    rng = np.random.default_rng() if rng is None else rng
    mics_per_node = [4] * n_sources
    sampler = make_setup("meetit", rng=rng, n_sensors_per_node=tuple(mics_per_node), n_sources=n_sources)
    generated, past_sirs = [], []

    for rir_id in range(rir_start, rir_start + n_rirs):
        if layout.infos(rir_id).exists():
            continue  # idempotency guard (gen_meetit:272, SURVEY.md §5.3)
        scene = None
        for _ in range(max_redraws):
            cfg = sampler.create_room_setup()
            out = simulate_meetit_room(
                cfg, signal_setup, dset, mics_per_node,
                past_sirs=past_sirs, n_rirs_per_proc=n_rirs,
                max_order=max_order, fs=fs, rng=rng, device=device,
            )
            if out == "redraw_room_setup":
                continue
            scene = out
            break
        if scene is None:
            raise RuntimeError(f"RIR {rir_id}: no valid room after {max_redraws} redraws")
        past_sirs.append(scene.sirs)
        infos = {
            "room": {
                "length": float(scene.setup.room_dim[0]),
                "width": float(scene.setup.room_dim[1]),
                "height": float(scene.setup.room_dim[2]),
                "alpha": scene.setup.alpha,
                "rt60": scene.setup.beta,
            },
            "mics": np.asarray(scene.setup.mic_positions),
            "sources": np.asarray(scene.setup.source_positions),
            "sirs": scene.sirs,
        }
        # masks/STFTs first, then save_meetit_scene (whose infos write is the
        # idempotency marker) — a crash mid-RIR stays restartable.
        mix, masks = get_masks(scene.images, mics_per_node, device=device)
        for ch in range(mix.shape[0]):
            p = layout.base / "stft" / "mix" / f"{rir_id}_Ch-{ch + 1}.npy"
            layout.ensure_dir(p)
            save_npy_atomic(p, mix[ch].astype("complex64"))
            for i_s in range(masks.shape[0]):
                p = layout.base / "mask" / f"{rir_id}_S-{i_s + 1}_Ch-{ch + 1}.npy"
                layout.ensure_dir(p)
                save_npy_atomic(p, masks[i_s, ch].astype("float32"))
        save_meetit_scene(scene, infos, rir_id, layout, fs=fs)
        generated.append(rir_id)
    return generated


def node_channel_bounds(mics_per_node) -> np.ndarray:
    """Cumulative channel offsets per node: node k's channels are
    ``bounds[k]..bounds[k+1]-1`` (1-based file channel = offset + 1), and its
    reference mic is the first — THE mapping shared by the sample loader and
    every consumer scoring against per-channel artifacts."""
    return np.concatenate([[0], np.cumsum(mics_per_node)])


def load_meetit_sample(layout: DatasetLayout, rir_id: int, mics_per_node):
    """Load one generated MEETIT sample back from disk: the per-channel
    mixture STFTs and per-source IRMs written by :func:`generate_meetit_rirs`,
    shaped for :func:`disco_tpu_torch.enhance.separation.separate_with_masks`.

    Returns (Y (K, C, F, T) complex64 node-major mixture STFTs,
             masks (n_src, K, F, T) float32 at each node's reference mic).
    """
    base = layout.base
    M = int(np.sum(mics_per_node))
    mix = np.stack([np.load(base / "stft" / "mix" / f"{rir_id}_Ch-{ch + 1}.npy") for ch in range(M)])
    n_src = len(mics_per_node)
    bounds = node_channel_bounds(mics_per_node)
    K = len(mics_per_node)
    Y = np.stack([mix[bounds[k] : bounds[k + 1]] for k in range(K)])  # (K, C, F, T)
    masks = np.stack(
        [
            np.stack([np.load(base / "mask" / f"{rir_id}_S-{s + 1}_Ch-{bounds[k] + 1}.npy") for k in range(K)])
            for s in range(n_src)
        ]
    )  # (n_src, K, F, T) — ref mic of each node
    return Y.astype("complex64"), masks.astype("float32")

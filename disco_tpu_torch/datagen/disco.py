"""DISCO dataset generation: room simulation + convolution + SNR gating
(counterpart of ``disco_tpu/datagen/disco.py``).

Capability parity with reference ``dataset_generation/gen_disco/
convolve_signals.py`` (mix_signals:84, get_convolved_vads:102,
reverb_other_noises:118, snr_at_mics:170, simulate_room:216, save_data:285,
__main__:329):

* RIRs come from the batched image-source model
  (``disco_tpu_torch.sim.shoebox_rirs``) instead of pyroomacoustics' libroom,
* all source->mic convolutions are ONE batched FFT convolution on the
  device instead of ``room.simulate`` + per-channel ``np.convolve`` loops;
  the device half of a scene (or of a chunk of scenes in the batched
  driver) crosses to the host in one ``device.to_host`` copy,
* geometry/SNR rejection sampling stays host-side (data-dependent control
  flow), with the reference's sentinel protocol ("redraw_source_signal" /
  "redraw_room_setup") and bounded retries; the host draws are the JAX
  package's, draw for draw,
* per-RIR idempotency guards and deterministic per-scene reseeding keep the
  corpus-scale jobs restartable and process-parallel.

Both drivers record the ``warning`` of temp litter removed on resume and
the ``run_resume`` event of a verified resume; the batched driver one
``scene`` event (stage ``datagen``) per chunk.

The reference's ``simulate_room`` calls ``signal_setup.get_signal(n_type=
"SSN", ...)`` which does not exist on SpeechAndNoiseSetup (its method is
``get_noise_segment``, SURVEY.md §7 defect list) — the evident intent is
implemented here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from disco_tpu_torch.core.masks import vad_oracle_batch
from disco_tpu_torch.core.metrics import fw_snr
from disco_tpu_torch.core.sigproc import increase_to_snr
from disco_tpu_torch.device import resolve_device, to_host
from disco_tpu_torch.io import DatasetLayout
from disco_tpu_torch.io.atomic import atomic_write, probe_npy, save_npy_atomic, write_wav_atomic
from disco_tpu_torch.sim import (
    RoomSetup,
    fft_convolve,
    rir_bucket,
    shoebox_rirs,
    shoebox_rirs_batched,
)


@dataclasses.dataclass
class SimulatedScene:
    """One simulated room: everything the mixing/saving passes need."""

    setup: RoomSetup
    rirs: np.ndarray  # (n_sources, n_mics, rir_len)
    sources: np.ndarray  # list of dry source signals (object array / list)
    images: np.ndarray  # (n_sources, n_mics, T) reverberated per-source images
    target_vad: np.ndarray  # dry-target VAD
    image_vads: np.ndarray  # (n_mics, T) VADs of the target images
    snr_images: np.ndarray  # per-mic fw-SNR


def get_convolved_vads(x: np.ndarray) -> np.ndarray:
    """Oracle VAD per image channel (convolve_signals.py:102-115), on the
    host (a CPU tensor per channel) as the JAX package evaluates it."""
    return np.stack(
        [vad_oracle_batch(torch.from_numpy(np.asarray(x[i], np.float32)), thr=0.001).numpy()
         for i in range(x.shape[0])]
    )


def snr_at_mics(s, n, mics_per_node, fs=16000, vad_s=None, vad_n=None):
    """Per-mic fw-SNR, per-node means, min inter-node |ΔSNR|
    (convolve_signals.py:170-213)."""
    n_mic = s.shape[0]
    bounds = np.concatenate([[0], np.cumsum(mics_per_node)])
    n_nodes = len(mics_per_node)
    snrs = np.zeros(n_mic)
    for i in range(n_mic):
        vs = None if vad_s is None else vad_s[i]
        vn = None if vad_n is None else vad_n[i]
        snrs[i] = fw_snr(s[i], n[i], fs=fs, vad_tar=vs, vad_noi=vn)[1]
    nodes_snr = np.array([np.mean(snrs[bounds[k] : bounds[k + 1]]) for k in range(n_nodes)])
    deltas = [
        nodes_snr[i] - nodes_snr[j] for i in range(n_nodes) for j in range(i + 1, n_nodes)
    ]
    return snrs, nodes_snr, np.min(np.abs(deltas))


def simulate_scene(
    room_cfg: RoomSetup,
    signal_setup,
    i_target_file: int,
    dset: str,
    mics_per_node,
    max_order: int = 20,
    fs: int = 16000,
    device=None,
):
    """Simulate one two-source scene (target + SSN noise source)
    (convolve_signals.py:216-282): the RIRs and images on ``device``
    (``"cuda"`` when None, RuntimeError without a CUDA device; ``"cpu"``
    for the host), read back in one copy, then the host's SNR gate.

    Returns a :class:`SimulatedScene`, or the sentinel strings
    "redraw_source_signal" / "redraw_room_setup".
    """
    target_file = signal_setup.target_list[i_target_file]
    target, target_vad, fs_t = signal_setup.get_target_segment(target_file)
    if target is None:
        return "redraw_source_signal"

    noise, _, _, noise_vad, _ = signal_setup.get_noise_segment("SSN", signal_setup.target_duration)
    noise = increase_to_snr(
        target, noise, signal_setup.source_snr[0],
        weight=True, vad_tar=target_vad, vad_noi=noise_vad, fs=fs,
    )

    # RIRs for both sources to all mics, and the images, on the device; the
    # bucket comes from the ONE canonical policy (sim.ism.rir_bucket), so
    # the per-scene and batched paths never disagree on sizing.
    max_order, rir_len = rir_bucket(room_cfg.beta, room_cfg.room_dim,
                                    max_order=max_order, fs=fs)
    srcs = np.asarray(room_cfg.source_positions[:2], np.float32)
    mics = np.asarray(room_cfg.mic_positions.T, np.float32)  # (M, 3)
    rirs_d = shoebox_rirs(
        np.asarray(room_cfg.room_dim, np.float32), srcs, mics,
        float(room_cfg.alpha), max_order=max_order, rir_len=rir_len, fs=fs,
        device=device,
    )

    # Per-source images: broadcast each dry signal over its (M, R) RIRs.
    L = len(target)
    sig_stack = np.zeros((2, L), np.float32)
    sig_stack[0] = target
    sig_stack[1, : len(noise)] = noise[:L]
    images_d = fft_convolve(sig_stack[:, None, :], rirs_d, out_len=L)  # (2, M, L)
    rirs, images = to_host([rirs_d, images_d])

    image_vads = get_convolved_vads(images[0])
    snr_images, snr_nodes, snr_diff = snr_at_mics(
        images[0], images[1], mics_per_node, fs, vad_s=image_vads
    )

    lo, hi = signal_setup.snr_cnv_range
    if not (np.all(lo < snr_nodes) and np.all(snr_nodes < hi) and signal_setup.min_delta_snr < snr_diff):
        return "redraw_room_setup"

    if dset == "train":
        # Pad/truncate train clips to the fixed corpus length
        # (convolve_signals.py:275-279).
        len_max = int((signal_setup.duration_range[-1] + 1) * fs)
        pad = max(len_max - images.shape[-1], 0)
        images = np.pad(images, ((0, 0), (0, 0), (0, pad)))[:, :, :len_max]

    return SimulatedScene(
        setup=room_cfg,
        rirs=rirs,
        sources=sig_stack,
        images=images,
        target_vad=target_vad,
        image_vads=image_vads,
        snr_images=snr_images,
    )


def reverb_other_noises(scene: SimulatedScene, signal_setup, dset="train", fs=16000,
                        max_snr_err=1.0, device=None):
    """Convolve additional noise types (freesound / interferent talker) with
    the noise-source RIRs already computed (convolve_signals.py:118-167),
    with the fw-SNR-checked retry loop on the host, then every convolution
    on ``device`` (``"cuda"`` when None; ``"cpu"`` for the host) and one
    copy back.

    Returns (dry noises, reverberated noises (n_noi, M, T), files, starts).
    """
    noise_names = [k for k in signal_setup.noises_dict.keys()]
    target = scene.sources[0]
    target_duration = len(target) / fs
    if dset in ("train", "val"):
        len_max = int((signal_setup.duration_range[-1] + 1) * fs)
    else:
        len_max = scene.image_vads.shape[-1]

    n_noi = len(noise_names)
    M = scene.rirs.shape[1]
    dry = np.zeros((n_noi, len(target)))
    reverbed = np.zeros((n_noi, M, len_max), np.float32)
    files, starts = [], np.zeros(n_noi)

    drawn = []
    for i, name in enumerate(noise_names):
        for _ in range(100):
            n, n_file, n_start, vad_n, _ = signal_setup.get_noise_segment(name, target_duration)
            n = increase_to_snr(
                target, n, signal_setup.source_snr[0],
                weight=True, vad_tar=scene.target_vad, vad_noi=vad_n, fs=fs,
            )
            snr_check = fw_snr(target, n, fs, vad_tar=scene.target_vad, vad_noi=vad_n, clipping=True)[1]
            if abs(snr_check - signal_setup.source_snr[0]) < max_snr_err:
                break
        dry[i, : len(n)] = n
        drawn.append(n)
        files.append(n_file)
        starts[i] = -1 if n_start is None else n_start
    if drawn:
        outs = to_host([fft_convolve(np.asarray(n, np.float32)[None, :], scene.rirs[1],
                                     out_len=min(len_max, len(n)), device=device)
                        for n in drawn])
        for i, out in enumerate(outs):
            reverbed[i, :, : out.shape[-1]] = out[:, :len_max]
    return dry, reverbed, files, starts


# File-name tags per noise type (convolve_signals.py:306 uses positional
# ['', '_ssn', '_it', '_fs']; deriving from the type name is robust to the
# dict ordering).
_NOISE_TAGS = {"ssn": "_ssn", "interferent_talker": "_it", "it": "_it", "freesound": "_fs", "fs": "_fs"}


def noise_tag(name: str) -> str:
    """Canonical filename tag for a noise kind."""
    return _NOISE_TAGS.get(name.lower(), f"_{name.lower()}")


def save_scene(
    scene: SimulatedScene, extra_dry, extra_reverbed, infos, rir_id,
    layout: DatasetLayout, fs=16000, extra_names=(),
):
    """Write the per-RIR corpus files in the reference layout
    (convolve_signals.py:285-326): dry sources, convolved images, extra
    noises, infos log.

    All writes are atomic (``disco_tpu_torch.io.atomic``) and the infos log —
    the scene's completion marker, written LAST — lands only after every
    wav it describes, so the validated idempotency guard in
    :func:`generate_disco_rirs` can trust a complete infos file.

    Returns the list of written artifact paths (what a run ledger digests
    into the scene's ``done`` record)."""
    tags = [None, "ssn"] + [noise_tag(n).lstrip("_") for n in extra_names]
    kinds = ["target", "noise"]
    written = []
    # Dry sources (target, SSN)
    for i_s, sig in enumerate(scene.sources):
        p = layout.dry_source(kinds[i_s], rir_id, i_s + 1, noise=tags[i_s])
        written.append(write_wav_atomic(p, np.asarray(sig, np.float32), fs))
    # Extra dry noises (S-2 with their tag)
    for i_n in range(len(extra_dry)):
        p = layout.dry_source("noise", rir_id, 2, noise=tags[i_n + 2])
        written.append(write_wav_atomic(p, np.asarray(extra_dry[i_n], np.float32), fs))
    # Convolved images
    for i_s in range(len(scene.images)):
        for ch in range(scene.images.shape[1]):
            p = layout.cnv_image(kinds[i_s], rir_id, i_s + 1, ch + 1, noise=tags[i_s])
            written.append(write_wav_atomic(p, scene.images[i_s, ch], fs))
    for i_n in range(len(extra_reverbed)):
        for ch in range(extra_reverbed.shape[1]):
            p = layout.cnv_image("noise", rir_id, 2, ch + 1, noise=tags[i_n + 2])
            written.append(write_wav_atomic(p, extra_reverbed[i_n, ch], fs))
    written.append(save_npy_atomic(layout.infos(rir_id), infos, allow_pickle=True))
    return written


def generate_disco_rirs(
    scenario: str,
    dset: str,
    rir_start: int,
    n_rirs: int,
    signal_setup,
    layout: DatasetLayout,
    rng=None,
    max_order: int = 20,
    fs: int = 16000,
    max_redraws: int = 50,
    ledger=None,
    resume: bool = False,
    device=None,
):
    """The per-RIR-range generation driver (convolve_signals.py:418-448):
    idempotent, restartable, sentinel-driven redraw loop.  ``device``: where
    the RIRs and convolutions run, ``"cuda"`` when None (RuntimeError
    without a CUDA device), or ``"cpu"``.

    Crash safety (``disco_tpu_torch.runs``): every scene artifact is written
    atomically with the infos log last, and the idempotency guard
    *validates* the infos file (integrity probe) instead of trusting bare
    existence — a scene whose datagen run crashed mid-save is regenerated.
    ``ledger``/``resume`` add per-scene digest records with verified
    resume; a graceful SIGTERM/SIGINT stop finishes the current scene and
    returns early, resumable.

    Returns the list of RIR ids actually generated (existing ones skipped).
    """
    from disco_tpu_torch.io.atomic import remove_tmp_litter
    from disco_tpu_torch.obs import events as obs_events
    from disco_tpu_torch.runs import chaos as run_chaos
    from disco_tpu_torch.runs import interrupt as run_interrupt
    from disco_tpu_torch.runs.ledger import RunLedger, unit_scene
    from disco_tpu_torch.sim import make_setup
    from disco_tpu_torch.sim.defaults import RoomDefaults

    device = resolve_device(device)
    rng = np.random.default_rng() if rng is None else rng
    defaults = RoomDefaults()
    room_sampler = make_setup(scenario, rng=rng)
    generated = []
    i_file = (rir_start - 1) * 2  # distinct talker per RIR, with margin (convolve_signals.py:373)

    if ledger is not None and not isinstance(ledger, RunLedger):
        ledger = RunLedger(ledger)
    if resume:
        litter = remove_tmp_litter(layout.base)
        if litter:
            obs_events.record("warning", stage="resume",
                              reason=f"removed {len(litter)} abandoned temp file(s) "
                                     f"from a crashed writer", files=litter[:20])
    ledger_done: set = set()
    requeued_units: set = set()
    if ledger is not None and resume:
        ledger_done, requeued = ledger.verified_done()
        requeued_units = set(requeued)
        obs_events.record(
            "run_resume", stage="datagen", ledger=str(ledger.path),
            n_done=len(ledger_done), n_requeued=len(requeued),
            requeued=sorted(requeued),
        )

    for rir_id in range(rir_start, rir_start + n_rirs):
        if run_interrupt.stop_requested():
            break  # graceful stop between scenes: everything saved, resumable
        if unit_scene(rir_id) in ledger_done:
            continue
        if unit_scene(rir_id) not in requeued_units and probe_npy(layout.infos(rir_id)):
            # validated idempotency guard (SURVEY.md §5.3): the infos log is
            # written LAST and atomically, so a complete one certifies the
            # scene; a truncated one (pre-atomic-era crash) is regenerated.
            # A unit the verified resume just requeued (digest-level damage
            # the infos probe cannot see) bypasses this skip and is redone.
            continue
        if ledger is not None:
            ledger.mark_in_flight(unit_scene(rir_id))
        signal_setup.get_random_dry_snr()
        scene = None
        for _ in range(max_redraws):
            cfg = room_sampler.create_room_setup()
            result = simulate_scene(
                cfg, signal_setup, i_file % len(signal_setup.target_list), dset,
                defaults.n_sensors_per_node, max_order=max_order, fs=fs, device=device,
            )
            if result == "redraw_source_signal":
                i_file += 1
                continue
            if result == "redraw_room_setup":
                continue
            scene = result
            break
        if scene is None:
            raise RuntimeError(f"RIR {rir_id}: no valid configuration after {max_redraws} redraws")
        extra_dry, extra_rev, files, starts = reverb_other_noises(scene, signal_setup, dset, fs,
                                                                  device=device)
        # Keys follow the reference infos contract (convolve_signals.py:438-446)
        # so plot_conf and reference-side tooling read these files unchanged.
        dims = np.asarray(scene.setup.room_dim)
        infos = {
            "room": {
                "length": float(dims[0]),
                "width": float(dims[1]),
                "height": float(dims[2]),
                "alpha": scene.setup.alpha,
                "rt60": scene.setup.beta,
            },
            "mics": np.asarray(scene.setup.mic_positions),
            "sources": np.asarray(scene.setup.source_positions),
            "nodes_centers": scene.setup.nodes_centers,
            "rirs": scene.rirs,
            "snr_images": scene.snr_images,
            "noise_files": files,
            "noise_starts": starts,
        }
        written = save_scene(
            scene, extra_dry, extra_rev, infos, rir_id, layout, fs,
            extra_names=list(signal_setup.noises_dict.keys()),
        )
        if ledger is not None:
            ledger.mark_done(unit_scene(rir_id), written)
        generated.append(rir_id)
        run_chaos.tick("between_scenes", rir=rir_id)
        i_file += 1
    return generated


def _draw_dry_pair(signal_setup, i_file: int, fs: int):
    """The dry-signal preamble of :func:`simulate_scene` (target + SSN
    noise, convolve_signals.py:216-240), factored so the batched driver can
    draw signals for a whole chunk before its one RIR dispatch.

    Returns ``(sig_stack (2, L), target_vad)`` or None (unusable target
    file — the caller advances ``i_file``, the "redraw_source_signal"
    protocol)."""
    target_file = signal_setup.target_list[i_file % len(signal_setup.target_list)]
    target, target_vad, _fs_t = signal_setup.get_target_segment(target_file)
    if target is None:
        return None
    noise, _, _, noise_vad, _ = signal_setup.get_noise_segment(
        "SSN", signal_setup.target_duration)
    noise = increase_to_snr(
        target, noise, signal_setup.source_snr[0],
        weight=True, vad_tar=target_vad, vad_noi=noise_vad, fs=fs,
    )
    L = len(target)
    sig_stack = np.zeros((2, L), np.float32)
    sig_stack[0] = target
    sig_stack[1, : len(noise)] = noise[:L]
    return sig_stack, target_vad


def _simulate_scenes_batched(cfgs, sig_stacks, target_vads, dset, signal_setup,
                             mics_per_node, max_order, fs, device=None):
    """Simulate a list of scenes with ONE pass of the RIR engine.

    The batched twin of :func:`simulate_scene`'s device half
    (convolve_signals.py:216-282): all rooms' RIRs come from one
    ``shoebox_rirs_batched`` call in the chunk's shared ``scenes.batched``
    bucket, all dry→wet convolutions from one padded batched FFT
    convolution, and the results cross to the host in one copy.  SNR gating
    stays host-side per scene — a scene failing the node-SNR window returns
    None in its slot ("redraw_room_setup").

    Returns a list of :class:`SimulatedScene` or None per slot."""
    from disco_tpu_torch.scenes.batched import BATCH_QUANTUM

    B = len(cfgs)
    rir_len = 0
    for cfg in cfgs:
        _, n = rir_bucket(cfg.beta, cfg.room_dim, max_order=max_order, fs=fs,
                          quantum=BATCH_QUANTUM)
        rir_len = max(rir_len, n)
    dims = np.stack([np.asarray(c.room_dim, np.float32) for c in cfgs])
    srcs = np.stack([np.asarray(c.source_positions[:2], np.float32) for c in cfgs])
    mics = np.stack([np.asarray(c.mic_positions.T, np.float32) for c in cfgs])
    alphas = np.asarray([c.alpha for c in cfgs], np.float32)

    lens = [s.shape[-1] for s in sig_stacks]
    L_max = max(lens)
    dry = np.zeros((B, 2, L_max), np.float32)
    for b, s in enumerate(sig_stacks):
        dry[b, :, : s.shape[-1]] = s

    rirs_d = shoebox_rirs_batched(dims, srcs, mics, alphas,
                                  max_order=max_order, rir_len=rir_len, fs=fs, device=device)
    images_d = fft_convolve(dry[:, :, None, :], rirs_d, out_len=L_max)
    got = dict(zip(("rirs", "images"), to_host([rirs_d, images_d])))

    scenes = []
    for b, cfg in enumerate(cfgs):
        images = got["images"][b][:, :, : lens[b]]
        image_vads = get_convolved_vads(images[0])
        snr_images, snr_nodes, snr_diff = snr_at_mics(
            images[0], images[1], mics_per_node, fs, vad_s=image_vads)
        lo, hi = signal_setup.snr_cnv_range
        if not (np.all(lo < snr_nodes) and np.all(snr_nodes < hi)
                and signal_setup.min_delta_snr < snr_diff):
            scenes.append(None)  # redraw_room_setup
            continue
        if dset == "train":
            len_max = int((signal_setup.duration_range[-1] + 1) * fs)
            pad = max(len_max - images.shape[-1], 0)
            images = np.pad(images, ((0, 0), (0, 0), (0, pad)))[:, :, :len_max]
        scenes.append(SimulatedScene(
            setup=cfg, rirs=got["rirs"][b], sources=sig_stacks[b],
            images=images, target_vad=target_vads[b],
            image_vads=image_vads, snr_images=snr_images,
        ))
    return scenes


def generate_disco_rirs_batched(
    scenario: str,
    dset: str,
    rir_start: int,
    n_rirs: int,
    signal_setup,
    layout: DatasetLayout,
    rng=None,
    max_order: int = 20,
    fs: int = 16000,
    max_redraws: int = 50,
    ledger=None,
    resume: bool = False,
    batch: int = 8,
    seed: int | None = None,
    device=None,
):
    """The batched generation driver: same idempotency, ledger and redraw
    semantics as :func:`generate_disco_rirs`, but the RIR engine runs once
    per chunk of ``batch`` scenes instead of once per scene, and a chunk's
    RIRs and images cross to the host in one copy.  ``device``: ``"cuda"``
    when None (RuntimeError without a CUDA device), or ``"cpu"``.

    Redraw protocol per chunk: every pending scene draws its dry signals
    up front (unusable targets advance the talker index, bounded); then
    redraw ROUNDS run — each round simulates all still-unsatisfied scenes
    in one dispatch and host-gates their node SNRs, failed scenes drawing
    a fresh room next round (the "redraw_room_setup" sentinel, amortized).
    Saving, ledger units (``scene:<id>``), the infos completion marker and
    the ``between_scenes`` chaos seam are IDENTICAL to the per-scene
    driver, so a batched corpus resumes (and chaos-drills) exactly like a
    per-scene one; the chunk boundary adds the ``between_scene_batches``
    seam.

    Unlike the per-scene driver — whose rng state at scene N depends on
    every draw scenes 1..N-1 consumed — the batched driver reseeds the
    samplers deterministically PER SCENE from ``(seed, rir_id, stream)``
    (the SURVEY §5.2 per-file reseeding discipline): scene ``rir_id``
    produces identical bytes whether it runs in a fresh run, a resumed
    run, or a different chunk split, which is what lets ``make
    scene-check`` assert byte-identical crash-and-resume trees.  ``seed``
    defaults to one integer drawn from ``rng`` (pass it explicitly — the
    CLI passes ``--seed`` — for cross-run reproducibility).

    Returns the list of RIR ids actually generated.
    """
    from disco_tpu_torch.io.atomic import remove_tmp_litter
    from disco_tpu_torch.obs import events as obs_events
    from disco_tpu_torch.runs import chaos as run_chaos
    from disco_tpu_torch.runs import interrupt as run_interrupt
    from disco_tpu_torch.runs.ledger import RunLedger, unit_scene
    from disco_tpu_torch.sim import make_setup
    from disco_tpu_torch.sim.defaults import RoomDefaults

    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    device = resolve_device(device)
    rng = np.random.default_rng() if rng is None else rng
    if seed is None:
        seed = int(rng.integers(2**31 - 1))
    defaults = RoomDefaults()
    room_sampler = make_setup(scenario, rng=rng)
    generated = []

    if ledger is not None and not isinstance(ledger, RunLedger):
        ledger = RunLedger(ledger)
    if resume:
        litter = remove_tmp_litter(layout.base)
        if litter:
            obs_events.record("warning", stage="resume",
                              reason=f"removed {len(litter)} abandoned temp file(s) "
                                     f"from a crashed writer", files=litter[:20])
    ledger_done: set = set()
    requeued_units: set = set()
    if ledger is not None and resume:
        ledger_done, requeued = ledger.verified_done()
        requeued_units = set(requeued)
        obs_events.record(
            "run_resume", stage="datagen", ledger=str(ledger.path),
            n_done=len(ledger_done), n_requeued=len(requeued),
            requeued=sorted(requeued),
        )

    # Pending ids under the same skip rules as the per-scene driver: ledger
    # done, or a validated infos completion marker (unless requeued).
    pending = []
    for rir_id in range(rir_start, rir_start + n_rirs):
        if unit_scene(rir_id) in ledger_done:
            continue
        if unit_scene(rir_id) not in requeued_units and probe_npy(layout.infos(rir_id)):
            continue
        pending.append(rir_id)

    for c0 in range(0, len(pending), batch):
        if run_interrupt.stop_requested():
            break  # graceful stop between chunks: everything saved, resumable
        chunk = pending[c0 : c0 + batch]
        if ledger is not None:
            for rir_id in chunk:
                ledger.mark_in_flight(unit_scene(rir_id))
        # Dry signals per scene, drawn up front (redraw_source_signal
        # advances the talker index, bounded like the per-scene loop).
        # Stream 0 of the per-scene reseeding: scene rir_id's signal
        # draws never depend on what other scenes consumed.
        sig_stacks, target_vads = [], []
        for rir_id in chunk:
            signal_setup.rng = np.random.default_rng([seed, rir_id, 0])
            signal_setup.get_random_dry_snr()
            i_file = (rir_id - 1) * 2  # per-scene driver's talker convention
            pair = None
            for _ in range(max_redraws):
                pair = _draw_dry_pair(signal_setup, i_file, fs)
                if pair is not None:
                    break
                i_file += 1
            if pair is None:
                raise RuntimeError(
                    f"no usable target signal after {max_redraws} files")
            sig_stacks.append(pair[0])
            target_vads.append(pair[1])
        # Redraw rounds: one RIR engine pass per round over the unsatisfied
        # slots, until every scene passes its SNR gate.  Stream 1000+round
        # per scene: a scene's round-r room draw is a pure function of
        # (seed, rir_id, r), so resumed runs redraw identical rooms.
        scenes: list = [None] * len(chunk)
        active = list(range(len(chunk)))
        for _round in range(max_redraws):
            cfgs = []
            for slot in active:
                room_sampler.rng = np.random.default_rng(
                    [seed, chunk[slot], 1000 + _round])
                cfgs.append(room_sampler.create_room_setup())
            results = _simulate_scenes_batched(
                cfgs, [sig_stacks[i] for i in active],
                [target_vads[i] for i in active], dset, signal_setup,
                defaults.n_sensors_per_node, max_order, fs, device)
            still = []
            for slot, scene in zip(active, results):
                if scene is None:
                    still.append(slot)
                else:
                    scenes[slot] = scene
            active = still
            if not active:
                break
        if active:
            raise RuntimeError(
                f"RIRs {[chunk[i] for i in active]}: no valid configuration "
                f"after {max_redraws} batched redraw rounds")
        obs_events.record("scene", stage="datagen", n_scenes=len(chunk),
                          rir_start=int(chunk[0]), rir_end=int(chunk[-1]),
                          scenario=scenario)
        for rir_id, scene in zip(chunk, scenes):
            # Stream 1: extra-noise reverb draws, reseeded per scene.
            signal_setup.rng = np.random.default_rng([seed, rir_id, 1])
            extra_dry, extra_rev, files, starts = reverb_other_noises(
                scene, signal_setup, dset, fs, device=device)
            dims = np.asarray(scene.setup.room_dim)
            infos = {
                "room": {
                    "length": float(dims[0]),
                    "width": float(dims[1]),
                    "height": float(dims[2]),
                    "alpha": scene.setup.alpha,
                    "rt60": scene.setup.beta,
                },
                "mics": np.asarray(scene.setup.mic_positions),
                "sources": np.asarray(scene.setup.source_positions),
                "nodes_centers": scene.setup.nodes_centers,
                "rirs": scene.rirs,
                "snr_images": scene.snr_images,
                "noise_files": files,
                "noise_starts": starts,
            }
            written = save_scene(
                scene, extra_dry, extra_rev, infos, rir_id, layout, fs,
                extra_names=list(signal_setup.noises_dict.keys()),
            )
            if ledger is not None:
                ledger.mark_done(unit_scene(rir_id), written)
            generated.append(rir_id)
            run_chaos.tick("between_scenes", rir=rir_id)
        run_chaos.tick("between_scene_batches", rir_start=int(chunk[0]),
                       rir_end=int(chunk[-1]))
    return generated


def get_wavs_list(librispeech_root, freesound_root=None, dset="train", cache_dir=None, seed=30):
    """Deterministically shuffled corpus file lists (convolve_signals.py:32-81):
    train targets from train-clean-100, SSN talkers from train-clean-360,
    test targets from test-clean; optional freesound noise files.  The fixed
    seed makes every parallel process see the same order; lists are cached
    as txt so restarts and job arrays agree.

    Returns (target_list, talkers_list, noises_dict).
    """
    import glob
    import os

    def listing(name, subdir):
        if cache_dir is not None:
            cache = os.path.join(cache_dir, f"{name}.txt")
            if os.path.isfile(cache):
                with open(cache) as fh:
                    return [ln.strip() for ln in fh if ln.strip()]
        pats = ("*.wav", "*.flac")
        files = sorted(
            f for pat in pats for f in glob.glob(os.path.join(subdir, "**", pat), recursive=True)
        )
        np.random.default_rng(seed).shuffle(files)
        if cache_dir is not None and files:
            os.makedirs(cache_dir, exist_ok=True)
            # atomic: a half-written listing cache READS clean (every prefix
            # of a line list parses), so a torn write would silently shrink
            # the corpus on the next run instead of erroring
            with atomic_write(os.path.join(cache_dir, f"{name}.txt"), "w") as fh:
                fh.write("\n".join(files))
        return files

    if dset in ("train", "val"):  # val RIRs live inside the train corpus
        targets = listing("train_targets", os.path.join(librispeech_root, "train-clean-100"))
        talkers = listing("train_talkers", os.path.join(librispeech_root, "train-clean-360"))
    else:
        targets = listing("test_targets", os.path.join(librispeech_root, "test-clean"))
        talkers = listing("test_talkers", os.path.join(librispeech_root, "train-clean-360"))
    if not targets:  # flat directory fallback (synthetic/test corpora)
        targets = listing("targets_flat", str(librispeech_root))
    talkers = talkers or targets  # SSN needs talker material even without train-clean-360
    noises = {}
    if freesound_root is not None:
        fs_files = listing("freesound", str(freesound_root))
        if fs_files:
            noises["fs"] = fs_files
    return targets, talkers, noises

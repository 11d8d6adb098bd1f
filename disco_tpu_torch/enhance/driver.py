"""The corpus driver: load a dataset sample, run the two-step TANGO pipeline
on the card, evaluate, save (counterpart of ``disco_tpu/enhance/driver.py``;
reference ``speech_enhancement/tango.py:460-641``).

Same idempotency guard, same results-directory layout
(``results/{scenario}/{dset}/{save_dir}/{WAV,MASK,OIM,STFT/z}``) and the same
pickled ``results_tango_* / results_mwf_*`` dicts of float64 numpy arrays
under the same keys as the JAX package, so each package's aggregation reads
the other's outputs.  The ``sdr_*`` / ``sir_*`` / ``sar_*`` keys carry the
512-tap filtered-projection values of ``core.bss`` (mir_eval's
``bss_eval_sources`` metric, which the reference calls), the ``si_*`` keys
the scale-invariant decomposition (``core.metrics.si_bss``); STOI is
``core.metrics.stoi``.  Scoring is host float64 numpy, the JAX package's
code.

Entry points: :func:`enhance_rir` (one clip: the staged, chained or
streaming lane) and :func:`enhance_rirs_batched` (a corpus, many clips per
launch, through the overlapped engine of ``enhance/pipeline.py``); the mask
stage :func:`estimate_masks` / :func:`_batched_masks`.  Each runs on
``"cuda"`` unless ``device="cpu"`` is passed, and raises without a CUDA
device.  Threads: the main thread is the only CUDA user; the prefetch
thread loads numpy and the scoring workers get numpy arrays only.

Telemetry, the JAX driver's (``disco_tpu_torch.obs``): the stage spans
``load_input``, ``stft``, ``masks``, ``mwf``, ``istft``, ``score_persist``,
``chunk_load``, ``chunk_enhance``, ``chunk_pipeline`` (and the pipeline's
``chunk_readback``); the finiteness sentinels ``stft_Y``, ``masks``,
``mwf_yf`` and ``istft_out``; the ``clips_enhanced``, ``degraded_clips``,
``snr_sidecar_missing`` and ``corrupt_artifacts_detected`` counters; the
``clip``, ``degraded``, ``fault``, ``warning``, ``run_resume``, ``note``
and ``counters`` events; the batch runners' call signatures
(``obs.accounting.counted_jit``).  With no event sink live, none of it
reads a tensor's value.

The FIG plot (``save_fig=True``, the default) is the JAX package's: a
room top view from the clip's validated infos ``.npy``
(``inference.plot_conf``), drawn under one lock on whichever thread scores
the clip, best-effort — a figure that cannot be drawn (no matplotlib, no
infos) is skipped, never fatal — and absent from the ledger's artifacts.

Multi-card (``mesh``, a ``(batch, node)`` mesh of ``disco_tpu_torch.
parallel``): every rank runs :func:`enhance_rirs_batched` with the same
arguments (SPMD), loads the same chunks, enhances its clips and nodes
through ``parallel.tango_batch_sharded`` (the oracle masks by the
``oracle_masks_batched`` runner; with oracle masks a rank transforms only
its own nodes), and the chunk's result is gathered to rank 0, which alone
scores, writes the artifacts and the run ledger and returns the results
(the other ranks return ``{}``).  The metrics are
the meshless run's.  ``compile_cache`` chooses the kernel build cache
(``disco_tpu_torch.utils.compile_cache``), where the kernel library is
built by ``nvcc`` and later runs load it from.
"""
from __future__ import annotations

import contextlib
import math
import pickle
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache, partial
from pathlib import Path

import numpy as np
import torch

from disco_tpu_torch.core.bss import BssEval
from disco_tpu_torch.core.dsp import bucket_length, n_stft_frames
from disco_tpu_torch.core.masks import tf_mask_mag
from disco_tpu_torch.core.metrics import fw_sd, fw_snr, si_bss, stoi
from disco_tpu_torch.device import resolve_device, to_host
from disco_tpu_torch.enhance.fused import tango_clip_fused
from disco_tpu_torch.enhance.inference import crnn_masks_batched
from disco_tpu_torch.enhance.pipeline import (
    MAX_PENDING_CHUNKS,
    ChunkPrefetcher,
    LoadedChunk,
    clip_slice,
    clip_time_domain,
    fetch_chained_host,
    fetch_chunk_host,
    note_chunk_overlap,
)
from disco_tpu_torch.enhance.streaming import DEFAULT_UPDATE_EVERY, streaming_tango
from disco_tpu_torch.enhance.tango import TangoResult, oracle_masks, others_index, tango
from disco_tpu_torch.enhance.zexport import compute_z_signals, load_node_signals
from disco_tpu_torch.fault import plan_faults
from disco_tpu_torch.io.atomic import (
    dump_pickle_atomic,
    probe_npy,
    probe_pickle,
    remove_tmp_litter,
    save_npy_atomic,
    write_wav_atomic,
)
from disco_tpu_torch.io.audio import read_wav
from disco_tpu_torch.io.layout import DatasetLayout, case_of_rir, snr_dirname
from disco_tpu_torch.obs import accounting as obs_accounting
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs import sentinels as obs_sentinels
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
from disco_tpu_torch.ops.stft_ops import stft_fused, stft_with_mag
from disco_tpu_torch.runs import chaos as run_chaos
from disco_tpu_torch.runs import interrupt as run_interrupt
from disco_tpu_torch.runs.ledger import RunLedger, unit_rir
from disco_tpu_torch.utils.resilience import TRANSPORT_ERRORS, call_with_retries

_FIG_LOCK = threading.Lock()  # see the save_fig block in _persist_and_score

def _record_degraded(fault_plan, streaming: bool = False, **attrs):
    """Record the pipeline's degraded-mode entry for one clip: a
    ``degraded`` event naming what was lost and the ``degraded_clips``
    counter.  No-op when the plan injects nothing."""
    if fault_plan is None or not fault_plan.any_fault():
        return
    obs_registry.counter("degraded_clips").inc()
    if not obs_events.enabled():
        return
    if streaming:
        lost = fault_plan.avail_streaming < 1.0
        obs_events.record(
            "degraded", stage="mwf", mode="streaming",
            n_blocks_held=int(lost.sum()),
            nodes=np.flatnonzero(lost.any(axis=1)).tolist(),
            **attrs,
        )
    else:
        excluded = np.flatnonzero(fault_plan.avail_offline < 1.0).tolist()
        obs_events.record(
            "degraded", stage="mwf", mode="offline",
            n_streams_excluded=len(excluded), nodes=excluded,
            nan_nodes=np.flatnonzero(fault_plan.z_nan).tolist(),
            **attrs,
        )


def load_input_signals(layout: DatasetLayout, rir: int, noise: str, snr_range, n_nodes=4,
                       mics_per_node=4):
    """Processed node signals + dry references + logged SNRs (reference
    tango.py:55-111).  A missing SNR sidecar reads as zeros, made visible:
    the ``snr_sidecar_missing`` counter and a ``warning`` event."""
    y, s, n = load_node_signals(layout, rir, noise, snr_range, n_nodes, mics_per_node)
    s_dry, fs = read_wav(layout.dry_source("target", rir, 1))
    n_dry, _ = read_wav(layout.dry_source("noise", rir, 2, noise=noise))
    snr_path = layout.snr_log(snr_range, rir, noise)
    if snr_path.exists():
        rnd_snrs = np.load(snr_path)
    else:
        rnd_snrs = np.zeros(n_nodes)
        obs_registry.counter("snr_sidecar_missing").inc()
        obs_events.record(
            "warning", stage="load_input", rir=rir, noise=noise,
            reason="SNR sidecar missing; substituting zeros for snr_in_raw",
            path=str(snr_path),
        )
    return y, s, n, s_dry, n_dry, fs, rnd_snrs


def dset_of_rir(rir: int) -> str:
    """Results-tree split: train for rir <= 11000, test above
    (reference tango.py:41-45)."""
    return "train" if rir <= 11000 else "test"


def results_root(scenario: str, dset: str, save_dir: str) -> Path:
    """Results tree root for one (scenario, dset, save_dir) run."""
    return Path("results") / scenario / dset / save_dir


def _clip_done(out: Path, rir, noise: str) -> bool:
    """Validated idempotency probe for one enhanced RIR: both OIM pickles
    (the last artifacts :func:`_persist_and_score` writes) must exist AND
    unpickle to completion; a truncated one reads as not-done and the clip
    is redone (``corrupt_artifacts_detected`` and a ``warning`` event)."""
    for kind in ("mwf", "tango"):
        p = out / "OIM" / f"results_{kind}_{rir}_{noise}.p"
        if not probe_pickle(p):
            if p.exists():
                obs_registry.counter("corrupt_artifacts_detected").inc()
                obs_events.record(
                    "warning", stage="skip_probe", rir=rir, noise=noise,
                    reason="existing OIM pickle failed its integrity probe; "
                           "re-enhancing this clip", path=str(p),
                )
            return False
    return True


def clip_artifacts(out: Path, rir, noise: str, snr_range, n_nodes: int) -> list:
    """The canonical artifact paths of one enhanced RIR — what the run
    ledger digests into a ``done`` record and re-verifies on resume.  The
    best-effort FIG render is deliberately absent (plotting may legally
    fail)."""
    paths = [
        out / "OIM" / f"results_tango_{rir}_{noise}.p",
        out / "OIM" / f"results_mwf_{rir}_{noise}.p",
    ]
    zdir = out / "STFT" / "z" / "raw" / snr_dirname(snr_range)
    for k in range(n_nodes):
        tag = f"{noise}_Node-{k + 1}"
        paths += [
            out / "WAV" / str(rir) / f"{stem}-{tag}.wav"
            for stem in ("in_mix", "out_mix", "mid_z", "in_noi", "out_noi", "in_tar", "out_tar")
        ]
        paths += [
            out / "MASK" / str(rir) / f"step1_{tag}.npy",
            out / "MASK" / str(rir) / f"step2_{tag}.npy",
            zdir / f"{rir}_{tag}.npy",
        ]
    return paths


#: Keys of the per-node metric dicts below — the degraded-mode NaN fill
#: must produce exactly this set so the nodes stack together.
_NODE_METRIC_KEYS = (
    "sdr_cnv", "sir_cnv", "sar_cnv", "sdr_dry", "sir_dry", "sar_dry",
    "sdr_in_cnv", "sir_in_cnv", "sdr_in_dry", "sir_in_dry", "sar_in_dry",
    "si_sdr_cnv", "si_sir_cnv", "si_sar_cnv",
    "si_sdr_dry", "si_sir_dry", "si_sar_dry",
    "si_sdr_in_cnv", "si_sir_in_cnv",
    "si_sdr_in_dry", "si_sir_in_dry", "si_sar_in_dry",
    "delta_stoi_cnv", "delta_stoi_dry",
    "snr_out", "snr_in_cnv", "snr_in_dry", "fw_sd_cnv", "fw_sd_dry",
)


def _node_metrics_pair(y0, s0, n0, sh_t, szh_t, s_dry, n_dry, sf_t, nf_t,
                       szf_t, nzf_t, fs, sl, proj_dry, bss_filt_len=512):
    """All metric variants for one node's two enhanced outputs — ``sh_t``
    (full TANGO) and ``szh_t`` (step-1/MWF) — against the dry and convolved
    references (tango.py:545-593).  Returns (tango_dict, mwf_dict).

    The 512-tap BSS projectors are reused for every estimate — the dry one
    (``proj_dry``, node-independent) is built once per RIR by the caller,
    the convolved one once per node here — and the input-side metrics are
    computed once for both outputs."""
    refs_dry = np.stack((s_dry[sl], n_dry[sl]), axis=1)
    refs_cnv = np.stack((s0[sl], n0[sl]), axis=1)
    proj_cnv = BssEval(refs_cnv.T, bss_filt_len)

    # input-side metrics: identical for both outputs
    sdr_in_dry, sir_in_dry, sar_in_dry = proj_dry.score(y0[sl])
    sdr_in_cnv, sir_in_cnv, _ = proj_cnv.score(y0[sl])
    si_sdr_in_dry, si_sir_in_dry, si_sar_in_dry = si_bss(y0[sl], refs_dry, 0)
    si_sdr_in_cnv, si_sir_in_cnv, _ = si_bss(y0[sl], refs_cnv, 0)
    stoi_in = stoi(s0[sl], y0[sl], fs)
    stoi_in_dry = stoi(s_dry[sl], y0[sl], fs)
    _, fw_snr_in_cnv, _ = fw_snr(s0[sl], n0[sl], fs)
    _, fw_snr_in_dry, _ = fw_snr(s_dry[sl], n_dry[sl], fs)

    def one_output(est, s_filt, n_filt):
        if not np.isfinite(est[sl]).all():
            # degraded mode (fault injection): a NaN stream — e.g. the saved
            # MWF output of a NaN-z node — scores as NaN metrics, never a
            # crash (the BSS projector's cho_solve rejects non-finite input)
            return dict.fromkeys(_NODE_METRIC_KEYS, float("nan"))
        sdr_dry, sir_dry, sar_dry = proj_dry.score(est[sl])
        sdr_cnv, sir_cnv, sar_cnv = proj_cnv.score(est[sl])
        si_sdr_dry, si_sir_dry, si_sar_dry = si_bss(est[sl], refs_dry, 0)
        si_sdr_cnv, si_sir_cnv, si_sar_cnv = si_bss(est[sl], refs_cnv, 0)
        stoi_out = stoi(s0[sl], est[sl], fs)
        stoi_out_dry = stoi(s_dry[sl], est[sl], fs)
        _, fw_snr_out, _ = fw_snr(s_filt[sl], n_filt[sl], fs)
        _, fsd_cnv, _ = fw_sd(s_filt[sl], s0[sl], fs)
        _, fsd_dry, _ = fw_sd(s_filt[sl], s_dry[sl], fs)
        return {
            "sdr_cnv": sdr_cnv, "sir_cnv": sir_cnv, "sar_cnv": sar_cnv,
            "sdr_dry": sdr_dry, "sir_dry": sir_dry, "sar_dry": sar_dry,
            "sdr_in_cnv": sdr_in_cnv, "sir_in_cnv": sir_in_cnv,
            "sdr_in_dry": sdr_in_dry, "sir_in_dry": sir_in_dry, "sar_in_dry": sar_in_dry,
            "si_sdr_cnv": si_sdr_cnv, "si_sir_cnv": si_sir_cnv, "si_sar_cnv": si_sar_cnv,
            "si_sdr_dry": si_sdr_dry, "si_sir_dry": si_sir_dry, "si_sar_dry": si_sar_dry,
            "si_sdr_in_cnv": si_sdr_in_cnv, "si_sir_in_cnv": si_sir_in_cnv,
            "si_sdr_in_dry": si_sdr_in_dry, "si_sir_in_dry": si_sir_in_dry,
            "si_sar_in_dry": si_sar_in_dry,
            "delta_stoi_cnv": stoi_out - stoi_in, "delta_stoi_dry": stoi_out_dry - stoi_in_dry,
            "snr_out": fw_snr_out, "snr_in_cnv": fw_snr_in_cnv, "snr_in_dry": fw_snr_in_dry,
            "fw_sd_cnv": fsd_cnv, "fw_sd_dry": fsd_dry,
        }

    return one_output(sh_t, sf_t, nf_t), one_output(szh_t, szf_t, nzf_t)


def _spectra(dev, *arrays):
    return tuple(None if a is None else torch.as_tensor(a, dtype=torch.complex64, device=dev)
                 for a in arrays)


def estimate_masks(Y, S, N, models, mask_type: str, n_nodes: int, mu: float = 1.0,
                   z_sigs: str = "zs_hat", mags=None, device=None):
    """Step-1 and step-2 masks of one clip, oracle or CRNN (reference
    tango.py:189-225, 387-394).

    Args:
      Y, S, N: (K, C, F, T) STFTs (S and N only for oracle masks and the
        z diagnostics; None where no oracle mask is asked for).
      models: a 2-list; each entry None (the oracle mask of ``mask_type``)
        or a CRNN module.  The step-2 CRNN reads the local reference channel
        and the exchanged z streams, so step 1 runs first to produce them,
        through :func:`compute_z_signals` with its default solver
        (``'power'``), whatever solver the TANGO run that follows uses.
      mags: optional ``(mag_S, mag_N)`` (K, C, F, T) magnitudes from the
        fused STFT (``ops.stft_ops.stft_with_mag``): the irm/ibm oracle
        masks then read them instead of the complex spectra.
      device: ``"cuda"`` when None.

    Returns:
      (masks_z, mask_w), each (K, F, T) float32 on ``device``.
    """
    dev = resolve_device(device)
    one = tuple(None if a is None else a[None] for a in _spectra(dev, Y, S, N))
    mags = None if mags is None else tuple(m[None] for m in mags)
    masks_z, mask_w = _batched_masks(*one, models, mask_type, mu, n_nodes, z_sigs, device=dev,
                                     mags=mags)
    return masks_z[0], mask_w[0]


def _z_for_mask_device(z_y, zn, n_nodes: int, z_sigs: str):
    """:func:`~disco_tpu_torch.enhance.inference.get_z_for_mask` for all
    nodes at once, on the device: (..., K, F, T) z streams → (..., K, n_z,
    F, T) per-node NN inputs ('zs_hat' / 'zn_hat': the other nodes' z_y /
    zn; the pair: [z_y_j, zn_j] interleaved, the local pair dropped)."""
    if z_sigs in ("zs_hat", "zn_hat"):
        z_in = z_y if z_sigs == "zs_hat" else zn
        oth = torch.as_tensor(others_index(n_nodes), device=z_in.device)  # (K, K-1)
        return z_in[..., oth, :, :]
    inter = torch.stack([z_y, zn], dim=-3)
    inter = inter.reshape(inter.shape[:-4] + (2 * n_nodes,) + inter.shape[-2:])
    keep = torch.as_tensor([[j for j in range(2 * n_nodes) if j not in (2 * k, 2 * k + 1)]
                            for k in range(n_nodes)], device=z_y.device)
    return inter[..., keep, :, :]


def _clip_host(res, length: int) -> dict:
    """One clip's scoring payload on the host, in ONE copy: the six ISTFTs
    at the clip's length (:func:`~disco_tpu_torch.enhance.pipeline.
    clip_time_domain`), both masks and the complex z export, under the
    transport-retry budget."""
    td, masks_z, mask_w, z_y = call_with_retries(
        to_host, [clip_time_domain(res, length), res.masks_z, res.mask_w, res.z_y],
        retry_on=TRANSPORT_ERRORS, label="persist_readback")
    return {"td": tuple(td), "masks_z": masks_z, "mask_w": mask_w, "z_y": z_y}


def _persist_and_score(out: Path, rir: int, noise: str, snr_range, y, s, n, s_dry, n_dry, fs,
                       rnd_snrs, host: dict, T_true: int, n_nodes: int,
                       bss_filt_len: int = 512, *, layout: DatasetLayout, save_fig: bool):
    """Per-RIR second half of the reference main (tango.py:528-639): every
    metric variant and the WAV/MASK/OIM/STFT-z/FIG results tree.  Shared by
    the single-RIR and batched drivers; host numpy only, so it runs on
    scoring worker threads.  ``save_fig``: draw ``FIG/<rir>.png`` from
    ``layout``'s infos of the clip, best-effort.

    ``host``: the clip's payload on the host (:func:`_clip_host`,
    ``pipeline.fetch_chunk_host`` or ``fetch_chained_host``) — ``td``, the
    six (K, L) time-domain streams ``(sh_t, szh_t, sf_t, nf_t, szf_t,
    nzf_t)``, and ``masks_z`` / ``mask_w`` / ``z_y`` (K, F, T)."""
    sh_t, szh_t, sf_t, nf_t, szf_t, nzf_t = host["td"]
    masks_z_h, mask_w_h, z_y_h = host["masks_z"], host["mask_w"], host["z_y"]
    obs_sentinels.check_finite("istft_out", sh_t, stage="istft")
    # score_persist covers the whole tail (node loop, artifacts); a clip
    # that crashes loses its stage_end, which the aborted run does not need
    score_stage = contextlib.ExitStack()
    score_stage.enter_context(obs_events.stage("score_persist", rir=rir, noise=noise))
    for sub in ("WAV", "MASK", "OIM", "FIG"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    (out / "WAV" / str(rir)).mkdir(exist_ok=True)
    (out / "MASK" / str(rir)).mkdir(exist_ok=True)
    zdir = out / "STFT" / "z" / "raw" / snr_dirname(snr_range)
    zdir.mkdir(parents=True, exist_ok=True)

    # first second (lead silence) skipped; lengths are node-independent,
    # so the slice and the dry-reference projector are per-RIR
    min_len = min(len(y[0, 0]), sh_t.shape[-1], len(s_dry), len(n_dry))
    sl = slice(fs, min_len)
    proj_dry = BssEval(np.stack((s_dry[sl], n_dry[sl])), bss_filt_len)

    per_node_tango, per_node_mwf = [], []
    for k in range(n_nodes):
        y0, s0, n0 = y[k, 0], s[k, 0], n[k, 0]
        tango_d, mwf_d = _node_metrics_pair(
            y0, s0, n0, sh_t[k], szh_t[k], s_dry, n_dry,
            sf_t[k], nf_t[k], szf_t[k], nzf_t[k], fs, sl, proj_dry,
            bss_filt_len=bss_filt_len,
        )
        per_node_tango.append(tango_d)
        per_node_mwf.append(mwf_d)

        tag = f"{noise}_Node-{k + 1}"
        # atomic writes: a crash mid-persist leaves the final paths either
        # complete or absent, the invariant the verified resume relies on
        wav = out / "WAV" / str(rir)
        write_wav_atomic(wav / f"in_mix-{tag}.wav", y0, fs)
        write_wav_atomic(wav / f"out_mix-{tag}.wav", sh_t[k], fs)
        write_wav_atomic(wav / f"mid_z-{tag}.wav", szh_t[k], fs)
        write_wav_atomic(wav / f"in_noi-{tag}.wav", n0, fs)
        write_wav_atomic(wav / f"out_noi-{tag}.wav", nf_t[k], fs)
        write_wav_atomic(wav / f"in_tar-{tag}.wav", s0, fs)
        write_wav_atomic(wav / f"out_tar-{tag}.wav", sf_t[k], fs)
        save_npy_atomic(out / "MASK" / str(rir) / f"step1_{tag}", masks_z_h[k, :, :T_true])
        save_npy_atomic(out / "MASK" / str(rir) / f"step2_{tag}", mask_w_h[k, :, :T_true])
        save_npy_atomic(zdir / f"{rir}_{tag}", z_y_h[k, :, :T_true])

    def stack_keys(dicts):
        return {k: np.array([d[k] for d in dicts]) for k in dicts[0]}

    results = {"snr_in_raw": rnd_snrs, **stack_keys(per_node_tango)}
    resultsz = {"snr_in_raw": rnd_snrs, **stack_keys(per_node_mwf)}
    dump_pickle_atomic(out / "OIM" / f"results_tango_{rir}_{noise}.p", results)
    dump_pickle_atomic(out / "OIM" / f"results_mwf_{rir}_{noise}.p", resultsz)

    if save_fig:
        infos_path = layout.infos(rir)
        # validated, not just exists(): a truncated infos .npy from a
        # crashed datagen run would otherwise be trusted here forever
        if probe_npy(infos_path):
            try:
                from disco_tpu_torch.enhance.inference import plot_conf

                # One figure at a time: the OO matplotlib API avoids pyplot's
                # main-thread requirement, but first-render font-cache builds
                # and the Agg rasterizer are not re-entrant — scoring may run
                # on a thread pool (enhance_rirs_batched score_workers).  The
                # unregistered Figure needs no pyplot close; it is GC'd.
                with _FIG_LOCK:
                    fig = plot_conf(np.load(infos_path, allow_pickle=True).item(), return_fig=True)
                    fig.savefig(out / "FIG" / f"{rir}.png")
            except Exception:
                pass  # plotting is best-effort observability, never fatal
    score_stage.close()
    obs_registry.counter("clips_enhanced").inc()
    if obs_events.enabled():
        obs_events.record("clip", rir=rir, noise=noise, n_nodes=n_nodes,
                          sdr_cnv_mean=float(np.mean(results["sdr_cnv"])))
    run_chaos.tick("between_clips", rir=rir)
    return results


def _check_chained(streaming: bool, models, fault_spec) -> None:
    """The chained lane's refusals, with the JAX package's messages."""
    if streaming:
        raise ValueError(
            "chained=True is the offline whole-clip lane; the streaming "
            "chained twin (enhance.fused.streaming_clip_fused) lives "
            "behind the serve scheduler's time-domain sessions"
        )
    if models != (None, None):
        raise ValueError(
            "chained=True computes oracle masks in-program; the CRNN "
            "mask lane needs host STFTs and stays on the staged path"
        )
    if fault_spec is not None:
        raise ValueError(
            "chained=True has no z-exchange host seam to inject faults "
            "at; run fault scenarios on the staged path"
        )


def enhance_rir(
    root: str,
    scenario: str,
    rir: int,
    noise: str,
    save_dir: str = "tango",
    snr_range=(0, 6),
    mask_type: str = "irm1",
    policy: str = "local",
    models=(None, None),
    mu: float = 1.0,
    n_nodes: int = 4,
    mics_per_node: int = 4,
    out_root: str | None = None,
    force: bool = False,
    save_fig: bool = True,
    streaming: bool = False,
    bucket: int = 0,
    z_sigs: str = "zs_hat",
    solver: str | None = None,
    cov_impl: str = "auto",
    stft_impl: str = "auto",
    precision: str = "f32",
    chained: bool = False,
    fault_spec=None,
    ledger=None,
    device=None,
):
    """Enhance one RIR end to end and persist everything (reference
    tango.py:460-641).

    Lanes:
      * staged (default): ``stft_with_mag`` of the stacked y/s/n streams
        (one STFT launch), the masks (:func:`estimate_masks`: oracle of
        ``mask_type``, or CRNNs from ``models``), ``tango``;
      * ``streaming=True``: the frame-recursive online pipeline
        (``streaming_tango``; policies 'local'/'distant'/'none');
      * ``chained=True``: the whole clip through ``tango_clip_fused(...,
        export=True)``; offline oracle lane only — ``streaming``, CRNN
        ``models`` and ``fault_spec`` are rejected.
      Each lane's six ISTFTs, masks and z come to the host in one copy.

    ``solver=None`` resolves per lane: ``'power'`` offline, ``'eigh'``
    streaming (its warm-up covariances have weak eigengaps), ``'fused'``
    chained.

    ``bucket``: pad the clip to a multiple of ``bucket`` samples before the
    STFT, as :func:`enhance_rirs_batched` does (default 0: no padding);
    saved masks and z are trimmed to the clip's own frames.

    ``fault_spec``: optional ``FaultSpec`` (or dict/path accepted by
    ``fault.load_fault_spec``) injected at the z-exchange seam; offline,
    unavailable or corrupted streams leave the step-2 MWF, streaming, lost
    blocks are bridged by the last-good-z hold.

    ``ledger``: optional :class:`~disco_tpu_torch.runs.RunLedger` (or path)
    recording the clip's in_flight/done transitions with artifact digests.
    All writes are atomic, and the idempotency skip validates the existing
    OIM pickles.

    ``save_fig``: draw the room top view into ``FIG/<rir>.png`` from the
    clip's generation infos, best-effort (see the module docstring).
    ``device``: ``"cuda"`` when None (RuntimeError without a CUDA device),
    ``"cpu"`` for the plain versions on the host.

    Returns the tango results dict, or None when the RIR was already
    processed.
    """
    if chained:
        _check_chained(streaming, models, fault_spec)
    if solver is None:
        solver = "fused" if chained else ("eigh" if streaming else "power")
    dev = resolve_device(device)

    out = Path(out_root) if out_root is not None else results_root(scenario, dset_of_rir(rir),
                                                                  save_dir)
    if not force and _clip_done(out, rir, noise):
        return None
    if ledger is not None and not isinstance(ledger, RunLedger):
        ledger = RunLedger(ledger)
    if ledger is not None:
        ledger.mark_in_flight(unit_rir(rir, noise))

    layout = DatasetLayout(root, scenario, case_of_rir(rir))
    with obs_events.stage("load_input", rir=rir, noise=noise):
        y, s, n, s_dry, n_dry, fs, rnd_snrs = load_input_signals(layout, rir, noise, snr_range,
                                                                 n_nodes, mics_per_node)
    L = y.shape[-1]
    if bucket:
        pad = ((0, 0), (0, 0), (0, bucket_length(L, bucket) - L))
        y_in, s_in, n_in = np.pad(y, pad), np.pad(s, pad), np.pad(n, pad)
    else:
        y_in, s_in, n_in = y, s, n
    T_true = n_stft_frames(L)  # saved masks/z trimmed to the true frames

    if chained:
        # the whole clip in one call and its scoring payload in one copy;
        # the staged stft/masks/mwf/istft stages below never run
        with obs_events.stage("mwf", rir=rir, mode="chained", solver=solver):
            exp = tango_clip_fused(y_in, s_in, n_in, mu=mu, policy=policy, mask_type=mask_type,
                                   solver=solver, cov_impl=cov_impl, stft_impl=stft_impl,
                                   precision=precision, export=True, device=dev)
            td, masks_z, mask_w, z_y = call_with_retries(
                to_host, [torch.stack(exp["td"]), exp["masks_z"], exp["mask_w"], exp["z_y"]],
                retry_on=TRANSPORT_ERRORS, label="chained_readback")
            del exp
        # bucket padding trimmed on the host (numpy views)
        host = {"td": tuple(td[..., :L]), "masks_z": masks_z, "mask_w": mask_w, "z_y": z_y}
        obs_sentinels.check_finite("mwf_yf", host["td"][0], stage="mwf")
    else:
        with obs_events.stage("stft", rir=rir):
            spec, mag = stft_with_mag(torch.as_tensor(np.stack([y_in, s_in, n_in]), device=dev),
                                      impl=stft_impl, precision=precision)
            Y, S, N = spec[0], spec[1], spec[2]
        obs_sentinels.check_finite("stft_Y", Y, stage="stft")
        with obs_events.stage("masks", rir=rir):
            masks_z, mask_w = estimate_masks(Y, S, N, models, mask_type, n_nodes, mu=mu,
                                             z_sigs=z_sigs, mags=(mag[1], mag[2]), device=dev)
        obs_sentinels.check_finite("masks", (masks_z, mask_w), stage="masks")
        del mag
        fault_plan = None
        if fault_spec is not None:
            n_blocks = math.ceil(Y.shape[-1] / DEFAULT_UPDATE_EVERY) if streaming else 1
            fault_plan = plan_faults(fault_spec, n_nodes, n_blocks)
            fault_plan.record(mode="streaming" if streaming else "offline")
            _record_degraded(fault_plan, rir=rir, streaming=streaming)
            if not fault_plan.any_fault():
                fault_plan = None  # nothing drawn: the fault-free path
        if streaming:
            if policy not in ("local", "distant", "none", None):
                raise ValueError(
                    f"streaming mode implements the 'local'/'distant'/'none' "
                    f"mask-for-z policies; got {policy!r}"
                )
            if cov_impl not in ("xla", "auto"):
                raise ValueError(
                    f"streaming mode uses the smoothed-covariance estimator; "
                    f"cov_impl={cov_impl!r} applies to the offline pipeline only"
                )
            with obs_events.stage("mwf", rir=rir, mode="streaming", solver=solver):
                st = streaming_tango(Y, masks_z, mask_w, mu=mu, S=S, N=N, with_diagnostics=True,
                                     policy=policy, solver=solver, precision=precision,
                                     z_avail=None if fault_plan is None
                                     else fault_plan.avail_streaming, device=dev)
            # one filter everywhere: every saved wav, mask, z and metric
            # describes the online beamformer
            res = TangoResult(yf=st["yf"], sf=st["sf"], nf=st["nf"], z_y=st["z_y"],
                              z_s=st["z_s"], z_n=st["z_n"], zn=st["zn"], masks_z=masks_z,
                              mask_w=mask_w)
        else:
            faults = {} if fault_plan is None else {
                "z_mask": fault_plan.avail_offline,
                "z_nan": fault_plan.z_nan if fault_plan.z_nan.any() else None}
            with obs_events.stage("mwf", rir=rir, mode="offline", solver=solver):
                res = tango(Y, S, N, masks_z, mask_w, mu=mu, policy=policy, mask_type=mask_type,
                            solver=solver, cov_impl=cov_impl, precision=precision, device=dev,
                            **faults)
        obs_sentinels.check_finite("mwf_yf", res.yf, stage="mwf")
        del spec, Y, S, N
        with obs_events.stage("istft", rir=rir):
            host = _clip_host(res, L)
        del res

    out_results = _persist_and_score(out, rir, noise, snr_range, y, s, n, s_dry, n_dry, fs,
                                     rnd_snrs, host, T_true, n_nodes, layout=layout,
                                     save_fig=save_fig)
    if ledger is not None:
        ledger.mark_done(unit_rir(rir, noise), clip_artifacts(out, rir, noise, snr_range,
                                                              n_nodes))
    if obs_events.enabled():
        obs_events.record("counters", **obs_registry.snapshot())
    return out_results


def aggregate_results(oim_dir, kind: str = "tango", noise: str | None = None):
    """Collect per-RIR pickles into one dict of stacked arrays — the
    aggregation the reference leaves to the user (SURVEY.md §5.5)."""
    from disco_tpu_torch.core.miscx import concatenate_dicts

    oim_dir = Path(oim_dir)
    dicts = []
    for p in sorted(oim_dir.glob(f"results_{kind}_*")):
        if noise is not None and not p.stem.endswith(f"_{noise}"):
            continue
        with open(p, "rb") as fh:
            d = pickle.load(fh)
        dicts.append({k: np.atleast_1d(v) for k, v in d.items()})
    if not dicts:
        return {}
    return concatenate_dicts(dicts)


@lru_cache(maxsize=8)
def _step1_2d(mu: float):
    """The corpus driver's batched step 1 for the CRNN step-2 masks, one
    counted entry point per ``mu`` (the JAX package's ``step1_2d`` label):
    :func:`compute_z_signals` over a (B, K, C, F, T) batch."""
    def step1_2d(Yb, Sb, Nb, Mz):
        return compute_z_signals(None, None, None, Y=Yb, S=Sb, N=Nb, masks_z=Mz, mu=mu,
                                 device=Yb.device)

    return obs_accounting.counted_jit(step1_2d, label="step1_2d")


def _batched_masks(Yb, Sb, Nb, models, mask_type, mu, n_nodes, z_sigs, device=None, mags=None,
                   step1=None):
    """Step-1/step-2 masks for a whole clip batch (B, K, C, F, T): the
    (B K) node forwards of each CRNN step run as one
    :func:`crnn_masks_batched` call, step 1 as one :func:`compute_z_signals`
    call over the batch (its default solver, ``'power'``; ``step1``: the
    function making it, which the corpus driver passes as its counted
    :func:`_step1_2d`).  ``mags``: optional (B, K, C, F, T)
    ``(mag_S, mag_N)`` for the irm/ibm oracle masks (see
    :func:`estimate_masks`).  Returns (Mz, Mw), each (B, K, F, T)."""
    dev = resolve_device(device)
    Yb, Sb, Nb = _spectra(dev, Yb, Sb, Nb)
    B, K, _, F, T = Yb.shape
    refs = Yb[:, :, 0].reshape(B * K, F, T)

    def oracle():
        if mags is not None and mask_type[:-1] in ("irm", "ibm"):
            mag_s, mag_n = (torch.as_tensor(m, device=dev) for m in mags)
            return tf_mask_mag(mag_s[..., 0, :, :], mag_n[..., 0, :, :], mask_type)
        return oracle_masks(Sb, Nb, mask_type)

    if models[0] is None:
        Mz = oracle()
    else:
        Mz = crnn_masks_batched(refs, models[0], device=dev).reshape(B, K, F, T)
    if models[1] is None:
        return Mz, oracle()
    if step1 is None:
        out = compute_z_signals(None, None, None, Y=Yb, S=Sb, N=Nb, masks_z=Mz, mu=mu,
                                device=dev)
    else:
        out = step1(Yb, Sb, Nb, Mz)
    zs = _z_for_mask_device(out["z_y"], out["zn"], n_nodes, z_sigs).reshape(B * K, -1, F, T)
    Mw = crnn_masks_batched(refs, models[1], zs=zs, device=dev).reshape(B, K, F, T)
    return Mz, Mw


def make_batch_runners(*, mask_type: str = "irm1", mu: float = 1.0, policy: str = "local",
                       solver: str = "power", cov_impl: str = "auto", precision: str = "f32",
                       z_mask_arr=None, z_nan_arr=None, chained: bool = False,
                       stft_impl: str = "auto", device=None, mesh=None, n_nodes: int = 4):
    """The per-chunk batch runners of :func:`enhance_rirs_batched`:
    ``(run_batch, run_batch_with_masks)`` over (B, K, C, F, T) STFT stacks
    (oracle masks of ``mask_type`` computed from S and N vs masks passed
    in), each one batched ``tango`` call.

    ``chained=True`` instead returns ``(run_batch_chained, None)``: one
    ``tango_clip_fused(..., export=True)`` call over (B, K, C, L)
    time-domain stacks — STFT, oracle masks, both MWF steps and the six
    scoring ISTFTs; the fault masks are rejected there.

    With a ``mesh`` the runners take this rank's (B_loc, K_loc, C, F, T)
    shard and route through ``parallel.tango_batch_sharded`` (the oracle
    masks counted as ``oracle_masks_batched``); ``chained`` and
    ``precision='bf16'`` are refused there, as in the JAX package.

    The JAX package donates the STFT stacks to its jitted runners; here the
    driver drops its references to them once a runner returns.  Each runner
    counts its call signatures under the JAX package's label
    (``run_batch``, ``run_batch_with_masks``, ``run_batch_chained``;
    :func:`~disco_tpu_torch.obs.accounting.counted_jit`).
    """
    dev = resolve_device(device)
    if chained:
        if mesh is not None:
            raise ValueError(
                "chained batch runners are a single-device lane; mesh runs "
                "stay on the staged STFT-stack runners"
            )
        if z_mask_arr is not None or z_nan_arr is not None:
            raise ValueError(
                "chained batch runners have no z-exchange host seam; run "
                "fault scenarios on the staged path"
            )

        @obs_accounting.counted_jit(label="run_batch_chained")
        def run_batch_chained(yb, sb, nb):
            # the uncounted function: this runner's signature is the count
            return tango_clip_fused.__wrapped__(
                yb, sb, nb, mu=mu, policy=policy, mask_type=mask_type, solver=solver,
                cov_impl=cov_impl, stft_impl=stft_impl, precision=precision, export=True,
                device=dev)

        return run_batch_chained, None
    if mesh is not None:
        return _mesh_runners(mesh, mask_type=mask_type, mu=mu, policy=policy, solver=solver,
                             cov_impl=cov_impl, precision=precision, z_mask_arr=z_mask_arr,
                             z_nan_arr=z_nan_arr, n_nodes=n_nodes)

    def batch_tango(Yb, Sb, Nb, Mz, Mw):
        return tango(Yb, Sb, Nb, Mz, Mw, mu=mu, policy=policy, mask_type=mask_type,
                     solver=solver, cov_impl=cov_impl, precision=precision,
                     z_mask=z_mask_arr, z_nan=z_nan_arr, device=dev)

    @obs_accounting.counted_jit(label="run_batch_with_masks")
    def run_batch_with_masks(Yb, Sb, Nb, Mz, Mw):
        return batch_tango(Yb, Sb, Nb, Mz, Mw)

    @obs_accounting.counted_jit(label="run_batch")
    def run_batch(Yb, Sb, Nb):
        m = oracle_masks(Sb, Nb, mask_type)
        return batch_tango(Yb, Sb, Nb, m, m)

    return run_batch, run_batch_with_masks


def _mesh_runners(mesh, *, mask_type, mu, policy, solver, cov_impl, precision, z_mask_arr,
                  z_nan_arr, n_nodes):
    """The runners of the mesh lane (:func:`make_batch_runners`)."""
    from disco_tpu_torch.ops.resolve import resolve_precision
    from disco_tpu_torch.parallel import tango_batch_sharded

    if resolve_precision(precision) != "f32":
        raise ValueError("precision='bf16' is a single-device lane; mesh runs are f32")
    oracle_mask_fn = obs_accounting.counted_jit(
        partial(oracle_masks, mask_type=mask_type), label="oracle_masks_batched")

    def run_batch_with_masks(Yb, Sb, Nb, Mz, Mw):
        zmb = znb = None
        if z_mask_arr is not None:
            B = Yb.shape[0]
            zm = torch.as_tensor(z_mask_arr, dtype=torch.float32, device=Yb.device)
            zmb = zm.expand((B,) + tuple(zm.shape))
            if z_nan_arr is not None:
                znb = torch.as_tensor(z_nan_arr, device=Yb.device).expand(B, n_nodes)
        return tango_batch_sharded(Yb, Sb, Nb, Mz, Mw, mesh, mu=mu, policy=policy,
                                   mask_type=mask_type, solver=solver, cov_impl=cov_impl,
                                   z_mask_b=zmb, z_nan_b=znb)

    def run_batch(Yb, Sb, Nb):
        Mb = oracle_mask_fn(Sb, Nb)
        return run_batch_with_masks(Yb, Sb, Nb, Mb, Mb)

    return run_batch, run_batch_with_masks


def enhance_rirs_batched(
    root: str,
    scenario: str,
    rirs,
    noise: str,
    save_dir: str = "tango",
    snr_range=(0, 6),
    mask_type: str = "irm1",
    policy: str = "local",
    mu: float = 1.0,
    n_nodes: int = 4,
    mics_per_node: int = 4,
    out_root: str | None = None,
    force: bool = False,
    save_fig: bool = True,
    bucket: int = 8192,
    max_batch: int = 16,
    models=(None, None),
    z_sigs: str = "zs_hat",
    solver: str | None = None,
    cov_impl: str = "auto",
    stft_impl: str = "auto",
    precision: str = "f32",
    score_workers: int = 4,
    chained: bool = False,
    fault_spec=None,
    ledger=None,
    resume: bool = False,
    pipeline: bool = True,
    device=None,
    mesh=None,
    compile_cache=None,
):
    """Corpus-scale enhancement: many RIRs per launch.

    RIRs are grouped by bucketed length (``core.dsp.bucket_length``),
    enhanced ``max_batch`` clips a chunk — oracle masks of ``mask_type``, or
    CRNN masks from ``models`` with each step's (clip, node) forwards in one
    call — then scored and persisted per RIR exactly like
    :func:`enhance_rir`.  A remainder chunk pads to the next power of two
    (not to ``max_batch``) by repeating its first clip.

    ``score_workers``: per-RIR scoring (the 512-tap BSS Gram factors, STOI
    and the fw metrics, host float64) runs in a thread pool so chunk N's
    scoring overlaps chunk N+1's load and dispatch; pending scoring is
    bounded at ``pipeline.MAX_PENDING_CHUNKS`` chunks; 1 scores inline.
    Workers get numpy arrays only.

    ``fault_spec``: the same seeded plan (offline semantics) applies to
    every clip in the run.

    ``ledger`` / ``resume``: with ``resume=True`` the ledger's done entries
    are verified against their artifact digests before being skipped and
    corrupt or missing units are requeued (abandoned ``*.tmp.<pid>`` files
    of a crashed writer are swept first); with a ledger but
    ``resume=False`` its done records are trusted.  Without a ledger the
    skip probe validates the existing OIM pickles.  A graceful stop
    (``runs.interrupt``) finishes the in-flight chunk, drains scoring and
    returns the partial results.

    ``pipeline``: the overlapped engine (default) — a background thread
    loads and pads chunk N+1 while the card runs chunk N, and each chunk's
    results come back in ONE copy (``pipeline.fetch_chunk_host``).
    ``pipeline=False`` loads inline and copies each clip back on its own;
    the artifacts are byte-identical either way.

    ``chained``: each chunk rides one ``tango_clip_fused`` call over the
    time-domain stacks; offline oracle lane only (CRNN ``models`` and
    ``fault_spec`` are rejected); ``solver=None`` then resolves to
    ``'fused'``, else to ``'power'``.

    ``save_fig``: as :func:`enhance_rir`, drawn on the scoring workers.
    ``device``: ``"cuda"`` when None (RuntimeError without a CUDA device),
    ``"cpu"`` for the plain versions on the host.

    ``mesh``: optional ``(batch, node)`` mesh (``parallel.make_mesh``) — a
    collective call: every rank of the mesh runs it with the same
    arguments, and each chunk runs as ``parallel.tango_batch_sharded``
    over the ranks (clips over ``batch``, nodes over ``node``); the device
    is the mesh's.  ``max_batch`` must divide over the ``batch`` dim and
    ``n_nodes`` over ``node``; a tail chunk keeps the full batch.  Rank 0
    alone scores, writes and keeps the ledger; it returns the results, the
    other ranks ``{}``.  ``chained`` and ``precision='bf16'`` are refused.
    The metrics are the meshless run's (module docstring).

    ``compile_cache``: the kernel build cache
    (``disco_tpu_torch.utils.compile_cache``), resolved before the first
    launch so that the kernel library is built once across runs and
    resumes.  ``None`` resolves the ``DISCO_TORCH_COMPILE_CACHE`` env var,
    then ``build/kernels/``; ``False`` or an off-string builds it into a
    per-process temporary directory (disco_tpu/enhance/driver.py:991-992).

    Returns {rir: results dict} for the RIRs actually processed.
    """
    if chained:
        if mesh is not None:
            raise ValueError(
                "chained=True is a single-device lane; mesh runs stay on "
                "the staged STFT-stack runners"
            )
        _check_chained(False, models, fault_spec)
    if solver is None:
        solver = "fused" if chained else "power"
    from disco_tpu_torch.utils import compile_cache as _compile_cache

    _compile_cache.ensure_enabled(compile_cache)
    writer, lanes = True, None
    if mesh is None:
        dev = resolve_device(device)
    else:
        import torch.distributed as dist

        from disco_tpu_torch.parallel.mesh import dim_size, mesh_device

        dev = mesh_device(mesh)
        n_b, n_k = dim_size(mesh, "batch"), dim_size(mesh, "node")
        if max_batch % n_b:
            raise ValueError(f"max_batch {max_batch} must be divisible by the mesh batch "
                             f"axis ({n_b})")
        if n_nodes % n_k:
            raise ValueError(f"the {n_nodes}-node array is not divisible over {n_k} mesh nodes")
        writer = dist.get_rank() == 0
        lanes = (mesh.get_local_rank("batch"), n_b, mesh.get_local_rank("node"), n_k)
        if not writer:
            ledger = None

    fault_plan = None
    z_mask_arr = z_nan_arr = None
    if fault_spec is not None:
        fault_plan = plan_faults(fault_spec, n_nodes, 1)
        fault_plan.record(mode="offline")
        if fault_plan.any_fault():
            z_mask_arr = fault_plan.avail_offline
            z_nan_arr = fault_plan.z_nan if fault_plan.z_nan.any() else None
        else:  # nothing drawn: every chunk on the fault-free path
            fault_plan = None

    def out_of(rir):
        return Path(out_root) if out_root is not None else results_root(
            scenario, dset_of_rir(rir), save_dir)

    if ledger is not None and not isinstance(ledger, RunLedger):
        ledger = RunLedger(ledger)
    if resume and writer:
        # a real crash (process death) can leave abandoned *.tmp.<pid>
        # partial writes; sweep them before probing
        litter = [p for root_ in sorted({str(out_of(r)) for r in rirs})
                  for p in remove_tmp_litter(root_)]
        if litter:
            obs_events.record(
                "warning", stage="resume",
                reason=f"removed {len(litter)} abandoned temp file(s) from a "
                       f"crashed writer", files=litter[:20],
            )
    ledger_done: set = set()
    requeued_units: set = set()
    if ledger is not None and resume:
        ledger_done, requeued = ledger.verified_done()
        requeued_units = set(requeued)
        obs_events.record(
            "run_resume", stage="enhance", ledger=str(ledger.path),
            n_done=len(ledger_done), n_requeued=len(requeued),
            requeued=sorted(requeued),
        )
    elif ledger is not None:
        ledger_done = {u for u, rec in ledger.replay().items() if rec["state"] == "done"}

    # index pass: group pending RIRs by bucketed length, reading one channel
    # per clip to learn its length
    groups: dict[int, list] = {}
    for rir in rirs if writer else ():
        out = out_of(rir)
        if not force:
            if unit_rir(rir, noise) in ledger_done:
                continue
            # a unit the verified resume requeued is redone even when its
            # pickles probe fine (its damage may be a deleted WAV)
            if unit_rir(rir, noise) not in requeued_units and _clip_done(out, rir, noise):
                if ledger is not None:
                    # complete on disk without a done record (a crash between
                    # the last rename and the append): catch the ledger up
                    ledger.mark_done(unit_rir(rir, noise),
                                     clip_artifacts(out, rir, noise, snr_range, n_nodes),
                                     recovered="complete artifacts found without a done record")
                continue
        layout = DatasetLayout(root, scenario, case_of_rir(rir))
        probe = layout.wav_processed(snr_range, "mixture", rir, 1, noise=noise)
        if not probe.exists():
            continue
        L = len(read_wav(probe)[0])
        groups.setdefault(bucket_length(L, bucket) if bucket else L, []).append(
            (rir, out, layout))
    if mesh is not None:
        # every rank runs rank 0's work list, chunk for chunk
        plan = [groups]
        dist.broadcast_object_list(plan, src=0)
        groups = plan[0]

    def stop_now() -> bool:
        """A graceful stop on any rank stops every rank between chunks."""
        stop = run_interrupt.stop_requested()
        if mesh is None:
            return stop
        flag = torch.tensor(int(stop), device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag)

    run_batch, run_batch_with_masks = make_batch_runners(
        mask_type=mask_type, mu=mu, policy=policy, solver=solver, cov_impl=cov_impl,
        precision=precision, z_mask_arr=z_mask_arr, z_nan_arr=z_nan_arr, chained=chained,
        stft_impl=stft_impl, device=dev, mesh=mesh, n_nodes=n_nodes)

    # one entry per (bucket, chunk) launch, bucket then offset order
    work_items = [(Lp, items[start:start + max_batch]) for Lp, items in groups.items()
                  for start in range(0, len(items), max_batch)]

    all_results = {}
    pending_chunks: deque = deque()

    def drain_chunks(bound: int = 0):
        while len(pending_chunks) > bound:
            for rir_, fut in pending_chunks.popleft():
                all_results[rir_] = fut.result()

    def score_unit(score_fn, rir_, out_):
        """One clip's scoring + ledger completion (runs on a worker)."""
        r = score_fn()
        if ledger is not None:
            ledger.mark_done(unit_rir(rir_, noise),
                             clip_artifacts(out_, rir_, noise, snr_range, n_nodes))
        return r

    def load_chunk(Lp, chunk):
        """Load + pad one chunk — host numpy only (wav decode, padding,
        ledger marks, chaos seam).  Runs on the prefetch thread in
        pipelined mode, inline otherwise."""
        if ledger is not None:
            for rir, _out, _layout in chunk:
                ledger.mark_in_flight(unit_rir(rir, noise), bucket=Lp)
        run_chaos.tick("chunk_load", bucket=Lp, n_clips=len(chunk))
        with obs_events.stage("chunk_load", n_clips=len(chunk), bucket=Lp):
            sigs = [load_input_signals(layout, rir, noise, snr_range, n_nodes, mics_per_node)
                    for rir, _, layout in chunk]
        ys, ss, ns = [], [], []
        for (y, s, n, *_rest) in sigs:
            pad = ((0, 0), (0, 0), (0, Lp - y.shape[-1]))
            ys.append(np.pad(y, pad))
            ss.append(np.pad(s, pad))
            ns.append(np.pad(n, pad))
        # a remainder chunk pads to the next power of two by repeating its
        # first clip; a mesh run keeps the full batch, which divides over
        # the mesh's batch dim
        n_real = len(ys)
        tail = max_batch if mesh is not None else min(
            max_batch, 1 << max(n_real - 1, 0).bit_length())
        while len(ys) < tail:
            ys.append(ys[0])
            ss.append(ss[0])
            ns.append(ns[0])
        return LoadedChunk(Lp, chunk, sigs, np.stack(ys), np.stack(ss), np.stack(ns), n_real)

    def dispatch_chunk(lc):
        """The chunk's launches (main thread, the only CUDA user); the STFT
        stacks are dropped as soon as the runner returns.  ``chunk_enhance``
        times the launches' queueing, not the card's work."""
        run_chaos.tick("pre_dispatch", bucket=lc.bucket, n_clips=lc.n_real)
        with obs_events.stage("chunk_enhance", n_clips=lc.n_real, bucket=lc.bucket,
                              batch=len(lc.ys)):
            stacks = (lc.ys, lc.ss, lc.ns)
            oracle = models == (None, None)
            if lanes is not None:
                # this rank's clips, and its nodes when the masks are the
                # oracle's (the CRNN's step-2 masks read every node's z)
                b, n_b, k, n_k = lanes
                per, per_k = len(lc.ys) // n_b, n_nodes // n_k
                stacks = tuple(a[b * per:(b + 1) * per] for a in stacks)
                if oracle:
                    stacks = tuple(a[:, k * per_k:(k + 1) * per_k] for a in stacks)
            x = torch.stack([torch.as_tensor(a, device=dev) for a in stacks])
            if chained:
                return run_batch(x[0], x[1], x[2])
            spec = stft_fused(x, impl=stft_impl, precision=precision)
            del x
            if oracle:
                Mz = Mw = None
            else:
                Mz, Mw = _batched_masks(spec[0], spec[1], spec[2], models, mask_type, mu,
                                        n_nodes, z_sigs, device=dev, step1=_step1_2d(mu))
                if lanes is not None:
                    # this rank's nodes: views, in the STFT's own memory
                    # layout (the meshless run's operands, cut)
                    spec = spec[:, :, k * per_k:(k + 1) * per_k]
                    Mz, Mw = (a[:, k * per_k:(k + 1) * per_k] for a in (Mz, Mw))
            res = (run_batch(spec[0], spec[1], spec[2]) if Mz is None
                   else run_batch_with_masks(spec[0], spec[1], spec[2], Mz, Mw))
            if lanes is None:
                return res
            from disco_tpu_torch.parallel import gather_result

            # rank 0 alone scores: the chunk's result is assembled there
            return gather_result(res, mesh, dst=0)

    def submit_scoring(lc, host_of):
        """Queue (or run inline) one chunk's per-clip scoring; ``host_of(i)``
        gives clip i's host payload."""
        futs = []
        for i in range(lc.n_real):
            rir, out, layout = lc.chunk[i]
            y, s, n, s_dry, n_dry, fs, rnd_snrs = lc.sigs[i]
            _record_degraded(fault_plan, rir=rir)
            L = y.shape[-1]
            score = partial(_persist_and_score, out, rir, noise, snr_range, y, s, n, s_dry,
                            n_dry, fs, rnd_snrs, host_of(i), n_stft_frames(L), n_nodes,
                            layout=layout, save_fig=save_fig)
            if score_workers <= 1:
                all_results[rir] = score_unit(score, rir, out)
            else:
                futs.append((rir, ex.submit(score_unit, score, rir, out)))
        if futs:
            pending_chunks.append(futs)
            drain_chunks(MAX_PENDING_CHUNKS)

    def host_payload(res_b, lc, fetch):
        host = fetch(res_b, lc.clip_lengths, lc.n_real)
        return lambda i: {"td": host["td"][i], "masks_z": host["masks_z"][i],
                          "mask_w": host["mask_w"][i], "z_y": host["z_y"][i]}

    stopping = False  # graceful interruption: wind down between chunks
    with ThreadPoolExecutor(max_workers=max(score_workers, 1)) as ex:
        if pipeline:
            # a mesh run's loader never stops on its own: the ranks agree on
            # the stop between chunks
            prefetcher = ChunkPrefetcher(
                work_items, load_chunk,
                stop_requested=run_interrupt.stop_requested if mesh is None else (lambda: False))
            n_done_chunks = 0
            try:
                for lc, stall_s in prefetcher:
                    if stop_now():
                        stopping = True
                        break  # graceful stop: in-flight scoring drains below
                    t0 = time.perf_counter()
                    with obs_events.stage("chunk_pipeline", n_clips=lc.n_real, bucket=lc.bucket,
                                          stall_ms=round(stall_s * 1e3, 3)):
                        res_b = dispatch_chunk(lc)
                        if writer:
                            host_of = host_payload(
                                res_b, lc, fetch_chained_host if chained else fetch_chunk_host)
                            del res_b
                            submit_scoring(lc, host_of)
                    note_chunk_overlap(stall_s, time.perf_counter() - t0)
                    n_done_chunks += 1
                # the prefetcher may be the one that saw the stop: the loop
                # then ends with work items never loaded
                if n_done_chunks < len(work_items):
                    stopping = True
            finally:
                prefetcher.close()
        else:
            for Lp, chunk in work_items:
                if stop_now():
                    stopping = True
                    break
                lc = load_chunk(Lp, chunk)
                res_b = dispatch_chunk(lc)
                if not writer:
                    continue
                if chained:
                    host_of = host_payload(res_b, lc, fetch_chained_host)
                else:
                    # one copy per clip, from the clip's slice of the batch
                    hosts = []
                    for i, L in enumerate(lc.clip_lengths):
                        with obs_events.stage("istft", rir=lc.chunk[i][0]):
                            hosts.append(_clip_host(clip_slice(res_b, i), L))
                    host_of = hosts.__getitem__
                del res_b
                submit_scoring(lc, host_of)
        drain_chunks()
    if stopping:
        obs_events.record(
            "note", stage="enhance",
            reason="graceful stop: partial corpus run; rerun with resume=True "
                   "(--resume) to continue",
            n_done=len(all_results),
        )
    if obs_events.enabled():
        obs_events.record("counters", **obs_registry.snapshot())
    return all_results

"""Z-signal export — step 1 only, producing the compressed signals that
become CRNN training inputs (counterpart of ``disco_tpu/enhance/zexport.py``;
reference speech_enhancement/get_z_signals.py:213-359).

:func:`compute_z_signals` runs step 1 over all nodes; :func:`export_z` saves,
per node, ``zs_hat`` (the compressed mixture estimate z) and ``zn_hat``
(y_ref − z), each raw and as ``|·|`` "normed", under
``stft_z/{zfile}/{raw,normed/abs}/{snrdir}/...`` — idempotently per RIR, in
the JAX package's file contract.  :func:`load_node_signals` and
:func:`load_mixture_signals` read a clip's processed channel WAVs.
"""
from __future__ import annotations

import numpy as np
import torch

from disco_tpu_torch.core.dsp import stft
from disco_tpu_torch.device import resolve_device, to_host
from disco_tpu_torch.enhance.tango import oracle_masks, tango_step1
from disco_tpu_torch.io.atomic import save_npy_atomic
from disco_tpu_torch.io.fastwav import read_wavs_batch
from disco_tpu_torch.io.layout import DatasetLayout, case_of_rir
from disco_tpu_torch.ops.resolve import check_canonical_precision


def compute_z_signals(y, s, n, masks_z=None, mask_type: str = "irm1", mu: float = 1.0,
                      oracle_stats: bool = False, Y=None, S=None, N=None, solver: str = "power",
                      cov_impl: str = "auto", precision: str = "f32", device=None):
    """Step 1 over all nodes: (K, C, L) time signals → dict of (K, F, T) z
    streams (reference get_z_signals.py:213-317, vectorized).

    ``masks_z`` may be given explicitly (K, F, T) — e.g. CRNN-estimated —
    else oracle masks of ``mask_type`` are computed from S and N.  With
    explicit masks, ``s``/``n`` may be None (z_s/z_n then come out zero).
    Precomputed STFTs may be passed as ``Y``/``S``/``N`` to skip the
    transform.

    ``solver``/``cov_impl``/``precision`` go to the step-1 covariance and
    solve stages as in :func:`~disco_tpu_torch.enhance.tango.tango`, with
    the JAX package's defaults ('power'/'auto'/'f32').  The port's step 1
    runs all K × F pencils as one covariance launch and one solve for every
    solver spec, which is the structure of the JAX package's fused-spec
    branch; its other branch, K vmapped per-node steps, computes the same.

    Returns the dict of :func:`~disco_tpu_torch.enhance.tango.tango_step1`
    plus ``masks_z``.  ``device``: ``"cuda"`` when None.
    """
    precision = check_canonical_precision(precision)
    dev = resolve_device(device)

    def spec(x, X):
        if X is not None:
            return torch.as_tensor(X, dtype=torch.complex64, device=dev)
        return None if x is None else stft(torch.as_tensor(x, dtype=torch.float32, device=dev))

    Y = spec(y, Y)
    S, N = (a if a is not None else torch.zeros_like(Y) for a in (spec(s, S), spec(n, N)))
    if masks_z is None:
        if s is None or n is None:
            raise ValueError("either pass masks_z explicitly or provide s and n for oracle masks")
        masks_z = oracle_masks(S, N, mask_type)
    masks_z = torch.as_tensor(masks_z, dtype=torch.float32, device=dev)
    out = tango_step1(Y, S, N, masks_z, mu=mu, oracle_stats=oracle_stats, solver=solver,
                      cov_impl=cov_impl, precision=precision)
    out["masks_z"] = masks_z
    return out


def _node_paths(layout, rir, noise_tag, snr_range, n_nodes, mics_per_node, source):
    return [
        layout.wav_processed(snr_range, source, rir, 1 + node * mics_per_node + c, noise=noise_tag)
        for node in range(n_nodes)
        for c in range(mics_per_node)
    ]


def load_node_signals(layout: DatasetLayout, rir: int, noise: str, snr_range, n_nodes: int = 4,
                      mics_per_node: int = 4):
    """Read processed mixture/target/noise wavs into (K, C, L) float32 arrays
    (reference get_z_signals.py:44-92): all 3 x K x C channel files in one
    :func:`~disco_tpu_torch.io.fastwav.read_wavs_batch`.  Host numpy only."""
    # targets are saved without a noise tag; mixture/noise carry it
    # (reference post_generator.py:133-150)
    paths = (
        _node_paths(layout, rir, noise, snr_range, n_nodes, mics_per_node, "mixture")
        + _node_paths(layout, rir, None, snr_range, n_nodes, mics_per_node, "target")
        + _node_paths(layout, rir, noise, snr_range, n_nodes, mics_per_node, "noise")
    )
    sigs, _fs = read_wavs_batch(paths)
    y, s, n = sigs.reshape(3, n_nodes, mics_per_node, -1)
    return y, s, n


def load_mixture_signals(layout: DatasetLayout, rir: int, noise: str, snr_range,
                         n_nodes: int = 4, mics_per_node: int = 4):
    """Mixture-only variant of :func:`load_node_signals` for mask-supplied
    exports (no oracle masks needed, so no target/noise reads)."""
    paths = _node_paths(layout, rir, noise, snr_range, n_nodes, mics_per_node, "mixture")
    sigs, _fs = read_wavs_batch(paths)
    return sigs.reshape(n_nodes, mics_per_node, -1)


def export_z(root: str, scenario: str, rir: int, noise: str, snr_range=(0, 6),
             zfile: str = "oracle", mask_type: str = "irm1", masks_z=None, masks_fn=None,
             n_nodes: int = 4, mics_per_node: int = 4, force: bool = False,
             device=None) -> bool:
    """Export z's for one RIR; returns False if already done (idempotency
    guard of reference get_z_signals.py:328-331, with the reference's
    missing-'.npy' stale-check fixed as in the JAX package).

    ``masks_fn``: optional callable (K, C, F, T) mixture STFT tensor ->
    (K, F, T) step-1 masks (the CRNN path of reference
    get_z_signals.py:95-120); ``masks_z`` passes them precomputed.  With
    neither, oracle masks of ``mask_type`` are used.  Both exported streams
    cross to the host in one copy.  ``device``: ``"cuda"`` when None
    (RuntimeError without a CUDA device), ``"cpu"`` for the plain versions.
    """
    dev = resolve_device(device)
    layout = DatasetLayout(root, scenario, case_of_rir(rir))
    done_marker = layout.stft_z(zfile, snr_range, "zn_hat", rir, n_nodes, noise, normed=True)
    if done_marker.exists() and not force:
        return False

    if masks_z is None and masks_fn is None:
        y, s, n = load_node_signals(layout, rir, noise, snr_range, n_nodes, mics_per_node)
    else:  # explicit masks: the target/noise wav reads are not needed
        y, s, n = load_mixture_signals(layout, rir, noise, snr_range, n_nodes,
                                       mics_per_node), None, None
    Y = None
    if masks_fn is not None and masks_z is None:
        Y = stft(torch.as_tensor(y, device=dev))
        masks_z = masks_fn(Y)
    out = compute_z_signals(y, s, n, masks_z=masks_z, mask_type=mask_type, Y=Y, device=dev)
    zs, zn = to_host([out["z_y"], out["zn"]])  # zs_hat = compressed mixture, zn_hat = y_ref - z
    for k in range(n_nodes):
        for zsig, arr in (("zs_hat", zs[k]), ("zn_hat", zn[k])):
            raw = layout.stft_z(zfile, snr_range, zsig, rir, k + 1, noise, normed=False)
            save_npy_atomic(layout.ensure_dir(raw), arr)
            normed = layout.stft_z(zfile, snr_range, zsig, rir, k + 1, noise, normed=True)
            save_npy_atomic(layout.ensure_dir(normed), np.abs(arr))
    return True

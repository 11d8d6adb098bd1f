"""The whole offline clip — STFT, masks, both MWF steps, ISTFT — in one call
(counterpart of ``disco_tpu/enhance/fused.py::tango_clip_fused``).

    stft_with_mag -> tf_mask_mag -> masked covariances -> fused step-1
    -> z-exchange -> fused step-2 -> istft

On a CUDA device this runs the three hand-written kernels of the port: one
STFT launch over the stacked y/s/n streams, and per step one covariance
launch and one fused-solve launch.

Its streaming twin :func:`streaming_clip_fused` takes one super-tick
window of time-domain signal through the window STFT (one STFT launch),
the oracle masks, ``streaming_tango_scan`` and the ISTFT; under
``solver='jacobi-pallas'`` every refresh block launches the eigensolver
kernel once per step.
"""
from __future__ import annotations

import torch

from disco_tpu_torch.core.dsp import istft
from disco_tpu_torch.core.masks import tf_mask_mag
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.streaming import (
    DEFAULT_LAMBDA_COR,
    DEFAULT_MU,
    DEFAULT_UPDATE_EVERY,
    streaming_tango_scan,
)
from disco_tpu_torch.enhance.tango import oracle_masks, tango
from disco_tpu_torch.ops.resolve import resolve_precision
from disco_tpu_torch.ops.stft_ops import stft_with_mag


def _clip_oracle_masks(spec, mag, mask_type: str, ref_mic: int):
    """(..., K, F, T) oracle step masks from the fused STFT's outputs: the
    irm/ibm families use the emitted magnitudes, the iam family the complex
    spectra."""
    if mask_type[:-1] in ("irm", "ibm"):
        return tf_mask_mag(mag[1][..., ref_mic, :, :], mag[2][..., ref_mic, :, :], mask_type)
    return oracle_masks(spec[1], spec[2], mask_type, ref_mic=ref_mic)


def tango_clip_fused(y, s, n, masks_z=None, mask_w=None, mu: float = 1.0,
                     policy: str | None = "local", ref_mic: int = 0, mask_type: str = "irm1",
                     oracle_step1_stats: bool = False, solver: str = "fused",
                     cov_impl: str = "auto", stft_impl: str = "auto", precision: str = "f32",
                     export: bool = False, device=None):
    """Enhance one clip (or a leading batch of clips) end to end.

    Args:
      y, s, n: (..., K, C, L) float mixture / speech / noise node signals
        (numpy or tensors).
      masks_z, mask_w: optional (..., K, F, T) step-1 / step-2 masks; None
        computes oracle masks of ``mask_type`` from the fused STFT's
        magnitudes, and ``mask_w=None`` reuses ``masks_z``.
      solver: rank-1 GEVD-MWF solver spec (``beam.filters.rank1_gevd``),
        ``'fused'`` by default — the hand-written fused-solve kernel.
      cov_impl / stft_impl / precision: the ``ops`` seams.
      export: False returns the (..., K, L) enhanced signal; True returns
        ``td`` (the 6-tuple of (..., K, L) ISTFTs: yf, z_y, sf, nf, z_s,
        z_n), ``masks_z``/``mask_w`` and the complex ``z_y``.
      device: ``"cuda"`` when None (RuntimeError without a CUDA device),
        ``"cpu"`` for the plain versions on the host.
    """
    precision = resolve_precision(precision)
    dev = resolve_device(device)
    y, s, n = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (y, s, n))
    L = y.shape[-1]
    spec, mag = stft_with_mag(torch.stack([y, s, n]), impl=stft_impl, precision=precision)
    if masks_z is None:
        masks_z = _clip_oracle_masks(spec, mag, mask_type, ref_mic)
    if mask_w is None:
        mask_w = masks_z
    res = tango(spec[0], spec[1], spec[2], masks_z, mask_w, mu=mu, policy=policy,
                ref_mic=ref_mic, mask_type=mask_type, oracle_step1_stats=oracle_step1_stats,
                solver=solver, cov_impl=cov_impl, precision=precision, device=dev)
    if not export:
        return istft(res.yf, length=L)
    td = istft(torch.stack([res.yf, res.z_y, res.sf, res.nf, res.z_s, res.z_n]), length=L)
    return {
        "td": tuple(td[i] for i in range(6)),
        "masks_z": res.masks_z,
        "mask_w": res.mask_w,
        "z_y": res.z_y,
    }


def streaming_clip_fused(y, s=None, n=None, masks_z=None, mask_w=None,
                         lambda_cor: float = DEFAULT_LAMBDA_COR,
                         update_every: int = DEFAULT_UPDATE_EVERY, mu: float = DEFAULT_MU,
                         ref_mic: int = 0, mask_type: str = "irm1", policy: str | None = "local",
                         state=None, solver: str = "eigh", z_avail=None,
                         blocks_per_dispatch: int = 1, stft_impl: str = "auto",
                         precision: str = "f32", device=None):
    """One streaming super-tick: window STFT, masks, the N-block two-step
    streaming pipeline (``streaming_tango_scan``), ISTFT.

    Each window is transformed with its own centered reflect padding, so
    its first and last frames differ from those of a whole-clip STFT.

    Args:
      y: (K, C, Lw) time-domain window whose ``1 + Lw // 256`` STFT frames
        split into ``blocks_per_dispatch`` refresh-aligned blocks (e.g.
        Lw = 16128: T = 64 frames = 16 blocks of ``update_every`` 4).
      s, n: optional (K, C, Lw) clean components for oracle masks of
        ``mask_type``; or pass ``masks_z`` (and ``mask_w``) as (K, F, T).
      state: continuation state from the previous window (None: the warm
        start).
      solver / precision / stft_impl: the shared seams.
      z_avail: optional availability of the exchanged streams, as in
        ``streaming_tango_scan``.
      device: ``"cuda"`` when None (RuntimeError without a CUDA device),
        ``"cpu"`` for the plain versions on the host.

    Returns:
      dict with ``yf`` (K, Lw) enhanced window and ``state``.
    """
    precision = resolve_precision(precision)
    dev = resolve_device(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    L = y.shape[-1]
    if masks_z is None:
        if s is None or n is None:
            raise ValueError(
                "streaming_clip_fused: either pass masks_z explicitly or "
                "provide s and n for oracle masks"
            )
        s, n = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (s, n))
        spec, mag = stft_with_mag(torch.stack([y, s, n]), impl=stft_impl, precision=precision)
        Y = spec[0]
        masks_z = _clip_oracle_masks(spec, mag, mask_type, ref_mic)
    else:
        Y = stft_with_mag(y, impl=stft_impl, precision=precision)[0]
    if mask_w is None:
        mask_w = masks_z
    out = streaming_tango_scan(
        Y, masks_z, mask_w, lambda_cor=lambda_cor, update_every=update_every, mu=mu,
        ref_mic=ref_mic, policy=policy, state=state, solver=solver, z_avail=z_avail,
        blocks_per_dispatch=blocks_per_dispatch, precision=precision, device=dev,
    )
    return {"yf": istft(out["yf"], length=L), "state": out["state"]}
